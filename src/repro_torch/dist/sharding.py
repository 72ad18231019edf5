"""Logical-axis rules: which mesh axis a logical axis of the decoder rides.

The decoder's half of the JAX package's ``dist/sharding.py``. Code names
its axes logically (``"chunks"``, ``"units"``, ``"batch"``); a rule set
maps each logical name to mesh axis names. :func:`resolve` gives the
mesh axes of a tuple of logical axes, one entry a dimension (``None``
for replicated), as the JAX package's ``PartitionSpec``.
``core.api.ParallelDecoder.decode_on(rules=)`` reads the axis of
``"chunks"``; the decode splits its lanes over it.

Rules are replaced, not merged, by :func:`logical_rules`. ``shard`` on
model activations, and the model axes' default rules, wait for the
sharding plan (ROADMAP A15).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

_STATE = threading.local()


def current_rules() -> Optional[Rules]:
    """The rule set of the innermost :func:`logical_rules`, or None."""
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Rules):
    """Activate a logical -> mesh axis rule set for the enclosed block."""
    prev = current_rules()
    _STATE.rules = dict(rules)
    try:
        yield
    finally:
        _STATE.rules = prev


def normalize(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def resolve(logical_axes: Sequence[Optional[str]],
            rules: Optional[Rules] = None) -> Tuple:
    """The mesh axes of each logical axis: ``None`` (replicated), an axis
    name, or a tuple of them. Unknown names are replicated; a mesh axis
    is used once, its first use winning, as in the JAX package."""
    if rules is None:
        rules = current_rules() or {}
    used, dims = set(), []
    for name in logical_axes:
        axes = normalize(rules.get(name)) if name is not None else ()
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        dims.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return tuple(dims)


def decode_rules(axis_names: Sequence[str]) -> Rules:
    """The decoder's rules on a mesh: lanes, units and batch ride its
    ``"data"`` axis, else its first."""
    axis = "data" if "data" in axis_names else axis_names[0]
    return {"chunks": (axis,), "units": (axis,), "batch": (axis,)}


def lane_axis(mesh, rules: Optional[Rules] = None) -> Optional[str]:
    """The mesh axis the lanes (``"chunks"``) ride under ``rules`` (the
    active :func:`logical_rules` by default): the first of its axes that
    the mesh has with more than one entry, None when there is none (the
    decode then runs on one block)."""
    for axis in normalize(resolve(("chunks",), rules)[0]):
        if mesh.shape.get(axis, 1) > 1:
            return axis
    return None

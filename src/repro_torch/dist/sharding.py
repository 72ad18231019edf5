"""Logical-axis rules: which mesh axis a logical axis rides.

The port of the JAX package's ``dist/sharding.py``. Code names its axes
logically (the decoder's ``"chunks"``, ``"units"``, ``"batch"``; the
model's ``"heads"``, ``"mlp"``, ``"vocab"`` ...); a rule set maps each
logical name to mesh axis names. :func:`resolve` gives the mesh axes of
a tuple of logical axes, one entry a dimension (``None`` for
replicated), as the JAX package's ``PartitionSpec``.
``core.api.ParallelDecoder.decode_on(rules=)`` reads the axis of
``"chunks"``; the decode splits its lanes over it. The model's rules
(:data:`DEFAULT_RULES`, ``dist.plan.rules_for``) become a
``dist.plan.ShardLayout``: the slice of each parameter, batch input and
cache that one rank holds.

Rules are replaced, not merged, by :func:`logical_rules`. The JAX
package's ``shard()`` and ``trace_token()`` have no counterpart: they are
constraints for XLA's partitioner, which inserts the collectives, where
the port's layers split themselves over the model group and call them
(``dist.tensor_parallel``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# Baseline rules for a ("data", "model") mesh: activation and batch axes
# ride the data axis, the tensor-parallel width axes the model axis, and
# everything else is replicated.
DEFAULT_RULES: Rules = {
    # model activations and parameters
    "batch": ("data",),
    "seq": (),
    "kv_seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    # the decoder's lanes: subsequence chunks and output units
    "chunks": ("data",),
    "units": ("data",),
}

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

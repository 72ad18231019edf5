"""Device meshes of one process: the cards a decode splits its lanes over.

The port's counterpart of the JAX package's ``launch/mesh.py``. A
:class:`Mesh` is an array of ``torch.device``s with axis names, the shape
of a ``jax.sharding.Mesh``. Nothing here touches the card when the module
is imported.

A mesh may name one device more than once: each entry is a *block* of
the decode's lanes (``core.mesh_decode``), and blocks on one device run
the same exchange as blocks on distinct cards, with local copies in place
of peer copies. The CPU tests decode over ``Mesh([cpu] * 4)`` where the
JAX package forces four host devices. A device index the machine does not
have raises.

The JAX package's TPU pod mesh (``make_production_mesh``) and its TPU
roofline constants are not ported (ROADMAP: no port, on purpose).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index on a card; raises
    for a card the machine does not have, and for any type but cuda and
    cpu."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"a mesh holds cuda or cpu devices, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev} named, but no CUDA device is "
                           f"available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"mesh device cuda:{index} does not exist: the "
                           f"machine has {torch.cuda.device_count()} cards")
    return torch.device("cuda", index)


class Mesh:
    """An n-d array of devices with one name per axis.

    ``devices`` is a numpy object array of ``torch.device``; ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does;
    ``size`` is the number of entries. Two meshes are equal when they hold
    the same devices in the same layout under the same names.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        flat = [check_device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        shape = np.shape(np.asarray(devices, dtype=object))
        if not flat:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-d devices need as many "
                             f"axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        kinds = {d.type for d in flat}
        if len(kinds) > 1:
            raise ValueError("a mesh holds cards or the CPU, not both")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def flat(self) -> "Mesh":
        """The same devices as a 1-D ``("data",)`` mesh, in row-major
        order."""
        return Mesh(self.devices.reshape(-1), ("data",))

    def key(self) -> Tuple:
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        devs = ",".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, [{devs}])"


def _cards(n: Optional[int]) -> list:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass devices to "
                           "Mesh, e.g. Mesh([torch.device('cpu')] * 4)")
    n = count if n is None else n
    if not 0 < n <= count:
        raise RuntimeError(f"asked for {n} cards, the machine has {count}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the first
    ``prod(shape)`` cards)."""
    n = int(np.prod(shape))
    devs = list(devices) if devices is not None else _cards(n)
    if len(devs) != n:
        raise ValueError(f"shape {shape} needs {n} devices, got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_host_mesh(n: Optional[int] = None, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over the first ``n`` cards (all of
    them by default)."""
    devs = _cards(n)
    if len(devs) % model:
        raise ValueError(f"{len(devs)} cards do not split into model={model}")
    return make_mesh((len(devs) // model, model), ("data", "model"), devs)


def make_local_data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ``"data"`` mesh over this process's cards: ``devices`` (the
    cards ``launch.multihost`` gives the process), else every card the
    process sees."""
    devs = list(devices) if devices is not None else _cards(None)
    return make_mesh((len(devs),), ("data",), devs)

"""Meshes: the cards of one process, and a mesh of processes.

The port's counterpart of the JAX package's ``launch/mesh.py``. A
:class:`Mesh` is an array of ``torch.device``s with axis names, the shape
of a ``jax.sharding.Mesh``: the cards a decode splits its lanes over. A
:class:`ProcessMesh` is a ``("data", "model")`` mesh of processes, one a
rank and a card, joined by ``torch.distributed``: what a model split
across cards runs over (:func:`init_process_mesh`, started once a process
by torchrun or :func:`run_ranks`). Nothing here touches the card when the
module is imported.

A mesh may name one device more than once: each entry is a *block* of
the decode's lanes (``core.mesh_decode``), and blocks on one device run
the same exchange as blocks on distinct cards, with local copies in place
of peer copies. The CPU tests decode over ``Mesh([cpu] * 4)`` where the
JAX package forces four host devices. A device index the machine does not
have raises.

The JAX package's production meshes are here too, as shapes alone
(:func:`make_production_mesh`: no process runs on them): the dry run
(``launch.dryrun``) reckons a rank of each over a process group that
moves nothing. :data:`H100` replaces the JAX package's TPU roofline
constants. The largest mesh that runs here is the cards of one host,
four H100s joined by NVLink, as a :class:`ProcessMesh`.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


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


# ---------------------------------------------------------------------------
# The production meshes, as shapes, and the card's peaks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A ``("data", "model")`` mesh as a shape alone: ``axis_names``,
    ``shape`` and ``size``, which ``dist.plan`` reads from any mesh."""
    data: int
    model: int

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def tag(self) -> str:
        return f"{self.data}x{self.model}"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The JAX package's production mesh as a shape: ``(data=16,
    model=16)``, or for its two pods of ``(pod=2, data=16, model=16)``
    ``(data=32, model=16)``: ``dist.plan.rules_for`` splits the batch over
    ``pod`` and ``data`` alike, so a rank's shapes are the same."""
    return MeshShape(32 if multi_pod else 16, 16)


# Peaks of one NVIDIA H100 SXM5 80GB HBM3 card at its 700 W limit, from
# NVIDIA's datasheet (dense rates, no sparsity), not measured: the
# roofline's rates. ``nvlink_bw`` is NVLink 4's rate a card in each
# direction within a node of ``node_cards``; ``net_bw`` a card's rate
# between nodes (400 Gb/s NDR InfiniBand).
H100 = {
    "peak_flops_bf16": 989e12,   # FLOP/s a card, tensor cores
    "peak_flops_f32": 67e12,     # FLOP/s a card, f32 outside the tensor cores
    "hbm_bw": 3.35e12,           # bytes/s a card
    "hbm_bytes": 80e9,           # capacity a card
    "nvlink_bw": 450e9,          # bytes/s a card, each direction
    "node_cards": 8,
    "net_bw": 50e9,              # bytes/s a card, each direction
}


# ---------------------------------------------------------------------------
# A mesh of processes over torch.distributed
# ---------------------------------------------------------------------------

BACKENDS = ("nccl", "gloo")


def rank_coords(rank: int, model: int) -> Tuple[int, int]:
    """``(data, model)`` coordinates of ``rank``: the ranks of one model
    group are consecutive."""
    return divmod(rank, model)


@dataclasses.dataclass
class ProcessMesh:
    """This process's place in a ``("data", "model")`` mesh of processes.

    ``device`` is the rank's card (or the CPU), ``backend`` the process
    group's (None for a mesh of one), ``model_group`` the ranks that share
    this one's data rank and split the model between them, ``data_group``
    those that share its model rank. ``axis_names`` and ``shape`` are a
    ``jax.sharding.Mesh``'s, so ``dist.plan`` reads it as one.
    """
    data: int
    model: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    model_group: object = None
    data_group: object = None

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> Tuple[int, int]:
        return rank_coords(self.rank, self.model)

    def layout(self, cfg, batch: int, kind: str = "decode"):
        """This rank's ``dist.plan.ShardLayout`` of ``cfg`` for a global
        batch of ``batch``, reducing over the model group (and MoE's
        capacity counted over the data group)."""
        from ..dist.plan import shard_layout
        return shard_layout(cfg, self, self.rank, batch, kind,
                            group=self.model_group,
                            data_group=self.data_group)


def init_process_mesh(data: int, model: int, backend: Optional[str],
                      device="cuda", *, coordinator: Optional[str] = None,
                      rank: Optional[int] = None,
                      timeout_s: int = 120) -> ProcessMesh:
    """Join a ``(data, model)`` mesh of ``data * model`` processes.

    The topology comes from ``launch.multihost.init_distributed`` (the
    arguments, then ``REPRO_*``, then torchrun's ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK``; or the launch this process already
    joined), whose store the process group is built on; every collective
    then fails after ``timeout_s`` rather than hang.
    ``backend`` is the caller's: ``"nccl"`` needs a card a rank (NCCL
    refuses two ranks on one card), ``"gloo"`` runs on the CPU and on
    shared cards. Each rank takes one card, as
    ``launch.multihost.process_cards`` gives them. A mesh of one process
    starts nothing. End with :func:`shutdown_process_mesh`.
    """
    from ..core.api import resolve_device
    from .multihost import (_store, init_distributed, process_cards,
                            process_info)

    world = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh data={data}, model={model}")
    dev = resolve_device(device)
    if world == 1:
        return ProcessMesh(1, 1, 0, dev)
    if backend not in BACKENDS:
        raise ValueError(f"a mesh of {world} processes needs its backend "
                         f"named: one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(f"nccl needs a card for each of the {world} ranks "
                         f"(device {dev}, "
                         f"{torch.cuda.device_count()} cards); use gloo")
    ctx = process_info()
    if not ctx.initialized:
        ctx = init_distributed(coordinator, world, rank,
                               timeout_s=timeout_s)
    if ctx.num_processes != world:
        raise ValueError(f"a mesh of {data} x {model} ranks in a launch of "
                         f"{ctx.num_processes} processes")
    if dev.type == "cuda":
        dev = process_cards(ctx)[0]
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.PrefixStore("repro/pg", _store("a mesh")),
        rank=ctx.process_id, world_size=world,
        timeout=timedelta(seconds=timeout_s))
    d_me, m_me = rank_coords(ctx.process_id, model)
    groups = {}
    # every rank makes every group, in one order
    for d in range(data):
        groups[("model", d)] = dist.new_group(
            [d * model + m for m in range(model)])
    for m in range(model):
        groups[("data", m)] = dist.new_group(
            [d * model + m for d in range(data)])
    return ProcessMesh(data, model, ctx.process_id, dev, backend,
                       groups[("model", d_me)], groups[("data", m_me)])


def shutdown_process_mesh(mesh: ProcessMesh) -> None:
    """Leave the mesh: the process group, then the launch's store
    (``launch.multihost.shutdown_distributed``)."""
    if mesh.size == 1:
        return
    from .multihost import shutdown_distributed
    if dist.is_initialized():
        dist.destroy_process_group()
    shutdown_distributed()


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"data=D,model=M"`` (either may be left out: 1) -> ``(D, M)``."""
    sizes = {"data": 1, "model": 1}
    for part in filter(None, text.split(",")):
        name, _, value = part.partition("=")
        if name.strip() not in sizes or not value.strip().isdigit():
            raise ValueError(f"mesh {text!r}: expected data=D,model=M")
        sizes[name.strip()] = int(value)
    return sizes["data"], sizes["model"]


def run_ranks(argv: Sequence[str], world: int, timeout_s: float,
              env: Optional[dict] = None,
              log_dir: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``python argv...`` as ``world`` ranks on this host, as torchrun
    would: each with ``MASTER_ADDR``/``MASTER_PORT`` (a free port of
    localhost), ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, its output in
    a file of ``log_dir`` (a temporary directory by default). Returns
    ``(returncode, output)`` a rank; past ``timeout_s`` every rank still
    running is killed (returncode -9)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = None if log_dir else tempfile.TemporaryDirectory()
    logs = Path(log_dir or tmp.name)
    logs.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ if env is None else env,
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world))
    procs, files = [], []
    try:
        for r in range(world):
            f = open(logs / f"rank{r}.log", "w")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=f, stderr=subprocess.STDOUT,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    out = [(p.returncode, (logs / f"rank{r}.log").read_text())
           for r, p in enumerate(procs)]
    if tmp is not None:
        tmp.cleanup()
    return out

"""Multi-process decode: a process per card, each fed its own JPEGs.

The port of the JAX package's ``launch/multihost.py``. At scale the
decoder feeds cards driven by many processes, and each process holds only
its slice of the compressed stream. The paper's point — only compressed
bytes + tiny metadata cross links — extends across processes: the plan is
built *where the bytes live*, and the only thing processes exchange is
their tiny :class:`~repro_torch.core.bitstream.PlanShape` (and, after the
decode, their unit counts and statuses). Nothing crosses processes but
strings: no tensor, no collective, no process group.

Protocol:

1. :func:`init_distributed` resolves the topology (arguments, then
   ``REPRO_*``, then torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
   ``WORLD_SIZE``/``RANK``) with *fail-fast validation* — inconsistent
   configuration raises immediately, an unreachable coordinator raises
   after a bounded timeout — and connects to a
   ``torch.distributed.TCPStore`` that process 0 hosts at the coordinator
   address. The store is a key-value exchange, the counterpart of JAX's
   coordination service; NCCL, which refuses two ranks on one card, is
   never involved.
2. A :class:`HostFeed` shards the JPEG corpus across processes in
   contiguous, balanced slices; each process parses and plans only its
   local blobs (:func:`host_plan`; a process left without images takes
   part via :func:`~repro_torch.core.bitstream.empty_batch_plan`).
3. Bucket consensus: processes publish their bucketed PlanShape under
   tagged keys of the store and merge by elementwise max
   (:func:`~repro_torch.core.bitstream.merge_plan_shapes`). Every process
   then pads its local plan data to the merged shape, so all decode in one
   program key: one program allocation per bucket per process.
4. Each process decodes on its own cards (:func:`process_cards`: with at
   least as many cards as processes, cards ``rank, rank + P, ...``, else
   ``cuda:{rank % device_count}``); with ``mesh="local"`` and more than
   one card, over a mesh of them (``ParallelDecoder.decode_on``: the
   process's lanes split over its cards). PyTorch has no host-sharded
   global array: the result is this process's coefficients and, from the
   exchanged unit counts, the global index of its first unit
   (:func:`assemble_global_coeffs`).

Process 0 hosts the store, so it must outlive every other process's last
read: every process calls :func:`shutdown_distributed` before it exits.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import socket
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.api import (DecodeOutput, ParallelDecoder, resolve_use_kernels,
                        sequential_chunk_bits)
from ..core.bitstream import (BatchPlan, BatchValidation, ImageGeometry,
                              PlanShape, bucket_capacity, consensus_plan,
                              merge_plan_shapes, plan_shape, validate_batch)
from ..jpeg.format import parse_jpeg, unstuff_scan
from .mesh import Mesh, make_local_data_mesh

_WIRE_VERSION = 1


# ---------------------------------------------------------------------------
# Distributed context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistContext:
    """One process's view of the launch topology.

    ``initialized`` records whether this process is connected to the
    launch's store (single-process contexts never touch it, so the whole
    module works unmodified in one process with zero configuration).
    """

    process_id: int
    num_processes: int
    coordinator: Optional[str]
    initialized: bool

    @property
    def is_main(self) -> bool:
        return self.process_id == 0


SINGLE_PROCESS = DistContext(process_id=0, num_processes=1,
                             coordinator=None, initialized=False)

# the context init_distributed set up and the store it connected to; one
# launch per process, as jax.distributed has
_ACTIVE: Dict[str, object] = {"ctx": None, "store": None}


def _env_first(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def _env_coordinator() -> Optional[str]:
    coord = _env_first("REPRO_COORDINATOR")
    if coord is None:
        addr, port = _env_first("MASTER_ADDR"), _env_first("MASTER_PORT")
        if addr is not None and port is not None:
            coord = f"{addr}:{port}"
    return coord


def process_info() -> DistContext:
    """The context :func:`init_distributed` set up, or the single-process
    one. Safe to call whether or not it ran."""
    ctx = _ACTIVE["ctx"]
    return ctx if ctx is not None else SINGLE_PROCESS


def _split_address(coordinator: str):
    try:
        host, port_s = coordinator.rsplit(":", 1)
        return host, int(port_s)
    except ValueError:
        raise ValueError(
            f"coordinator address must be 'host:port', got {coordinator!r}")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     *, timeout_s: int = 120) -> DistContext:
    """Connect this process to the launch's store, with validation.

    Resolution order per field: explicit argument, then
    ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``,
    then torchrun's ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``. With nothing configured (or ``num_processes == 1``) this is
    a single-process no-op returning a :data:`SINGLE_PROCESS`-style
    context — the same code path runs on one card and on many.

    Process 0 hosts a ``torch.distributed.TCPStore`` at the coordinator
    address (under torchrun, whose agent already hosts one there, it
    connects to that one instead); the others connect to it.

    Fail-fast guarantees (a distributed launch must never hang silently):

    * inconsistent flags — a multi-process count without a coordinator
      address or process id, a count <= 0, an id out of range — raise
      ``ValueError`` immediately, before any network activity;
    * an unreachable coordinator, or processes that disagree on the
      process count, raise ``RuntimeError`` within ``timeout_s`` seconds
      with the topology in the message.
    """

    def _int(v, name):
        if v is None:
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError(f"{name} must be an integer, got {v!r}")

    if coordinator is None:
        coordinator = _env_coordinator()
    if num_processes is None:
        num_processes = _int(_env_first("REPRO_NUM_PROCESSES", "WORLD_SIZE"),
                             "num_processes")
    if process_id is None:
        process_id = _int(_env_first("REPRO_PROCESS_ID", "RANK"),
                          "process_id")

    if num_processes is None and coordinator is None and process_id is None:
        return SINGLE_PROCESS
    if num_processes is None:
        raise ValueError(
            "init_distributed: a coordinator/process id was configured but "
            "num_processes was not — pass num_processes= or set "
            "REPRO_NUM_PROCESSES in every process")
    num_processes = int(num_processes)
    if num_processes <= 0:
        raise ValueError(
            f"init_distributed: num_processes must be positive, got "
            f"{num_processes}")
    if num_processes == 1:
        return DistContext(0, 1, coordinator, False)
    if coordinator is None:
        raise ValueError(
            f"init_distributed: {num_processes} processes but no "
            f"coordinator address — pass coordinator='host:port' or set "
            f"REPRO_COORDINATOR (refusing to guess: a wrong address would "
            f"hang every process)")
    if process_id is None:
        raise ValueError(
            f"init_distributed: {num_processes} processes but no "
            f"process_id — pass process_id= or set REPRO_PROCESS_ID "
            f"(0..{num_processes - 1}, unique per process)")
    process_id = int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"init_distributed: process_id {process_id} out of range for "
            f"{num_processes} processes (need 0..{num_processes - 1})")
    host, port = _split_address(coordinator)

    have = _ACTIVE["ctx"]
    if have is not None:
        # already initialized: verify the topology rather than reconnect
        if (have.process_id, have.num_processes) != (process_id,
                                                     num_processes):
            raise RuntimeError(
                f"init_distributed already ran as process "
                f"{have.process_id}/{have.num_processes}, which contradicts "
                f"the requested {process_id}/{num_processes}")
        return have

    who = f"process {process_id}/{num_processes}"
    hosting = (process_id == 0
               and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True")
    if not hosting:
        # a plain TCP probe first, retried up to timeout_s (the host may
        # legitimately come up after the others), so a wrong address is
        # reported here with the address in the message
        _wait_for_coordinator(coordinator, timeout_s, who=who)
    try:
        store = torch.distributed.TCPStore(
            host, port, world_size=num_processes, is_master=hosting,
            timeout=timedelta(seconds=timeout_s), wait_for_workers=True)
        # every process checks the count against the one process 0 set
        if process_id == 0:
            store.set("repro/mh/num_processes", str(num_processes))
        store.wait(["repro/mh/num_processes"], timedelta(seconds=timeout_s))
        agreed = int(store.get("repro/mh/num_processes"))
    except RuntimeError as e:
        raise RuntimeError(
            f"init_distributed failed for {who} (coordinator {coordinator}, "
            f"timeout {timeout_s}s): {e}. Check that the coordinator is "
            f"reachable and that EVERY process was launched with the same "
            f"num_processes and a unique process_id.") from e
    if agreed != num_processes:
        raise RuntimeError(
            f"init_distributed: {who} was launched with num_processes="
            f"{num_processes}, but process 0 with {agreed}")
    ctx = DistContext(process_id, num_processes, coordinator, True)
    _ACTIVE.update(ctx=ctx, store=store)
    return ctx


def shutdown_distributed(*, timeout_ms: int = 120_000) -> None:
    """Leave the launch: every process but 0 reports its exit, and
    process 0, which hosts the store, waits for those reports before it
    drops the store, so that no process loses the store mid-read. A no-op
    without :func:`init_distributed`."""
    ctx, store = _ACTIVE["ctx"], _ACTIVE["store"]
    if ctx is None:
        return
    if ctx.is_main:
        _wait_keys(store, [f"repro/mh/exit/{p}"
                           for p in range(1, ctx.num_processes)],
                   timeout_ms, ctx, "shutdown")
    else:
        store.set(f"repro/mh/exit/{ctx.process_id}", "1")
    _ACTIVE.update(ctx=None, store=None)


def _wait_for_coordinator(coordinator: str, timeout_s: int,
                          who: str) -> None:
    """Block until a TCP connect to ``coordinator`` succeeds, or raise."""
    host, port = _split_address(coordinator)
    deadline = time.monotonic() + timeout_s
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            socket.create_connection((host, port), timeout=1.0).close()
            return
        except OSError as e:
            last_err = e
            time.sleep(0.25)
    raise RuntimeError(
        f"{who}: coordinator {coordinator} unreachable after {timeout_s}s "
        f"({last_err}) — check the address/port and that process 0 is up")


# ---------------------------------------------------------------------------
# Tiny-metadata exchange over the store
# ---------------------------------------------------------------------------

_exchange_counter = itertools.count()
# keys are never overwritten, so a *reused* tag (e.g. decode_multihost(...,
# tag="step") every training step) must not collide with — or silently
# read — an earlier round's keys. Each tag carries a per-process use
# counter into the key; processes stay in sync as long as they perform the
# same exchanges in the same order, which is the same ordering contract
# the auto-generated tags rely on.
_tag_rounds: Dict[str, int] = {}


def _key_base(kind: str, tag: str) -> str:
    rnd = _tag_rounds.get(f"{kind}/{tag}", 0)
    _tag_rounds[f"{kind}/{tag}"] = rnd + 1
    return f"repro/mh/{kind}/{tag}#{rnd}"


def _store(what: str):
    store = _ACTIVE["store"]
    if store is None:
        raise RuntimeError(
            f"{what} needs init_distributed to have run when "
            f"num_processes > 1")
    return store


def _wait_keys(store, keys: List[str], timeout_ms: int, ctx: DistContext,
               what: str) -> None:
    for key in keys:
        try:
            store.wait([key], timedelta(milliseconds=timeout_ms))
        except RuntimeError as e:
            peer = key.rsplit("/", 1)[1]
            raise RuntimeError(
                f"{what}: process {ctx.process_id} timed out after "
                f"{timeout_ms}ms waiting for process {peer} of "
                f"{ctx.num_processes} — a peer likely died, hung, or was "
                f"launched with a different num_processes") from e


def exchange(payload: str, ctx: DistContext, tag: Optional[str] = None,
             *, timeout_ms: int = 120_000) -> List[str]:
    """All-to-all of tiny strings through the store.

    Every process publishes ``payload`` under a shared ``tag`` and reads
    every peer's value; returns the list ordered by process id. This is
    the multi-process metadata channel (PlanShapes, unit counts, stats) —
    a few hundred bytes per process.

    ``tag`` defaults to a module-level counter; an explicit tag may be
    reused freely (each use gets a fresh key round). Either way the
    correctness condition is that every process performs the same
    exchanges in the same order. A bounded ``timeout_ms`` turns a missing
    peer — the classic mismatched-process-count deadlock — into a clear
    error. Keys are never deleted (peers may read late); they live as long
    as the store.
    """
    if ctx.num_processes == 1:
        return [payload]
    store = _store("exchange()")
    if tag is None:
        tag = f"auto{next(_exchange_counter)}"
    base = _key_base("x", tag)
    store.set(f"{base}/{ctx.process_id}", payload)
    keys = [f"{base}/{peer}" for peer in range(ctx.num_processes)]
    _wait_keys(store, keys, timeout_ms, ctx, f"exchange({tag!r})")
    return [store.get(k).decode() for k in keys]


def barrier(ctx: DistContext, tag: str, *, timeout_ms: int = 120_000) -> None:
    """Cross-process barrier over the store; no-op single-process."""
    if ctx.num_processes == 1:
        return
    store = _store("barrier()")
    base = _key_base("barrier", tag)
    store.set(f"{base}/{ctx.process_id}", "1")
    _wait_keys(store, [f"{base}/{p}" for p in range(ctx.num_processes)],
               timeout_ms, ctx, f"barrier({tag!r})")


# ---------------------------------------------------------------------------
# PlanShape wire codec (the store carries strings)
# ---------------------------------------------------------------------------

def shape_to_wire(shape: PlanShape) -> str:
    """A shape as one JSON string, byte-identical to the JAX package's."""
    d = dataclasses.asdict(shape)
    d["_v"] = _WIRE_VERSION
    return json.dumps(d, sort_keys=True)


def shape_from_wire(wire: str) -> PlanShape:
    d = json.loads(wire)
    v = d.pop("_v", None)
    if v != _WIRE_VERSION:
        raise ValueError(
            f"PlanShape wire version mismatch: got {v}, expected "
            f"{_WIRE_VERSION} — every process must run the same build")
    g = d.pop("geometry")
    if g is not None:
        g = ImageGeometry(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in g.items()})
    return PlanShape(geometry=g, **d)


# ---------------------------------------------------------------------------
# Per-process JPEG feeding
# ---------------------------------------------------------------------------

class HostFeed:
    """Shards a JPEG corpus across processes; a process keeps only its
    slice.

    The split is contiguous and balanced (the first ``len % n`` processes
    get one extra image), so concatenating per-process outputs in process
    order reproduces the single-process decode of the whole corpus — the
    bit-identity contract of :func:`decode_multihost`. Processes past the
    end of a short corpus hold zero blobs and take part with inert plans.
    """

    def __init__(self, local_blobs: Sequence[bytes], ctx: DistContext):
        self.local_blobs: List[bytes] = list(local_blobs)
        self.ctx = ctx

    @staticmethod
    def bounds(n_items: int, num_processes: int) -> List[int]:
        """Slice boundaries: process h owns [bounds[h], bounds[h+1])."""
        if num_processes <= 0:
            raise ValueError(f"num_processes must be positive, "
                             f"got {num_processes}")
        q, r = divmod(n_items, num_processes)
        sizes = [q + (1 if h < r else 0) for h in range(num_processes)]
        out = [0]
        for s in sizes:
            out.append(out[-1] + s)
        return out

    @classmethod
    def from_corpus(cls, blobs: Sequence[bytes],
                    ctx: DistContext) -> "HostFeed":
        """This process's contiguous slice of a globally-known corpus."""
        b = cls.bounds(len(blobs), ctx.num_processes)
        lo, hi = b[ctx.process_id], b[ctx.process_id + 1]
        return cls(list(blobs[lo:hi]), ctx)

    def __len__(self) -> int:
        return len(self.local_blobs)

    def batches(self, batch_size: int) -> List[List[bytes]]:
        """The local slice in decode-batch-sized groups."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        return [self.local_blobs[i: i + batch_size]
                for i in range(0, len(self.local_blobs), batch_size)]


# ---------------------------------------------------------------------------
# Per-process planning + bucket consensus
# ---------------------------------------------------------------------------

def host_plan(local_blobs: Sequence[bytes], *, chunk_bits: int = 1024,
              seq_chunks: int = 32, balance: str = "none",
              lanes: Optional[int] = None,
              validation: Optional[BatchValidation] = None,
              device="cuda") -> BatchPlan:
    """Plan this process's local blobs (inert-only plan when it has none).

    Thin re-export of :func:`repro_torch.dist.plan.local_batch_plan`; this
    module owns the exchange/consensus protocol around it. ``validation``
    switches to resilient planning (damaged local blobs quarantined, never
    raised).
    """
    from ..dist.plan import local_batch_plan
    return local_batch_plan(local_blobs, chunk_bits=chunk_bits,
                            seq_chunks=seq_chunks, balance=balance,
                            lanes=lanes, validation=validation, device=device)


def plan_consensus(plan: BatchPlan, ctx: DistContext,
                   tag: Optional[str] = None, *, bucket: bool = True,
                   timeout_ms: int = 120_000):
    """One consensus round: publish my shape, merge everyone's, align.

    Returns ``(aligned_plan, merged_shape)``. Single-process this
    degenerates to ``(plan, plan_shape(plan))``.
    """
    shape = plan_shape(plan, bucket=bucket)
    wires = exchange(shape_to_wire(shape), ctx, tag, timeout_ms=timeout_ms)
    merged = merge_plan_shapes([shape_from_wire(w) for w in wires])
    return consensus_plan(plan, merged), merged


# ---------------------------------------------------------------------------
# The multi-process decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GlobalCoeffs:
    """This process's block of the global coefficient batch: rows
    ``[offset, offset + coeffs.shape[0])`` of ``n_units`` rows, the
    processes' coefficients concatenated in process order."""

    coeffs: torch.Tensor
    offset: int
    n_units: int


def assemble_global_coeffs(coeffs: torch.Tensor, unit_counts: List[int],
                           ctx: DistContext) -> GlobalCoeffs:
    """Place this process's coefficients in the global order, from every
    process's exchanged unit count. Nothing moves: PyTorch has no
    host-sharded global array, so each process keeps its own block."""
    mine = unit_counts[ctx.process_id]
    if coeffs.shape[0] != mine:
        raise ValueError(
            f"process {ctx.process_id} has {coeffs.shape[0]} coefficient "
            f"rows but reported {mine} units")
    return GlobalCoeffs(coeffs, sum(unit_counts[:ctx.process_id]),
                        sum(unit_counts))


@dataclasses.dataclass
class MultiHostDecodeOutput:
    """Per-process decode result plus its place in the global batch.

    ``local`` is this process's :class:`DecodeOutput` (coeffs sliced to
    its real unit count). ``unit_counts`` is every process's real unit
    count (exchanged as tiny ints) and ``global_coeffs`` this process's
    block of the global batch. ``compiles`` counts this process's
    allocations of the decode's bucket program (the counterpart of the JAX
    package's traces: one per bucket per process, however many decodes;
    over a local mesh, the decodes that allocated its blocks' buffers).
    ``exchange_ms`` is the wall time this process spent in the exchanges
    (waiting for the slowest peer included).
    """

    local: DecodeOutput
    shape: PlanShape
    process_id: int
    num_processes: int
    unit_counts: List[int]
    global_coeffs: GlobalCoeffs
    compiles: int = 0
    exchange_ms: float = 0.0
    # resilient decodes (validate=True): this process's per-image STATUS_*
    # array, and every process's status list in process order (tiny ints
    # over the store — damage is reportable launch-wide without moving
    # pixels)
    status: Optional[np.ndarray] = None
    host_statuses: Optional[List[List[int]]] = None


def process_cards(ctx: DistContext) -> List[torch.device]:
    """The cards this process owns: with at least as many cards as
    processes, every ``num_processes``-th card from its own id; else the
    one it shares, ``cuda:{process_id % device_count}``."""
    n = torch.cuda.device_count()
    if n >= ctx.num_processes:
        return [torch.device("cuda", c)
                for c in range(ctx.process_id, n, ctx.num_processes)]
    return [torch.device("cuda", ctx.process_id % n)]


def _process_device(device, ctx: DistContext) -> torch.device:
    """``cuda`` without an index becomes this process's first card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        dev = process_cards(ctx)[0]
    return dev


def local_mesh(ctx: DistContext, device: torch.device) -> Optional[Mesh]:
    """The mesh a process decodes over with ``mesh="local"``: its cards
    (:func:`process_cards`); None for a mesh of one or on the CPU."""
    if device.type == "cpu":
        return None
    devs = process_cards(ctx)
    return make_local_data_mesh(devs) if len(devs) > 1 else None


def decode_multihost(local_blobs: Sequence[bytes],
                     ctx: Optional[DistContext] = None, *,
                     chunk_bits: int = 1024, seq_chunks: int = 32,
                     sync: str = "jacobi", backend: Optional[str] = None,
                     fuse: Optional[str] = None, balance: str = "none",
                     lanes: Optional[int] = None, emit: str = "coeffs",
                     device="cuda", tag: Optional[str] = None,
                     validate: bool = False,
                     timeout_ms: int = 120_000,
                     use_kernels: bool = False,
                     mesh: Union[str, Mesh] = "local"
                     ) -> MultiHostDecodeOutput:
    """Decode one global batch whose bytes are spread across processes.

    Every process calls this with its *local* blobs (see
    :class:`HostFeed`); the result is bit-identical to a single-process
    ``decode_batch`` of the processes' corpora concatenated in process
    order. ``sync="sequential"`` adds one round settling the
    data-dependent chunk size (elementwise max of the processes'
    ladder-rounded candidates) so the framing constant agrees before
    shapes are exchanged.

    ``device="cuda"`` decodes on this process's cards
    (:func:`process_cards`; several processes may share a card);
    ``"cpu"`` runs the plain versions. ``mesh="local"`` splits the
    process's lanes over its cards when it has more than one (``balance``
    then balances over as many lane blocks), ``mesh="none"`` decodes on
    its first card, and a :class:`~repro_torch.launch.mesh.Mesh` over
    that mesh's devices (``Mesh([torch.device("cpu")] * 2)`` runs two
    blocks on the CPU); the local result is gathered to the first. The
    deprecated ``use_kernels=True`` warns and means ``backend="cuda"``.

    ``validate=True`` (must agree across processes — it changes the
    exchange schedule) classifies each local blob before planning: a
    damaged blob is quarantined or partially recovered locally and NEVER
    raises. This matters in a collective decode — one process dying on a
    corrupt feed would strand every peer at the consensus exchange until
    timeout. Per-image statuses ride the result (``status``,
    ``host_statuses``).
    """
    backend = resolve_use_kernels(backend, use_kernels)
    if not isinstance(mesh, Mesh) and mesh not in ("local", "none"):
        raise ValueError(f"mesh must be 'local', 'none' or a Mesh, got "
                         f"{mesh!r}")
    if ctx is None:
        ctx = process_info()
    if tag is None:
        tag = f"decode{next(_exchange_counter)}"
    dev = _process_device(device, ctx)
    on = mesh if isinstance(mesh, Mesh) else None
    if mesh == "local" and torch.device(device).index is None:
        on = local_mesh(ctx, dev)
    if on is not None and lanes is None:
        lanes = on.size
    exchange_s = 0.0

    def timed_exchange(payload: str, name: str) -> List[str]:
        nonlocal exchange_s
        t0 = time.perf_counter()
        out = exchange(payload, ctx, f"{tag}/{name}", timeout_ms=timeout_ms)
        exchange_s += time.perf_counter() - t0
        return out

    validation: Optional[BatchValidation] = None
    if validate:
        validation = validate_batch(local_blobs)

    if sync == "sequential":
        # settle the data-dependent framing constant first: every process
        # proposes the ladder-rounded chunk size its local segments need,
        # the consensus is the max — identical to what a single process
        # holding the whole corpus would compute
        if validation is not None:
            # size from the surviving scans only; a raw parse here would
            # re-raise on exactly the damaged blobs validation absorbed
            live = [(r.clean, r.rst_bits) for r in validation.reports
                    if r.clean is not None]
            mine = (sequential_chunk_bits(live, bucket=True) if live
                    else -(-bucket_capacity(32) // 32) * 32)
        elif local_blobs:
            unstuffed = [unstuff_scan(parse_jpeg(b).scan_data)
                         for b in local_blobs]
            mine = sequential_chunk_bits(unstuffed, bucket=True)
        else:
            mine = -(-bucket_capacity(32) // 32) * 32
        chunk_bits = max(int(v) for v in timed_exchange(str(mine),
                                                        "chunkbits"))

    plan = host_plan(local_blobs, chunk_bits=chunk_bits,
                     seq_chunks=seq_chunks, balance=balance, lanes=lanes,
                     validation=validation, device=dev)
    t0 = time.perf_counter()
    plan, merged = plan_consensus(plan, ctx, f"{tag}/shape",
                                  timeout_ms=timeout_ms)
    exchange_s += time.perf_counter() - t0

    dec = ParallelDecoder(plan, sync=sync, backend=backend, fuse=fuse,
                          device=dev, shape=merged, validation=validation)
    if on is not None:
        out = dec.decode_on(on, emit=emit)
        out = dataclasses.replace(
            out, coeffs=out.coeffs.full(dev),
            rgb=None if out.rgb is None else out.rgb.full(dev),
            planes=None if out.planes is None else
            [p.full(dev) for p in out.planes])
    else:
        out = dec.decode(emit=emit)

    unit_counts = [int(c) for c in timed_exchange(str(plan.total_units),
                                                  "units")]
    status = None
    host_statuses = None
    if validation is not None:
        status = validation.status
        wires = timed_exchange(json.dumps([int(s) for s in status]),
                               "status")
        host_statuses = [json.loads(w) for w in wires]

    return MultiHostDecodeOutput(
        local=out, shape=merged, process_id=ctx.process_id,
        num_processes=ctx.num_processes, unit_counts=unit_counts,
        global_coeffs=assemble_global_coeffs(out.coeffs, unit_counts, ctx),
        compiles=(dec.program.allocations if on is None else
                  out.mesh["allocating_decodes"]),
        exchange_ms=exchange_s * 1e3, status=status,
        host_statuses=host_statuses)


# ---------------------------------------------------------------------------
# Per-process decode-stats aggregation
# ---------------------------------------------------------------------------

def gather_decode_stats(stats: Dict, ctx: Optional[DistContext] = None,
                        tag: Optional[str] = None, *,
                        timeout_ms: int = 120_000) -> List[Dict]:
    """Every process's ``decode_stats()`` dict, ordered by process id.

    Allocation counters are per process by construction (each process
    allocates its own programs); summing them would misreport the
    one-allocation-per-bucket invariant, so this returns the per-process
    dicts and leaves the assertion to the caller.
    """
    if ctx is None:
        ctx = process_info()
    wires = exchange(json.dumps(stats), ctx,
                     tag or f"stats{next(_exchange_counter)}",
                     timeout_ms=timeout_ms)
    return [json.loads(w) for w in wires]

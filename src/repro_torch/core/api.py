"""Public API: batched JPEG decoding on the card.

Usage:
    out = decode_batch(list_of_jpeg_blobs)          # DecodeOutput, on "cuda"
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=1024)
    out = dec.decode(emit="rgb")

The port of the JAX package's ``core/api.py``: host parse and plan
(numpy), then on the device the sync (a speculative decode of every
chunk, then rounds to the fixed point), the segmented prefix sum for the
write bases, the write pass, DC undiff and the pixel stage.

``device`` defaults to ``"cuda"``: without a card the call raises, and the
decoder runs on the CPU only when the caller passes ``device="cpu"``.
``backend`` is ``"cuda"`` (the hand-written kernels) or ``"torch"`` (their
plain versions); it defaults to ``"cuda"`` on a CUDA device and to
``"torch"`` on the CPU, and ``"cuda"`` on the CPU raises. The deprecated
``use_kernels=True`` warns and means ``backend="cuda"``; with another
backend it raises.

``sync`` picks the schedule (``core/sync.py``): ``"jacobi"`` (default),
``"faithful"`` (the paper's Algorithm 3), ``"specmap"`` (phase-map
composition) or ``"sequential"`` (one chunk per entropy segment, sized by
:func:`sequential_chunk_bits`, so the cold decode is exact: the
per-image baseline). All four give bit-identical coefficients.

``fuse`` (kernels only; the argument, else ``REPRO_PALLAS_FUSE``, else
``"post"``; the plain backend ignores the variable): ``"post"`` runs the write
pass as the stream kernel plus a scatter and the pixel stage as the fused
pixel kernel; ``"full"`` runs the write pass as the store kernel instead;
``"none"`` runs the stream write pass and the unfused pixel chain: the
IDCT kernel, plane assembly (torch indexing) and the color kernel. A
grayscale batch runs the IDCT kernel, plane assembly and a crop under
every mode. The plain backend runs the unfused chain (``fuse="none"``).
``DecodeOutput`` says which of the kernels ran.

``emit``: ``"rgb"`` (default), ``"coeffs"`` (the entropy stage only) or
``"planes"`` (the pixel stage with ``rgb=None``; ``planes`` is None where
the fused pixel kernel ran, as in the JAX package). Any other string
raises ``ValueError``.

Compile-once buckets: the device side of a decode is a
:class:`DecodeProgram`, one per (bucketed :class:`PlanShape`, sync,
backend, fuse, device, launch config) in a module-level cache
(:func:`decode_program`). The launch config
(:class:`~repro_torch.kernels.autotune.LaunchConfig`: the kernels' launch
sizes and the sync loops' rounds between host checks) is resolved per
bucket by :func:`~repro_torch.kernels.autotune.resolve_launch` (the
``REPRO_TORCH_LAUNCH`` override, the tuned table, a measured search under
``REPRO_TORCH_AUTOTUNE=1``, else the defaults) or pinned with
``launch=``; a program's CUDA graphs are its own config's.
A program holds the capacity-sized device buffers of its key: the plan
arrays, which each decode fills from its decoder's pinned host copy (and
skips when they already hold that decoder's data), and the decode's
intermediates (exit states, write bases, the write pass's streams or
store target). A stream of batches that land in one bucket allocates once
(:func:`decode_program_stats`); :func:`clear_decode_programs` frees the
memory. What a decode returns never aliases these buffers.

Across the cards of one process: :meth:`ParallelDecoder.decode_on` (and
``decode_batch(mesh=)``) splits the batch's lanes over a
``launch.mesh.Mesh`` (``core/mesh_decode.py``), bit-identical to
``decode()``, in a :class:`MeshProgram` of the same cache keyed by the
mesh as well.

Resilient decode (``validate=True``): damaged blobs never raise. Each
blob is classified (:func:`~repro_torch.core.bitstream.validate_batch`);
rejected images become inert quarantine lanes and recovered ones decode
their intact restart segments, so the rest of the batch decodes
bit-identically to a clean batch. ``DecodeOutput.status`` carries the
per-image status; a quarantined batch borrows a cached bucket that covers
it, so quarantine adds no program.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import decode as D
from .bitstream import (MAX_UPM, STATUS_OK, BatchPlan, BatchValidation,
                        PlanShape, bucket_capacity, build_batch_plan,
                        build_plan_data, consensus_plan, derived_arrays,
                        plan_shape, validate_batch)
from . import mesh_decode as MD
from .mesh_decode import BlockProgram, Sharded
from .state import DecodeState
from .sync import (RoundBlocks, SyncResult, chain_entries, faithful_sync,
                   jacobi_sync, specmap_sync, sync_limits)
from ..dist import plan as DP
from ..dist import sharding as SH
from ..launch.mesh import Mesh
from ..jpeg.format import parse_jpeg, segment_byte_bounds, unstuff_scan
from ..kernels.color.ops import upsample_color, upsample_color_plain
from ..kernels.fused.ops import (decode_pixels_fused, fuse_traffic,
                                 pixels_fusible)
from ..kernels.fused.pixels import fused_pixels
from ..kernels.fused.store import (decode_coeffs_store, write_coefficients,
                                  writes_streams)
from ..kernels.huffman import ops as HK
from ..kernels.idct.ops import idct_units, idct_units_plain
from ..kernels.autotune import (DEFAULT_LAUNCH, LaunchConfig,
                                autotune_enabled, resolve_launch)

BACKENDS = ("cuda", "torch")
FUSE_MODES = ("none", "post", "full")
FUSE_ENV = "REPRO_PALLAS_FUSE"
SYNCS = ("jacobi", "faithful", "specmap", "sequential")
EMITS = ("rgb", "coeffs", "planes")


@dataclasses.dataclass
class DecodeOutput:
    coeffs: torch.Tensor                  # (U_total, 64) zig-zag, absolute DC
    planes: Optional[List[torch.Tensor]]  # per component (B, Hc, Wc) float32
    rgb: Optional[torch.Tensor]           # (B, H, W, 3) or (B, H, W) uint8
    sync_rounds: int
    converged: bool
    plan: BatchPlan
    # which kernels ran: the store kernel for the write pass (fuse="full"),
    # and for the pixel stage either the fused pixel kernel or the IDCT
    # kernel followed by the color kernel (three planes)
    store_fused: bool = False
    pixels_fused: bool = False
    idct_kernel: bool = False
    color_kernel: bool = False
    # per-image STATUS_OK/RECOVERED/REJECTED (validated decodes only; the
    # per-segment / per-unit validity masks ride on plan.seg_valid /
    # plan.unit_valid)
    status: Optional[np.ndarray] = None   # (B,) int32
    validation: Optional[BatchValidation] = None
    # decode_on: coeffs, rgb and each plane are core.mesh_decode.Sharded
    # pieces on the mesh's cards; ``mesh`` has the blocks' lanes, rows,
    # launches by kernel, graph replays, host checks, exchange bytes, the
    # host's ms by phase ("host_ms") and the sync's exit states ("exits":
    # Sharded (lanes, 4) p, u, z, n)
    mesh: Optional[Dict] = None


def check_sync(sync: str) -> str:
    if sync not in SYNCS:
        raise ValueError(f"unknown sync {sync!r}; expected one of {SYNCS}")
    return sync


def sequential_chunk_bits(unstuffed, bucket: bool = True) -> int:
    """Chunk size that makes every entropy *segment* a single chunk.

    Sized from the unstuffed scans' longest segment (restart intervals
    split a scan into many short segments), not from whole-file bytes, so
    ``s_max`` stays as small as the batch allows. ``unstuffed`` is a list
    of ``unstuff_scan`` results, shared with the plan builder so each scan
    is unstuffed once. With ``bucket`` the size is rounded up the capacity
    ladder before word alignment, as the JAX package does.
    """
    worst = 32
    for clean, rst_bits in unstuffed:
        bounds = segment_byte_bounds(clean, rst_bits)
        longest = max(b - a for a, b in zip(bounds, bounds[1:]))
        worst = max(worst, longest * 8)
    if bucket:
        worst = bucket_capacity(worst)
    return -(-worst // 32) * 32


def resolve_options(sync: str, backend: Optional[str], fuse: Optional[str],
                    device) -> Tuple[torch.device, str, str]:
    """Validate the knobs and resolve their defaults: (device, backend, fuse).

    Unknown or conflicting knobs are refused before the device is looked
    at.
    """
    check_sync(sync)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; expected one of {BACKENDS}")
    if fuse is not None:
        check_fuse(fuse)
    if backend is not None:
        resolve_fuse(fuse, backend)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    return dev, backend, resolve_fuse(fuse, backend)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the decoder runs on the card, "
                "or on the CPU only when the caller passes device='cpu'")
        if dev.index is None:  # one cache key per card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' runs the kernels and needs a CUDA "
                         "device; on the CPU use backend='torch'")
    return backend


def resolve_use_kernels(backend: Optional[str], use_kernels: bool
                        ) -> Optional[str]:
    """The backend the deprecated ``use_kernels=True`` asks for: it warns
    and means ``"cuda"``, however the other defaults fall; with another
    backend it raises rather than drop the kernels."""
    if not use_kernels:
        return backend
    warnings.warn("use_kernels= is deprecated; pass backend=\"cuda\" (and "
                  "optionally fuse=\"none\"|\"post\"|\"full\") instead",
                  DeprecationWarning, stacklevel=3)
    if backend not in (None, "cuda"):
        raise ValueError(f"conflicting backend selection: use_kernels=True "
                         f"with backend={backend!r} would silently drop the "
                         f"kernels; pass one or the other")
    return "cuda"


def check_fuse(fuse: str) -> str:
    if fuse not in FUSE_MODES:
        raise ValueError(f"unknown fuse mode {fuse!r}; expected one of "
                         f"{FUSE_MODES}")
    return fuse


def resolve_fuse(fuse: Optional[str], backend: str) -> str:
    """The fuse mode: the argument, else ``REPRO_PALLAS_FUSE``, else
    ``"post"`` on the kernels. The plain backend runs the unfused chain
    and ignores the variable."""
    if backend == "torch":
        if fuse not in (None, "none"):
            raise ValueError(f"fuse={fuse!r} requires backend='cuda'; the "
                             f"plain backend runs the unfused chain")
        return "none"
    if fuse is None:
        fuse = os.environ.get(FUSE_ENV) or "post"
    return check_fuse(fuse)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name."""
    return {"huffman_exits": HK.decode_exits.launches,
            "huffman_exits_idx": HK.decode_exits.subset_launches,
            "huffman_streams": HK.decode_streams.launches,
            "huffman_store": decode_coeffs_store.launches,
            "fused_pixels": fused_pixels.launches,
            "idct": idct_units.launches,
            "color": upsample_color.launches}


# ---------------------------------------------------------------------------
# Compact tables, made once per distinct LUT set
# ---------------------------------------------------------------------------

# (digest, shape, device) -> (luts_compact on the device, row starts)
_LUT_TABLES: Dict[Tuple, Tuple[torch.Tensor, np.ndarray]] = \
    collections.OrderedDict()
_LUT_TABLES_LIMIT = 16


def lut_tables(luts: np.ndarray, device: torch.device
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """The kernels' compact tables of a (padded) LUT set: ``luts_compact``
    on ``device`` and each row's start (host int32), from a cache keyed on
    the LUTs' bytes (the 16 sets used last)."""
    key = (hashlib.blake2b(luts.tobytes(), digest_size=16).digest(),
           luts.shape, str(device))
    with _PROGRAMS_LOCK:
        hit = _LUT_TABLES.get(key)
        if hit is not None:
            _LUT_TABLES.move_to_end(key)
            return hit
    tab, start = HK.compact_luts(torch.from_numpy(luts))
    tab = tab.to(device)
    if device.type == "cuda":
        # the copy must land before another thread's stream reads it
        torch.cuda.current_stream(device).synchronize()
    entry = (tab, start.numpy())
    with _PROGRAMS_LOCK:
        _LUT_TABLES[key] = entry
        while len(_LUT_TABLES) > _LUT_TABLES_LIMIT:
            _LUT_TABLES.popitem(last=False)
    return entry


# ---------------------------------------------------------------------------
# The program cache: one DecodeProgram per (PlanShape, sync, backend, fuse)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DecodeProgram:
    """The device side of one bucket, shared by every decoder whose batch
    lands in it.

    ``plan`` holds the plan arrays at the shape's capacities, ``work`` the
    decode's intermediates: the lanes' metadata, two exit states the
    full-lane rounds write in turn, the verify loop's flags, the write
    bases, and the write pass's (s_max, C) streams and scatter target or
    its store target. Both are allocated at the first decode
    (``allocations``). ``owner`` is the decoder whose plan data ``plan``
    holds; ``hints`` the sync loops' iteration counts of the last decode
    and ``graphs`` the CUDA graphs of their rounds
    (``core.sync.RoundBlocks``), which read these buffers; ``audit``, None
    but in the traced-program checker (``analysis/trace_check.py``), is
    told of their captures and replays. ``lock`` serializes the decodes of
    the key: a decode uploads its plan data and reads the buffers under
    it. ``host_checks`` and ``launches`` are the last decode's.
    """

    shape: PlanShape
    sync: str
    backend: str
    fuse: str
    device: torch.device
    launch: LaunchConfig = DEFAULT_LAUNCH
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False)
    plan: Optional[Dict[str, torch.Tensor]] = None
    work: Dict[str, object] = dataclasses.field(default_factory=dict)
    owner: object = None
    stream: object = None        # the CUDA stream of the last decode
    hints: Dict[str, int] = dataclasses.field(default_factory=dict)
    graphs: Dict[Tuple, object] = dataclasses.field(default_factory=dict)
    audit: object = None
    allocations: int = 0
    uploads: int = 0
    decodes: int = 0
    host_checks: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tensors(self) -> List[torch.Tensor]:
        out, todo = [], [*(self.plan or {}).values(), *self.work.values()]
        while todo:
            t = todo.pop()
            if isinstance(t, torch.Tensor):
                out.append(t)
            else:  # a dict or tuple of tensors, or a tuple of DecodeStates
                todo.extend(t.values() if isinstance(t, dict) else t)
        return out

    def nbytes(self) -> int:
        """Device bytes the program's buffers hold."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def allocate(self, host: Dict[str, torch.Tensor]) -> None:
        """The buffers of this key, shaped like ``host`` (a decoder's plan
        arrays) and by the shape."""
        sh, dev = self.shape, self.device
        self.plan = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                     for k, v in host.items()}
        c, n_coef = sh.n_chunks, sh.n_units * 64

        def ints(*size):
            return torch.empty(size, dtype=torch.int32, device=dev)

        self.work = {"meta": {k: ints(c) for k in ("word_base", "ts", "upm")},
                     "exits": tuple(DecodeState(*(ints(c) for _ in range(4)))
                                    for _ in range(2)),
                     "flags": (torch.zeros((), dtype=torch.bool, device=dev),
                               torch.zeros((), dtype=torch.int32,
                                           device=dev)),
                     "bases": ints(c)}
        if writes_streams(self.backend == "cuda", self.fuse):
            self.work["streams"] = (ints(sh.s_max, c), ints(sh.s_max, c))
            self.work["scatter"] = ints(n_coef + c)
        else:
            self.work["store"] = ints(n_coef)
        self.allocations += 1

    def follow(self) -> None:
        """Order this decode after the last one when the current CUDA
        stream differs from the last decode's (the decode service runs on
        a stream of its own)."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        if self.stream is not None and self.stream != cur:
            cur.wait_stream(self.stream)
            for t in self.tensors():
                t.record_stream(cur)
        self.stream = cur


_PROGRAMS: Dict[Tuple, DecodeProgram] = {}
# guards _PROGRAMS and _LUT_TABLES: two threads first-touching one key get
# one program
_PROGRAMS_LOCK = threading.Lock()


def decode_program(shape: PlanShape, sync: str = "jacobi",
                   backend: Optional[str] = None, fuse: Optional[str] = None,
                   device="cuda",
                   launch: LaunchConfig = DEFAULT_LAUNCH) -> DecodeProgram:
    """The shared program of a (shape, sync, backend, fuse, device, launch)
    key."""
    dev, backend, fuse = resolve_options(sync, backend, fuse, device)
    key = (shape, sync, backend, fuse, dev, launch)
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = DecodeProgram(shape, sync, backend, fuse,
                                                  dev, launch)
    return prog


@dataclasses.dataclass(eq=False)
class MeshProgram(DecodeProgram):
    """The device side of one bucket decoded over a mesh
    (:meth:`ParallelDecoder.decode_on`): a
    :class:`~repro_torch.core.mesh_decode.BlockProgram` a mesh entry, each
    holding the plan's arrays (words and compact tables included) on its
    card, its block's buffers and the CUDA graphs of its rounds. ``device``
    is the mesh; ``hints`` are shared by the blocks; ``peer_access``
    says which ordered pairs of its cards have peer access; ``keep_graphs``
    (the traced-program checker's) keeps the graphs readable; ``last`` is
    the last decode's per-block account (``DecodeOutput.mesh``)."""

    blocks: List[BlockProgram] = dataclasses.field(default_factory=list)
    grown: int = 0               # decodes that allocated a buffer
    peer_access: Dict[str, bool] = dataclasses.field(default_factory=dict)
    keep_graphs: bool = False
    last: Dict = dataclasses.field(default_factory=dict)

    def tensors(self) -> List[torch.Tensor]:
        return [t for b in self.blocks for t in b.tensors()]


def mesh_program(shape: PlanShape, sync: str, backend: str, fuse: str,
                 mesh: Mesh, launch: LaunchConfig = DEFAULT_LAUNCH
                 ) -> MeshProgram:
    """The shared program of a (shape, sync, backend, fuse, mesh, launch)
    key; ``mesh`` is 1-D."""
    key = (shape, sync, backend, fuse, ("mesh",) + mesh.key(), launch)
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = MeshProgram(
                shape, sync, backend, fuse, mesh, launch,
                blocks=[BlockProgram(d) for d in mesh.devices.flat],
                peer_access=MD.peer_access(mesh))
    return prog


def decode_programs() -> List[DecodeProgram]:
    with _PROGRAMS_LOCK:
        return list(_PROGRAMS.values())


def discard_decode_programs(drop) -> int:
    """Drop the cached programs for which ``drop(program)`` is true (an
    autotuner's losing candidates); returns how many."""
    with _PROGRAMS_LOCK:
        keys = [k for k, p in _PROGRAMS.items() if drop(p)]
        for k in keys:
            del _PROGRAMS[k]
    return len(keys)


def clear_decode_programs() -> None:
    """Drop every cached program and compact table set, and return the
    card's freed memory (decoders still alive keep their own program)."""
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()
        _LUT_TABLES.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def decode_program_stats() -> Dict:
    """The cache's counters: programs, allocations, device bytes held, and
    a row per bucket."""
    progs = decode_programs()
    return {
        "programs": len(progs),
        "allocations": sum(p.allocations for p in progs),
        "device_bytes": sum(p.nbytes() for p in progs),
        "decodes": sum(p.decodes for p in progs),
        "uploads": sum(p.uploads for p in progs),
        "buckets": [
            {"bucket": p.shape.label(), "sync": p.sync,
             "backend": p.backend, "fuse": p.fuse, "device": str(p.device),
             "launch": dataclasses.asdict(p.launch),
             "allocations": p.allocations, "decodes": p.decodes,
             "uploads": p.uploads, "device_bytes": p.nbytes(),
             "host_checks": p.host_checks}
            for p in progs
        ],
    }


def _shape_covers(shape: PlanShape, plan: BatchPlan) -> bool:
    """Whether ``plan`` can decode under ``shape`` bit-exactly: every
    constant of the decode matches (or relaxes soundly, the
    ``consensus_plan`` argument), and every actual count fits the
    capacity."""
    if (shape.chunk_bits != plan.chunk_bits
            or shape.seq_chunks != plan.seq_chunks
            or shape.n_lanes != plan.n_lanes
            or shape.permuted != (plan.balance != "none")
            or shape.n_images != plan.n_images
            or shape.uniform != plan.uniform
            or shape.geometry != plan.geometry):
        return False
    if shape.s_max < plan.s_max or shape.min_code_bits > plan.min_code_bits:
        return False
    counts = dict(n_words=len(plan.words), n_luts=plan.luts.shape[0],
                  n_tablesets=plan.ts_upm.shape[0],
                  n_matrices=plan.m_matrices.shape[0],
                  n_segments=plan.n_segments, n_chunks=plan.n_chunks,
                  n_sequences=plan.n_sequences, n_units=plan.total_units)
    return all(v <= getattr(shape, k) for k, v in counts.items())


def _quarantine_shape(plan: BatchPlan, own: PlanShape, sync: str,
                      backend: str, fuse: str,
                      device: torch.device) -> PlanShape:
    """Shape selection for a batch with quarantined images.

    Quarantine removes the damaged images' bits, so the batch's own ladder
    rung can drop below the bucket its clean siblings decode in, and would
    add a program for what is the same traffic. Prefer the smallest cached
    shape of the same (sync, backend, fuse, device) that covers the plan;
    ``own`` when none does.
    """
    best = None
    with _PROGRAMS_LOCK:
        keys = list(_PROGRAMS)
    for (shape, s, b, f, d, _) in keys:
        if (s, b, f, d) != (sync, backend, fuse, device):
            continue
        if _shape_covers(shape, plan) and (
                best is None or shape.n_words < best.n_words):
            best = shape
    return best if best is not None else own


def _host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # torch cannot shift uint32: the same bits
        a = a.view(np.int32)
    if not a.flags.c_contiguous:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.pin_memory() if pin else t


class ParallelDecoder:
    """A decoder for one batch: its (optionally bucketed) plan, the shared
    :class:`DecodeProgram` of its bucket, and the backend and fuse mode
    that run it.

    The plan data waits in host memory (pinned on a card) until a decode
    copies it into the program's buffers; :meth:`prefetch` copies it to
    the card ahead of time, on a stream of the caller's. ``shape=`` pins
    the bucket (the decode service pins an admitted one); ``bucket=False``
    the exact-fit shape. ``launch=`` pins the launch config; without it
    the bucket's is resolved (module docstring), by a measured search of
    this batch's decodes under ``REPRO_TORCH_AUTOTUNE=1`` on the card.
    """

    def __init__(self, plan: BatchPlan, sync: str = "jacobi",
                 backend: Optional[str] = None, bucket: bool = True,
                 fuse: Optional[str] = None, device="cuda",
                 shape: Optional[PlanShape] = None,
                 validation: Optional[BatchValidation] = None,
                 launch: Optional[LaunchConfig] = None):
        self.device, self.backend, self.fuse = resolve_options(
            sync, backend, fuse, device)
        self.sync = sync
        self.validation = validation
        if shape is None:
            shape = plan_shape(plan, bucket=bucket)
            if (bucket and plan.image_status is not None
                    and (plan.image_status != STATUS_OK).any()):
                # quarantined batches borrow a cached bucket that covers
                # them, so quarantine never adds a program
                shape = _quarantine_shape(plan, shape, sync, self.backend,
                                          self.fuse, self.device)
        if (shape.s_max, shape.min_code_bits, shape.n_images) != \
                (plan.s_max, plan.min_code_bits, plan.n_images):
            plan = consensus_plan(plan, shape)
        self.plan, self.shape = plan, shape
        if launch is None:
            tune = (autotune_enabled() and self.backend == "cuda"
                    and self.device.type == "cuda")
            launch = resolve_launch(shape, self.backend, self.fuse,
                                    measure=self._measure_fn() if tune
                                    else None)
            if tune:  # the losing candidates' programs hold their buffers
                discard_decode_programs(
                    lambda p: (p.shape, p.sync, p.backend, p.fuse,
                               p.device) == (shape, sync, self.backend,
                                             self.fuse, self.device)
                    and p.launch != launch)
        self.launch = launch
        self.data = build_plan_data(plan, shape)
        self._layouts: Dict[int, Tuple] = {}    # mesh size -> layout
        self._on_device: Dict[torch.device, "ParallelDecoder"] = {}
        self._card_tables: Dict[torch.device, torch.Tensor] = {}
        self.program = decode_program(shape, sync, self.backend, self.fuse,
                                      self.device, launch)
        arrays = dict(self.data.arrays, words=self.data.words)
        arrays.update(derived_arrays(arrays))
        self._luts_compact = None
        if self.backend == "cuda":
            self._luts_compact, start = lut_tables(arrays["luts"],
                                                   self.device)
            arrays["unit_lut_off"] = start[arrays["unit_lut_row"]]
        if plan.uniform:
            for ci in range(len(plan.comp_unit_idx)):
                arrays[f"comp_unit_idx{ci}"] = \
                    plan.comp_unit_idx[ci].astype(np.int64)
                arrays[f"comp_block_idx{ci}"] = \
                    plan.comp_block_idx[ci].astype(np.int64)
        self._arrays = arrays
        pin = self.device.type == "cuda"
        self._host = {k: _host_tensor(a, pin) for k, a in arrays.items()}
        self._staged = None     # (device copies, event) from prefetch()
        self._token = object()  # what the program's `owner` is set to
        self._launches: Dict[str, int] = {}
        self._host_checks = self._replays = 0

    def _measure_fn(self):
        """The autotuner's ``measure``: the seconds of one warm decode of
        this batch under a config (each config's decoder made once and
        decoded twice first, the second capturing its CUDA graphs)."""
        decoders: Dict[LaunchConfig, ParallelDecoder] = {}

        def measure(cfg: LaunchConfig) -> float:
            dec = decoders.get(cfg)
            if dec is None:
                dec = decoders[cfg] = ParallelDecoder(
                    self.plan, sync=self.sync, backend=self.backend,
                    fuse=self.fuse, device=self.device, shape=self.shape,
                    launch=cfg)
                for _ in range(2):
                    dec.decode()
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            dec.decode()
            torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

        return measure

    @classmethod
    def from_bytes(cls, blobs: Sequence[bytes], chunk_bits: int = 1024,
                   seq_chunks: int = 32, sync: str = "jacobi",
                   backend: Optional[str] = None, bucket: bool = True,
                   fuse: Optional[str] = None, device="cuda",
                   validate: bool = False, balance: str = "none",
                   lanes: Optional[int] = None,
                   launch: Optional[LaunchConfig] = None,
                   use_kernels: bool = False
                   ) -> "ParallelDecoder":
        """Parse and plan one batch (``validate``: never raising on a
        damaged blob, see the module docstring).

        ``balance`` selects the plan-time lane partitioner
        (:func:`repro_torch.dist.plan.balance_lanes`): ``"roundrobin"`` or
        ``"lpt"`` lays whole sequences of chunks out in ``lanes`` lane
        blocks (default: the card count on a CUDA device, 1 on the CPU,
        where balancing is then the identity). Bit-identical to ``"none"``
        on every schedule and backend; a balanced plan has a shape, and so
        a program and CUDA graphs, of its own.
        """
        DP.check_balance(balance)
        backend = resolve_use_kernels(backend, use_kernels)
        dev, _, _ = resolve_options(sync, backend, fuse, device)
        validation = None
        if validate:
            validation = validate_batch(blobs)
            if sync == "sequential":
                live = [(r.clean, r.rst_bits) for r in validation.reports
                        if r.clean is not None]
                if live:
                    chunk_bits = sequential_chunk_bits(live, bucket=bucket)
            plan = build_batch_plan(blobs, chunk_bits=chunk_bits,
                                    seq_chunks=seq_chunks,
                                    validation=validation)
        else:
            images = [parse_jpeg(b) for b in blobs]
            unstuffed = None
            if sync == "sequential":
                unstuffed = [unstuff_scan(img.scan_data) for img in images]
                chunk_bits = sequential_chunk_bits(unstuffed, bucket=bucket)
            plan = build_batch_plan(blobs, chunk_bits=chunk_bits,
                                    seq_chunks=seq_chunks, parsed=images,
                                    unstuffed=unstuffed)
        if balance != "none":
            n_lanes = (int(lanes) if lanes is not None
                       else DP.default_lanes(dev))
            plan = DP.balance_lanes(plan, n_lanes, balance)
        return cls(plan, sync=sync, backend=backend, bucket=bucket,
                   fuse=fuse, device=device, validation=validation,
                   launch=launch)

    # -- the program's buffers ------------------------------------------------
    def prefetch(self, stream=None) -> None:
        """Copy the plan data to the card now, on ``stream`` (the current
        stream without one), and record an event that the decode's stream
        waits on before it copies the data into the program's buffers.
        Nothing to do on the CPU."""
        if self.device.type != "cuda":
            return
        stream = stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            staged = {k: v.to(self.device, non_blocking=True)
                      for k, v in self._host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        self._staged = (staged, event)

    def _bind(self) -> Dict[str, torch.Tensor]:
        """The program's buffers holding this decoder's plan data (under
        the program's lock): uploaded unless they hold it already."""
        prog = self.program
        if prog.plan is None:
            prog.allocate(self._host)
        prog.follow()
        if prog.owner is not self._token:
            src = self._host
            if self._staged is not None:
                src, event = self._staged
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(event)
                for t in src.values():
                    t.record_stream(cur)
                self._staged = None
            for k, buf in prog.plan.items():
                buf.copy_(src[k], non_blocking=True)
            prog.owner = self._token
            prog.uploads += 1
        dev = dict(prog.plan)
        if self._luts_compact is not None:
            if self.device.type == "cuda":
                self._luts_compact.record_stream(
                    torch.cuda.current_stream(self.device))
            dev["luts_compact"] = self._luts_compact
        return dev

    @property
    def dev(self) -> Dict[str, torch.Tensor]:
        """The program's device buffers, holding this decoder's plan data
        (the next decode of another decoder of the same key overwrites
        them)."""
        with self.program.lock:
            return self._bind()

    @property
    def _comp_unit_idx(self) -> List[torch.Tensor]:
        dev = self.dev
        return [dev[f"comp_unit_idx{ci}"]
                for ci in range(len(self.plan.comp_unit_idx))]

    @property
    def _comp_block_idx(self) -> List[torch.Tensor]:
        dev = self.dev
        return [dev[f"comp_block_idx{ci}"]
                for ci in range(len(self.plan.comp_block_idx))]

    def launch_stats(self) -> Dict[str, object]:
        """Kernel launches of this decoder's last decode by kernel, its
        host checks, which fused kernels its fuse mode runs, and
        :func:`~repro_torch.kernels.fused.ops.fuse_traffic`'s analytic
        inter-stage bytes. The launch counts are differences of the
        wrappers' counters around the decode, exact when one decode runs
        at a time; ``graph_replays`` counts the CUDA graphs of two Jacobi
        rounds replayed besides (two exit-kernel launches each)."""
        kernels = self.backend == "cuda"
        store = kernels and self.fuse == "full"
        pixels = (kernels and self.fuse != "none" and self.plan.uniform
                  and pixels_fusible(self.plan.geometry))
        return {"launches": dict(self._launches),
                "graph_replays": self._replays,
                "host_checks": self._host_checks, "fuse": self.fuse,
                "store_fused": store, "pixels_fused": pixels,
                **fuse_traffic(self.shape, store_fused=store,
                               pixels_fused=pixels)}

    # -- execution --------------------------------------------------------------
    def coefficients(self) -> DecodeOutput:
        """Entropy stage: sync, write bases, write pass, DC undiff."""
        return self.decode(emit="coeffs")

    def _coefficients(self, dev: Dict[str, torch.Tensor]) -> DecodeOutput:
        prog = self.program
        # rounds replay as CUDA graphs from a program's second decode on:
        # the first has loaded every kernel they capture
        graphs = prog.graphs if (self.device.type == "cuda"
                                 and prog.decodes) else None
        blocks = RoundBlocks(size=self.launch.block_rounds, hints=prog.hints,
                             graphs=graphs, audit=prog.audit)
        coeffs, rounds, converged = decode_coefficients(
            dev, self.shape, backend=self.backend, fuse=self.fuse,
            sync=self.sync, blocks=blocks, work=prog.work,
            launch=self.launch)
        self._host_checks = prog.host_checks = blocks.checks
        self._replays = blocks.replays
        prog.decodes += 1
        return DecodeOutput(coeffs[:self.plan.total_units], None, None,
                            rounds, converged, self.plan,
                            store_fused=self.backend == "cuda"
                            and self.fuse == "full",
                            status=self.plan.image_status,
                            validation=self.validation)

    def decode(self, emit: str = "rgb") -> DecodeOutput:
        if emit not in EMITS:
            raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
        plan = self.plan
        if emit != "coeffs" and not plan.uniform \
                and plan.image_status is None:
            raise NotImplementedError(
                "pixel stage requires a geometry-uniform batch; decode "
                "images with mixed geometry with emit='coeffs'")
        prog = self.program
        # the kernels run on the current device: make it the decoder's
        with prog.lock, MD.device_ctx(self.device):
            before = launch_counts()
            dev = self._bind()
            out = self._coefficients(dev)
            # a validated batch can lose uniformity to quarantine (every
            # image rejected): its coefficients, and the status says why
            if emit != "coeffs" and plan.uniform:
                rgb, planes = self._pixels(
                    out.coeffs, dev, dev["unit_mrow"][:plan.total_units],
                    plan.n_images)
                out = self._with_pixels(out, rgb, planes, emit)
            after = launch_counts()
            self._launches = prog.launches = {
                k: after[k] - before[k] for k in after}
        return out

    def _pixels(self, coeffs: torch.Tensor, dev: Dict[str, torch.Tensor],
                mrow: torch.Tensor, n_images: int
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """The pixel stage of ``n_images`` images' coefficient rows
        (``mrow`` their rows of ``unit_mrow``) on their device: ``(rgb,
        planes)``, ``planes`` None where the fused pixel kernel ran."""
        plan, g = self.plan, self.plan.geometry
        kernels = self.backend == "cuda"
        fused = kernels and self.fuse != "none" and pixels_fusible(g)
        n_comp = len(plan.comp_unit_idx)
        comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                     for h, v in zip(g.comp_h, g.comp_v)]
        if n_images == 0:   # a mesh block that owns no image
            rgb = torch.empty((0, g.height, g.width)
                              + ((3,) if n_comp > 1 else ()),
                              dtype=torch.uint8, device=coeffs.device)
            return rgb, None if fused else [
                torch.empty((0, 8 * by, 8 * bx), device=coeffs.device)
                for by, bx in comp_grid]
        if fused:
            return decode_pixels_fused(coeffs, dev["m_matrices_t"], mrow,
                                       geometry=g, n_images=n_images,
                                       launch=self.launch), None
        # the unfused chain: IDCT, plane assembly, then color or, for one
        # plane, a crop and cast
        if kernels:
            pixels = idct_units(coeffs, dev["m_matrices_t"], mrow,
                                units_per_mcu=g.units_per_mcu,
                                launch=self.launch)
        else:
            pixels = idct_units_plain(coeffs, dev["m_matrices_t"], mrow)
        planes = D.assemble_planes(
            pixels, n_images,
            [dev[f"comp_unit_idx{ci}"] for ci in range(n_comp)],
            [dev[f"comp_block_idx{ci}"] for ci in range(n_comp)], comp_grid)
        geo = (g.comp_h, g.comp_v, g.h_max, g.v_max, g.height, g.width)
        if len(planes) == 1:
            return D.upsample_color(planes, *geo), planes
        color = upsample_color if kernels else upsample_color_plain
        return color(planes, *geo), planes

    def _with_pixels(self, out: DecodeOutput, rgb, planes,
                     emit: str) -> DecodeOutput:
        """``out`` with the pixel stage's ``rgb`` and ``planes`` (tensors,
        or a mesh decode's :class:`Sharded` pieces) and the kernels that
        made them."""
        rgb = rgb if emit == "rgb" else None
        if planes is None:
            return dataclasses.replace(out, rgb=rgb, pixels_fused=True)
        kernels = self.backend == "cuda"
        return dataclasses.replace(out, planes=planes, rgb=rgb,
                                   idct_kernel=kernels,
                                   color_kernel=kernels and len(planes) > 1)

    # -- the decode over a mesh (core/mesh_decode.py) -----------------------------
    def decode_on(self, mesh: Mesh, emit: str = "rgb",
                  rules: Optional[Dict] = None) -> DecodeOutput:
        """Decode with the chunk lanes split over the mesh's cards, each
        card owning a contiguous range of images of the output; the
        result is bit-identical to :meth:`decode` and stays on the cards
        (``coeffs``, ``rgb`` and each plane are
        :class:`~repro_torch.core.mesh_decode.Sharded`).

        The decoder is purely data-parallel, so a multi-axis mesh is
        flattened to a 1-D lane mesh over the same devices when ``rules``
        is None. Caller-supplied ``rules`` name the axes of ``mesh``
        itself and require a 1-D mesh: a multi-axis mesh with ``rules``
        raises ``ValueError``, as in the JAX package. Lanes split over the
        mesh axis ``rules`` give ``"chunks"``; without one (of size above
        1) the decode runs on the mesh's first device. A mesh of one
        device runs :meth:`decode` there.
        """
        if emit not in EMITS:
            raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
        if rules is None:
            if len(mesh.axis_names) > 1:
                mesh = mesh.flat()
            rules = SH.decode_rules(mesh.axis_names)
        elif len(mesh.axis_names) > 1:
            raise ValueError(
                "decode_on(rules=...) requires a 1-D mesh; flatten the mesh "
                "(e.g. Mesh(mesh.devices.reshape(-1), ('data',))) or omit "
                "rules to let the decoder flatten it")
        if mesh.device_type != self.device.type:
            raise ValueError(f"the decoder was made for {self.device}; the "
                             f"mesh holds {mesh.device_type} devices")
        with SH.logical_rules(rules):
            if SH.lane_axis(mesh) is None:
                return self._decode_one(mesh.devices.flat[0], emit)
            return self._decode_mesh(mesh, emit)

    def _decode_one(self, device: torch.device, emit: str) -> DecodeOutput:
        """:meth:`decode` on ``device`` (a decoder of this plan made there
        once), its outputs as one-piece shards."""
        dec = self
        if device != self.device:
            dec = self._on_device.get(device)
            if dec is None:
                dec = self._on_device[device] = ParallelDecoder(
                    self.plan, sync=self.sync, backend=self.backend,
                    fuse=self.fuse, device=device, shape=self.shape,
                    validation=self.validation, launch=self.launch)
        out = dec.decode(emit=emit)
        self._launches, self._host_checks = dec._launches, dec._host_checks
        self._replays = dec._replays

        def one(t):
            return None if t is None else Sharded([t], [0, t.shape[0]])

        return dataclasses.replace(
            out, coeffs=one(out.coeffs), rgb=one(out.rgb),
            planes=None if out.planes is None else [one(p) for p in
                                                    out.planes],
            mesh={"blocks": 1, "devices": [str(device)],
                  "lanes": [dec.shape.n_chunks], "halo": [0],
                  "rows": [(0, dec.plan.total_units)],
                  "images": [(0, dec.plan.n_images)],
                  "launches": [dict(dec._launches)],
                  "graph_replays": [dec._replays],
                  "host_checks": dec._host_checks, "exchanges": 0,
                  "round_bytes": 0, "copy_bytes": {}, "expected_bytes": {},
                  "peer_access": {}})

    def mesh_layout(self, n_blocks: int):
        """The plan's lane blocks over ``n_blocks`` mesh entries
        (``dist.plan.mesh_layout``) and each block's arrays as host
        tensors, made once per size."""
        hit = self._layouts.get(n_blocks)
        if hit is None:
            layout = DP.mesh_layout(self.plan, self._arrays, n_blocks)
            pin = self.device.type == "cuda"
            host = [{k: _host_tensor(a, pin) for k, a in arrs.items()}
                    for arrs in MD.host_arrays(layout)]
            hit = self._layouts[n_blocks] = (layout, host)
        return hit

    def _bind_block(self, prog: MeshProgram, b: int, lay: DP.BlockLayout,
                    host: Dict[str, torch.Tensor], sends) -> "MD._Block":
        """Block ``b``'s buffers holding this decoder's data (uploaded
        unless they hold it) and its views of them."""
        bp = prog.blocks[b]
        dev = bp.device
        bp.follow()
        views = {k: bp.buf("lay_" + k, t.numel(), t.dtype)
                 for k, t in host.items()}
        if bp.plan is None:
            bp.plan = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in self._host.items()}
            bp.allocations += 1
        if bp.owner is not self._token:
            for k, t in bp.plan.items():
                t.copy_(self._host[k], non_blocking=True)
            for k, t in views.items():
                t.copy_(host[k], non_blocking=True)
            bp.owner = self._token
            bp.uploads += 1
        d = dict(bp.plan)
        if self.backend == "cuda":
            tab = self._card_tables.get(dev)
            if tab is None:   # hashing the LUTs takes milliseconds
                tab = self._card_tables[dev] = lut_tables(
                    self._arrays["luts"], dev)[0]
            d["luts_compact"] = tab
        lo, hi, n = lay.lo, lay.hi, lay.n
        v = dict(views, start=d["chunk_start"][lo:hi],
                 first=d["chunk_first"][lo:hi],
                 seg=d["chunk_seg"][lo:hi].to(torch.int64),
                 last_neq=bp.buf("last_neq", 1).view(()),
                 ridx=bp.buf("ridx", 1).view(()))
        meta = D.chunk_meta(
            {"chunk_seg": d["chunk_seg"][lo:hi],
             "chunk_limit": d["chunk_limit"][lo:hi],
             **{k: d[k] for k in ("seg_tableset", "seg_word_base",
                                  "ts_upm")}},
            out={k: bp.buf("meta_" + k, n) for k in ("word_base", "ts",
                                                     "upm")})
        width = n + len(lay.halo)
        ext = bp.buf("ext", 8 * width).view(2, 4, width)
        sbufs = [(dst, views[f"send{dst}"],
                  bp.buf(f"sendbuf{dst}", 4 * len(lanes)).view(4, len(lanes)))
                 for dst, lanes in sends]
        return MD._Block(b, lay, bp, d, v, meta, ext, sbufs,
                         collections.Counter())

    def _decode_mesh(self, mesh: Mesh, emit: str) -> DecodeOutput:
        plan = self.plan
        if emit != "coeffs" and not plan.uniform \
                and plan.image_status is None:
            raise NotImplementedError(
                "pixel stage requires a geometry-uniform batch; decode "
                "images with mixed geometry with emit='coeffs'")
        mesh = mesh.flat()
        prog = mesh_program(self.shape, self.sync, self.backend, self.fuse,
                            mesh, self.launch)
        layout, host = self.mesh_layout(mesh.size)
        kernels = self.backend == "cuda"
        cuda = self.device.type == "cuda"
        with prog.lock:
            before, allocations = launch_counts(), prog.allocations
            clock = [("start", time.perf_counter())]

            def lap(name):
                clock.append((name, time.perf_counter()))

            blocks = []
            for b, lay in enumerate(layout.blocks):
                with MD.device_ctx(prog.blocks[b].device):
                    blocks.append(self._bind_block(prog, b, lay, host[b],
                                                   layout.sends[b]))
            rb = RoundBlocks(size=self.launch.block_rounds, hints=prog.hints)
            run = MD.MeshRun(blocks, layout, self.shape, self.sync,
                             self.fuse, kernels, self.launch, launch_counts,
                             rb, graphs=cuda and prog.decodes > 0,
                             keep_graphs=prog.keep_graphs)
            lap("bind")
            rounds, converged = run.run_sync()
            exits = Sharded([b.ext[run.side][:, :b.n].t().clone()
                             for b in blocks], layout.bounds)
            lap("sync")
            written = run.write_pass()
            lap("write")
            rows = run.place(written)
            coeffs = []
            for blk, acc in zip(blocks, rows):
                r0, r1 = blk.lay.rows
                with run.on(blk):
                    coeffs.append(D.undiff_dc(
                        {"unit_comp": blk.d["unit_comp"][r0:r1],
                         "unit_seg_start":
                             blk.d["unit_seg_start"][r0:r1] - r0}, acc))
            out = DecodeOutput(
                Sharded(coeffs, [b.lay.rows[0] for b in blocks]
                        + [blocks[-1].lay.rows[1]]),
                None, None, rounds, converged, plan,
                store_fused=kernels and self.fuse == "full",
                status=plan.image_status, validation=self.validation)
            lap("place")
            if emit != "coeffs" and plan.uniform:
                # each block's images on its card
                rgbs, planes = [], []
                for blk, co in zip(blocks, coeffs):
                    r0, r1 = blk.lay.rows
                    with run.on(blk):
                        rgb, pl = self._pixels(co, blk.d,
                                               blk.d["unit_mrow"][r0:r1],
                                               blk.lay.images[1]
                                               - blk.lay.images[0])
                    rgbs.append(rgb)
                    planes.append(pl)
                offs = [b.lay.images[0] for b in blocks] + \
                    [blocks[-1].lay.images[1]]
                out = self._with_pixels(
                    out, Sharded(rgbs, offs),
                    None if planes[0] is None else
                    [Sharded([p[ci] for p in planes], offs)
                     for ci in range(len(planes[0]))], emit)
                lap("pixels")
            prog.decodes += 1
            prog.host_checks = self._host_checks = rb.checks
            self._replays = sum(b.replays for b in blocks)
            after = launch_counts()
            self._launches = prog.launches = {
                k: after[k] - before[k] for k in after}
            prog.allocations = sum(b.allocations for b in prog.blocks)
            prog.grown += prog.allocations > allocations
            prog.uploads = sum(b.uploads for b in prog.blocks)
            prog.last = {
                "blocks": mesh.size,
                "devices": [str(b.prog.device) for b in blocks],
                "lanes": [b.n for b in blocks],
                "halo": [len(b.lay.halo) for b in blocks],
                "rows": [b.lay.rows for b in blocks],
                "images": [b.lay.images for b in blocks],
                "launches": [dict(b.launches) for b in blocks],
                "graph_replays": [b.replays for b in blocks],
                "host_checks": rb.checks,
                "allocations": prog.allocations - allocations,
                "allocating_decodes": prog.grown,
                "exchanges": run.exchanges,
                "round_bytes": 16 * sum(len(b.lay.halo) for b in blocks),
                "copy_bytes": dict(run.copy_bytes),
                "expected_bytes": MD.expected_bytes(
                    layout, self.sync, run.exchanges, run.sized,
                    run.pieces),
                "peer_access": prog.peer_access,
                "host_ms": {b[0]: 1e3 * (b[1] - a[1])
                            for a, b in zip(clock, clock[1:])}}
        return dataclasses.replace(out, mesh=dict(prog.last, exits=exits))


def run_sync(dev: Dict[str, torch.Tensor], shape: PlanShape, sync: str,
             decode_exits, blocks: Optional[RoundBlocks] = None,
             bufs=None, flags=None) -> SyncResult:
    """Run schedule ``sync`` with the bounds the JAX package gives it.

    Every bound is a capacity: inert lanes are stable from round 0.
    ``blocks``, ``bufs`` and ``flags`` go to the schedule
    (``core/sync.py``).
    """
    lim = sync_limits(shape)
    kw = dict(decode_exits=decode_exits, permuted=shape.permuted,
              blocks=blocks, bufs=bufs, flags=flags)
    if sync == "jacobi":
        return jacobi_sync(dev, max_rounds=lim.jacobi, **kw)
    if sync == "specmap":
        return specmap_sync(dev, max_upm=MAX_UPM, max_verify=lim.specmap,
                            **kw)
    if sync == "faithful":
        return faithful_sync(dev, seq_chunks=shape.seq_chunks,
                             max_outer=lim.outer, **kw)
    # sequential: one chunk per segment, so the cold decode is exact
    cold = DecodeState.cold(dev["chunk_start"])
    exits = decode_exits(dev, cold, **({"out": bufs[0]} if bufs else {}))
    return SyncResult(exits, 1, True)


def decode_coefficients(dev: Dict[str, torch.Tensor], shape: PlanShape, *,
                        backend: str, fuse: str, sync: str = "jacobi",
                        blocks: Optional[RoundBlocks] = None,
                        work: Optional[Dict[str, object]] = None,
                        launch: LaunchConfig = DEFAULT_LAUNCH
                        ) -> Tuple[torch.Tensor, int, bool]:
    """The entropy stage on a padded plan's tensors.

    Returns ``(coeffs, sync_rounds, converged)`` with capacity-sized
    (``shape.n_units``, 64) coefficients in a new tensor. ``dev`` is
    ``dev_from_numpy(PlanData.arrays + words)`` of either package's plan,
    with ``HK.exit_tables(dev)`` added for ``backend="cuda"``; ``work``
    the intermediates' buffers (``DecodeProgram.work``), fresh ones
    without it; ``launch`` the kernels' launch sizes.
    """
    sh = shape
    work = work or {}
    kernels = backend == "cuda"
    meta = D.chunk_meta(dev, out=work.get("meta"))
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    exits_fn = HK.decode_exits if kernels else HK.decode_exits_plain
    kernel_kw = dict(kw, launch=launch)

    def decode_exits(d, entry, idx=None, out=None):
        return exits_fn(d, meta, entry, idx, out=out,
                        **(kernel_kw if kernels else kw))

    res = run_sync(dev, sh, check_sync(sync), decode_exits, blocks,
                   work.get("exits"), work.get("flags"))
    # Output placement (Alg. 1 lines 7-8) and write pass (lines 9-15).
    # The final segment's write clamp is units_end, the real batch's
    # coefficient count; pad segments carry the same value.
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted,
                                out=work.get("bases"))
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    write_max = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    entries = chain_entries(dev, res.exits, sh.permuted)
    out = write_coefficients(dev, meta, entries, bases, write_max,
                             sh.n_units * 64, kernels=kernels, fuse=fuse,
                             launch=launch, buf=work.get, **kw)
    # undiff_dc writes a new tensor: nothing returned aliases ``work``
    coeffs = D.undiff_dc(dev, out.reshape(sh.n_units, 64))
    return coeffs, res.rounds, res.converged


def decode_batch(blobs: Sequence[bytes], chunk_bits: int = 1024,
                 seq_chunks: int = 32, sync: str = "jacobi",
                 emit: str = "rgb", backend: Optional[str] = None,
                 bucket: bool = True, fuse: Optional[str] = None,
                 device=None, validate: bool = False,
                 balance: str = "none",
                 lanes: Optional[int] = None,
                 use_kernels: bool = False,
                 mesh: Optional[Mesh] = None) -> DecodeOutput:
    """Parse, plan and decode one batch (see the module docstring and
    :meth:`ParallelDecoder.from_bytes` for ``balance`` and ``lanes``).

    With ``mesh`` the batch decodes over the mesh's devices
    (:meth:`ParallelDecoder.decode_on`), ``balance`` over ``mesh.size``
    lane blocks; ``device`` defaults to the mesh's first device, else to
    ``"cuda"``."""
    if device is None:
        device = mesh.devices.flat[0] if mesh is not None else "cuda"
    if mesh is not None and lanes is None:
        lanes = mesh.size
    dec = ParallelDecoder.from_bytes(
        blobs, chunk_bits=chunk_bits, seq_chunks=seq_chunks, sync=sync,
        backend=backend, bucket=bucket, fuse=fuse, device=device,
        validate=validate, balance=balance, lanes=lanes,
        use_kernels=use_kernels)
    if mesh is None:
        return dec.decode(emit=emit)
    return dec.decode_on(mesh, emit=emit)

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
from .state import DecodeState
from .sync import (RoundBlocks, SyncResult, chain_entries, faithful_sync,
                   jacobi_sync, specmap_sync)
from ..dist import plan as DP
from ..jpeg.format import parse_jpeg, segment_byte_bounds, unstuff_scan
from ..kernels.color.ops import upsample_color, upsample_color_plain
from ..kernels.fused.ops import (decode_pixels_fused, fuse_traffic,
                                 pixels_fusible)
from ..kernels.fused.pixels import fused_pixels
from ..kernels.fused.store import (decode_coeffs_store,
                                  decode_coeffs_store_plain)
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
        if self.backend == "cuda" and self.fuse != "full":
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
        with prog.lock:
            before = launch_counts()
            dev = self._bind()
            out = self._coefficients(dev)
            # a validated batch can lose uniformity to quarantine (every
            # image rejected): its coefficients, and the status says why
            if emit != "coeffs" and plan.uniform:
                out = self._pixels(dev, out, emit)
            after = launch_counts()
            self._launches = prog.launches = {
                k: after[k] - before[k] for k in after}
        return out

    def _pixels(self, dev: Dict[str, torch.Tensor], out: DecodeOutput,
                emit: str) -> DecodeOutput:
        plan, g = self.plan, self.plan.geometry
        mrow = dev["unit_mrow"][:plan.total_units]
        kernels = self.backend == "cuda"
        if kernels and self.fuse != "none" and pixels_fusible(g):
            rgb = decode_pixels_fused(out.coeffs, dev["m_matrices_t"], mrow,
                                      geometry=g, n_images=plan.n_images,
                                      launch=self.launch)
            return dataclasses.replace(out, rgb=rgb if emit == "rgb"
                                       else None, pixels_fused=True)
        # the unfused chain: IDCT, plane assembly, then color or, for one
        # plane, a crop and cast
        if kernels:
            pixels = idct_units(out.coeffs, dev["m_matrices_t"], mrow,
                                units_per_mcu=g.units_per_mcu,
                                launch=self.launch)
        else:
            pixels = idct_units_plain(out.coeffs, dev["m_matrices_t"], mrow)
        n_comp = len(plan.comp_unit_idx)
        comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                     for h, v in zip(g.comp_h, g.comp_v)]
        planes = D.assemble_planes(
            pixels, plan.n_images,
            [dev[f"comp_unit_idx{ci}"] for ci in range(n_comp)],
            [dev[f"comp_block_idx{ci}"] for ci in range(n_comp)], comp_grid)
        geo = (g.comp_h, g.comp_v, g.h_max, g.v_max, g.height, g.width)
        if len(planes) == 1:
            rgb = D.upsample_color(planes, *geo)
        else:
            color = upsample_color if kernels else upsample_color_plain
            rgb = color(planes, *geo)
        return dataclasses.replace(out, planes=planes,
                                   rgb=rgb if emit == "rgb" else None,
                                   idct_kernel=kernels,
                                   color_kernel=kernels and len(planes) > 1)


def run_sync(dev: Dict[str, torch.Tensor], shape: PlanShape, sync: str,
             decode_exits, blocks: Optional[RoundBlocks] = None,
             bufs=None, flags=None) -> SyncResult:
    """Run schedule ``sync`` with the bounds the JAX package gives it.

    Every bound is a capacity: inert lanes are stable from round 0.
    ``blocks``, ``bufs`` and ``flags`` go to the schedule
    (``core/sync.py``).
    """
    sh = shape
    kw = dict(decode_exits=decode_exits, permuted=sh.permuted,
              blocks=blocks, bufs=bufs, flags=flags)
    if sync == "jacobi":
        return jacobi_sync(dev, max_rounds=sh.n_chunks + 2, **kw)
    if sync == "specmap":
        # the hypothesis decodes count as rounds, so the verify budget adds
        # them to the longest truth-propagation chain
        return specmap_sync(dev, max_upm=MAX_UPM,
                            max_verify=sh.n_chunks + MAX_UPM + 2, **kw)
    if sync == "faithful":
        return faithful_sync(dev, seq_chunks=sh.seq_chunks,
                             max_outer=sh.n_sequences + 2, **kw)
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
    n_coef = sh.n_units * 64
    if not kernels:  # decode_span(write=True)
        out = decode_coeffs_store_plain(dev, meta, entries, bases, write_max,
                                        n_coef, out=work.get("store"), **kw)
    elif fuse == "full":
        out = decode_coeffs_store(dev, meta, entries, bases, write_max,
                                  n_coef, out=work.get("store"), **kernel_kw)
    else:
        out = HK.decode_coeffs(dev, meta, entries, bases, write_max, n_coef,
                               streams=work.get("streams"),
                               out=work.get("scatter"), **kernel_kw)
    # undiff_dc writes a new tensor: nothing returned aliases ``work``
    coeffs = D.undiff_dc(dev, out.reshape(sh.n_units, 64))
    return coeffs, res.rounds, res.converged


def decode_batch(blobs: Sequence[bytes], chunk_bits: int = 1024,
                 seq_chunks: int = 32, sync: str = "jacobi",
                 emit: str = "rgb", backend: Optional[str] = None,
                 bucket: bool = True, fuse: Optional[str] = None,
                 device="cuda", validate: bool = False,
                 balance: str = "none",
                 lanes: Optional[int] = None,
                 use_kernels: bool = False) -> DecodeOutput:
    """Parse, plan and decode one batch (see the module docstring and
    :meth:`ParallelDecoder.from_bytes` for ``balance`` and ``lanes``)."""
    dec = ParallelDecoder.from_bytes(
        blobs, chunk_bits=chunk_bits, seq_chunks=seq_chunks, sync=sync,
        backend=backend, bucket=bucket, fuse=fuse, device=device,
        validate=validate, balance=balance, lanes=lanes,
        use_kernels=use_kernels)
    return dec.decode(emit=emit)

"""Kernel verifier: bounds, tiling and scatter-race checks of the CUDA
decode kernels (``python -m repro_torch.analysis kernels``).

The counterpart of the JAX package's ``analysis/kernel_check.py``, with
its three families (``contracts.KERNEL_CHECK_FAMILIES``) and its
:class:`Violation` record. Where the JAX verifier abstract-interprets the
Pallas kernels' jaxprs, the CUDA kernels have no jaxpr to read, so each
family is shown another way:

* **kernel-tiling, on the host** (:func:`check_geometry`): each kernel's
  launch geometry for every bucket-ladder rung up to the ``newyork``
  capacity (269,063 lanes, 1,566,720 units) and every launch candidate of
  ``kernels/autotune.py``: the blocks cover the lanes, units and MCUs
  exactly, every thread group's units tile an IDCT / pixel tile once, the
  pixel kernel's second stage reaches every pixel chunk, the persistent
  loops of the IDCT and pixel kernels reach every tile, and each launch's
  shared memory fits a block. The arithmetic is the kernels' own: the
  functions of ``csrc/geometry.cuh``, built with g++ into a small library
  (:func:`geometry_lib`), not a Python copy. The counterpart of
  ``check_tiling`` and ``check_ladder_alignment``.
* **kernel-tiling, at run time**: the checked build (``csrc/check.cuh``)
  counts each write of the IDCT, pixel and color kernels' outputs; every
  element must be written exactly once.
* **kernel-bounds**: every global and shared access of the six kernels
  runs through the checked build's guard, whose record must be empty
  after every launch (:func:`check_record`).
* **kernel-scatter-race**: on the host, ``check_seg_coeff_disjoint`` on
  every plan; on the device, the targets that ``scatter_streams`` writes,
  other than its sentinel, are unique and each lane's positions strictly
  increase (:func:`check_scatter_targets`), the counterpart of
  ``check_scatters``.

:func:`run_self_test` proves the verifier catches what it claims to: the
seeded faults S1 (an off-by-one row read, kernel-bounds), S2 (a copy grid
that stops short) and S3 (the pixel kernel on a misaligned tile), both
kernel-tiling, and a duplicate-index scatter (kernel-scatter-race). On
the CPU (``device="cpu"``) it runs their plain versions, which make the
same faults. :func:`run` needs a card; every function it calls on the host
is a plain function the CPU tests call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import contracts

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

# the newyork batch's capacities (32 1080p frames at chunk_bits 1024): the
# largest batch the port is run at
MAX_LANES = 269_063
MAX_UNITS = 1_566_720
# layouts of the pixel kernel, (comp_h, comp_v): 4:2:0, 4:2:2 and 4:4:4
# (kernels of their own), 4:1:1 and 4:4:0 (the generic one)
PIXEL_LAYOUTS = (((2, 1, 1), (2, 1, 1)), ((2, 1, 1), (1, 1, 1)),
                 ((1, 1, 1), (1, 1, 1)), ((4, 1, 1), (1, 1, 1)),
                 ((1, 1, 1), (2, 1, 1)))
SMEM_BLOCK_MAX = 232_448        # shared memory a block may have (227 KB)
TABLE_BUDGET = 24 * 1024        # kernels/huffman/ops.EXIT_SMEM_BUDGET
PIXEL_SHARED_MATRICES = 3       # csrc/pixels.cu kSharedMatrices
IDCT_SHARED_MATRICES = 4        # csrc/idct.cu kSharedMatrices
# resident blocks a persistent launch may have (1, an SM's worth on the
# H100, several SMs' worth)
PERSISTENT_SLOTS = (1, 132, 396)


@dataclasses.dataclass
class Violation:
    family: str   # KERNEL_CHECK_FAMILIES key (or "self-test")
    cell: str     # which batch, kernel and launch
    detail: str

    def format(self) -> str:
        return f"[{self.family}] {self.cell}: {self.detail}"


def check_sites() -> Dict[int, str]:
    """The checked build's sites, {id: name}, read from ``check.cuh``'s
    ``CheckSite`` enum."""
    text = (CSRC / "check.cuh").read_text()
    body = text[text.index("enum CheckSite"):]
    body = body[:body.index("};")]
    return {int(v): k for k, v in re.findall(r"(kSite\w+)\s*=\s*(\d+)",
                                             body)}


# ---------------------------------------------------------------------------
# kernel-tiling on the host: the kernels' own geometry, built with g++
# ---------------------------------------------------------------------------

GEOMETRY_SHIM = r"""
#include "geometry.cuh"

extern "C" {
long long geo_blocks(long long n, int threads) {
  return rt::blocks_for(n, threads);
}
long long geo_tiles(long long n, long long tile) {
  return rt::tiles_for(n, tile);
}
int geo_groups(int knob, int stride) { return rt::launch_groups(knob, stride); }
int geo_group_unit(int g, int i, int stride) {
  return rt::group_unit(g, i, stride);
}
int geo_tile_units(int groups) { return rt::tile_units(groups); }
int geo_idct_shared(int shared_m, int nq, int tile) {
  return rt::idct_shared_bytes(shared_m != 0, nq, tile);
}
int geo_pixels_shared(int shared_m, int nq, int tile) {
  return rt::pixels_shared_bytes(shared_m != 0, nq, tile);
}
int geo_store_slot_bytes(int threads) { return rt::store_slot_bytes(threads); }
int geo_chunks_per_mcu(int h_max, int v_max) {
  return rt::chunks_per_mcu(h_max, v_max);
}
int geo_warp_units(int writer, int n_lanes, int sms) {
  return rt::store_warp_units(writer, n_lanes, sms);
}
int geo_threads_per_group() { return rt::kThreadsPerGroup; }
// the block sizes a Huffman kernel is instantiated for (0 exit, 1 stream,
// 2 store): their count, written to out
int geo_thread_choices(int which, int* out) {
  const int* c = which == 0 ? rt::kExitThreadChoices
                 : which == 1 ? rt::kStreamThreadChoices
                              : rt::kStoreThreadChoices;
  const int n = which == 2 ? 2 : 3;
  for (int i = 0; i < n; ++i) out[i] = c[i];
  return n;
}
int geo_units() { return rt::kUnits; }
void geo_color_grid(int n, int h, int w, int* out) {
  const rt::ColorGrid g = rt::color_grid(n, h, w);
  out[0] = g.x;
  out[1] = g.y;
  out[2] = g.z;
}
int geo_color_consts(int* out) {
  out[0] = rt::kColorRun;
  out[1] = rt::kRunsX;
  out[2] = rt::kRowsY;
  out[3] = rt::kMaxGrid;
  return 0;
}
}
"""

_GEO: Dict[str, ctypes.CDLL] = {}
_GEO_LOCK = threading.Lock()


def geometry_lib(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """``csrc/geometry.cuh`` built with g++ into a library (once per
    content of the header, into ``build/repro_torch/``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the host geometry check needs g++")
    header = (CSRC / "geometry.cuh").read_bytes()
    digest = hashlib.sha256(header + GEOMETRY_SHIM.encode()).hexdigest()[:16]
    with _GEO_LOCK:
        lib = _GEO.get(digest)
        if lib is not None:
            return lib
        if build_dir is None:
            from ..kernels.build import BUILD_DIR
            build_dir = BUILD_DIR
        build_dir.mkdir(parents=True, exist_ok=True)
        so = build_dir / f"libgeometry-{digest}.so"
        if not so.exists():
            # per-process names: several test workers may build at once
            cpp = build_dir / f"geometry-{digest}.{os.getpid()}.cpp"
            cpp.write_text(GEOMETRY_SHIM)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                            f"-I{CSRC}", str(cpp), "-o", str(tmp)],
                           check=True, capture_output=True, text=True,
                           timeout=300)
            tmp.replace(so)
            cpp.unlink()
        lib = ctypes.CDLL(str(so))
        ll, i = ctypes.c_longlong, ctypes.c_int
        for name, args, res in (
                ("geo_blocks", [ll, i], ll), ("geo_tiles", [ll, ll], ll),
                ("geo_groups", [i, i], i), ("geo_group_unit", [i, i, i], i),
                ("geo_tile_units", [i], i),
                ("geo_idct_shared", [i, i, i], i),
                ("geo_pixels_shared", [i, i, i], i),
                ("geo_store_slot_bytes", [i], i),
                ("geo_chunks_per_mcu", [i, i], i),
                ("geo_warp_units", [i, i, i], i),
                ("geo_threads_per_group", [], i), ("geo_units", [], i),
                ("geo_thread_choices", [i, ctypes.POINTER(i)], i),
                ("geo_color_grid", [i, i, i, ctypes.POINTER(i)], None),
                ("geo_color_consts", [ctypes.POINTER(i)], i)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _GEO[digest] = lib
        return lib


def ladder(cap: int) -> List[int]:
    """Every rung of the bucket ladder up to the one that covers ``cap``."""
    from ..core.bitstream import bucket_capacity

    rungs, r = [], 1
    while True:
        rungs.append(r)
        if r >= cap:
            return rungs
        r = bucket_capacity(r + 1)


def _cover(extent: int, tile: int, blocks: int, cell: str, what: str,
           out: List[Violation]) -> None:
    try:
        contracts.check_block_cover(extent, tile, blocks, what)
    except contracts.ContractViolation as e:
        out.append(Violation("kernel-tiling", cell, str(e)))


def _persistent_cover(n_tiles: int, slots: int) -> Tuple[int, int]:
    """(blocks, tiles visited) of a persistent launch: min(n_tiles, slots)
    blocks, block b walking tiles b, b + blocks, ... (counted, not
    enumerated)."""
    blocks = min(n_tiles, slots)
    visits = sum(-(-(n_tiles - b) // blocks) for b in range(blocks)) \
        if blocks else 0
    return blocks, visits


def check_geometry(configs=None, max_lanes: int = MAX_LANES,
                   max_units: int = MAX_UNITS) -> Tuple[List[Violation], int]:
    """The kernel-tiling family's host half; returns (violations, cells
    checked). ``configs``: the launch candidates (default: every one of
    ``autotune.candidate_configs``)."""
    from ..kernels.autotune import WRITER_CODES, candidate_configs

    geo = geometry_lib()
    configs = list(configs or candidate_configs())
    out: List[Violation] = []
    cells = 0
    per_group = geo.geo_threads_per_group()
    n_unit = geo.geo_units()
    lane_rungs, unit_rungs = ladder(max_lanes), ladder(max_units)

    # the Huffman kernels: one thread a lane, blocks of each candidate,
    # each a block size the kernel is instantiated for
    for which, knob in enumerate(("exit_threads", "stream_threads",
                                  "store_threads")):
        built = (ctypes.c_int * 3)()
        built = set(built[:geo.geo_thread_choices(which, built)])
        for threads in {getattr(c, knob) for c in configs} - built:
            out.append(Violation("kernel-tiling", f"{knob}={threads}",
                                 f"the kernel is instantiated for {built} "
                                 f"only"))
        for threads in sorted({getattr(c, knob) for c in configs} & built):
            for rung in lane_rungs:
                cells += 1
                _cover(rung, threads, geo.geo_blocks(rung, threads),
                       f"{knob}={threads} lanes={rung}",
                       "lanes by blocks", out)
    for c in configs:
        slots = geo.geo_store_slot_bytes(c.store_threads)
        if slots + TABLE_BUDGET > SMEM_BLOCK_MAX:
            out.append(Violation(
                "kernel-tiling", f"store_threads={c.store_threads}",
                f"unit slots {slots} B + tables {TABLE_BUDGET} B exceed a "
                f"block's {SMEM_BLOCK_MAX} B of shared memory"))
        writer = WRITER_CODES[c.store_writer]
        for lanes in (1, 31, 32, 4223, 4224, max_lanes):
            warp = geo.geo_warp_units(writer, lanes, 132)
            if warp < 0 and not (c.store_writer == "warp" and lanes < 32):
                out.append(Violation(
                    "kernel-tiling", f"store_writer={c.store_writer}",
                    f"refused at {lanes} lanes"))

    # the IDCT and pixel kernels: tiles of thread groups
    groups_seen = set()
    for knob in ("idct_groups", "pixel_groups"):
        for value in sorted({getattr(c, knob) for c in configs}):
            for stride in range(1, 7):
                groups = geo.geo_groups(value, stride)
                if groups < 0:
                    continue  # refused: the wrapper raises before a launch
                groups_seen.add((groups, stride))
    for groups, stride in sorted(groups_seen):
        cells += 1
        tile = geo.geo_tile_units(groups)
        units = sorted(geo.geo_group_unit(g, i, stride)
                       for g in range(groups) for i in range(n_unit))
        if units != list(range(tile)):
            out.append(Violation(
                "kernel-tiling", f"groups={groups} stride={stride}",
                f"the groups' units do not tile the {tile}-unit tile once"))
        if groups * per_group > 384:
            out.append(Violation(
                "kernel-tiling", f"groups={groups}",
                f"{groups * per_group} threads exceed the kernels' launch "
                f"bounds of 384"))
        for nq in range(1, IDCT_SHARED_MATRICES + 1):
            if geo.geo_idct_shared(1, nq, tile) > SMEM_BLOCK_MAX:
                out.append(Violation(
                    "kernel-tiling", f"idct groups={groups} nq={nq}",
                    "shared memory exceeds a block's"))
        for nq in range(1, PIXEL_SHARED_MATRICES + 1):
            if geo.geo_pixels_shared(1, nq, tile) > SMEM_BLOCK_MAX:
                out.append(Violation(
                    "kernel-tiling", f"pixels groups={groups} nq={nq}",
                    "shared memory exceeds a block's"))
        for rung in unit_rungs:
            cells += 1
            n_tiles = geo.geo_tiles(rung, tile)
            _cover(rung, tile, n_tiles, f"idct groups={groups} "
                   f"stride={stride} units={rung}", "units by tiles", out)
            for slots in PERSISTENT_SLOTS:
                blocks, visits = _persistent_cover(n_tiles, slots)
                if visits != n_tiles or blocks < 1:
                    out.append(Violation(
                        "kernel-tiling", f"groups={groups} units={rung} "
                        f"slots={slots}", f"the persistent loop visits "
                        f"{visits} of {n_tiles} tiles"))
    for comp_h, comp_v in PIXEL_LAYOUTS:
        upm = sum(h * v for h, v in zip(comp_h, comp_v))
        cpm = geo.geo_chunks_per_mcu(max(comp_h), max(comp_v))
        for value in sorted({c.pixel_groups for c in configs}):
            groups = geo.geo_groups(value, upm)
            if groups < 0:
                continue
            cells += 1
            cell = f"pixels {comp_h}x{comp_v} groups={groups}"
            tile = geo.geo_tile_units(groups)
            if tile % upm:
                out.append(Violation("kernel-tiling", cell,
                                     f"a tile of {tile} units is not whole "
                                     f"MCUs of {upm}"))
                continue
            if groups * per_group < cpm:
                out.append(Violation(
                    "kernel-tiling", cell,
                    f"{groups * per_group} threads cannot reach an MCU's "
                    f"{cpm} pixel chunks"))
            tile_mcus = tile // upm
            for rung in unit_rungs:
                n_mcus = rung // upm
                if not n_mcus:
                    continue
                n_tiles = geo.geo_tiles(n_mcus, tile_mcus)
                _cover(n_mcus, tile_mcus, n_tiles, f"{cell} mcus={n_mcus}",
                       "MCUs by tiles", out)

    # the color kernel: runs of a row by blocks across, rows and images
    # by stride loops
    consts = (ctypes.c_int * 4)()
    geo.geo_color_consts(consts)
    run, runs_x, rows_y, max_grid = consts
    for n, h, w in ((32, 1080, 1920), (32, 1078, 1918), (1, 1, 1),
                    (2, 48, 64), (70000, 8, 8), (1, 70000 * 8, 16)):
        cells += 1
        g = (ctypes.c_int * 3)()
        geo.geo_color_grid(n, h, w, g)
        cell = f"color {n}x{h}x{w}"
        _cover(w, run * runs_x, g[0], cell, "row by blocks", out)
        if g[1] < 1 or g[1] > max_grid or g[2] < 1 or g[2] > max_grid:
            out.append(Violation("kernel-tiling", cell,
                                 f"grid ({g[0]}, {g[1]}, {g[2]}) out of the "
                                 f"card's limits"))
        if g[1] * rows_y < min(h, max_grid * rows_y) or g[2] < min(
                n, max_grid):
            out.append(Violation("kernel-tiling", cell,
                                 "rows or images not reached"))
    return out, cells


# ---------------------------------------------------------------------------
# kernel-scatter-race
# ---------------------------------------------------------------------------

def check_plan_disjoint(plan, cell: str) -> List[Violation]:
    """The host leg: the plan's segment coefficient ranges are disjoint."""
    from ..core.bitstream import check_seg_coeff_disjoint

    try:
        check_seg_coeff_disjoint(plan.seg_coeff_base, plan.total_units,
                                 what=cell)
    except contracts.ContractViolation as e:
        return [Violation("kernel-scatter-race", cell, str(e))]
    return []


def check_scatter_targets(pos, val, write_base, write_max, n_coef: int,
                          cell: str) -> List[Violation]:
    """The device legs of the write pass's scatter (``scatter_streams``):
    the targets it writes, other than its sentinel slots, are unique, and
    each lane's recorded positions strictly increase. ``pos``/``val`` are
    the (s_max, C) streams; runs on the tensors' device."""
    import torch

    out: List[Violation] = []
    room = (write_max - write_base).to(torch.int64)
    rec = pos >= 0
    writes = rec & (pos.to(torch.int64) <= room)
    tgt = pos.to(torch.int64) + write_base.to(torch.int64)
    real = writes & (tgt >= 0) & (tgt < n_coef)
    t = tgt[real]
    if t.numel():
        s, _ = torch.sort(t)
        dup = s[1:] == s[:-1]
        n_dup = int(dup.sum())
        if n_dup:
            first = int(s[1:][dup][0])
            out.append(Violation(
                "kernel-scatter-race", cell,
                f"{n_dup} duplicate scatter target(s), the first {first}: "
                f"an overwrite scatter with duplicates is order-dependent"))
    # strictly increasing positions per lane: each recorded pos above every
    # earlier recorded pos of its lane
    masked = torch.where(rec, pos.to(torch.int64),
                         torch.full_like(pos, -1, dtype=torch.int64))
    if masked.shape[0] > 1:
        prev = torch.cummax(masked, dim=0).values[:-1]
        bad = rec[1:] & (masked[1:] <= prev)
        n_bad = int(bad.sum())
        if n_bad:
            step, lane = (int(v) for v in bad.nonzero()[0])
            out.append(Violation(
                "kernel-scatter-race", cell,
                f"{n_bad} stream position(s) not above their lane's "
                f"earlier ones (first: lane {lane}, step {step + 1})"))
    return out


# ---------------------------------------------------------------------------
# The checked build's record and coverage (on the card)
# ---------------------------------------------------------------------------

def _check_entry(lib: str, name: str, argtypes):
    from ..kernels import build as B
    return B.entry(lib, name, argtypes, checked=True)


def reset_record(lib: str) -> None:
    from ..kernels import build as B
    B.check(_check_entry(lib, "rt_check_reset", [])(), "rt_check_reset")


def read_record(lib: str) -> Dict[str, int]:
    """The checked build's record of library ``lib``: the first
    violation's site, index and extent, and the count."""
    from ..kernels import build as B

    buf = (ctypes.c_longlong * 4)()
    B.check(_check_entry(lib, "rt_check_read",
                         [ctypes.POINTER(ctypes.c_longlong)])(buf),
            "rt_check_read")
    return dict(site=int(buf[0]), count=int(buf[1]), index=int(buf[2]),
                extent=int(buf[3]))


def set_coverage(lib: str, buf) -> None:
    """Count the covered writes of ``lib``'s kernels into ``buf`` (int32 on
    the card, zeroed), or none for ``None``."""
    from ..kernels import build as B

    fn = _check_entry(lib, "rt_check_coverage",
                      [ctypes.c_void_p, ctypes.c_longlong])
    B.check(fn(None if buf is None else ctypes.c_void_p(buf.data_ptr()),
               0 if buf is None else buf.numel()), "rt_check_coverage")


def checked_run(lib: str, fn, cover: int = 0):
    """Run ``fn()`` (launches of ``lib``'s checked build) with an empty
    record and, for ``cover`` > 0, a zeroed coverage buffer of that many
    elements; returns ``(result, record, coverage or None)`` after a
    synchronize."""
    import torch

    torch.cuda.synchronize()
    reset_record(lib)
    cov = None
    if cover:
        cov = torch.zeros(cover, dtype=torch.int32, device="cuda")
        set_coverage(lib, cov)
    try:
        result = fn()
        torch.cuda.synchronize()
    finally:
        if cover:
            set_coverage(lib, None)
    return result, read_record(lib), cov


def check_record(rec: Dict[str, int], cell: str) -> List[Violation]:
    """kernel-bounds: the record must be empty."""
    if rec["count"] == 0 and rec["site"] == 0:
        return []
    site = check_sites().get(rec["site"], f"site {rec['site']}")
    return [Violation("kernel-bounds", cell,
                      f"{rec['count']} out-of-range access(es); the first "
                      f"at {site}, index {rec['index']} of extent "
                      f"{rec['extent']}")]


def check_coverage(cov, cell: str) -> List[Violation]:
    """kernel-tiling at run time: every element written exactly once."""
    import torch

    zero = cov == 0
    many = cov > 1
    n_zero, n_many = int(zero.sum()), int(many.sum())
    if not n_zero and not n_many:
        return []
    first = int(torch.nonzero(zero | many)[0, 0])
    return [Violation("kernel-tiling", cell,
                      f"{n_zero} of {cov.numel()} output elements never "
                      f"written, {n_many} written more than once (the "
                      f"first at element {first})")]


# ---------------------------------------------------------------------------
# The six kernels' checked builds on a batch (on the card)
# ---------------------------------------------------------------------------

def kernel_launches(configs=None) -> Dict[str, List]:
    """For each kernel, the distinct launches among ``configs`` (default:
    every candidate), as the configs that make them: a config that changes
    only another kernel's knobs launches this kernel as the default does.
    The color kernel has no knob: one launch."""
    from ..kernels.autotune import DEFAULT_LAUNCH, candidate_configs

    configs = list(configs or candidate_configs())
    knobs = {"huffman_exits": ("exit_threads",),
             "huffman_streams": ("stream_threads",),
             "huffman_store": ("store_threads", "store_writer"),
             "fused_pixels": ("pixel_groups",), "idct": ("idct_groups",),
             "color": ()}
    out = {}
    for kernel, names in knobs.items():
        seen, kept = set(), []
        for c in [DEFAULT_LAUNCH] + configs:
            key = tuple(getattr(c, n) for n in names)
            if key not in seen:
                seen.add(key)
                kept.append(c)
        out[kernel] = kept
    return out


def verify_batch(dec, cell: str, configs=None, layouts=(), crops=(),
                 only: Optional[Sequence[str]] = None,
                 timings: Optional[Dict[str, List[float]]] = None,
                 time_fn=None) -> Tuple[List[Violation], int, List[str]]:
    """Every kernel of the decode of ``dec`` (a ``ParallelDecoder`` on the
    card) run by the checked build under each of its launches among
    ``configs``; returns (violations, launches checked, launches refused).

    Each checked launch must leave an empty record (kernel-bounds), write
    every output element of the IDCT, pixel and color kernels exactly once
    (kernel-tiling), and give the output of the release build under the
    same config, which must equal the plain version's (``torch.equal``).
    A launch the batch refuses with ``ValueError`` (a group count its
    layout does not divide, the warp writer below a warp of lanes) is
    listed, not run. The plan's segments are held disjoint and the write
    pass's streams to the scatter-race check. ``layouts``: more
    ``ParallelDecoder``s whose IDCT, pixel and color kernels are checked
    the same way (other sampling layouts); ``crops``: (height, width)
    crops of ``dec``'s color run; ``only``: the kernels to check (names
    of :func:`kernel_launches`; default all). With ``time_fn`` (the ms of
    a call), ``timings[kernel]`` gets [checked ms, release ms] of the
    default launch on ``dec``.
    """
    import torch

    from ..core import decode as D
    from ..core.state import DecodeState
    from ..core.sync import chain_entries, jacobi_sync
    from ..kernels.fused import store as FS
    from ..kernels.huffman import ops as HK

    launches = kernel_launches(configs)
    todo = set(only or launches) | ({"huffman_exits_idx"} if only is None
                                    or "huffman_exits" in only else set())
    out: List[Violation] = []
    refused: List[str] = []
    count = [0]
    sh, dev = dec.shape, dec.dev
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    budget = HK.EXIT_SMEM_BUDGET
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2,
                      decode_exits=lambda d, e: HK.run_exit_kernel(
                          d, meta, e, **kw, smem_budget=budget),
                      permuted=sh.permuted)
    entries = chain_entries(dev, res.exits, sh.permuted)
    cold = DecodeState.cold(dev["chunk_start"])
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    write_max = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    n_coef = sh.n_units * 64
    out += check_plan_disjoint(dec.plan, cell)

    def held(kernel, lib, cfg, checked_fn, release_fn, plain, cover=0,
             tag=""):
        """One checked launch against the release build and the plain
        version."""
        label = f"{cell} {kernel}{tag} {cfg.label()}"
        try:
            got, rec, cov = checked_run(lib, checked_fn, cover)
        except ValueError as e:  # a launch this batch refuses
            refused.append(f"{label}: {e}")
            return
        count[0] += 1
        out.extend(check_record(rec, label))
        if cov is not None:
            out.extend(check_coverage(cov, label))
        rel = release_fn()
        flat = lambda x: [x] if isinstance(x, torch.Tensor) else list(x)  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(rel))):
            out.append(Violation("kernel-bounds", label,
                                 "the checked build's output differs from "
                                 "the release build's"))
        if not all(torch.equal(a, b) for a, b in zip(flat(rel),
                                                      flat(plain))):
            out.append(Violation("kernel-bounds", label,
                                 "the release build's output differs from "
                                 "the plain version's"))
        if time_fn is not None and timings is not None and not tag and \
                cfg == launches.get(kernel, [cfg])[0] and \
                kernel not in timings:
            timings[kernel] = [time_fn(checked_fn), time_fn(release_fn)]

    if "huffman_exits" in todo:  # B1 over every lane, cold and chained
        for entry, tag in ((cold, " cold"), (entries, "")):
            plain = HK.decode_exits_plain(dev, meta, entry, **kw)
            for cfg in launches["huffman_exits"]:
                for b, where in ((budget, ""), (0, " global")):
                    held("huffman_exits", "huffman", cfg,
                         lambda: HK.run_exit_kernel(
                             dev, meta, entry, **kw, smem_budget=b,
                             launch=cfg, checked=True),
                         lambda: HK.run_exit_kernel(
                             dev, meta, entry, **kw, smem_budget=b,
                             launch=cfg), plain, tag=tag + where)
    if "huffman_exits_idx" in todo:  # B1 at every other lane
        idx = torch.arange(0, sh.n_chunks, 2, dtype=torch.int32,
                           device=entries.p.device)
        sub = DecodeState(*(f[idx.long()] for f in entries))
        plain = HK.decode_exits_plain(dev, meta, sub, idx, **kw)
        for cfg in launches["huffman_exits"]:
            held("huffman_exits_idx", "huffman", cfg,
                 lambda: HK.run_exit_kernel(dev, meta, sub, idx, **kw,
                                            smem_budget=budget, launch=cfg,
                                            checked=True),
                 lambda: HK.run_exit_kernel(dev, meta, sub, idx, **kw,
                                            smem_budget=budget, launch=cfg),
                 plain)
    plain = HK.decode_streams_plain(dev, meta, entries, **kw)
    out += check_scatter_targets(plain[0], plain[1], bases, write_max,
                                 n_coef, f"{cell} scatter_streams")
    if "huffman_streams" in todo:  # B2
        for cfg in launches["huffman_streams"]:
            held("huffman_streams", "huffman", cfg,
                 lambda: HK.run_stream_kernel(dev, meta, entries, **kw,
                                              smem_budget=budget, launch=cfg,
                                              checked=True),
                 lambda: HK.run_stream_kernel(dev, meta, entries, **kw,
                                              smem_budget=budget,
                                              launch=cfg), plain)
    coef = HK.scatter_streams(plain[0], plain[1], bases, write_max, n_coef)
    del plain
    if "huffman_store" in todo:  # B3
        for cfg in launches["huffman_store"]:
            held("huffman_store", "huffman", cfg,
                 lambda: FS.run_store_kernel(dev, meta, entries, bases,
                                             write_max, n_coef, **kw,
                                             smem_budget=budget, launch=cfg,
                                             checked=True),
                 lambda: FS.run_store_kernel(dev, meta, entries, bases,
                                             write_max, n_coef, **kw,
                                             smem_budget=budget, launch=cfg),
                 coef)
    units = D.undiff_dc(dev, coef.reshape(sh.n_units, 64))
    del coef
    units = units[:dec.plan.total_units].contiguous()
    _verify_pixels(dec, units, crops, launches, held, todo)
    for other in layouts:
        _verify_pixels(other, other.coefficients().coeffs.contiguous(), (),
                       launches, held, todo)
    return out, count[0], refused


def _verify_pixels(dec, units, crops, launches, held, todo) -> None:
    """B4, B5 and B6 of one batch's coefficients (``verify_batch``)."""
    from ..core import decode as D
    from ..kernels.color import ops as CK
    from ..kernels.fused import pixels as FP
    from ..kernels.idct import ops as IK

    g = dec.plan.geometry
    m_t = dec.dev["m_matrices_t"]
    mrow = dec.dev["unit_mrow"][:dec.plan.total_units]
    upm = g.units_per_mcu
    tag = "" if (g.h_max, g.v_max) == (2, 2) and len(g.comp_h) == 3 \
        else f" {tuple(g.comp_h)}x{tuple(g.comp_v)}"
    if len(g.comp_h) == 3 and "fused_pixels" in todo:
        geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
                   h_max=g.h_max, v_max=g.v_max, upm=upm)
        plain = FP.fused_pixels_plain(units, m_t, mrow, **geo)
        for cfg in launches["fused_pixels"]:
            held("fused_pixels", "pixels", cfg,
                 lambda: FP.run_pixel_kernel(units, m_t, mrow, **geo,
                                             launch=cfg, checked=True),
                 lambda: FP.run_pixel_kernel(units, m_t, mrow, **geo,
                                             launch=cfg),
                 plain, cover=plain.numel(), tag=tag)
        del plain
    if not {"idct", "color"} & set(todo):
        return
    pix = IK.idct_units_plain(units, m_t, mrow)
    if "idct" in todo:
        for cfg in launches["idct"]:
            held("idct", "idct", cfg,
                 lambda: IK.run_idct_kernel(units, m_t, mrow, upm, cfg,
                                            checked=True),
                 lambda: IK.run_idct_kernel(units, m_t, mrow, upm, cfg),
                 pix, cover=pix.numel(), tag=tag)
    if len(g.comp_h) != 3 or "color" not in todo:
        return
    comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                 for h, v in zip(g.comp_h, g.comp_v)]
    planes = D.assemble_planes(pix, dec.plan.n_images, dec._comp_unit_idx,
                               dec._comp_block_idx, comp_grid)
    del pix
    cfg = launches["color"][0]
    for height, width in ((g.height, g.width),) + tuple(crops):
        cgeo = (g.comp_h, g.comp_v, g.h_max, g.v_max, height, width)
        plain = CK.upsample_color_plain(planes, *cgeo)
        crop = "" if (height, width) == (g.height, g.width) \
            else f" crop {width}x{height}"
        held("color", "color", cfg,
             lambda: CK.run_color_kernel(planes, *cgeo, checked=True),
             lambda: CK.run_color_kernel(planes, *cgeo), plain,
             cover=plain.numel(), tag=tag + crop)


# ---------------------------------------------------------------------------
# Seeded-fault self-test
# ---------------------------------------------------------------------------

def dup_scatter_case(device="cpu"):
    """A write pass whose scatter has a duplicate target: two lanes of one
    segment given one write base, each recording positions 0..3."""
    import torch

    pos = torch.arange(4, dtype=torch.int32, device=device)[:, None] \
        .repeat(1, 2).contiguous()
    val = torch.ones_like(pos)
    base = torch.zeros(2, dtype=torch.int32, device=device)
    wmax = torch.full((2,), 63, dtype=torch.int32, device=device)
    return pos, val, base, wmax, 64


def run_self_test(verbose: bool = False, device: str = "cuda",
                  seed: int = 0) -> Tuple[List[str], List[Violation]]:
    """Prove the verifier catches its seeded faults: S1 by kernel-bounds,
    S2 and S3 by kernel-tiling, a duplicate-index scatter by
    kernel-scatter-race. Returns ``(failures, caught)``: what was not
    caught, and the violations that caught the rest. On ``device="cpu"``
    the seeds' plain versions make the faults (S1 raises ``IndexError``,
    S2 and S3 leave elements unwritten)."""
    import numpy as np
    import torch

    from ..kernels import seeds as S

    failures: List[str] = []
    caught: List[Violation] = []
    rng = np.random.default_rng(seed)

    def expect(family, vs, what):
        hit = [v for v in vs if v.family == family]
        if hit:
            caught.append(hit[0])
            if verbose:
                print(f"self-test {what} caught: {hit[0].format()}")
        else:
            failures.append(f"seeded {what} not caught by {family}")

    # S1: the off-by-one row read
    x = torch.from_numpy(rng.integers(-8, 9, (S.ROWS, S.COLS)).astype(
        np.float32)).to(device)
    if device == "cpu":
        try:
            S.seed_oob_rows(x)
            vs = []
        except IndexError as e:
            vs = [Violation("kernel-bounds", "self-test:oob-rows (plain)",
                            f"IndexError: {e}")]
    else:
        _, rec, _ = checked_run("seeds", lambda: S.seed_oob_rows(x))
        vs = check_record(rec, "self-test:oob-rows")
    expect("kernel-bounds", vs, "off-by-one row read (S1)")

    # S2: the copy grid that stops short
    x = torch.from_numpy(rng.integers(-8, 9, S.IDENT_N).astype(
        np.float32)).to(device)
    if device == "cpu":
        _, cov = S.seed_ident_plain(x)
    else:
        _, rec, cov = checked_run("seeds", lambda: S.seed_ident(x),
                                  cover=S.IDENT_N)
        caught_b = check_record(rec, "self-test:short-copy")
        if caught_b:
            failures.append("S2 touched memory out of bounds: "
                            + caught_b[0].detail)
    vs = check_coverage(cov, "self-test:short-copy")
    _cover(S.IDENT_N, S.IDENT_TILE, S.IDENT_BLOCKS,
           "self-test:short-copy (geometry)", "elements by blocks", vs)
    expect("kernel-tiling", vs, "non-covering copy grid (S2)")

    # S3: the pixel kernel on a misaligned tile
    coeffs, m_t, mrow, geo = S.seed_pixel_operands(device, seed)
    n_bytes = S.TILE_N_MCUS * 64 * geo["h_max"] * geo["v_max"] * 3
    if device == "cpu":
        _, cov = S.seed_misaligned_tile_plain(coeffs, m_t, mrow, **geo)
    else:
        _, rec, cov = checked_run(
            "pixels", lambda: S.seed_misaligned_tile(coeffs, m_t, mrow,
                                                     **geo), cover=n_bytes)
        caught_b = check_record(rec, "self-test:misaligned-tile")
        if caught_b:
            failures.append("S3 touched memory out of bounds: "
                            + caught_b[0].detail)
    vs = check_coverage(cov, "self-test:misaligned-tile")
    _cover(S.TILE_N_MCUS, S.TILE_MCUS, S.TILE_BLOCKS,
           "self-test:misaligned-tile (geometry)", "MCUs by tiles", vs)
    expect("kernel-tiling", vs, "misaligned pixel tile (S3)")

    # the duplicate-index scatter
    vs = check_scatter_targets(*dup_scatter_case(device),
                               "self-test:dup-scatter")
    expect("kernel-scatter-race", vs, "duplicate scatter index")
    return failures, caught


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def tier0_batches() -> List[Tuple[str, list, int]]:
    """(name, blobs, chunk_bits) of the verifier's small cells, as the JAX
    verifier's tier-0 grid: a restart cell framed in small chunks (segments
    over several lanes), a plain one at the default framing, and two
    frames at 4:2:2 and 4:4:4 for the pixel and color kernels' layouts."""
    import numpy as np

    from ..jpeg import codec_ref as cr
    from ..jpeg.encoder import synth_frame

    rng = np.random.default_rng(0)
    rst = [cr.encode_baseline(synth_frame(rng, 48, 32, t=0.3 * i),
                              quality=75, restart_interval=2).jpeg_bytes
           for i in range(2)]
    one = [cr.encode_baseline(synth_frame(rng, 64, 64, t=0.7),
                              quality=90).jpeg_bytes]
    lay = {s: [cr.encode_baseline(synth_frame(rng, 40, 24, t=0.9),
                                  quality=85, subsampling=s).jpeg_bytes]
           for s in ("4:2:2", "4:4:4")}
    return [("t0-restart", rst, 128), ("t0-plain", one, 1024),
            ("t0-422", lay["4:2:2"], 256), ("t0-444", lay["4:4:4"], 256)]


def run(self_test: bool = False, verbose: bool = False) -> int:
    """The whole verifier: the host geometry, then the checked build of
    every kernel under every launch candidate on the tier-0 cells, then
    (``self_test``) the seeded faults. Needs a card; returns the exit
    code."""
    import torch

    from ..core.api import ParallelDecoder

    if not torch.cuda.is_available():
        raise RuntimeError("the kernel verifier runs the checked build on "
                           "the card: no CUDA device")
    violations, n_cells = check_geometry()
    if verbose:
        print(f"host geometry: {n_cells} cells")
    decs = {name: ParallelDecoder.from_bytes(blobs, chunk_bits=bits,
                                             device="cuda", bucket=False)
            for name, blobs, bits in tier0_batches()}
    main = [n for n in decs if n in ("t0-restart", "t0-plain")]
    for name in main:
        layouts = [decs[n] for n in decs if n not in main] \
            if name == "t0-plain" else []
        g = decs[name].plan.geometry
        crops = [(g.height - 2, g.width - 3)] if name == "t0-plain" else []
        vs, n, refused = verify_batch(decs[name], name, layouts=layouts,
                                      crops=crops)
        violations += vs
        n_cells += n
        if verbose:
            print(f"checked {name}: {n} launches, {len(refused)} refused")
            for r in refused:
                print(f"  refused {r}")
    if self_test:
        failures, _ = run_self_test(verbose=verbose)
        for f in failures:
            violations.append(Violation("self-test", "seeded", f))
        if not failures:
            print("self-test: all 4 seeded faults caught (off-by-one row "
                  "read, non-covering copy grid, misaligned pixel tile, "
                  "duplicate scatter index)")
    for v in violations:
        print(v.format())
    print(f"{len(violations)} kernel-contract violation"
          f"{'s' if len(violations) != 1 else ''} across {n_cells} cells "
          f"(families: {', '.join(contracts.KERNEL_CHECK_FAMILIES)})")
    return 1 if violations else 0

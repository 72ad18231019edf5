"""The exit and stream-write kernels: wrappers, plain versions, scatter.

:func:`decode_exits` is the sync-phase decode (one call per sync round,
over every lane or, for faithful sync's chains, a gathered subset) and
:func:`decode_streams` the write pass of ``fuse="post"``: per lane and
per symbol step, the local zig-zag offset and the coefficient, which
:func:`scatter_streams` places. The kernels are
``csrc/huffman.cu``; each wrapper takes its plain version only for
tensors on the CPU and otherwise launches the kernel or raises.

Operands: ``dev`` holds ``words`` (int32 bits of the uint32 words),
``luts`` and ``unit_lut_row`` (the plain versions'), and the kernels'
compact tables ``luts_compact`` and ``unit_lut_off`` (:func:`exit_tables`
of a plan's tensors; ``core.api.ParallelDecoder`` on the kernel backend
takes them from ``core.api.lut_tables``, made once per distinct LUT set;
the exit, stream and store kernels all read them); ``meta`` is
``core.decode.chunk_meta(dev)`` (per-lane ``word_base``, ``limit``,
``ts``, ``upm``); ``entry`` is the lanes' entry state. ``out=`` hands a
wrapper buffers of its result's shape to write into (the ones a
``core.api.DecodeProgram`` holds), which it returns; the plain versions
copy their result into them. ``launch=`` (a ``kernels.autotune.
LaunchConfig``) gives the kernels' block sizes; the ``run_*`` launches
also take ``checked=True``, the checked build of the kernel verifier
(``kernels/build.py``), which the counted wrappers never load.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...core import decode as D
from ...core.contracts import INT32_MAX
from ...core.state import DecodeState
from .. import build as B
from ..autotune import DEFAULT_LAUNCH, LaunchConfig

Dev = Dict[str, torch.Tensor]
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rt_decode_exits": [_VP, _I, _VP, _I, _VP, _I] + [_VP] * 11 + [_I] * 5
    + [_VP],
    "rt_decode_streams": [_VP, _I, _VP, _I, _VP, _I] + [_VP] * 9
    + [_I] * 5 + [_VP],
    "rt_decode_store": [_VP, _I, _VP, _I, _VP, _I] + [_VP] * 10
    + [_LL] + [_I] * 6 + [_VP],
    "rt_graph_nodes": [_VP, _VP, _I],
}

# The shared memory the exit, stream and store kernels may give their
# tables (bytes). The four standard tables of a color batch take about
# 7 KB; the registers let an SM hold 8 exit-kernel blocks of 256 threads
# (2 stream blocks of 1024), and 8 x 24 KB still fits its 228 KB of
# shared memory, so tables within the budget cost those two no occupancy
# (the store kernel's unit slots come on top). Larger tables are read
# from global memory by the same kernel.
EXIT_SMEM_BUDGET = 24 * 1024

# compact tables: the window's top 9 bits index a row's primary table; a
# primary entry that points to a secondary (code length 0, not 0) gives
# the secondary's start, in units of 2^7 entries from the row's start
PRIMARY_BITS, SECONDARY_BITS = 9, 7


def compact_luts(luts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (L, 65536) int32 LUTs as two-level uint16 tables.

    Returns ``(tab, start)``: ``tab`` (int16, the uint16 bits) holds, row
    after row, a primary of 2^9 entries, one per 9-bit prefix of the
    window, then the row's secondaries of 2^7 entries; ``start`` (L,)
    int32 is each row's offset in ``tab``. Where the 2^7 windows under a
    prefix share one entry, the primary holds it; otherwise it holds
    ``(4 + k) << 5`` for the row's k-th secondary, which starts at
    ``start + (4 + k) * 2^7``. A LUT entry has code length 0 only for the
    invalid window, and is 0 there, so the two cannot be confused; the
    table is lossless (``tests/test_torch_lut.py`` expands it back).
    """
    if luts.dim() != 2 or luts.shape[1] != 1 << 16:
        raise ValueError(f"luts must be (L, 65536), got {tuple(luts.shape)}")
    luts = luts.to(torch.int32)
    if bool(((luts < 0) | (luts > 0xFFFF)).any()) or \
            bool((((luts & 0x1F) == 0) & (luts != 0)).any()):
        raise ValueError("a LUT entry does not fit the compact table: "
                         "entries must be 16-bit, and 0 where the code "
                         "length is 0")
    n = luts.shape[0]
    blocks = luts.reshape(n, 1 << PRIMARY_BITS, 1 << SECONDARY_BITS)
    uniform = (blocks == blocks[..., :1]).all(-1)
    split = ~uniform
    first = (1 << PRIMARY_BITS) >> SECONDARY_BITS  # the primary's 4 units
    pointer = (torch.cumsum(split.to(torch.int32), 1) - 1 + first) << 5
    primary = torch.where(uniform, blocks[..., 0], pointer)
    rows = [torch.cat([primary[r], blocks[r][split[r]].reshape(-1)])
            for r in range(n)]
    sizes = torch.tensor([len(r) for r in rows], dtype=torch.int64)
    start = torch.cumsum(sizes, 0) - sizes
    tab = torch.cat(rows)
    tab = torch.where(tab >= 1 << 15, tab - (1 << 16), tab).to(torch.int16)
    return tab, start.to(torch.int32)


def exit_tables(dev: Dev) -> Dev:
    """The exit kernel's tables for a plan's tensors ``dev``:
    ``luts_compact`` (:func:`compact_luts` of ``dev["luts"]``) and
    ``unit_lut_off``, the start of each ``unit_lut_row`` entry's row in
    it. Made once per plan; add them to ``dev``."""
    tab, start = compact_luts(dev["luts"])
    rows = dev["unit_lut_row"].to(torch.int64)
    return {"luts_compact": tab,
            "unit_lut_off": start.to(rows.device)[rows]}


def kernel_fn(name: str, checked: bool = False):
    """The C entry point ``name`` of ``csrc/huffman.cu``, typed (of the
    checked build with ``checked``)."""
    return B.entry("huffman", name, _SIGNATURES[name], checked)


def copy_into(out, result):
    """``result`` (a tensor or a tuple of them) copied into ``out`` of the
    same structure, which is returned; ``result`` itself without ``out``."""
    if out is None:
        return result
    if isinstance(out, torch.Tensor):
        return out.copy_(result)
    for o, r in zip(out, result):
        o.copy_(r)
    return out


def check_out(tensors, shape, device) -> None:
    """Refuse an ``out=`` buffer a kernel cannot write: each tensor must be
    contiguous int32 of ``shape`` on ``device``."""
    for t in tensors:
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or \
                t.device != device or not t.is_contiguous():
            raise ValueError(f"out buffers must be contiguous int32 "
                             f"{tuple(shape)} tensors on {device}")


def _checked_ptrs(words: torch.Tensor, tables: list, dtypes: list,
                  meta: Dev, entry: DecodeState) -> Tuple[list, list]:
    """Check that ``tables`` (of ``dtypes``) and the lanes' int32 metadata
    and entries are contiguous on the words' device, the lane operands of
    one shape (C,); return the pointers of tables, then lanes."""
    c = entry.p.shape[0]
    lane = [meta["word_base"], meta["ts"], meta["limit"], meta["upm"],
            entry.p, entry.u, entry.z]
    for t, dt in zip([words] + tables + lane,
                     [torch.int32] + dtypes + [torch.int32] * len(lane)):
        if t.device != words.device or t.dtype != dt or \
                not t.is_contiguous():
            raise ValueError(
                f"kernel operands must be contiguous {dt} tensors on "
                f"{words.device}; got {t.dtype} on {t.device}")
    if any(t.shape != (c,) for t in lane):
        raise ValueError(f"per-lane operands must all have shape ({c},)")
    return [B.ptr(t) for t in tables], [B.ptr(t) for t in lane]


def exit_args(dev: Dev, meta: Dev, entry: DecodeState) -> list:
    """The exit, stream and store kernels' operands, checked, as C
    arguments: their compact tables in place of the LUTs."""
    if "luts_compact" not in dev:
        raise ValueError("the exit, stream and store kernels need their "
                         "compact tables: add exit_tables(dev) to the "
                         "plan's tensors once")
    words, tab, off = dev["words"], dev["luts_compact"], dev["unit_lut_off"]
    (tab_p, off_p), lane = _checked_ptrs(
        words, [tab, off], [torch.int16, torch.int32], meta, entry)
    if tab.numel() % (1 << SECONDARY_BITS) or tab.data_ptr() % 16 or \
            off.shape[1:] != (6, 2):
        raise ValueError("luts_compact must be 16-byte aligned rows of 2^7 "
                         "entries and unit_lut_off (TS, 6, 2)")
    return [B.ptr(words), int(words.shape[0]), tab_p, tab.numel(), off_p,
            off.numel()] + lane


def exit_table_bytes(dev: Dev) -> int:
    """Shared memory the kernels' tables take: compact tables and row
    starts."""
    return 2 * dev["luts_compact"].numel() + 4 * dev["unit_lut_off"].numel()


# ---------------------------------------------------------------------------
# Exit decode (sync phase)
# ---------------------------------------------------------------------------

def lane_subset(meta: Dev, idx: Optional[torch.Tensor]) -> Dev:
    """``meta`` gathered at the lanes ``idx`` (all lanes for ``None``):
    the same values as ``core.decode.chunk_meta(dev, idx)``."""
    if idx is None:
        return meta
    idx = idx.to(torch.int64)
    return {k: v[idx] for k, v in meta.items()}


def decode_exits_plain(dev: Dev, meta: Dev, entry: DecodeState,
                       idx: Optional[torch.Tensor] = None, *, s_max: int,
                       min_code_bits: int,
                       out: Optional[DecodeState] = None) -> DecodeState:
    """Exit (p, u, z, n) of every lane, or of the lanes ``idx`` (one per
    entry, repeats allowed): ``core.decode.decode_span``."""
    m = lane_subset(meta, idx)
    st, _ = D.decode_span(dev, entry, m["word_base"], m["limit"], m["ts"],
                          m["upm"], s_max=s_max, min_code_bits=min_code_bits)
    return copy_into(out, st)


def run_exit_kernel(dev: Dev, meta: Dev, entry: DecodeState,
                    idx: Optional[torch.Tensor] = None, *, s_max: int,
                    min_code_bits: int, smem_budget: int,
                    out: Optional[DecodeState] = None,
                    launch: LaunchConfig = DEFAULT_LAUNCH,
                    checked: bool = False) -> DecodeState:
    """One launch of the exit kernel (``rt_decode_exits``), uncounted, in
    blocks of ``launch.exit_threads``.

    The tables go to shared memory when :func:`exit_table_bytes` is at
    most ``smem_budget``, else the kernel reads them from global memory.
    :func:`decode_exits` passes ``EXIT_SMEM_BUDGET``.
    """
    args = exit_args(dev, lane_subset(meta, idx), entry)
    c = entry.p.shape[0]
    if out is None:
        out = DecodeState(*(torch.empty_like(entry.p) for _ in range(4)))
    check_out(out, (c,), entry.p.device)
    B.check(kernel_fn("rt_decode_exits", checked)(
        *args, *(B.ptr(t) for t in out), c, s_max, min_code_bits,
        smem_budget, launch.exit_threads, B.stream_of(entry.p)),
        "rt_decode_exits")
    return out


def decode_exits(dev: Dev, meta: Dev, entry: DecodeState,
                 idx: Optional[torch.Tensor] = None, *, s_max: int,
                 min_code_bits: int,
                 out: Optional[DecodeState] = None,
                 launch: LaunchConfig = DEFAULT_LAUNCH) -> DecodeState:
    """:func:`decode_exits_plain`, by the exit kernel on the card.

    The ``idx`` form (faithful sync's ``decode_at``) runs the same kernel
    over ``len(idx)`` lanes whose metadata is gathered at ``idx``, as the
    JAX wrapper's ``_lane_meta`` does. ``launches`` counts the full-lane
    form and ``subset_launches`` the ``idx`` form, each only its own.
    """
    if dev["words"].device.type == "cpu":
        return decode_exits_plain(dev, meta, entry, idx, s_max=s_max,
                                  min_code_bits=min_code_bits, out=out)
    out = run_exit_kernel(dev, meta, entry, idx, s_max=s_max,
                          min_code_bits=min_code_bits,
                          smem_budget=EXIT_SMEM_BUDGET, out=out,
                          launch=launch)
    if idx is None:
        decode_exits.launches += 1
    else:
        decode_exits.subset_launches += 1
    return out


decode_exits.launches = 0
decode_exits.subset_launches = 0


# ---------------------------------------------------------------------------
# Write pass, stream form: (pos, val) per step, then a scatter
# ---------------------------------------------------------------------------

def decode_streams_plain(dev: Dev, meta: Dev, entry: DecodeState, *,
                         s_max: int, min_code_bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos, val)``, each (s_max, C) int32: step ``i`` of a lane wrote
    ``val[i]`` at local offset ``pos[i]``, or nothing where ``pos`` is -1
    (then ``val`` is 0)."""
    words64 = D.widen_words(dev["words"])
    st = DecodeState(entry.p, entry.u, entry.z, torch.zeros_like(entry.p))
    pos, val = [], []
    for _ in range(s_max):
        o = D.decode_symbol(words64, dev["luts"], dev["unit_lut_row"], st,
                            meta["word_base"], meta["limit"], meta["ts"],
                            meta["upm"], min_code_bits)
        rec = o.active & ~o.invalid
        pos.append(torch.where(rec, st.n + o.run, -1))
        val.append(torch.where(rec, o.coef, 0))
        st = o.state
    return torch.stack(pos), torch.stack(val)


def run_stream_kernel(dev: Dev, meta: Dev, entry: DecodeState, *,
                      s_max: int, min_code_bits: int, smem_budget: int,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      launch: LaunchConfig = DEFAULT_LAUNCH,
                      checked: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the stream kernel (``rt_decode_streams``), uncounted,
    in blocks of ``launch.stream_threads``.

    Its tables go to shared memory when :func:`exit_table_bytes` is at
    most ``smem_budget``, else the kernel reads them from global memory.
    :func:`decode_streams` passes ``EXIT_SMEM_BUDGET``.
    """
    args = exit_args(dev, meta, entry)
    c = entry.p.shape[0]
    if out is None:
        out = tuple(torch.empty((s_max, c), dtype=torch.int32,
                                device=entry.p.device) for _ in range(2))
    check_out(out, (s_max, c), entry.p.device)
    pos, val = out
    B.check(kernel_fn("rt_decode_streams", checked)(
        *args, B.ptr(pos), B.ptr(val), c, s_max, min_code_bits, smem_budget,
        launch.stream_threads, B.stream_of(pos)), "rt_decode_streams")
    return pos, val


def decode_streams(dev: Dev, meta: Dev, entry: DecodeState, *, s_max: int,
                   min_code_bits: int,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   launch: LaunchConfig = DEFAULT_LAUNCH
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_streams_plain`, by the stream kernel on the card."""
    if dev["words"].device.type == "cpu":
        return copy_into(out, decode_streams_plain(
            dev, meta, entry, s_max=s_max, min_code_bits=min_code_bits))
    out = run_stream_kernel(dev, meta, entry, s_max=s_max,
                            min_code_bits=min_code_bits,
                            smem_budget=EXIT_SMEM_BUDGET, out=out,
                            launch=launch)
    decode_streams.launches += 1
    return out


decode_streams.launches = 0


def scatter_streams(pos: torch.Tensor, val: torch.Tensor,
                    write_base: torch.Tensor, write_max: torch.Tensor,
                    n_coef: int, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Place the streams: ``out[write_base + pos] = val`` where ``pos >= 0``
    and the target is within the lane's clamp ``write_max``.

    Targets are unique by construction (positions strictly increase within
    a lane; lanes own disjoint ranges). A dropped write of lane ``j`` goes
    to its own sentinel slot ``n_coef + j`` past the end, sliced off, so
    that the dropped writes of a warp's consecutive lanes fall on
    consecutive words instead of all on one. The target is computed once,
    in int32 where ``n_coef + C`` fits (the planner keeps ``write_base +
    pos`` within int32 for every recorded step: ``contracts.
    checked_coeff_capacity``); ``index_put`` widens it to int64 itself,
    which measured cheaper than computing it in int64 (PERF.md).
    ``out``, ``n_coef + C`` int32, is zeroed and written in place of a
    new buffer; the result is its first ``n_coef`` entries.
    """
    c = pos.shape[1]
    dt = torch.int32 if n_coef + c <= INT32_MAX else torch.int64
    base = write_base.to(dt)
    room = (write_max - write_base).to(dt)  # the last in-range pos
    sentinel = torch.arange(n_coef, n_coef + c, dtype=dt, device=pos.device)
    tgt = torch.where((pos >= 0) & (pos <= room), pos + base, sentinel)
    if out is None:
        out = torch.zeros(n_coef + c, dtype=torch.int32, device=pos.device)
    else:
        check_out((out,), (n_coef + c,), pos.device)
        out.zero_()
    out[tgt.reshape(-1)] = val.reshape(-1)
    return out[:n_coef]


def decode_coeffs(dev: Dev, meta: Dev, entry: DecodeState,
                  write_base: torch.Tensor, write_max: torch.Tensor,
                  n_coef: int, *, s_max: int, min_code_bits: int,
                  streams: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  out: Optional[torch.Tensor] = None,
                  launch: LaunchConfig = DEFAULT_LAUNCH) -> torch.Tensor:
    """The ``fuse="post"`` write pass: streams, then the scatter
    (``streams`` and ``out`` the buffers of each)."""
    pos, val = decode_streams(dev, meta, entry, s_max=s_max,
                              min_code_bits=min_code_bits, out=streams,
                              launch=launch)
    return scatter_streams(pos, val, write_base, write_max, n_coef, out)


# ---------------------------------------------------------------------------
# The graph reader (the traced-program checker's, analysis/trace_check.py)
# ---------------------------------------------------------------------------

#: int64 words a node takes in :func:`graph_nodes` (csrc/huffman.cu
#: ``kNodeWords``): type; kernel: 1 for the exit kernel, 0 for another, -err
#: for one the exit kernel's runtime cannot read; copy: source and
#: destination memory types and the copy's kind; an exit node's lane
#: count (word 3) and its pointer operands (words 4-17, ``EXIT_NODE_POINTERS``)
NODE_WORDS = 18
EXIT_NODE_POINTERS = ("words", "word_base", "ts", "limit", "upm", "in_p",
                      "in_u", "in_z", "luts_compact", "unit_lut_off",
                      "out_p", "out_u", "out_z", "out_n")


def graph_nodes(graph) -> torch.Tensor:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) as ``rt_graph_nodes`` reads them: an (N,
    :data:`NODE_WORDS`) int64 CPU tensor, a row a node."""
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    cap = 64
    while True:
        out = torch.zeros((cap, NODE_WORDS), dtype=torch.int64)
        n = kernel_fn("rt_graph_nodes")(raw, ctypes.c_void_p(out.data_ptr()),
                                        cap)
        if n < 0:
            raise RuntimeError(f"rt_graph_nodes failed with CUDA error {-n}")
        if n <= cap:
            return out[:n]
        cap = n


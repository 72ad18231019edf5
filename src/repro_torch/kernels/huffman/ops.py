"""The exit and stream-write kernels: wrappers, plain versions, scatter.

:func:`decode_exits` is the sync-phase decode (one call per sync round,
over every lane or, for faithful sync's chains, a gathered subset) and
:func:`decode_streams` the write pass of ``fuse="post"``: per lane and
per symbol step, the local zig-zag offset and the coefficient, which
:func:`scatter_streams` places. The kernels are
``csrc/huffman.cu``; each wrapper takes its plain version only for
tensors on the CPU and otherwise launches the kernel or raises.

Operands: ``dev`` holds ``words`` (int32 bits of the uint32 words),
``luts`` and ``unit_lut_row``, and for the exit kernel its compact
tables ``luts_compact`` and ``unit_lut_off`` (:func:`exit_tables`, added
once per plan by ``core.api.ParallelDecoder`` on the kernel backend);
``meta`` is
``core.decode.chunk_meta(dev)`` (per-lane ``word_base``, ``limit``,
``ts``, ``upm``); ``entry`` is the lanes' entry state.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...core import decode as D
from ...core.state import DecodeState
from .. import build as B

Dev = Dict[str, torch.Tensor]
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LANE_ARGS = [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
_SIGNATURES = {
    "rt_decode_exits": [_VP, _I, _VP, _I, _VP, _I] + [_VP] * 11 + [_I] * 4
    + [_VP],
    "rt_decode_streams": _LANE_ARGS + [_VP] * 2 + [_I, _I, _I, _VP],
    "rt_decode_store": _LANE_ARGS + [_VP] * 3 + [_LL, _I, _I, _I, _VP],
}

# The shared memory the exit kernel may give its tables (bytes). The four
# standard tables of a color batch take about 7 KB; at its 256 threads a
# block the registers let an SM hold 8 blocks, and 8 x 24 KB still fits its
# 228 KB of shared memory, so tables within the budget cost no occupancy.
# Larger tables are read from global memory by the same kernel.
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


def kernel_fn(name: str):
    """The C entry point ``name`` of ``csrc/huffman.cu``, typed."""
    return B.entry("huffman", name, _SIGNATURES[name])


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


def lane_args(dev: Dev, meta: Dev, entry: DecodeState) -> list:
    """The stream and store kernels' operands, checked, as C arguments."""
    words, luts, rows = dev["words"], dev["luts"], dev["unit_lut_row"]
    tables, lane = _checked_ptrs(words, [luts, rows], [torch.int32] * 2,
                                 meta, entry)
    if luts.shape[1:] != (1 << 16,) or rows.shape[1:] != (6, 2):
        raise ValueError("luts must be (L, 65536) and unit_lut_row (TS, 6, 2)")
    return [B.ptr(words), int(words.shape[0])] + tables + lane


def exit_args(dev: Dev, meta: Dev, entry: DecodeState) -> list:
    """The exit kernel's operands, checked, as C arguments: its compact
    tables in place of the LUTs."""
    if "luts_compact" not in dev:
        raise ValueError("the exit kernel needs its compact tables: add "
                         "exit_tables(dev) to the plan's tensors once")
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
    """Shared memory the exit kernel's tables take: compact tables and
    row starts."""
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
                       min_code_bits: int) -> DecodeState:
    """Exit (p, u, z, n) of every lane, or of the lanes ``idx`` (one per
    entry, repeats allowed): ``core.decode.decode_span``."""
    m = lane_subset(meta, idx)
    st, _ = D.decode_span(dev, entry, m["word_base"], m["limit"], m["ts"],
                          m["upm"], s_max=s_max, min_code_bits=min_code_bits)
    return st


def run_exit_kernel(dev: Dev, meta: Dev, entry: DecodeState,
                    idx: Optional[torch.Tensor] = None, *, s_max: int,
                    min_code_bits: int, smem_budget: int) -> DecodeState:
    """One launch of the exit kernel (``rt_decode_exits``), uncounted.

    The tables go to shared memory when :func:`exit_table_bytes` is at
    most ``smem_budget``, else the kernel reads them from global memory.
    :func:`decode_exits` passes ``EXIT_SMEM_BUDGET``.
    """
    args = exit_args(dev, lane_subset(meta, idx), entry)
    c = entry.p.shape[0]
    out = DecodeState(*(torch.empty_like(entry.p) for _ in range(4)))
    B.check(kernel_fn("rt_decode_exits")(
        *args, *(B.ptr(t) for t in out), c, s_max, min_code_bits,
        smem_budget, B.stream_of(entry.p)), "rt_decode_exits")
    return out


def decode_exits(dev: Dev, meta: Dev, entry: DecodeState,
                 idx: Optional[torch.Tensor] = None, *, s_max: int,
                 min_code_bits: int) -> DecodeState:
    """:func:`decode_exits_plain`, by the exit kernel on the card.

    The ``idx`` form (faithful sync's ``decode_at``) runs the same kernel
    over ``len(idx)`` lanes whose metadata is gathered at ``idx``, as the
    JAX wrapper's ``_lane_meta`` does. ``launches`` counts the full-lane
    form and ``subset_launches`` the ``idx`` form, each only its own.
    """
    if dev["words"].device.type == "cpu":
        return decode_exits_plain(dev, meta, entry, idx, s_max=s_max,
                                  min_code_bits=min_code_bits)
    out = run_exit_kernel(dev, meta, entry, idx, s_max=s_max,
                          min_code_bits=min_code_bits,
                          smem_budget=EXIT_SMEM_BUDGET)
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


def decode_streams(dev: Dev, meta: Dev, entry: DecodeState, *, s_max: int,
                   min_code_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_streams_plain`, by the stream kernel on the card."""
    if dev["words"].device.type == "cpu":
        return decode_streams_plain(dev, meta, entry, s_max=s_max,
                                    min_code_bits=min_code_bits)
    args = lane_args(dev, meta, entry)
    c = entry.p.shape[0]
    pos = torch.empty((s_max, c), dtype=torch.int32, device=entry.p.device)
    val = torch.empty_like(pos)
    B.check(kernel_fn("rt_decode_streams")(
        *args, B.ptr(pos), B.ptr(val), c, s_max, min_code_bits,
        B.stream_of(pos)), "rt_decode_streams")
    decode_streams.launches += 1
    return pos, val


decode_streams.launches = 0


def scatter_streams(pos: torch.Tensor, val: torch.Tensor,
                    write_base: torch.Tensor, write_max: torch.Tensor,
                    n_coef: int) -> torch.Tensor:
    """Place the streams: ``out[write_base + pos] = val`` where ``pos >= 0``
    and the target is within the lane's clamp ``write_max``.

    Targets are unique by construction (positions strictly increase within
    a lane; lanes own disjoint ranges), and every dropped write goes to one
    sentinel slot past the end that is sliced off.
    """
    tgt = write_base[None, :].to(torch.int64) + pos
    ok = (pos >= 0) & (tgt <= write_max[None, :])
    tgt = torch.where(ok, tgt, n_coef)
    out = torch.zeros(n_coef + 1, dtype=torch.int32, device=pos.device)
    out[tgt.reshape(-1)] = val.reshape(-1)
    return out[:n_coef]


def decode_coeffs(dev: Dev, meta: Dev, entry: DecodeState,
                  write_base: torch.Tensor, write_max: torch.Tensor,
                  n_coef: int, *, s_max: int,
                  min_code_bits: int) -> torch.Tensor:
    """The ``fuse="post"`` write pass: streams, then the scatter."""
    pos, val = decode_streams(dev, meta, entry, s_max=s_max,
                              min_code_bits=min_code_bits)
    return scatter_streams(pos, val, write_base, write_max, n_coef)

"""Plain PyTorch decoder: the reference version of every decode stage.

A port of the JAX package's ``core/decode.py``. The decode primitive is
:func:`decode_span`: a lane-vectorized version of the paper's
``decode_subsequence`` (Algorithm 2), one lane per chunk, one Huffman
symbol per lane per loop step via a 16-bit-lookahead LUT gather. The CUDA
kernels under ``repro_torch.kernels`` compute the same functions; these
versions run on any device and are what the kernels are held against.

Three things differ from the JAX original:

* torch has no ``>>``/``<<`` for ``uint32``, so the packed words (int32
  tensors of the same bits) are widened to int64 and masked;
* torch has no scatter ``mode="drop"``, so dropped writes go to one
  sentinel slot past the end that is sliced off;
* torch has no ``associative_scan``, so the segmented scans are a
  ``cumsum`` minus its value at each segment's start, gathered with the
  start index the plan gives (``bitstream.derived_arrays``), in int64.

All functions take ``dev``, the plan's tensors (``bitstream.dev_from_numpy``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..jpeg import tables as T
from .state import DecodeState

WORD_MASK = 0xFFFFFFFF
Dev = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Bit window fetch
# ---------------------------------------------------------------------------

def widen_words(words: torch.Tensor) -> torch.Tensor:
    """The packed uint32 words (held as int32 bits) as non-negative int64."""
    return words.to(torch.int64) & WORD_MASK


def fetch_window32(words64: torch.Tensor, word_base: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    """32-bit MSB-aligned window starting at bit `p` of each lane's segment.

    ``words64`` comes from :func:`widen_words`. Word indices past the end
    clamp to the last word, as JAX's gathers do.
    """
    last = words64.shape[0] - 1
    w = (word_base + (p >> 5)).to(torch.int64)
    off = (p & 31).to(torch.int64)
    hi = words64[w.clamp(0, last)]
    lo = words64[(w + 1).clamp(0, last)]
    lo_shift = torch.where(off == 0, 0, lo >> ((32 - off) & 31))
    return ((hi << off) & WORD_MASK) | lo_shift


# ---------------------------------------------------------------------------
# One symbol decode step (vectorized over lanes)
# ---------------------------------------------------------------------------

class StepOut(NamedTuple):
    state: DecodeState
    coef: torch.Tensor     # int32 decoded coefficient (0 for EOB/ZRL/garbage)
    run: torch.Tensor      # int32 effective zero-run before the coefficient
    active: torch.Tensor   # bool: this lane decoded a symbol this step
    invalid: torch.Tensor  # bool: window had no valid codeword (garbage phase)


def decode_symbol(
    words64: torch.Tensor,
    luts: torch.Tensor,
    unit_lut_row: torch.Tensor,
    st: DecodeState,
    word_base: torch.Tensor,
    limit: torch.Tensor,
    ts: torch.Tensor,
    upm: torch.Tensor,
    min_code_bits: int,
) -> StepOut:
    """decode_next_symbol() from the paper, for all lanes at once."""
    active = st.p < limit
    win32 = fetch_window32(words64, word_base, st.p)
    win16 = win32 >> 16

    is_dc = (st.z == 0).to(torch.int64)
    row = unit_lut_row[ts.to(torch.int64), st.u.to(torch.int64), is_dc]
    entry = luts[row.to(torch.int64), win16]

    clen = entry & 0x1F
    size = (entry >> T.LUT_SIZE_SHIFT) & 0xF
    run = (entry >> T.LUT_RUN_SHIFT) & 0xF
    eob = (entry & T.LUT_EOB_BIT) != 0
    invalid = clen == 0

    # magnitude bits: the `size` bits following the codeword
    size64 = size.to(torch.int64)
    shift = (32 - clen.to(torch.int64) - size64) & 31
    mask = (torch.ones_like(size64) << size64) - 1
    vbits = ((win32 >> shift) & mask).to(torch.int32)
    one = torch.ones_like(size)
    half = one << torch.clamp(size - 1, min=0)
    full = one << size
    coef = torch.where(vbits < half, vbits - full + 1, vbits)
    coef = torch.where(size == 0, 0, coef)

    run_eff = torch.where(eob, 63 - st.z, run)
    run_eff = torch.where(invalid, 0, run_eff)
    zstep = run_eff + 1
    adv = torch.where(invalid, min_code_bits, clen + size)

    new_z = st.z + zstep
    blk_done = new_z >= 64
    z_next = torch.where(blk_done, 0, new_z)
    u_next = torch.where(blk_done, torch.where(st.u + 1 >= upm, 0, st.u + 1),
                         st.u)

    nxt = DecodeState(
        p=torch.where(active, st.p + adv, st.p),
        u=torch.where(active, u_next, st.u),
        z=torch.where(active, z_next, st.z),
        n=torch.where(active, st.n + zstep, st.n),
    )
    return StepOut(nxt, coef, run_eff, active, invalid)


# ---------------------------------------------------------------------------
# Chunk decode: the paper's decode_subsequence over all lanes
# ---------------------------------------------------------------------------

def decode_span(
    dev: Dev,
    entry: DecodeState,
    word_base: torch.Tensor,
    limit: torch.Tensor,
    ts: torch.Tensor,
    upm: torch.Tensor,
    *,
    s_max: int,
    min_code_bits: int,
    write: bool = False,
    out: Optional[torch.Tensor] = None,
    write_base: Optional[torch.Tensor] = None,
    write_max: Optional[torch.Tensor] = None,
) -> Tuple[DecodeState, Optional[torch.Tensor]]:
    """Decode every lane from its entry state to the end of its bit range.

    Returns the exit states (with per-chunk n counts). When `write=True`,
    coefficients are scattered into a copy of `out` at
    write_base + local_n + run, and that buffer is returned.
    """
    words64 = widen_words(dev["words"])
    luts, rows = dev["luts"], dev["unit_lut_row"]
    st = DecodeState(entry.p, entry.u, entry.z, torch.zeros_like(entry.p))

    def step(st):
        return decode_symbol(words64, luts, rows, st, word_base, limit, ts,
                             upm, min_code_bits)

    if not write:
        for _ in range(s_max):
            st = step(st).state
        return st, None

    assert out is not None and write_base is not None and write_max is not None
    sentinel = out.shape[0]
    # dropped writes land in one slot past the end (never at -1: negative
    # indices wrap), which is sliced off; every other index is unique
    buf = torch.cat([out, out.new_zeros(1)])
    for _ in range(s_max):
        o = step(st)
        idx = write_base + st.n + o.run
        ok = o.active & ~o.invalid & (idx <= write_max)
        idx = torch.where(ok, idx, sentinel)
        buf[idx.to(torch.int64)] = o.coef
        st = o.state
    return st, buf[:sentinel]


def chunk_meta(dev: Dev, idx: Optional[torch.Tensor] = None,
               out: Optional[Dev] = None):
    """Gather per-chunk decode metadata (optionally at a chunk-index subset).

    ``out`` (every lane only): ``word_base``, ``ts`` and ``upm`` buffers
    to gather into, so the metadata keeps its addresses from decode to
    decode (a captured CUDA graph reads them).
    """
    seg = dev["chunk_seg"] if idx is None else dev["chunk_seg"][idx]
    limit = dev["chunk_limit"] if idx is None else dev["chunk_limit"][idx]
    seg = seg.to(torch.int64)
    out = out or {}
    ts = torch.index_select(dev["seg_tableset"], 0, seg, out=out.get("ts"))
    return dict(
        word_base=torch.index_select(dev["seg_word_base"], 0, seg,
                                     out=out.get("word_base")),
        limit=limit,
        ts=ts,
        upm=torch.index_select(dev["ts_upm"], 0, ts.to(torch.int64),
                               out=out.get("upm")),
    )


# ---------------------------------------------------------------------------
# Output placement: segmented exclusive prefix sum over per-chunk n
# ---------------------------------------------------------------------------

def segmented_exclusive_cumsum(values: torch.Tensor,
                               start: torch.Tensor) -> torch.Tensor:
    """Exclusive per-segment prefix sum (paper Alg. 1 lines 7-8, batched).

    ``start[i]`` is the position of the first element of ``i``'s segment
    (``bitstream.segment_starts``). The counterpart of ``associative_scan``
    with the JAX package's ``_seg_scan_op``: the running total before each
    element minus its value at the segment's start, in int64.
    """
    v = values.to(torch.int64)
    before = torch.cumsum(v, 0) - v
    return (before - before[start]).to(values.dtype)


def chunk_write_bases(dev: Dev, exit_n: torch.Tensor,
                      permuted: bool = True,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absolute dense-coefficient write base for every chunk lane.

    The segmented prefix sum runs over *bitstream* chunk order: gather
    ``n`` into chunk order via ``chunk_order``, scan, and gather the bases
    back to lanes via ``lane_perm``. Inert padding chunks order after
    every real chunk and are segment-firsts, so they contribute nothing.
    ``permuted=False`` (identity plans, whose chunk order is the lane
    order) skips both gathers. ``out`` receives the bases.
    """
    start = dev["chunk_seg_start"]
    if permuted:
        order = dev["chunk_order"].to(torch.int64)
        local_o = segmented_exclusive_cumsum(exit_n[order], start)
        local = local_o[dev["lane_perm"].to(torch.int64)]
    else:
        local = segmented_exclusive_cumsum(exit_n, start)
    base = dev["seg_coeff_base"][dev["chunk_seg"].to(torch.int64)]
    return torch.add(base, local, out=out)


# ---------------------------------------------------------------------------
# DC difference decoding (paper §IV-B): segmented prefix sum per component
# ---------------------------------------------------------------------------

def undiff_dc(dev: Dev, coeffs: torch.Tensor,
              n_components: int = 3) -> torch.Tensor:
    """Reverse DC prediction over the flat (U, 64) zig-zag coefficient array.

    Capacity-safe: pad units (bucketed plans) are flagged segment-first
    with zero coefficients and sit after every real unit, so the forward
    segmented scans leave the real prefix bit-identical to the exact-fit
    array.
    """
    comp = dev["unit_comp"].to(torch.int64)
    dc = coeffs[:, 0].to(torch.int64)
    # one running total per component (a row each), restarted at every
    # segment start: segment starts reset *all* predictors. The rows are
    # scanned as one flat cumsum (a 1-D scan; torch's scan along a short
    # outer axis runs nearly serially on the card): each row's totals are
    # taken relative to the row's own segment start, so the carry from
    # the rows before it cancels.
    own = torch.arange(n_components, device=comp.device)[:, None] == comp
    vals = torch.where(own, dc, 0)
    flat = vals.reshape(-1)
    before = (torch.cumsum(flat, 0) - flat).reshape(vals.shape)
    acc = before - before[:, dev["unit_seg_start"]] + vals
    out = coeffs.clone()
    out[:, 0] = acc.gather(0, comp[None, :])[0].to(coeffs.dtype)
    return out


# ---------------------------------------------------------------------------
# Pixel stage: fused dequant + de-zigzag + IDCT as one 64x64 product
# ---------------------------------------------------------------------------

def folded_product(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` for (U, 64) ``x``, summed over j = 0..63 in order.

    One rounding per multiply and one per add, with no fused multiply-add:
    the pixel and IDCT kernels (``kernels/csrc/idct.cuh``) sum in exactly
    this order, so they agree with it bit for bit on any device. A library
    matrix product would sum in its own order, and a pixel whose sum lands
    within rounding of a half would round the other way.
    """
    acc = torch.zeros_like(x)
    for j in range(64):
        acc = acc + x[:, j, None] * m[None, :, j]
    return acc


def idct_units_folded(coeffs: torch.Tensor, m_matrices: torch.Tensor,
                      unit_mrow: torch.Tensor) -> torch.Tensor:
    """(U, 64) zig-zag int coeffs -> (U, 64) row-major pixel values (uint8 range).

    Computes every folded matrix's transform and selects per unit — the
    number of distinct quantization matrices per batch is tiny (usually 2).
    """
    x = coeffs.to(torch.float32)
    out = torch.zeros_like(x)
    for q in range(m_matrices.shape[0]):
        y = folded_product(x, m_matrices[q])
        out = torch.where((unit_mrow == q)[:, None], y, out)
    return torch.clamp(torch.round(out + 128.0), 0.0, 255.0)


def assemble_planes(pixels: torch.Tensor, n_images: int, comp_unit_idx,
                    comp_block_idx, comp_grid):
    """(U_total, 64) pixels -> list of per-component (B, Hc, Wc) planes.

    Uniform-batch path: every image shares the same scan layout. The index
    lists are int64 tensors on the pixels' device.
    """
    upi = pixels.shape[0] // n_images
    pix = pixels.reshape(n_images, upi, 64)
    planes = []
    for ci in range(len(comp_unit_idx)):
        blocks = pix[:, comp_unit_idx[ci], :]  # (B, Uc, 64)
        by, bx = comp_grid[ci]
        plane = pixels.new_zeros((n_images, by * bx, 64))
        plane[:, comp_block_idx[ci], :] = blocks
        plane = plane.reshape(n_images, by, bx, 8, 8)
        plane = plane.permute(0, 1, 3, 2, 4).reshape(n_images, by * 8, bx * 8)
        planes.append(plane)
    return planes


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                 cr: torch.Tensor) -> torch.Tensor:
    """BT.601 color convert of full-size float planes, then clip(round).

    The arithmetic and its order are the JAX package's; the pixel and
    color kernels write each multiply and add with its own rounding in
    the same order.
    Returns the three channels stacked on a new last axis, as uint8.
    """
    cb, cr = cb - 128.0, cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def upsample_color(planes, comp_h, comp_v, h_max, v_max, height, width):
    """Replicate-upsample chroma + YCbCr->RGB, cropped to true image size."""
    if len(planes) == 1:
        return torch.round(planes[0][:, :height, :width]).to(torch.uint8)
    full = []
    for ci, p in enumerate(planes):
        fv, fh = v_max // comp_v[ci], h_max // comp_h[ci]
        if fv > 1:
            p = torch.repeat_interleave(p, fv, dim=1)
        if fh > 1:
            p = torch.repeat_interleave(p, fh, dim=2)
        full.append(p[:, : planes[0].shape[1] * (v_max // comp_v[0]),
                      : planes[0].shape[2] * (h_max // comp_h[0])])
    rgb = ycbcr_to_rgb(full[0], full[1], full[2])
    return rgb[:, :height, :width]

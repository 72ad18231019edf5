"""Sequential reference JPEG codec (numpy) — the bit-exact oracle.

The encoder produces standard baseline JFIF files (these are what the
device decoder consumes in tests/benchmarks); the decoder is a strict
sequential implementation of T.81 decoding used as ground truth for the
parallel decoder and for every CUDA kernel's plain version.

Performance note: the encoder is vectorized per image (numpy); the decoder
is intentionally a straightforward sequential loop — it is the *oracle*,
not a baseline for speed. This module is a copy of the JAX package's
``jpeg/codec_ref.py``: the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import tables as T
from .format import (
    ComponentInfo,
    JpegImage,
    pack_bits_to_words,
    parse_jpeg,
    stuff_scan,
    unstuff_scan,
    write_jpeg,
)

# ---------------------------------------------------------------------------
# DCT operators
# ---------------------------------------------------------------------------

def dct_matrix() -> np.ndarray:
    """8x8 orthonormal DCT-II matrix C; fDCT: C @ X @ C.T, IDCT: C.T @ F @ C."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    C = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2.0 / 8.0)
    C[0] /= np.sqrt(2.0)
    return C


_C = dct_matrix()


def fdct_units(units: np.ndarray) -> np.ndarray:
    """Forward DCT of (N, 8, 8) level-shifted samples."""
    return np.einsum("ij,njk,lk->nil", _C, units, _C)


def idct_units(coeffs: np.ndarray) -> np.ndarray:
    """Inverse DCT of (N, 8, 8) dequantized coefficients."""
    return np.einsum("ji,njk,kl->nil", _C, coeffs, _C)


# ---------------------------------------------------------------------------
# Color space (JFIF / BT.601 full range)
# ---------------------------------------------------------------------------

def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    ycc = ycc.astype(np.float64)
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    out = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

SUBSAMPLING = {
    "4:4:4": ((1, 1), (1, 1), (1, 1)),
    "4:2:2": ((2, 1), (1, 1), (1, 1)),
    "4:2:0": ((2, 2), (1, 1), (1, 1)),
    "gray": ((1, 1),),
}


def _pad_edge(plane: np.ndarray, ph: int, pw: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def _box_subsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Box-average subsampling by integer factors (fh horizontal, fv vertical)."""
    if fh == 1 and fv == 1:
        return plane
    h, w = plane.shape
    return plane.reshape(h // fv, fv, w // fh, fh).mean(axis=(1, 3))


def _blocks_from_plane(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//8 * W//8, 8, 8) raster block order."""
    h, w = plane.shape
    return (
        plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    )


def _plane_from_blocks(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return (
        blocks.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)
    )


def scan_unit_layout(img: JpegImage) -> Dict[str, np.ndarray]:
    """Per-data-unit metadata in scan (interleaved MCU) order.

    Returns dict with (n_units,) arrays:
      comp      : component index of each unit
      block_idx : raster block index within that component's padded plane
    """
    ucomp = img.unit_component()
    upm = img.units_per_mcu
    n = img.n_units
    comp = np.tile(ucomp, img.n_mcus)
    block_idx = np.zeros(n, dtype=np.int64)
    # within-MCU unit offsets per component
    off_in_mcu = []
    for ci, c in enumerate(img.components):
        for i in range(c.v * c.h):
            off_in_mcu.append((ci, i))
    mcu_ids = np.repeat(np.arange(img.n_mcus, dtype=np.int64), upm)
    mx = mcu_ids % img.mcus_x
    my = mcu_ids // img.mcus_x
    unit_slot = np.tile(np.arange(upm), img.n_mcus)
    for s, (ci, i) in enumerate(off_in_mcu):
        sel = unit_slot == s
        c = img.components[ci]
        bx = mx[sel] * c.h + (i % c.h)
        by = my[sel] * c.v + (i // c.h)
        blocks_x = img.mcus_x * c.h
        block_idx[sel] = by * blocks_x + bx
    return {"comp": comp.astype(np.int32), "block_idx": block_idx}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodeResult:
    jpeg_bytes: bytes
    image: JpegImage                 # parsed-back structure (convenience)
    coeff_zigzag: np.ndarray         # (n_units, 64) quantized, DC differential
    n_units: int


def encode_baseline(
    img: np.ndarray,
    quality: int = 90,
    subsampling: str = "4:2:0",
    restart_interval: int = 0,
    optimize_huffman: bool = False,
) -> EncodeResult:
    """Encode an (H, W, 3) uint8 RGB or (H, W) grayscale image."""
    if img.ndim == 2:
        subsampling = "gray"
    factors = SUBSAMPLING[subsampling]
    n_comp = len(factors)
    h_max = max(f[0] for f in factors)
    v_max = max(f[1] for f in factors)
    H, W = img.shape[:2]
    mcu_h, mcu_w = 8 * v_max, 8 * h_max
    mcus_y, mcus_x = -(-H // mcu_h), -(-W // mcu_w)
    pH, pW = mcus_y * mcu_h, mcus_x * mcu_w

    # Component sample planes (padded).
    if n_comp == 1:
        planes = [_pad_edge(img.astype(np.float64), pH, pW)]
    else:
        ycc = rgb_to_ycbcr(img)
        planes = []
        for ci, (fh, fv) in enumerate(factors):
            p = _pad_edge(ycc[..., ci], pH, pW)
            planes.append(_box_subsample(p, h_max // fh, v_max // fv))

    qt_luma, qt_chroma = T.quant_tables_for_quality(quality)
    quant_tables = {0: qt_luma} if n_comp == 1 else {0: qt_luma, 1: qt_chroma}

    components = []
    for ci, (fh, fv) in enumerate(factors):
        qid = 0 if ci == 0 else 1
        components.append(
            ComponentInfo(comp_id=ci + 1, h=fh, v=fv, quant_id=qid,
                          dc_table=0 if ci == 0 else 1, ac_table=0 if ci == 0 else 1)
        )

    # Quantized coefficients per component, raster block order.
    comp_coeff = []
    for ci, plane in enumerate(planes):
        blocks = _blocks_from_plane(plane) - 128.0
        f = fdct_units(blocks)
        q = quant_tables[components[ci].quant_id].reshape(8, 8)
        quant = np.sign(f) * np.floor(np.abs(f) / q + 0.5)
        comp_coeff.append(quant.astype(np.int32))

    # Gather into scan order + zig-zag.
    tmp_img = JpegImage(
        width=W, height=H, components=components, quant_tables=quant_tables,
        huffman_specs={}, scan_data=b"", restart_interval=restart_interval,
    )
    layout = scan_unit_layout(tmp_img)
    n_units = tmp_img.n_units
    coeff = np.zeros((n_units, 64), dtype=np.int32)
    for ci in range(n_comp):
        sel = layout["comp"] == ci
        blocks = comp_coeff[ci][layout["block_idx"][sel]]
        coeff[sel] = blocks.reshape(-1, 64)[:, T.ZIGZAG]

    # DC differential per component (in scan order), with prediction reset at
    # restart-interval boundaries when enabled.
    coeff_diff = coeff.copy()
    coeff_diff[:, 0] = rediff_dc_for_restart(
        coeff[:, 0], layout["comp"], tmp_img.units_per_mcu, restart_interval, n_comp
    )

    # Huffman table selection.
    if optimize_huffman:
        specs = optimal_specs_for(coeff_diff, layout["comp"], n_comp)
    else:
        specs = {
            ("dc", 0): T.STD_SPECS[("dc", 0)],
            ("ac", 0): T.STD_SPECS[("ac", 0)],
        }
        if n_comp > 1:
            specs[("dc", 1)] = T.STD_SPECS[("dc", 1)]
            specs[("ac", 1)] = T.STD_SPECS[("ac", 1)]

    scan = encode_scan(coeff_diff, layout["comp"], components, specs,
                       restart_interval, tmp_img.units_per_mcu)

    jpeg = write_jpeg(W, H, components, quant_tables, specs, scan, restart_interval)
    return EncodeResult(jpeg, parse_jpeg(jpeg), coeff_diff, n_units)


def _symbol_stream(
    coeff: np.ndarray, comp: np.ndarray, components: List[ComponentInfo],
    codes: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized (values, lengths) Huffman+magnitude field stream for the scan.

    Per unit emits: DC(code+mag), then per nonzero AC slot up to 3 ZRL codes +
    (run,size) code + mag, then optional EOB. Inactive slots have length 0.
    """
    n_units = coeff.shape[0]
    # --- DC ---------------------------------------------------------------
    dc = coeff[:, 0]
    dc_cat = T.magnitude_category(dc)
    dc_bits = T.ones_complement_bits(dc, dc_cat)
    dc_tbl = np.array([components[c].dc_table for c in comp])
    # per-unit code/len lookup
    dc_code = np.zeros(n_units, dtype=np.uint32)
    dc_len = np.zeros(n_units, dtype=np.int32)
    for tid in np.unique(dc_tbl):
        cvals, clens = codes[("dc", int(tid))]
        sel = dc_tbl == tid
        dc_code[sel] = cvals[dc_cat[sel]]
        dc_len[sel] = clens[dc_cat[sel]]
    # DC field = code then magnitude bits
    dc_val = (dc_code.astype(np.uint64) << dc_cat.astype(np.uint64)) | dc_bits.astype(
        np.uint64
    )
    dc_totlen = dc_len + dc_cat

    # --- AC ---------------------------------------------------------------
    ac = coeff[:, 1:]  # (n, 63)
    nz = ac != 0
    pos = np.broadcast_to(np.arange(1, 64), ac.shape)
    # previous nonzero position (0 for none) via cumulative max of pos*nz
    prev = np.maximum.accumulate(np.where(nz, pos, 0), axis=1)
    prev_shifted = np.concatenate([np.zeros((n_units, 1), np.int64), prev[:, :-1]], 1)
    run = np.where(nz, pos - prev_shifted - 1, 0)
    zrl_n = run // 16
    rem = run % 16
    ac_cat = T.magnitude_category(ac)
    ac_bits = T.ones_complement_bits(ac, ac_cat)
    ac_sym = (rem.astype(np.int64) << 4) | ac_cat.astype(np.int64)
    ac_tbl = np.array([components[c].ac_table for c in comp])

    ac_code = np.zeros_like(ac, dtype=np.uint32)
    ac_len = np.zeros_like(ac, dtype=np.int32)
    zrl_code = np.zeros(n_units, dtype=np.uint32)
    zrl_len = np.zeros(n_units, dtype=np.int32)
    eob_code = np.zeros(n_units, dtype=np.uint32)
    eob_len = np.zeros(n_units, dtype=np.int32)
    for tid in np.unique(ac_tbl):
        cvals, clens = codes[("ac", int(tid))]
        sel = ac_tbl == tid
        ac_code[sel] = cvals[ac_sym[sel]]
        ac_len[sel] = clens[ac_sym[sel]]
        zrl_code[sel] = cvals[0xF0]
        zrl_len[sel] = clens[0xF0]
        eob_code[sel] = cvals[0x00]
        eob_len[sel] = clens[0x00]
    ac_len = np.where(nz, ac_len, 0)
    ac_val = (ac_code.astype(np.uint64) << ac_cat.astype(np.uint64)) | ac_bits.astype(
        np.uint64
    )
    ac_totlen = np.where(nz, ac_len + ac_cat, 0)

    # EOB if last nonzero AC position < 63 (including all-zero AC).
    last_nz = prev[:, -1]
    need_eob = last_nz < 63
    eob_len = np.where(need_eob, eob_len, 0)

    # Slot layout per unit: [DC] + 63 * [zrl0, zrl1, zrl2, ac] + [EOB]
    S = 1 + 63 * 4 + 1
    vals = np.zeros((n_units, S), dtype=np.uint64)
    lens = np.zeros((n_units, S), dtype=np.int32)
    vals[:, 0] = dc_val
    lens[:, 0] = dc_totlen
    for zi in range(3):
        active = (zrl_n > zi) & nz
        vals[:, 1 + zi + np.arange(63) * 4] = np.where(
            active, zrl_code[:, None].astype(np.uint64), 0
        )
        lens[:, 1 + zi + np.arange(63) * 4] = np.where(active, zrl_len[:, None], 0)
    vals[:, 1 + 3 + np.arange(63) * 4] = ac_val
    lens[:, 1 + 3 + np.arange(63) * 4] = ac_totlen
    vals[:, -1] = eob_code.astype(np.uint64)
    lens[:, -1] = eob_len

    flat_v = vals.reshape(-1)
    flat_l = lens.reshape(-1)
    keep = flat_l > 0
    return flat_v[keep], flat_l[keep]


def pack_bitstream(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized MSB-first bit packing -> uint8 array (1-padded to byte)."""
    lens = lens.astype(np.int64)
    offs = np.cumsum(lens) - lens
    total = int(offs[-1] + lens[-1]) if len(lens) else 0
    nbytes = (total + 7) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)
    if len(lens):
        shift = (offs % 8).astype(np.uint64)
        # place value MSB-aligned at bit `shift` of a 64-bit window
        place = vals.astype(np.uint64) << (np.uint64(64) - shift - lens.astype(np.uint64))
        byte0 = (offs // 8).astype(np.int64)
        for k in range(5):
            np.add.at(out, byte0 + k, ((place >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)).astype(np.uint8))
    # pad final partial byte with 1s
    if total % 8 != 0:
        out[nbytes - 1] |= (1 << (8 - total % 8)) - 1
    return out[:nbytes]


def encode_scan(
    coeff_diff: np.ndarray,
    comp: np.ndarray,
    components: List[ComponentInfo],
    specs: Dict[Tuple[str, int], T.HuffmanSpec],
    restart_interval: int,
    units_per_mcu: int,
) -> bytes:
    """Entropy-encode the (already differential) coefficient stream."""
    codes = {k: T.build_canonical_codes(s) for k, s in specs.items()}
    if restart_interval <= 0:
        vals, lens = _symbol_stream(coeff_diff, comp, components, codes)
        return stuff_scan(pack_bitstream(vals, lens))
    # Restart intervals: re-diff DC within each interval and byte-align.
    n_units = coeff_diff.shape[0]
    n_mcus = n_units // units_per_mcu
    out = bytearray()
    m = 0
    for start_mcu in range(0, n_mcus, restart_interval):
        end_mcu = min(start_mcu + restart_interval, n_mcus)
        sl = slice(start_mcu * units_per_mcu, end_mcu * units_per_mcu)
        chunk = coeff_diff[sl].copy()
        vals, lens = _symbol_stream(chunk, comp[sl], components, codes)
        out += stuff_scan(pack_bitstream(vals, lens))
        if end_mcu < n_mcus:
            out += bytes([0xFF, 0xD0 + (m % 8)])
            m += 1
    return bytes(out)


def rediff_dc_for_restart(
    coeff_abs_dc: np.ndarray, comp: np.ndarray, units_per_mcu: int,
    restart_interval: int, n_comp: int,
) -> np.ndarray:
    """DC differences with predictor reset at each restart interval."""
    n_units = len(coeff_abs_dc)
    out = np.zeros_like(coeff_abs_dc)
    interval_units = restart_interval * units_per_mcu if restart_interval else n_units
    for s in range(0, n_units, interval_units):
        e = min(s + interval_units, n_units)
        for ci in range(n_comp):
            sel = np.where(comp[s:e] == ci)[0] + s
            out[sel] = np.diff(coeff_abs_dc[sel], prepend=0)
    return out


def optimal_specs_for(
    coeff_diff: np.ndarray, comp: np.ndarray, n_comp: int
) -> Dict[Tuple[str, int], T.HuffmanSpec]:
    """Image-adaptive Huffman tables from symbol frequencies (Annex K.2)."""
    specs: Dict[Tuple[str, int], T.HuffmanSpec] = {}
    groups = [(0, [0])] if n_comp == 1 else [(0, [0]), (1, [1, 2])]
    for tid, comps in groups:
        sel = np.isin(comp, comps)
        sub = coeff_diff[sel]
        # DC frequencies
        dc_cat = T.magnitude_category(sub[:, 0])
        dc_freq = np.bincount(dc_cat, minlength=256).astype(np.int64)
        # AC frequencies
        ac = sub[:, 1:]
        nz = ac != 0
        pos = np.broadcast_to(np.arange(1, 64), ac.shape)
        prev = np.maximum.accumulate(np.where(nz, pos, 0), axis=1)
        prev_shifted = np.concatenate(
            [np.zeros((len(sub), 1), np.int64), prev[:, :-1]], 1
        )
        run = np.where(nz, pos - prev_shifted - 1, 0)
        zrl_n = (run // 16)[nz]
        rem = (run % 16)[nz]
        cat = T.magnitude_category(ac[nz])
        sym = rem * 16 + cat
        ac_freq = np.bincount(sym, minlength=256).astype(np.int64)
        ac_freq[0xF0] += int(zrl_n.sum())
        last_nz = prev[:, -1]
        ac_freq[0x00] += int((last_nz < 63).sum())
        specs[("dc", tid)] = T.spec_from_frequencies(dc_freq)
        specs[("ac", tid)] = T.spec_from_frequencies(ac_freq)
    return specs


# ---------------------------------------------------------------------------
# Sequential decoder (oracle)
# ---------------------------------------------------------------------------

class BitReader:
    """MSB-first bit reader over a clean (unstuffed) byte stream."""

    def __init__(self, data: np.ndarray):
        self.words = pack_bits_to_words(data)
        self.pos = 0  # bit position
        self.nbits = len(data) * 8

    def peek16(self) -> int:
        w = self.pos >> 5
        off = self.pos & 31
        hi = int(self.words[w])
        lo = int(self.words[w + 1])
        window = ((hi << 32) | lo) >> (48 - off)
        return window & 0xFFFF

    def take(self, n: int) -> int:
        w = self.pos >> 5
        off = self.pos & 31
        hi = int(self.words[w])
        lo = int(self.words[w + 1])
        window = ((hi << 32) | lo) & 0xFFFFFFFFFFFFFFFF
        val = (window >> (64 - off - n)) & ((1 << n) - 1) if n else 0
        self.pos += n
        return val


def decode_coefficients(img: JpegImage) -> np.ndarray:
    """Entropy-decode the scan to (n_units, 64) zig-zag coefficients.

    DC coefficients are the *differential* values (prediction not yet
    reversed), matching the raw entropy output of the parallel decoder. With
    restart markers, prediction resets per interval (handled by the caller
    via dc_prefix_sum with interval resets).
    """
    clean, rst_bits = unstuff_scan(img.scan_data)
    luts = {
        k: T.build_decode_lut(s, is_dc=(k[0] == "dc"))
        for k, s in img.huffman_specs.items()
    }
    ucomp = img.unit_component()
    upm = img.units_per_mcu
    n_units = img.n_units
    out = np.zeros((n_units, 64), dtype=np.int32)
    reader = BitReader(clean)
    del rst_bits  # interval boundaries are re-derived from byte alignment below
    for u in range(n_units):
        comp = img.components[ucomp[u % upm]]
        # DC
        dc_lut = luts[("dc", comp.dc_table)]
        entry = int(dc_lut[reader.peek16()])
        clen = entry & 0x1F
        size = (entry >> T.LUT_SIZE_SHIFT) & 0xF
        if clen == 0:
            raise ValueError(f"invalid DC code at bit {reader.pos}")
        reader.take(clen)
        bits = reader.take(size)
        out[u, 0] = int(T.extend_magnitude(np.array([bits]), np.array([size]))[0])
        # AC
        z = 1
        ac_lut = luts[("ac", comp.ac_table)]
        while z < 64:
            entry = int(ac_lut[reader.peek16()])
            clen = entry & 0x1F
            if clen == 0:
                raise ValueError(f"invalid AC code at bit {reader.pos}")
            size = (entry >> T.LUT_SIZE_SHIFT) & 0xF
            run = (entry >> T.LUT_RUN_SHIFT) & 0xF
            reader.take(clen)
            if entry & T.LUT_EOB_BIT:
                break
            if entry & T.LUT_ZRL_BIT:
                z += 16
                continue
            z += run
            bits = reader.take(size)
            if z > 63:
                raise ValueError("AC run overflows block")
            out[u, z] = int(
                T.extend_magnitude(np.array([bits]), np.array([size]))[0]
            )
            z += 1
        # Byte-align at restart boundaries.
        if img.restart_interval and (u + 1) % (img.restart_interval * upm) == 0:
            if reader.pos % 8:
                reader.take(8 - reader.pos % 8)
    return out


def undiff_dc(img: JpegImage, coeff: np.ndarray) -> np.ndarray:
    """Reverse DC prediction in place (returns copy)."""
    out = coeff.copy()
    layout = scan_unit_layout(img)
    upm = img.units_per_mcu
    interval_units = (
        img.restart_interval * upm if img.restart_interval else img.n_units
    )
    for s in range(0, img.n_units, interval_units):
        e = min(s + interval_units, img.n_units)
        for ci in range(len(img.components)):
            sel = np.where(layout["comp"][s:e] == ci)[0] + s
            out[sel, 0] = np.cumsum(coeff[sel, 0])
    return out


def coefficients_to_planes(img: JpegImage, coeff_abs: np.ndarray) -> List[np.ndarray]:
    """Dequantize + de-zigzag + IDCT + assemble padded component planes."""
    layout = scan_unit_layout(img)
    planes = []
    for ci, c in enumerate(img.components):
        sel = layout["comp"] == ci
        zz = coeff_abs[sel]
        nat = np.zeros_like(zz)
        nat[:, T.ZIGZAG] = zz
        q = img.quant_tables[c.quant_id].reshape(1, 64)
        deq = (nat * q).astype(np.float64).reshape(-1, 8, 8)
        pix = idct_units(deq) + 128.0
        ph, pw = img.comp_plane_shape(ci)
        blocks = np.zeros((ph // 8 * (pw // 8), 8, 8))
        blocks[layout["block_idx"][sel]] = pix
        planes.append(np.clip(np.round(_plane_from_blocks(blocks, ph, pw)), 0, 255))
    return planes


def upsample_and_color(img: JpegImage, planes: List[np.ndarray]) -> np.ndarray:
    """Replicate-upsample chroma, convert to RGB, crop to true size."""
    if len(planes) == 1:
        return planes[0][: img.height, : img.width].astype(np.uint8)
    full = []
    for ci, p in enumerate(planes):
        c = img.components[ci]
        fh, fv = img.h_max // c.h, img.v_max // c.v
        up = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
        full.append(up[: img.mcus_y * img.mcu_height, : img.mcus_x * img.mcu_width])
    ycc = np.stack(full, axis=-1)
    rgb = ycbcr_to_rgb(ycc)
    return rgb[: img.height, : img.width]


def decode_baseline(data: bytes) -> np.ndarray:
    """Full sequential decode: bytes -> RGB (or grayscale) uint8 array."""
    img = parse_jpeg(data)
    coeff = decode_coefficients(img)
    coeff = undiff_dc(img, coeff)
    planes = coefficients_to_planes(img, coeff)
    return upsample_and_color(img, planes)

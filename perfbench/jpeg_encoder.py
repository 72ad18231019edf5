"""The benchmark's own input maker: synthetic frames and a baseline encoder.

A frozen copy of what the benchmark needs from the repository's reference
codec (``repro_torch/jpeg/encoder.py`` ``synth_frame``, and
``jpeg/codec_ref.py`` ``encode_baseline`` with its tables and writer),
so that no later change to the program can change the inputs the
benchmark measures it on. For an image and a setting the bytes equal the
reference codec's (``test_perfbench_reference.py`` holds that).

Besides the bytes, :func:`encode` returns what the bytes hold: the
quantized coefficients in scan order (zig-zag, DC differential), from
which :mod:`perfbench.reference` works out the pixels, and the clean
(unstuffed) length of each entropy segment, from which
:mod:`perfbench.counts` counts a batch's bytes and lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# ZIGZAG[k] = natural (row-major) index of the k-th zig-zag coefficient
ZIGZAG = np.array(
    [
        0,  1,  8, 16,  9,  2,  3, 10,
        17, 24, 32, 25, 18, 11,  4,  5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13,  6,  7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# T.81 Annex K tables, natural (row-major) order.
STD_LUMA_QUANT = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.int32,
)

STD_CHROMA_QUANT = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int32,
)


def quant_tables_for_quality(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantization tables in natural order, libjpeg's
    quality scaling (50 = the base tables, 100 = all ones)."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2

    def scaled(base):
        q = (base.astype(np.int64) * scale + 50) // 100
        return np.clip(q, 1, 255).astype(np.int32)

    return scaled(STD_LUMA_QUANT), scaled(STD_CHROMA_QUANT)


@dataclasses.dataclass(frozen=True, eq=False)
class HuffmanSpec:
    """(bits, vals) as a DHT segment stores them: ``bits[i]`` codes of
    length ``i + 1``, ``vals`` the symbols in code order."""

    bits: np.ndarray
    vals: np.ndarray


def _vals(*rows):
    return np.array([v for row in rows for v in row], dtype=np.int32)


# Annex K defaults: DC symbols are size categories, AC symbols
# (run << 4) | size with 0x00 = EOB and 0xF0 = ZRL.
STD_SPECS = {
    ("dc", 0): HuffmanSpec(
        np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int32),
        np.arange(12, dtype=np.int32)),
    ("ac", 0): HuffmanSpec(
        np.array([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
                 np.int32),
        _vals([0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12],
              [0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07],
              [0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08],
              [0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0],
              [0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16],
              [0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28],
              [0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39],
              [0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49],
              [0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59],
              [0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69],
              [0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79],
              [0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89],
              [0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98],
              [0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7],
              [0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6],
              [0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5],
              [0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4],
              [0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2],
              [0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA],
              [0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8],
              [0xF9, 0xFA])),
    ("dc", 1): HuffmanSpec(
        np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.int32),
        np.arange(12, dtype=np.int32)),
    ("ac", 1): HuffmanSpec(
        np.array([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                 np.int32),
        _vals([0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21],
              [0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71],
              [0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91],
              [0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0],
              [0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34],
              [0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26],
              [0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38],
              [0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48],
              [0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58],
              [0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68],
              [0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78],
              [0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87],
              [0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96],
              [0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5],
              [0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4],
              [0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3],
              [0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2],
              [0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA],
              [0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9],
              [0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8],
              [0xF9, 0xFA])),
}

# (h, v) sampling factors of Y, Cb, Cr
SUBSAMPLING = {
    "4:4:4": ((1, 1), (1, 1), (1, 1)),
    "4:2:2": ((2, 1), (1, 1), (1, 1)),
    "4:2:0": ((2, 2), (1, 1), (1, 1)),
}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A color frame's layout: size, sampling factors and MCU grid."""

    width: int
    height: int
    factors: Tuple[Tuple[int, int], ...]

    @property
    def h_max(self) -> int:
        return max(h for h, _ in self.factors)

    @property
    def v_max(self) -> int:
        return max(v for _, v in self.factors)

    @property
    def mcus_x(self) -> int:
        return -(-self.width // (8 * self.h_max))

    @property
    def mcus_y(self) -> int:
        return -(-self.height // (8 * self.v_max))

    @property
    def units_per_mcu(self) -> int:
        return sum(h * v for h, v in self.factors)

    @property
    def n_units(self) -> int:
        return self.mcus_x * self.mcus_y * self.units_per_mcu

    def plane_shape(self, ci: int) -> Tuple[int, int]:
        """Padded (height, width) of component ``ci``'s sample plane."""
        h, v = self.factors[ci]
        return self.mcus_y * v * 8, self.mcus_x * h * 8


def geometry(width: int, height: int, subsampling: str) -> Geometry:
    return Geometry(width, height, SUBSAMPLING[subsampling])


def scan_layout(g: Geometry) -> Tuple[np.ndarray, np.ndarray]:
    """Each data unit's component and raster block index within its
    component's padded plane, in scan (interleaved MCU) order."""
    upm = g.units_per_mcu
    n_mcus = g.mcus_x * g.mcus_y
    slots = [(ci, i) for ci, (h, v) in enumerate(g.factors)
             for i in range(h * v)]
    comp = np.tile(np.array([ci for ci, _ in slots], np.int32), n_mcus)
    block = np.zeros(n_mcus * upm, dtype=np.int64)
    mcu = np.arange(n_mcus, dtype=np.int64)
    mx, my = mcu % g.mcus_x, mcu // g.mcus_x
    for s, (ci, i) in enumerate(slots):
        h, v = g.factors[ci]
        bx = mx * h + (i % h)
        by = my * v + (i // h)
        block[s::upm] = by * (g.mcus_x * h) + bx
    return comp, block


def dct_matrix() -> np.ndarray:
    """8x8 orthonormal DCT-II matrix C; fDCT C X C^T, IDCT C^T F C."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2.0 / 8.0)
    c[0] /= np.sqrt(2.0)
    return c


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def _canonical_codes(spec: HuffmanSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) indexed by symbol (T.81 Annex C)."""
    codes = np.zeros(256, dtype=np.uint32)
    lengths = np.zeros(256, dtype=np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(int(spec.bits[length - 1])):
            sym = int(spec.vals[k])
            codes[sym], lengths[sym] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _category(values: np.ndarray) -> np.ndarray:
    """JPEG size category: bits of |v| (0 for v == 0)."""
    a = np.abs(values.astype(np.int64))
    cat = np.zeros_like(a)
    nz = a > 0
    cat[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return cat.astype(np.int32)


def _magnitude_bits(values: np.ndarray, cats: np.ndarray) -> np.ndarray:
    """The ``cat``-bit magnitude field (T.81 F.1.2.1.1)."""
    v = values.astype(np.int64)
    return np.where(v >= 0, v, v + (np.int64(1) << cats.astype(np.int64)) - 1)


def _symbol_stream(coeff: np.ndarray, comp: np.ndarray,
                   codes: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(values, lengths) of the scan's Huffman codes and magnitude fields,
    unit by unit: DC, then for each nonzero AC up to three ZRLs and its
    code, then EOB where the block ends early."""
    n_units = coeff.shape[0]
    tbl = (comp > 0).astype(np.int64)   # table 0 for Y, 1 for chroma
    dc = coeff[:, 0]
    dc_cat = _category(dc)
    dc_code = np.zeros(n_units, dtype=np.uint32)
    dc_len = np.zeros(n_units, dtype=np.int32)
    for tid in np.unique(tbl):
        cvals, clens = codes[("dc", int(tid))]
        sel = tbl == tid
        dc_code[sel] = cvals[dc_cat[sel]]
        dc_len[sel] = clens[dc_cat[sel]]
    dc_val = ((dc_code.astype(np.uint64) << dc_cat.astype(np.uint64))
              | _magnitude_bits(dc, dc_cat).astype(np.uint64))

    ac = coeff[:, 1:]
    nz = ac != 0
    pos = np.broadcast_to(np.arange(1, 64), ac.shape)
    prev = np.maximum.accumulate(np.where(nz, pos, 0), axis=1)
    prev_shifted = np.concatenate([np.zeros((n_units, 1), np.int64),
                                   prev[:, :-1]], 1)
    run = np.where(nz, pos - prev_shifted - 1, 0)
    zrl_n = run // 16
    ac_cat = _category(ac)
    ac_sym = ((run % 16).astype(np.int64) << 4) | ac_cat.astype(np.int64)
    ac_code = np.zeros_like(ac, dtype=np.uint32)
    ac_len = np.zeros_like(ac, dtype=np.int32)
    zrl_code = np.zeros(n_units, dtype=np.uint32)
    zrl_len = np.zeros(n_units, dtype=np.int32)
    eob_code = np.zeros(n_units, dtype=np.uint32)
    eob_len = np.zeros(n_units, dtype=np.int32)
    for tid in np.unique(tbl):
        cvals, clens = codes[("ac", int(tid))]
        sel = tbl == tid
        ac_code[sel] = cvals[ac_sym[sel]]
        ac_len[sel] = clens[ac_sym[sel]]
        zrl_code[sel], zrl_len[sel] = cvals[0xF0], clens[0xF0]
        eob_code[sel], eob_len[sel] = cvals[0x00], clens[0x00]
    ac_val = ((ac_code.astype(np.uint64) << ac_cat.astype(np.uint64))
              | _magnitude_bits(ac, ac_cat).astype(np.uint64))
    ac_totlen = np.where(nz, ac_len + ac_cat, 0)
    eob_len = np.where(prev[:, -1] < 63, eob_len, 0)

    # slots a unit: [DC] + 63 * [zrl0, zrl1, zrl2, ac] + [EOB]
    slots = 1 + 63 * 4 + 1
    vals = np.zeros((n_units, slots), dtype=np.uint64)
    lens = np.zeros((n_units, slots), dtype=np.int32)
    vals[:, 0] = dc_val
    lens[:, 0] = dc_len + dc_cat
    for zi in range(3):
        active = (zrl_n > zi) & nz
        vals[:, 1 + zi + np.arange(63) * 4] = np.where(
            active, zrl_code[:, None].astype(np.uint64), 0)
        lens[:, 1 + zi + np.arange(63) * 4] = np.where(
            active, zrl_len[:, None], 0)
    vals[:, 4 + np.arange(63) * 4] = ac_val
    lens[:, 4 + np.arange(63) * 4] = ac_totlen
    vals[:, -1] = eob_code.astype(np.uint64)
    lens[:, -1] = eob_len
    flat_v, flat_l = vals.reshape(-1), lens.reshape(-1)
    keep = flat_l > 0
    return flat_v[keep], flat_l[keep]


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """MSB-first bit packing to bytes, the last byte padded with ones."""
    lens = lens.astype(np.int64)
    offs = np.cumsum(lens) - lens
    total = int(offs[-1] + lens[-1]) if len(lens) else 0
    nbytes = (total + 7) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)
    if len(lens):
        shift = (offs % 8).astype(np.uint64)
        place = vals.astype(np.uint64) << (np.uint64(64) - shift
                                           - lens.astype(np.uint64))
        byte0 = (offs // 8).astype(np.int64)
        for k in range(5):
            np.add.at(out, byte0 + k, ((place >> np.uint64(56 - 8 * k))
                                       & np.uint64(0xFF)).astype(np.uint8))
    if total % 8:
        out[nbytes - 1] |= (1 << (8 - total % 8)) - 1
    return out[:nbytes]


def _stuff(clean: np.ndarray) -> bytes:
    """Byte stuffing: a 0x00 after every 0xFF."""
    n_ff = int((clean == 0xFF).sum())
    if n_ff == 0:
        return clean.tobytes()
    out = np.zeros(len(clean) + n_ff, dtype=np.uint8)
    idx = np.arange(len(clean)) + np.concatenate(
        [[0], np.cumsum(clean == 0xFF)[:-1]])
    out[idx] = clean
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return (bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big")
            + payload)


def _write_jpeg(g: Geometry, quant: Tuple[np.ndarray, np.ndarray],
                scan: bytes, restart_interval: int) -> bytes:
    """A baseline JFIF file: APP0, DQT, SOF0, DHT, [DRI], SOS, scan, EOI."""
    out = bytearray([0xFF, 0xD8])
    out += _segment(0xE0, b"JFIF\x00" + bytes([1, 2, 0])
                    + (1).to_bytes(2, "big") * 2 + bytes([0, 0]))
    for qid, q in enumerate(quant):
        out += _segment(0xDB, bytes([qid]) + bytes(int(q[ZIGZAG[k]])
                                                   for k in range(64)))
    sof = (bytes([8]) + g.height.to_bytes(2, "big")
           + g.width.to_bytes(2, "big") + bytes([len(g.factors)]))
    for ci, (h, v) in enumerate(g.factors):
        sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
    out += _segment(0xC0, sof)
    for (kind, tid), spec in sorted(STD_SPECS.items()):
        out += _segment(0xC4, bytes([((kind == "ac") << 4) | tid])
                        + bytes(int(b) for b in spec.bits)
                        + bytes(int(v) for v in spec.vals))
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    sos = bytes([len(g.factors)])
    for ci in range(len(g.factors)):
        t = 0 if ci == 0 else 1
        sos += bytes([ci + 1, (t << 4) | t])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    return bytes(out) + scan + bytes([0xFF, 0xD9])


@dataclasses.dataclass
class Encoded:
    jpeg_bytes: bytes
    coeff: np.ndarray          # (n_units, 64) int32, zig-zag, DC differential
    segment_bytes: List[int]   # clean bytes of each entropy segment


def encode(img: np.ndarray, quality: int, subsampling: str = "4:2:0",
           restart_interval: int = 0) -> Encoded:
    """Encode an (H, W, 3) uint8 RGB image as baseline JPEG with the
    Annex K Huffman tables; a restart marker every ``restart_interval``
    MCUs where it is not 0."""
    H, W = img.shape[:2]
    g = geometry(W, H, subsampling)
    ph, pw = g.mcus_y * 8 * g.v_max, g.mcus_x * 8 * g.h_max
    ycc = rgb_to_ycbcr(img)
    quant = quant_tables_for_quality(quality)
    c = dct_matrix()
    comp_coeff = []
    for ci, (h, v) in enumerate(g.factors):
        p = np.pad(ycc[..., ci], ((0, ph - H), (0, pw - W)), mode="edge")
        fh, fv = g.h_max // h, g.v_max // v
        if fh > 1 or fv > 1:
            p = p.reshape(ph // fv, fv, pw // fh, fh).mean(axis=(1, 3))
        bh, bw = p.shape
        blocks = p.reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ij,njk,lk->nil", c, blocks.reshape(-1, 8, 8) - 128.0, c)
        q = quant[0 if ci == 0 else 1].reshape(8, 8)
        comp_coeff.append((np.sign(f) * np.floor(np.abs(f) / q + 0.5))
                          .astype(np.int32))
    comp, block = scan_layout(g)
    coeff = np.zeros((g.n_units, 64), dtype=np.int32)
    for ci in range(len(g.factors)):
        sel = comp == ci
        coeff[sel] = comp_coeff[ci][block[sel]].reshape(-1, 64)[:, ZIGZAG]
    # DC differences within each restart interval, per component
    upm = g.units_per_mcu
    step = restart_interval * upm if restart_interval else g.n_units
    for s in range(0, g.n_units, step):
        for ci in range(len(g.factors)):
            sel = np.where(comp[s:s + step] == ci)[0] + s
            coeff[sel, 0] = np.diff(coeff[sel, 0], prepend=0)

    codes = {k: _canonical_codes(s) for k, s in STD_SPECS.items()}
    scan, seg_bytes = bytearray(), []
    n_mcus = g.n_units // upm
    interval = restart_interval or n_mcus
    for m, start in enumerate(range(0, n_mcus, interval)):
        sl = slice(start * upm, min(start + interval, n_mcus) * upm)
        clean = _pack_bits(*_symbol_stream(coeff[sl], comp[sl], codes))
        seg_bytes.append(len(clean))
        scan += _stuff(clean)
        if start + interval < n_mcus:
            scan += bytes([0xFF, 0xD0 + (m % 8)])
    return Encoded(_write_jpeg(g, quant, bytes(scan), restart_interval),
                   coeff, seg_bytes)


def synth_frame(rng: np.random.Generator, width: int, height: int, t: float,
                detail: float = 1.0) -> np.ndarray:
    """One synthetic photograph-like RGB frame: low-frequency illumination,
    a few oriented textures and film grain; ``t`` slides the phases so
    consecutive frames correlate like video."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    xn, yn = xx / width, yy / height
    base = 120 + 60 * np.sin(2.2 * xn + 0.7 * t) * np.cos(1.7 * yn - 0.3 * t)
    tex = np.zeros_like(base)
    for k in range(4):
        fx = 2 ** (k + 2) * np.pi
        ang = 0.6 * k + 0.2 * t
        tex += (18.0 / (k + 1)) * np.sin(
            fx * (xn * np.cos(ang) + yn * np.sin(ang)) + 3.1 * t)
    grain = rng.normal(0, 6.0 * detail, size=(height, width))
    luma = base + detail * tex + grain
    cb = 16 * np.sin(3.1 * xn + t) + 10 * np.cos(2.3 * yn)
    cr = 14 * np.cos(2.7 * xn - 0.5 * t) + 9 * np.sin(3.7 * yn + t)
    rgb = np.stack([luma + 1.402 * cr, luma - 0.344 * cb - 0.714 * cr,
                    luma + 1.772 * cb], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)

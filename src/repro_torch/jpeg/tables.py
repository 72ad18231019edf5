"""JPEG coding tables: zig-zag order, quantization matrices, canonical Huffman.

Everything in this module is host-side (numpy) table *construction*; the
resulting arrays are shipped to the device by :mod:`repro_torch.core.decode`.

References: ITU-T T.81 (the JPEG standard), Annex K for the example tables.

This module is a copy of the JAX package's ``jpeg/tables.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Zig-zag scan order
# ---------------------------------------------------------------------------

# ZIGZAG[k] = natural (row-major) index of the k-th coefficient in zig-zag order.
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

# INV_ZIGZAG[n] = zig-zag position of natural index n.
INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)

# 64x64 permutation matrix P with (P @ v_zigzag) = v_natural.
ZIGZAG_PERM = np.zeros((64, 64), dtype=np.float64)
ZIGZAG_PERM[ZIGZAG, np.arange(64)] = 1.0

# ---------------------------------------------------------------------------
# Quantization tables (Annex K) and libjpeg-style quality scaling
# ---------------------------------------------------------------------------

# Natural (row-major) order.
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


def quality_scaled_quant(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling of a base quantization table.

    quality in [1, 100]; 50 = base table, 100 = all ones (max quality).
    """
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000 // quality
    else:
        scale = 200 - quality * 2
    q = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)


def quant_tables_for_quality(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantization tables in natural order."""
    return (
        quality_scaled_quant(STD_LUMA_QUANT, quality),
        quality_scaled_quant(STD_CHROMA_QUANT, quality),
    )


# ---------------------------------------------------------------------------
# Huffman table specifications (Annex K defaults)
# ---------------------------------------------------------------------------
# A Huffman spec is (bits, vals):
#   bits[i]  = number of codes of length i+1 (i in 0..15)
#   vals     = symbols in increasing code order
# Symbols: DC tables -> size category (0..11); AC tables -> (run << 4) | size,
# with 0x00 = EOB and 0xF0 = ZRL.

STD_DC_LUMA_BITS = np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int32)
STD_DC_LUMA_VALS = np.arange(12, dtype=np.int32)

STD_DC_CHROMA_BITS = np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.int32)
STD_DC_CHROMA_VALS = np.arange(12, dtype=np.int32)

STD_AC_LUMA_BITS = np.array(
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], np.int32
)
STD_AC_LUMA_VALS = np.array(
    # fmt: off
    [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    # fmt: on
    dtype=np.int32,
)

STD_AC_CHROMA_BITS = np.array(
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], np.int32
)
STD_AC_CHROMA_VALS = np.array(
    # fmt: off
    [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    # fmt: on
    dtype=np.int32,
)


@dataclasses.dataclass(frozen=True, eq=False)
class HuffmanSpec:
    """(bits, vals) Huffman table specification as stored in a DHT segment.

    ``eq=False``: the ndarray fields make the generated ``__eq__`` /
    ``__hash__`` raise (or compare elementwise), so instances compare and
    hash by identity — content identity goes through :meth:`digest`,
    which is what the LUT cache keys on.
    """

    bits: np.ndarray  # (16,) int32, bits[i] = #codes of length i+1
    vals: np.ndarray  # (sum(bits),) int32 symbols

    def __post_init__(self):
        assert self.bits.shape == (16,)
        assert int(self.bits.sum()) == len(self.vals)
        # Kraft inequality must hold for a prefix code.
        kraft = sum(int(n) / (1 << (i + 1)) for i, n in enumerate(self.bits))
        assert kraft <= 1.0 + 1e-12, f"invalid Huffman spec (Kraft={kraft})"

    def digest(self) -> str:
        h = hashlib.sha1()
        h.update(self.bits.astype(np.int32).tobytes())
        h.update(self.vals.astype(np.int32).tobytes())
        return h.hexdigest()


STD_SPECS = {
    ("dc", 0): HuffmanSpec(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS),
    ("ac", 0): HuffmanSpec(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS),
    ("dc", 1): HuffmanSpec(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS),
    ("ac", 1): HuffmanSpec(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS),
}


# ---------------------------------------------------------------------------
# Canonical code construction (T.81 Annex C)
# ---------------------------------------------------------------------------

def build_canonical_codes(spec: HuffmanSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Return (codes, lengths) indexed by *symbol value* (0..255).

    codes[sym] is the right-aligned canonical codeword for `sym`;
    lengths[sym] == 0 means the symbol is absent from the table.
    """
    codes = np.zeros(256, dtype=np.uint32)
    lengths = np.zeros(256, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(spec.bits[length - 1])):
            sym = int(spec.vals[k])
            codes[sym] = code
            lengths[sym] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


# LUT entry packing (int32):
#   bits  0..4   : codeword length in bits (1..16); 0 => invalid window
#   bits  5..9   : size (number of magnitude bits following the codeword, 0..15)
#   bits 10..13  : run (number of zero coefficients preceding, 0..15)
#   bit  14      : is_eob
#   bit  15      : is_zrl
LUT_LEN_SHIFT = 0
LUT_SIZE_SHIFT = 5
LUT_RUN_SHIFT = 10
LUT_EOB_BIT = 1 << 14
LUT_ZRL_BIT = 1 << 15
LOOKAHEAD_BITS = 16


def pack_lut_entry(codelen: int, size: int, run: int, is_eob: bool, is_zrl: bool) -> int:
    v = (codelen << LUT_LEN_SHIFT) | (size << LUT_SIZE_SHIFT) | (run << LUT_RUN_SHIFT)
    if is_eob:
        v |= LUT_EOB_BIT
    if is_zrl:
        v |= LUT_ZRL_BIT
    return v


def build_decode_lut(spec: HuffmanSpec, is_dc: bool) -> np.ndarray:
    """Full 2^16-entry lookahead decode table.

    lut[w] for a 16-bit window w (MSB-aligned next bits of the stream) packs
    (codelen, size, run, eob, zrl) for the codeword at the head of w.
    Windows that do not start with any valid codeword get entry 0; the decoder
    treats codelen==0 as "skip one bit" (desynchronized garbage), which
    preserves forward progress during speculative decoding.
    """
    lut = np.zeros(1 << LOOKAHEAD_BITS, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(spec.bits[length - 1])
        for _ in range(n):
            sym = int(spec.vals[k])
            if is_dc:
                size, run, eob, zrl = sym & 0xF, 0, False, False
                # DC size categories can reach 11 for 8-bit precision -> the
                # 4-bit LUT size field only holds 0..15, fine.
                assert sym <= 15, "DC category out of range"
            else:
                run, size = (sym >> 4) & 0xF, sym & 0xF
                eob = sym == 0x00
                zrl = sym == 0xF0
            entry = pack_lut_entry(length, size, run, eob, zrl)
            lo = code << (LOOKAHEAD_BITS - length)
            hi = (code + 1) << (LOOKAHEAD_BITS - length)
            lut[lo:hi] = entry
            code += 1
            k += 1
        code <<= 1
    return lut


def min_bits_per_zstep(specs: Sequence[HuffmanSpec]) -> int:
    """Lower bound on bits consumed per zig-zag step across the given tables.

    Used to bound the number of decode iterations per subsequence. A symbol
    consuming (codelen + size) bits advances the zig-zag index by run+1 (or
    more for EOB); the per-step cost is (codelen+size)/(run+1).
    """
    best = 32.0
    for spec in specs:
        codes, lengths = build_canonical_codes(spec)
        for sym in range(256):
            if lengths[sym] == 0:
                continue
            run, size = (sym >> 4) & 0xF, sym & 0xF
            if sym == 0x00:  # EOB advances up to 64
                step = (lengths[sym]) / 64.0
            else:
                step = (lengths[sym] + size) / (run + 1)
            best = min(best, step)
    return max(1, int(np.floor(best)))


# ---------------------------------------------------------------------------
# Optimal (image-adaptive) Huffman table generation — T.81 Annex K.2
# ---------------------------------------------------------------------------

def spec_from_frequencies(freqs: np.ndarray) -> HuffmanSpec:
    """Generate a JPEG-legal (<=16 bit) Huffman spec from symbol frequencies.

    Implements the standard's two-phase procedure: build an unconstrained
    Huffman code by repeated pairing (with the reserved all-ones codepoint
    trick via the +1 dummy symbol), then apply the Annex K.2 BITS adjustment
    to cap code lengths at 16.
    """
    freqs = np.asarray(freqs, dtype=np.int64).copy()
    assert freqs.shape == (256,)
    # Dummy symbol (index 256) with freq 1 reserves the all-ones codeword.
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = freqs
    freq[256] = 1
    others = np.full(257, -1, dtype=np.int64)
    codesize = np.zeros(257, dtype=np.int64)

    while True:
        present = np.where(freq > 0)[0]
        if len(present) <= 1:
            break
        # Find two least-frequent symbols (ties -> larger index first, per spec).
        order = sorted(present, key=lambda i: (freq[i], -i))
        v1, v2 = int(order[0]), int(order[1])
        if v1 > v2:  # spec: v1 is the larger-index of equal-freq pair
            v1, v2 = v2, v1
        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] >= 0:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] >= 0:
            v2 = int(others[v2])
            codesize[v2] += 1

    bits = np.zeros(33, dtype=np.int64)
    for i in range(257):
        if codesize[i] > 0:
            bits[min(int(codesize[i]), 32)] += 1

    # Adjust BITS so no code exceeds 16 bits (Annex K.2 Figure K.3).
    i = 32
    while i > 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    # Remove the reserved codepoint (largest code).
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1

    # Sort symbols by (codesize, symbol value) to produce VALS.
    syms = [s for s in range(256) if codesize[s] > 0]
    syms.sort(key=lambda s: (codesize[s], s))
    out_bits = bits[1:17].astype(np.int32)
    vals = np.array(syms, dtype=np.int32)
    assert int(out_bits.sum()) == len(vals)
    return HuffmanSpec(out_bits, vals)


# ---------------------------------------------------------------------------
# Magnitude category ("size") helpers
# ---------------------------------------------------------------------------

def magnitude_category(values: np.ndarray) -> np.ndarray:
    """JPEG size category: number of bits to represent |v| (0 for v == 0)."""
    a = np.abs(values.astype(np.int64))
    cat = np.zeros_like(a)
    nz = a > 0
    cat[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return cat.astype(np.int32)


def ones_complement_bits(values: np.ndarray, cats: np.ndarray) -> np.ndarray:
    """The `cat`-bit magnitude field for each value (T.81 F.1.2.1.1).

    Positive v -> v; negative v -> v + 2^cat - 1 (ones' complement).
    """
    v = values.astype(np.int64)
    out = np.where(v >= 0, v, v + (np.int64(1) << cats.astype(np.int64)) - 1)
    return out.astype(np.int64)


def extend_magnitude(bits: np.ndarray, cats: np.ndarray) -> np.ndarray:
    """Inverse of ones_complement_bits (T.81 F.2.2.1 EXTEND)."""
    b = bits.astype(np.int64)
    c = cats.astype(np.int64)
    half = np.where(c > 0, np.int64(1) << np.maximum(c - 1, 0), np.int64(1))
    out = np.where((c > 0) & (b < half), b - (np.int64(1) << c) + 1, b)
    return np.where(c == 0, 0, out)

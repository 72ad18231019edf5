"""What a batch's data needs of the card, counted from the data itself,
and the card's published peaks: the yardstick of the roofline metrics.

The counts stay the same whatever implements a stage, so a redesign or a
fusion can neither make a share stale nor push it past 100%:

- the sync: one pass over every lane's data. Every schedule decodes at
  least each lane's compressed bits once (read once) and leaves an exit
  state a lane (four 32-bit words: bit position, unit, zig-zag position
  and symbol count, written once).
- the pixel stage: each coefficient read once at the width baseline JPEG
  needs (16 bits) and each RGB sample written once (8 bits); operations
  the dequantization (one product a coefficient), the separable 8x8
  inverse DCT (two 8x8x8 products a block, 2 FLOPs a multiply-add) and
  the color conversion (four multiply-adds a pixel).

Lanes are the paper's subsequences: each entropy segment cut into
``chunk_bits`` pieces. No count depends on the program's instructions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from .jpeg_encoder import Geometry

EXIT_STATE_BYTES = 16
COEFF_BYTES = 2
IDCT_FLOPS_PER_UNIT = 2 * 8 * 8 * 8 * 2
DEQUANT_FLOPS_PER_UNIT = 64
COLOR_FLOPS_PER_PIXEL = 4 * 2

# NVIDIA H100 SXM5 data sheet, dense, at the full 700 W power limit
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}}


@dataclasses.dataclass(frozen=True)
class BatchWork:
    images: int
    lanes: int
    scan_bytes: int      # clean (unstuffed) entropy-coded bytes
    units: int
    pixels: int

    @property
    def sync_bytes(self) -> int:
        return self.scan_bytes + EXIT_STATE_BYTES * self.lanes

    @property
    def pixel_bytes(self) -> int:
        return self.units * 64 * COEFF_BYTES + self.pixels * 3

    @property
    def pixel_flops(self) -> int:
        return (self.units * (IDCT_FLOPS_PER_UNIT + DEQUANT_FLOPS_PER_UNIT)
                + self.pixels * COLOR_FLOPS_PER_PIXEL)


def lanes_of(segment_bytes: Sequence[int], chunk_bits: int) -> int:
    """Subsequences of ``chunk_bits`` that a frame's segments cut into."""
    return sum(-(-8 * b // chunk_bits) for b in segment_bytes)


def batch_work(frame_ids: Sequence[int], segment_bytes, g: Geometry,
               chunk_bits: int) -> BatchWork:
    """The work of a batch of the frames ``frame_ids``."""
    return BatchWork(
        images=len(frame_ids),
        lanes=sum(lanes_of(segment_bytes[f], chunk_bits) for f in frame_ids),
        scan_bytes=sum(sum(segment_bytes[f]) for f in frame_ids),
        units=len(frame_ids) * g.n_units,
        pixels=len(frame_ids) * g.width * g.height)


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card by its name, None for another card."""
    return next((p for k, p in PEAKS.items() if k in kind), None)


def least_seconds(nbytes: float, flops: float,
                  peaks: Dict[str, float]) -> Tuple[float, str]:
    """The least time of ``nbytes`` and ``flops`` on the card, and which
    of the two bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_flops = flops / peaks["f32_flops_per_s"]
    if t_bytes >= t_flops:
        return t_bytes, "bytes"
    return t_flops, "operations"

"""The plain reference: a frame's pixels from the coefficients it was
encoded with, and the comparison that decides ``correct``.

T.81's decode after the entropy stage, written straight in PyTorch on any
device: DC prediction undone per component (reset at each restart
interval), dequantization, the 8x8 inverse DCT as ``C^T F C`` in float64,
level shift, rounding and clamping of each component's plane, chroma
upsampled by replication, the JFIF color conversion in float64, rounding
and clamping. That is the repository's sequential oracle
(``jpeg/codec_ref.py`` ``decode_baseline``) step for step
(``test_perfbench_reference.py`` holds them equal), made from the
encoder's own coefficients instead of a decode of the bytes, which at
full size would take the oracle tens of seconds a frame. It imports
nothing of the program.

``precision="tf32"`` is the control: the same, with the IDCT's operands
rounded to TF32 (10 explicit mantissa bits, as the tensor cores take
float32 operands) and its sums and the color conversion in float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import jpeg_encoder as E

PRECISIONS = ("float64", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _idct(deq: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return c.T @ deq @ c
    c32 = to_tf32(c.float())
    half = to_tf32(c32.T @ to_tf32(deq.float()))
    return to_tf32(half) @ c32


def rgb(coeff: np.ndarray, g: E.Geometry, quality: int,
        restart_interval: int, device, precision: str = "float64"
        ) -> torch.Tensor:
    """One frame's (H, W, 3) uint8 RGB on ``device`` from its encoded
    (n_units, 64) coefficients (zig-zag, DC differential)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    fdt = torch.float64 if precision == "float64" else torch.float32
    comp, block = E.scan_layout(g)
    quant = E.quant_tables_for_quality(quality)
    c = torch.from_numpy(E.dct_matrix()).to(device)
    zz = torch.from_numpy(E.ZIGZAG.astype(np.int64)).to(device)
    x = torch.from_numpy(np.ascontiguousarray(coeff, dtype=np.int64)
                         ).to(device)
    upm = g.units_per_mcu
    step = restart_interval * upm if restart_interval else g.n_units
    planes = []
    for ci in range(len(g.factors)):
        sel = np.flatnonzero(comp == ci)
        z = x[torch.from_numpy(sel).to(device)]
        # DC prediction restarts at each interval boundary
        interval = torch.from_numpy(sel // step).to(device)
        dc = z[:, 0].cumsum(0)
        first = torch.ones_like(interval, dtype=torch.bool)
        first[1:] = interval[1:] != interval[:-1]
        starts = torch.cummax(torch.where(
            first, torch.arange(len(sel), device=device), 0), 0).values
        base = torch.where(starts > 0, dc[(starts - 1).clamp(min=0)], 0)
        z = z.clone()
        z[:, 0] = dc - base
        nat = torch.zeros_like(z)
        nat[:, zz] = z
        q = torch.from_numpy(quant[0 if ci == 0 else 1].astype(np.int64)
                             ).to(device)
        deq = (nat * q).to(torch.float64).reshape(-1, 8, 8)
        pix = _idct(deq, c, precision).to(fdt) + 128.0
        ph, pw = g.plane_shape(ci)
        blocks = torch.zeros((ph // 8) * (pw // 8), 8, 8, dtype=fdt,
                             device=device)
        blocks[torch.from_numpy(block[sel]).to(device)] = pix
        plane = blocks.reshape(ph // 8, pw // 8, 8, 8).permute(0, 2, 1, 3)
        planes.append(plane.reshape(ph, pw).round().clamp(0, 255))
    full = []
    h_full, w_full = g.mcus_y * 8 * g.v_max, g.mcus_x * 8 * g.h_max
    for ci, p in enumerate(planes):
        h, v = g.factors[ci]
        up = p.repeat_interleave(g.v_max // v, 0)
        up = up.repeat_interleave(g.h_max // h, 1)
        full.append(up[:h_full, :w_full])
    y, cb, cr = full[0], full[1] - 128.0, full[2] - 128.0
    out = torch.stack([y + 1.402 * cr,
                       y - 0.344136286 * cb - 0.714136286 * cr,
                       y + 1.772 * cb], dim=-1)
    out = out.round().clamp(0, 255).to(torch.uint8)
    return out[:g.height, :g.width]


class Comparison:
    """The compared numbers over every image checked: the largest
    difference of a sample from the reference, the share of samples that
    differ at all, and the batches that did not converge."""

    def __init__(self):
        self.max_diff = 0
        self.off = 0
        self.samples = 0
        self.images = 0
        self.unconverged = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """One image: the program's RGB against the reference's."""
        self.images += 1
        n = want.numel()
        self.samples += n
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            self.max_diff = max(self.max_diff, 255)
            self.off += n
            return
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        self.max_diff = max(self.max_diff, int(d.max()))
        self.off += int((d > 0).sum())

    def numbers(self) -> Dict[str, float]:
        return {"rgb_max_diff": self.max_diff,
                "rgb_off_share": self.off / max(self.samples, 1),
                "unconverged_batches": self.unconverged}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Whether every compared number is within its limit, and each
    number beside its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), shown

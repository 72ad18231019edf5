"""The color kernel: three component planes to (B, H, W, 3) uint8 RGB.

:func:`upsample_color` runs ``csrc/color.cu`` on the card (a run of
consecutive pixels of one row a thread, its body in ``csrc/color.cuh``);
its plain version :func:`upsample_color_plain` is
``core.decode.upsample_color`` for three planes (replicate upsample, then
``ycbcr_to_rgb``), whose arithmetic the kernel repeats with one rounding
per operation, so the two agree bit for bit. The last stage of the
unfused pixel chain (``fuse="none"``).

Each component ``c`` is upsampled by ``v_max // comp_v[c]`` rows and
``h_max // comp_h[c]`` columns, the factors the geometry gives, so every
layout the plain version takes, the kernel takes.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from ...core import decode as D
from .. import build as B

_IP = ctypes.POINTER(ctypes.c_int)
_ARGS = [ctypes.POINTER(ctypes.c_void_p)] + [_IP] * 4 + \
    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(planes: List[torch.Tensor], comp_h: Sequence[int],
           comp_v: Sequence[int], h_max: int, v_max: int, height: int,
           width: int):
    """Validate the layout; return the per-component factors (fv, fh)."""
    if len(planes) != 3 or len(comp_h) != 3 or len(comp_v) != 3:
        raise ValueError(f"the color stage needs three planes; got "
                         f"{len(planes)}")
    fv = [v_max // v for v in comp_v]
    fh = [h_max // h for h in comp_h]
    full_h = planes[0].shape[1] * fv[0]
    full_w = planes[0].shape[2] * fh[0]
    for p, v, h in zip(planes, fv, fh):
        if p.dim() != 3 or p.shape[0] != planes[0].shape[0] or \
                p.shape[1] * v < full_h or p.shape[2] * h < full_w:
            raise ValueError("planes must be (B, Hc, Wc) and each must "
                             "cover the luma plane once upsampled")
    if not (0 < height <= full_h and 0 < width <= full_w):
        raise ValueError(f"image {height}x{width} exceeds the planes")
    return fv, fh


def upsample_color_plain(planes: List[torch.Tensor], comp_h, comp_v,
                         h_max: int, v_max: int, height: int,
                         width: int) -> torch.Tensor:
    """(B, height, width, 3) uint8 RGB: ``core.decode.upsample_color``."""
    _check(planes, comp_h, comp_v, h_max, v_max, height, width)
    return D.upsample_color(planes, comp_h, comp_v, h_max, v_max, height,
                            width)


def upsample_color(planes: List[torch.Tensor], comp_h, comp_v, h_max: int,
                   v_max: int, height: int, width: int) -> torch.Tensor:
    """:func:`upsample_color_plain`, by the color kernel on the card."""
    if planes[0].device.type == "cpu":
        return upsample_color_plain(planes, comp_h, comp_v, h_max, v_max,
                                    height, width)
    out = run_color_kernel(planes, comp_h, comp_v, h_max, v_max, height,
                           width)
    upsample_color.launches += 1
    return out


upsample_color.launches = 0


def run_color_kernel(planes: List[torch.Tensor], comp_h, comp_v,
                     h_max: int, v_max: int, height: int, width: int,
                     checked: bool = False) -> torch.Tensor:
    """One launch of the color kernel (``rt_upsample_color``), uncounted,
    also of the checked build (``checked=True``, the kernel verifier's).
    Its launch has no knob: a block is a warp of runs across 8 rows."""
    fv, fh = _check(planes, comp_h, comp_v, h_max, v_max, height, width)
    dev = planes[0].device
    for p in planes:
        if p.device != dev or p.dtype != torch.float32 \
                or not p.is_contiguous():
            raise ValueError(f"planes must be contiguous float32 on {dev}; "
                             f"got {p.dtype} on {p.device}")
    n = planes[0].shape[0]
    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=dev)
    ints3 = ctypes.c_int * 3
    fn = B.entry("color", "rt_upsample_color", _ARGS, checked)
    B.check(fn((ctypes.c_void_p * 3)(*(B.ptr(p) for p in planes)),
               ints3(*(p.shape[1] for p in planes)),
               ints3(*(p.shape[2] for p in planes)), ints3(*fv), ints3(*fh),
               B.ptr(out), n, height, width, B.stream_of(out)),
            "rt_upsample_color")
    return out

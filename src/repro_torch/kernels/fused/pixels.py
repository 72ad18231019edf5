"""The fused pixel kernel: coefficients to RGB MCU blocks in one launch.

:func:`fused_pixels` runs ``csrc/pixels.cu`` on the card; its plain
version :func:`fused_pixels_plain` computes the same function with the
plain decoder's stages (``core.decode``), in the same arithmetic order,
so the two agree bit for bit. Both return ``(n_mcus, 8*v_max, 8*h_max, 3)``
uint8 blocks; ``ops.decode_pixels_fused`` turns them into images.

The plan's unit order is image-major, MCU-major and component-blocked
within an MCU (comp 0's v*h units row-major over the MCU's block grid,
then comp 1's, ...), so one MCU's units are ``upm`` consecutive rows.

Both take the folded operators transposed, ``m_t[q, j, k] = M_q[k, j]``
(``dev["m_matrices_t"]``, made once per plan), the layout in which the
kernel's threads read consecutive words.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core import decode as D
from .. import build as B

#: Units staged per block: 8 MCUs of 4:2:0, 16 of 4:4:4 (24.8 KB of
#: shared memory either way).
UNITS_PER_BLOCK = 48
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
    [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p]


def _check_layout(coeffs, comp_h, comp_v, upm):
    u, width = coeffs.shape
    if width != 64 or len(comp_h) != 3 or len(comp_v) != 3 or upm != sum(
            h * v for h, v in zip(comp_h, comp_v)) or u % upm:
        raise ValueError(
            f"the fused pixel stage needs (n_mcus*upm, 64) coefficients "
            f"for a 3-component layout; got {tuple(coeffs.shape)}, upm "
            f"{upm}, comp_h {comp_h}, comp_v {comp_v}")
    return u // upm


def fused_pixels_plain(coeffs: torch.Tensor, m_t: torch.Tensor,
                       unit_mrow: torch.Tensor, *, comp_h: Tuple[int, ...],
                       comp_v: Tuple[int, ...], h_max: int, v_max: int,
                       upm: int) -> torch.Tensor:
    """RGB MCU blocks from (n_mcus*upm, 64) zig-zag coefficients."""
    n_mcus = _check_layout(coeffs, comp_h, comp_v, upm)
    pix = D.idct_units_folded(coeffs, m_t.transpose(1, 2), unit_mrow)
    pix = pix.reshape(n_mcus, upm, 64)
    planes, off = [], 0
    for h, v in zip(comp_h, comp_v):
        sub = pix[:, off:off + v * h].reshape(n_mcus, v, h, 8, 8)
        off += v * h
        p = sub.permute(0, 1, 3, 2, 4).reshape(n_mcus, v * 8, h * 8)
        fv, fh = v_max // v, h_max // h
        if fv > 1:
            p = torch.repeat_interleave(p, fv, dim=1)
        if fh > 1:
            p = torch.repeat_interleave(p, fh, dim=2)
        planes.append(p)
    return D.ycbcr_to_rgb(*planes)


def fused_pixels(coeffs: torch.Tensor, m_t: torch.Tensor,
                 unit_mrow: torch.Tensor, *, comp_h: Tuple[int, ...],
                 comp_v: Tuple[int, ...], h_max: int, v_max: int,
                 upm: int) -> torch.Tensor:
    """:func:`fused_pixels_plain`, by the pixel kernel on the card."""
    if coeffs.device.type == "cpu":
        return fused_pixels_plain(coeffs, m_t, unit_mrow, comp_h=comp_h,
                                  comp_v=comp_v, h_max=h_max, v_max=v_max,
                                  upm=upm)
    n_mcus = _check_layout(coeffs, comp_h, comp_v, upm)
    dev = coeffs.device
    for t, dt in ((coeffs, torch.int32), (unit_mrow, torch.int32),
                  (m_t, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pixel kernel operands must be contiguous and "
                             f"on {dev}; got {t.dtype} on {t.device}")
    if unit_mrow.shape != (coeffs.shape[0],) or m_t.shape[1:] != (64, 64):
        raise ValueError("unit_mrow must be (U,) and m_t (NQ, 64, 64)")
    out = torch.empty((n_mcus, 8 * v_max, 8 * h_max, 3), dtype=torch.uint8,
                      device=dev)
    ints3 = ctypes.c_int * 3
    fn = B.entry("pixels", "rt_fused_pixels", _ARGS)
    B.check(fn(B.ptr(coeffs), B.ptr(m_t), B.ptr(unit_mrow), B.ptr(out),
               n_mcus, upm, ints3(*comp_h), ints3(*comp_v), h_max, v_max,
               max(1, UNITS_PER_BLOCK // upm), B.stream_of(out)),
            "rt_fused_pixels")
    fused_pixels.launches += 1
    return out


fused_pixels.launches = 0

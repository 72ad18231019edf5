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
kernel's threads read consecutive words. The kernel has its own code for
4:2:0, 4:2:2 and 4:4:4 and one generic path for every other layout whose
sampling factors divide the largest (``csrc/pixels.cuh`` holds its
pixel-to-sample mapping; :func:`mcu_planes` is the plain version's).

``launch.pixel_groups`` (a ``kernels.autotune.LaunchConfig``) sets the
kernel's thread groups a block: 0 is its default, any other value must be
a multiple of the units per MCU (else ``ValueError``).
:func:`run_pixel_kernel` is one launch, uncounted, also of the checked
build (``checked=True``, the kernel verifier's).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core import decode as D
from .. import build as B
from ..autotune import DEFAULT_LAUNCH, LaunchConfig

_VP = ctypes.c_void_p
_INTS = ctypes.POINTER(ctypes.c_int)
_ARGS = [_VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_longlong, _INTS, _INTS,
         ctypes.c_int, _VP]
# rt_fused_pixels_geometry (checked build): _ARGS with tile_mcus and blocks
GEOMETRY_ARGS = _ARGS[:8] + [ctypes.c_int, ctypes.c_int, _VP]
MAX_UNITS_PER_MCU = 6


def _check_layout(coeffs, comp_h, comp_v, h_max, v_max, upm):
    u, width = coeffs.shape
    if width != 64 or len(comp_h) != 3 or len(comp_v) != 3 or upm != sum(
            h * v for h, v in zip(comp_h, comp_v)) or u % upm \
            or upm > MAX_UNITS_PER_MCU or (h_max, v_max) != (
                max(comp_h), max(comp_v)) \
            or any(h_max % h or v_max % v for h, v in zip(comp_h, comp_v)):
        raise ValueError(
            f"the fused pixel stage needs (n_mcus*upm, 64) coefficients "
            f"for a 3-component layout of at most {MAX_UNITS_PER_MCU} units "
            f"per MCU whose sampling factors divide the largest; got "
            f"{tuple(coeffs.shape)}, upm {upm}, comp_h {comp_h}, comp_v "
            f"{comp_v}, h_max {h_max}, v_max {v_max}")
    return u // upm


def mcu_planes(pix: torch.Tensor, *, comp_h: Tuple[int, ...],
               comp_v: Tuple[int, ...], h_max: int, v_max: int,
               upm: int) -> list:
    """The three (n_mcus, 8*v_max, 8*h_max) planes of each MCU, replicate
    upsampled, from its units' (n_mcus*upm, 64) row-major samples (any
    dtype): the plane assembly and upsample of :func:`fused_pixels_plain`.
    """
    n_mcus = pix.shape[0] // upm
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
    return planes


def fused_pixels_plain(coeffs: torch.Tensor, m_t: torch.Tensor,
                       unit_mrow: torch.Tensor, *, comp_h: Tuple[int, ...],
                       comp_v: Tuple[int, ...], h_max: int, v_max: int,
                       upm: int) -> torch.Tensor:
    """RGB MCU blocks from (n_mcus*upm, 64) zig-zag coefficients."""
    _check_layout(coeffs, comp_h, comp_v, h_max, v_max, upm)
    pix = D.idct_units_folded(coeffs, m_t.transpose(1, 2), unit_mrow)
    return D.ycbcr_to_rgb(*mcu_planes(pix, comp_h=comp_h, comp_v=comp_v,
                                      h_max=h_max, v_max=v_max, upm=upm))


def kernel_operands(coeffs: torch.Tensor, m_t: torch.Tensor,
                    unit_mrow: torch.Tensor, comp_h, comp_v, h_max: int,
                    v_max: int, upm: int) -> int:
    """Check the pixel kernel's operands on the card; return its MCUs."""
    n_mcus = _check_layout(coeffs, comp_h, comp_v, h_max, v_max, upm)
    dev = coeffs.device
    for t, dt in ((coeffs, torch.int32), (unit_mrow, torch.int32),
                  (m_t, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pixel kernel operands must be contiguous and "
                             f"on {dev}; got {t.dtype} on {t.device}")
    if unit_mrow.shape != (coeffs.shape[0],) or m_t.dim() != 3 \
            or m_t.shape[1:] != (64, 64):
        raise ValueError("unit_mrow must be (U,) and m_t (NQ, 64, 64)")
    if coeffs.data_ptr() % 16 or m_t.data_ptr() % 16:
        raise ValueError("the pixel kernel reads coeffs and m_t as 16-byte "
                         "words: they must be 16-byte aligned")
    return n_mcus


def run_pixel_kernel(coeffs: torch.Tensor, m_t: torch.Tensor,
                     unit_mrow: torch.Tensor, *, comp_h: Tuple[int, ...],
                     comp_v: Tuple[int, ...], h_max: int, v_max: int,
                     upm: int, launch: LaunchConfig = DEFAULT_LAUNCH,
                     checked: bool = False) -> torch.Tensor:
    """One launch of the pixel kernel (``rt_fused_pixels``), uncounted."""
    n_mcus = kernel_operands(coeffs, m_t, unit_mrow, comp_h, comp_v, h_max,
                             v_max, upm)
    groups = launch.pixel_groups
    if groups and groups % upm:
        raise ValueError(f"pixel_groups={groups} is not a multiple of the "
                         f"{upm} units per MCU")
    out = torch.empty((n_mcus, 8 * v_max, 8 * h_max, 3), dtype=torch.uint8,
                      device=coeffs.device)
    ints3 = ctypes.c_int * 3
    B.check(B.entry("pixels", "rt_fused_pixels", _ARGS, checked)(
        B.ptr(coeffs), B.ptr(m_t), m_t.shape[0], B.ptr(unit_mrow),
        B.ptr(out), n_mcus, ints3(*comp_h), ints3(*comp_v), groups,
        B.stream_of(out)), "rt_fused_pixels")
    return out


def fused_pixels(coeffs: torch.Tensor, m_t: torch.Tensor,
                 unit_mrow: torch.Tensor, *, comp_h: Tuple[int, ...],
                 comp_v: Tuple[int, ...], h_max: int, v_max: int,
                 upm: int, launch: LaunchConfig = DEFAULT_LAUNCH
                 ) -> torch.Tensor:
    """:func:`fused_pixels_plain`, by the pixel kernel on the card."""
    if coeffs.device.type == "cpu":
        return fused_pixels_plain(coeffs, m_t, unit_mrow, comp_h=comp_h,
                                  comp_v=comp_v, h_max=h_max, v_max=v_max,
                                  upm=upm)
    out = run_pixel_kernel(coeffs, m_t, unit_mrow, comp_h=comp_h,
                           comp_v=comp_v, h_max=h_max, v_max=v_max, upm=upm,
                           launch=launch)
    fused_pixels.launches += 1
    return out


fused_pixels.launches = 0


def tile_mcus(upm: int, groups: int = 0) -> int:
    """MCUs per tile of the pixel kernel at ``upm`` units per MCU and a
    ``pixel_groups`` knob (a partial last tile is the edge the card's
    tests cover); -1 for a knob the layout refuses."""
    return B.entry("pixels", "rt_pixels_tile_mcus",
                   [ctypes.c_int, ctypes.c_int])(upm, groups)

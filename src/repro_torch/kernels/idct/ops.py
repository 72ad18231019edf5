"""The IDCT kernel: (U, 64) zig-zag coefficients to (U, 64) pixel samples.

:func:`idct_units` runs ``csrc/idct.cu`` on the card; its plain version
:func:`idct_units_plain` is ``core.decode.idct_units_folded``, which sums
in the kernel's order, so the two agree bit for bit. It is the first
stage of the unfused pixel chain (``fuse="none"``, and grayscale batches
under every fuse mode): IDCT, then ``core.decode.assemble_planes``, then
the color kernel (``kernels/color``) or, for one plane, a crop and cast.

Both take the folded operators transposed, ``m_t[q, j, k] = M_q[k, j]``
(``dev["m_matrices_t"]``, made once per plan), the layout in which the
kernel's threads read consecutive words.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import decode as D
from .. import build as B

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]


def idct_units_plain(coeffs: torch.Tensor, m_t: torch.Tensor,
                     unit_mrow: torch.Tensor) -> torch.Tensor:
    """(U, 64) f32 samples in [0, 255] from (U, 64) int32 coefficients."""
    return D.idct_units_folded(coeffs, m_t.transpose(1, 2), unit_mrow)


def idct_units(coeffs: torch.Tensor, m_t: torch.Tensor,
               unit_mrow: torch.Tensor) -> torch.Tensor:
    """:func:`idct_units_plain`, by the IDCT kernel on the card."""
    if coeffs.device.type == "cpu":
        return idct_units_plain(coeffs, m_t, unit_mrow)
    dev = coeffs.device
    for t, dt in ((coeffs, torch.int32), (unit_mrow, torch.int32),
                  (m_t, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"IDCT kernel operands must be contiguous and "
                             f"on {dev}; got {t.dtype} on {t.device}")
    u = coeffs.shape[0]
    if coeffs.shape != (u, 64) or unit_mrow.shape != (u,) \
            or m_t.dim() != 3 or m_t.shape[1:] != (64, 64):
        raise ValueError("the IDCT kernel needs coeffs (U, 64), unit_mrow "
                         "(U,) and m_t (NQ, 64, 64)")
    out = torch.empty((u, 64), dtype=torch.float32, device=dev)
    B.check(B.entry("idct", "rt_idct_units", _ARGS)(
        B.ptr(coeffs), B.ptr(m_t), B.ptr(unit_mrow), B.ptr(out), u,
        B.stream_of(out)), "rt_idct_units")
    idct_units.launches += 1
    return out


idct_units.launches = 0

"""The IDCT kernel: (U, 64) zig-zag coefficients to (U, 64) pixel samples.

:func:`idct_units` runs ``csrc/idct.cu`` on the card; its plain version
:func:`idct_units_plain` is ``core.decode.idct_units_folded``, which sums
in the kernel's order, so the two agree bit for bit. It is the first
stage of the unfused pixel chain (``fuse="none"``, and grayscale batches
under every fuse mode): IDCT, then ``core.decode.assemble_planes``, then
the color kernel (``kernels/color``) or, for one plane, a crop and cast.

Both take the folded operators transposed, ``m_t[q, j, k] = M_q[k, j]``
(``dev["m_matrices_t"]``, made once per plan): for each ``j`` the kernel
reads a run of consecutive ``k`` as 16-byte words.

``launch.idct_groups`` (a ``kernels.autotune.LaunchConfig``) sets the
kernel's thread groups a block: 0 is its default, any other value must be
a multiple of ``units_per_mcu`` (else ``ValueError``).
:func:`run_idct_kernel` is one launch, uncounted, also of the checked
build (``checked=True``, the kernel verifier's).
"""
from __future__ import annotations

import ctypes

import torch

from ...core import decode as D
from .. import build as B
from ..autotune import DEFAULT_LAUNCH, LaunchConfig

_VP = ctypes.c_void_p
_ARGS = [_VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, _VP]
MAX_UNITS_PER_MCU = 6


def idct_units_plain(coeffs: torch.Tensor, m_t: torch.Tensor,
                     unit_mrow: torch.Tensor) -> torch.Tensor:
    """(U, 64) f32 samples in [0, 255] from (U, 64) int32 coefficients."""
    return D.idct_units_folded(coeffs, m_t.transpose(1, 2), unit_mrow)


def idct_units(coeffs: torch.Tensor, m_t: torch.Tensor,
               unit_mrow: torch.Tensor, units_per_mcu: int = 1,
               launch: LaunchConfig = DEFAULT_LAUNCH) -> torch.Tensor:
    """:func:`idct_units_plain`, by the IDCT kernel on the card.

    Each thread of the kernel computes 6 units that lie ``units_per_mcu``
    apart and shares their matrix's words among them when the 6 units
    share one matrix: give the batch's units per MCU, which makes them
    the same component of 6 MCUs. Any value in 1..6 gives the same
    samples.
    """
    if not 1 <= units_per_mcu <= MAX_UNITS_PER_MCU:
        raise ValueError(f"units_per_mcu must be in 1..{MAX_UNITS_PER_MCU}, "
                         f"got {units_per_mcu}")
    if coeffs.device.type == "cpu":
        return idct_units_plain(coeffs, m_t, unit_mrow)
    out = run_idct_kernel(coeffs, m_t, unit_mrow, units_per_mcu, launch)
    idct_units.launches += 1
    return out


idct_units.launches = 0


def run_idct_kernel(coeffs: torch.Tensor, m_t: torch.Tensor,
                    unit_mrow: torch.Tensor, units_per_mcu: int = 1,
                    launch: LaunchConfig = DEFAULT_LAUNCH,
                    checked: bool = False) -> torch.Tensor:
    """One launch of the IDCT kernel (``rt_idct_units``), uncounted."""
    groups = launch.idct_groups
    if groups and groups % units_per_mcu:
        raise ValueError(f"idct_groups={groups} is not a multiple of "
                         f"units_per_mcu {units_per_mcu}")
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
    if coeffs.data_ptr() % 16 or m_t.data_ptr() % 16:
        raise ValueError("the IDCT kernel reads coeffs and m_t as 16-byte "
                         "words: they must be 16-byte aligned")
    out = torch.empty((u, 64), dtype=torch.float32, device=dev)
    B.check(B.entry("idct", "rt_idct_units", _ARGS, checked)(
        B.ptr(coeffs), B.ptr(m_t), m_t.shape[0], B.ptr(unit_mrow),
        B.ptr(out), u, units_per_mcu, groups, B.stream_of(out)),
        "rt_idct_units")
    return out


def tile_units(units_per_mcu: int = 1, groups: int = 0) -> int:
    """Units per tile of the IDCT kernel at an ``idct_groups`` knob (a
    partial last tile is the edge the card's tests cover); -1 for a knob
    the stride refuses."""
    return B.entry("idct", "rt_idct_tile_units",
                   [ctypes.c_int, ctypes.c_int])(units_per_mcu, groups)

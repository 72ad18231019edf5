"""The fused pixel stage as the decoder calls it: kernel plus layout.

:func:`decode_pixels_fused` runs the pixel kernel (``pixels.py``) over a
uniform batch's coefficient rows and turns its MCU blocks into
(B, H, W, 3) uint8 images: a reshape, a transpose and a crop, with no
arithmetic, so parity is decided inside the kernel.
"""
from __future__ import annotations

import torch

from .pixels import fused_pixels


def pixels_fusible(geometry) -> bool:
    """Whether the fused pixel kernel covers this batch's layout: a
    uniform 3-component geometry."""
    return (geometry is not None and geometry.n_components == 3
            and len(geometry.comp_h) == 3)


def decode_pixels_fused(coeffs: torch.Tensor, m_t: torch.Tensor,
                        unit_mrow: torch.Tensor, *, geometry,
                        n_images: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB from (B*g.n_units, 64) zig-zag coefficients
    with absolute DC; ``m_t`` is ``dev["m_matrices_t"]``."""
    g = geometry
    if not pixels_fusible(g):
        raise ValueError(
            f"the fused pixel kernel needs a uniform 3-component geometry; "
            f"got {g!r}")
    blocks = fused_pixels(coeffs, m_t, unit_mrow,
                          comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
                          h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    mcu_h, mcu_w = 8 * g.v_max, 8 * g.h_max
    img = blocks.reshape(n_images, g.mcus_y, g.mcus_x, mcu_h, mcu_w, 3)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(
        n_images, g.mcus_y * mcu_h, g.mcus_x * mcu_w, 3)
    return img[:, :g.height, :g.width]

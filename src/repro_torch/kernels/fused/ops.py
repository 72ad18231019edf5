"""The fused pixel stage as the decoder calls it: kernel plus layout.

:func:`decode_pixels_fused` runs the pixel kernel (``pixels.py``) over a
uniform batch's coefficient rows and turns its MCU blocks into
(B, H, W, 3) uint8 images: a reshape, a transpose and a crop, with no
arithmetic, so parity is decided inside the kernel. :func:`fuse_traffic`
counts the inter-stage bytes each fuse mode keeps out of device memory.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..autotune import DEFAULT_LAUNCH, LaunchConfig
from .pixels import fused_pixels


def pixels_fusible(geometry) -> bool:
    """Whether the fused pixel kernel covers this batch's layout: a
    uniform 3-component geometry."""
    return (geometry is not None and geometry.n_components == 3
            and len(geometry.comp_h) == 3)


def decode_pixels_fused(coeffs: torch.Tensor, m_t: torch.Tensor,
                        unit_mrow: torch.Tensor, *, geometry,
                        n_images: int,
                        launch: LaunchConfig = DEFAULT_LAUNCH
                        ) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB from (B*g.n_units, 64) zig-zag coefficients
    with absolute DC; ``m_t`` is ``dev["m_matrices_t"]``."""
    g = geometry
    if not pixels_fusible(g):
        raise ValueError(
            f"the fused pixel kernel needs a uniform 3-component geometry; "
            f"got {g!r}")
    blocks = fused_pixels(coeffs, m_t, unit_mrow,
                          comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
                          h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu,
                          launch=launch)
    mcu_h, mcu_w = 8 * g.v_max, 8 * g.h_max
    img = blocks.reshape(n_images, g.mcus_y, g.mcus_x, mcu_h, mcu_w, 3)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(
        n_images, g.mcus_y * mcu_h, g.mcus_x * mcu_w, 3)
    return img[:, :g.height, :g.width]


def fuse_traffic(shape, *, store_fused: bool, pixels_fused: bool) -> Dict:
    """Analytic inter-stage device-memory bytes per decode of one shape.

    * ``stream_bytes``: the write pass's (C, s_max) pos/val streams (one
      write and one read each): gone when the store kernel runs.
    * ``pixel_bytes``: the unfused pixel chain's intermediates (the
      per-unit pixels out of the IDCT kernel and the assembled YCbCr
      planes into the color stage, each written then read): gone when the
      fused pixel kernel runs.
    """
    stream = 0 if store_fused else 2 * 2 * shape.n_chunks * shape.s_max * 4
    pixel = 0
    if not pixels_fused and shape.uniform and shape.geometry is not None:
        unit_px = shape.n_images * shape.geometry.n_units * 64 * 4
        pixel = 2 * 2 * unit_px  # pixel tile + planes, written then read
    return {
        "stream_bytes": stream,
        "pixel_bytes": pixel,
        "inter_stage_bytes": stream + pixel,
    }

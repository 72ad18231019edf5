"""The kernel verifier's seeded faults, each with its plain version.

The JAX package's verifier proves itself on seeded faults before its
green result is trusted (``analysis/kernel_check.py`` ``run_self_test``);
three of them are Pallas kernels. Their counterparts here are CUDA
kernels of the checked build (``csrc/seeds.cu``, built only with
``-DRT_CHECK``) that make the same faults on the card:

* **S1** :func:`seed_oob_rows`, an off-by-one row read: the sum of rows
  ``i + 1`` of an (8, 4) f32 operand for ``i`` in 0..7, whose last read
  is row 8 of 8. The checked build records the read (site
  ``kSiteSeedRows``) and skips it (reads 0). Its plain version reads row
  8 and raises ``IndexError`` (``strict=False``: the sum of the rows that
  exist, what the checked kernel computes).
* **S2** :func:`seed_ident`, an identity copy over 2 blocks of 4 onto a
  (10,) f32: elements 8 and 9 are never written, which the coverage count
  shows. Its plain version copies 8 of 10 (the rest stay 0).
* **S3** :func:`seed_misaligned_tile`, the real pixel kernel (B4)
  launched through the checked build's explicit-geometry entry
  ``rt_fused_pixels_geometry`` with 4 MCUs a tile and 2 blocks over 10
  MCUs of a 4:2:0 batch: 8 of 10 MCUs are written. Its plain version is
  ``fused_pixels_plain`` on the first 8 MCUs (the rest stay 0).

Each card wrapper counts its launches (``.launches``) and, for a tensor on
the CPU, takes its plain version, which makes the same fault there.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import build as B
from .fused import pixels as FP

ROWS, COLS = 8, 4
IDENT_N, IDENT_TILE, IDENT_BLOCKS = 10, 4, 2
TILE_N_MCUS, TILE_MCUS, TILE_BLOCKS = 10, 4, 2
_VP = ctypes.c_void_p


def _seed_fn(name: str, argtypes):
    return B.entry("seeds", name, argtypes, checked=True)


# -- S1 --------------------------------------------------------------------

def seed_oob_rows_plain(x: torch.Tensor, strict: bool = True
                        ) -> torch.Tensor:
    """(1,) f32: the sum of rows 1..8 of the (8, 4) ``x``; row 8 raises
    ``IndexError``, or with ``strict=False`` counts 0."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(ROWS):
        if i + 1 >= x.shape[0] and not strict:
            continue
        acc = acc + x[i + 1].sum()  # the seeded fault: row i + 1
    return acc.reshape(1)


def seed_oob_rows(x: torch.Tensor) -> torch.Tensor:
    """S1 on the card (the checked build), its plain version on the CPU."""
    if x.device.type == "cpu":
        return seed_oob_rows_plain(x)
    if x.shape != (ROWS, COLS) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"S1 takes a contiguous ({ROWS}, {COLS}) f32")
    out = torch.zeros(1, dtype=torch.float32, device=x.device)
    B.check(_seed_fn("rt_seed_oob_rows", [_VP, _VP, _VP])(
        B.ptr(x), B.ptr(out), B.stream_of(out)), "rt_seed_oob_rows")
    seed_oob_rows.launches += 1
    return out


seed_oob_rows.launches = 0


# -- S2 --------------------------------------------------------------------

def seed_ident_plain(x: torch.Tensor, tile: int = IDENT_TILE,
                     blocks: int = IDENT_BLOCKS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, writes)``: the copy of the first ``tile * blocks`` elements
    of ``x`` (the rest 0), and how often each element was written."""
    n = min(tile * blocks, x.shape[0])
    out = torch.zeros_like(x)
    out[:n] = x[:n]
    writes = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    writes[:n] = 1
    return out, writes


def seed_ident(x: torch.Tensor, tile: int = IDENT_TILE,
               blocks: int = IDENT_BLOCKS) -> torch.Tensor:
    """S2 on the card (the checked build), its plain version's copy on the
    CPU."""
    if x.device.type == "cpu":
        return seed_ident_plain(x, tile, blocks)[0]
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("S2 takes a contiguous 1-D f32")
    out = torch.zeros_like(x)
    B.check(_seed_fn("rt_seed_ident", [_VP, _VP, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int, _VP])(
        B.ptr(x), B.ptr(out), x.shape[0], tile, blocks, B.stream_of(out)),
        "rt_seed_ident")
    seed_ident.launches += 1
    return out


seed_ident.launches = 0


# -- S3 --------------------------------------------------------------------

def seed_pixel_operands(device, seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """S3's operands: a 4:2:0 frame of 10 MCUs (80 x 32 pixels) from
    ``seed``, encoded and decoded to its coefficients by the plain decoder
    on the CPU: ``(coeffs (60, 64) int32, m_t (NQ, 64, 64) f32, unit_mrow
    (60,) int32, geo)`` on ``device``, ``geo`` the layout's keywords."""
    from ..core.api import ParallelDecoder
    from ..jpeg import codec_ref as cr
    from ..jpeg.encoder import synth_frame

    frame = synth_frame(np.random.default_rng(seed), 80, 32, t=0.0)
    blob = cr.encode_baseline(frame, quality=90,
                              subsampling="4:2:0").jpeg_bytes
    dec = ParallelDecoder.from_bytes([blob], chunk_bits=256, device="cpu",
                                     bucket=False)
    out = dec.coefficients()
    g = dec.plan.geometry
    geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
               h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    units = dec.plan.total_units
    tensors = (out.coeffs.contiguous(), dec.dev["m_matrices_t"].contiguous(),
               dec.dev["unit_mrow"][:units].contiguous())
    return tuple(t.to(device) for t in tensors) + (geo,)


def seed_misaligned_tile_plain(coeffs: torch.Tensor, m_t: torch.Tensor,
                               unit_mrow: torch.Tensor, *,
                               tile_mcus: int = TILE_MCUS,
                               blocks: int = TILE_BLOCKS, **geo
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, writes)``: ``fused_pixels_plain`` on the first
    ``tile_mcus * blocks`` MCUs (the rest 0), and how often each output
    byte was written."""
    full = FP.fused_pixels_plain(coeffs, m_t, unit_mrow, **geo)
    n = min(tile_mcus * blocks, full.shape[0])
    upm = geo["upm"]
    out = torch.zeros_like(full)
    out[:n] = FP.fused_pixels_plain(coeffs[:n * upm], m_t,
                                    unit_mrow[:n * upm], **geo)
    writes = torch.zeros(full.numel(), dtype=torch.int32,
                         device=full.device)
    writes[:out[:n].numel()] = 1
    return out, writes


def seed_misaligned_tile(coeffs: torch.Tensor, m_t: torch.Tensor,
                         unit_mrow: torch.Tensor, *,
                         tile_mcus: int = TILE_MCUS,
                         blocks: int = TILE_BLOCKS, **geo) -> torch.Tensor:
    """S3 on the card (the pixel kernel of the checked build, its tile and
    grid given), its plain version's output on the CPU."""
    if coeffs.device.type == "cpu":
        return seed_misaligned_tile_plain(coeffs, m_t, unit_mrow,
                                          tile_mcus=tile_mcus,
                                          blocks=blocks, **geo)[0]
    n_mcus = FP.kernel_operands(coeffs, m_t, unit_mrow, geo["comp_h"],
                                geo["comp_v"], geo["h_max"], geo["v_max"],
                                geo["upm"])
    out = torch.zeros((n_mcus, 8 * geo["v_max"], 8 * geo["h_max"], 3),
                      dtype=torch.uint8, device=coeffs.device)
    ints3 = ctypes.c_int * 3
    B.check(B.entry("pixels", "rt_fused_pixels_geometry", FP.GEOMETRY_ARGS,
                    checked=True)(
        B.ptr(coeffs), B.ptr(m_t), m_t.shape[0], B.ptr(unit_mrow),
        B.ptr(out), n_mcus, ints3(*geo["comp_h"]), ints3(*geo["comp_v"]),
        tile_mcus, blocks, B.stream_of(out)), "rt_fused_pixels_geometry")
    seed_misaligned_tile.launches += 1
    return out


seed_misaligned_tile.launches = 0


def launch_counts() -> Dict[str, int]:
    """Each seed wrapper's launch count, by seed name."""
    return {"seed_oob_rows": seed_oob_rows.launches,
            "seed_ident": seed_ident.launches,
            "seed_misaligned_tile": seed_misaligned_tile.launches}

"""The store kernel: the write pass with an in-kernel coefficient store.

The ``fuse="full"`` write pass. Where the stream form
(``kernels/huffman/ops.py``) writes a (s_max, C) pair of streams for a
scatter to place, the store kernel stores each recorded coefficient at
``write_base + n + run_eff`` itself, under the mask of the stream form's
scatter, into a buffer the wrapper zeroes: a unit a lane decodes whole
as one 256-byte store by its warp, the units it enters or leaves midway
entry by entry. It decodes from the exit kernel's sources (the compact
tables of ``ops.exit_tables``, which the wrapper refuses to go without,
and a per-lane word buffer). Its source is in ``csrc/huffman.cu``
(``rt_decode_store``, loop ``rt::store_lane`` in ``csrc/huffman.cuh``);
the JAX package's VMEM gate has no counterpart here, so it engages at
any size.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ...core import decode as D
from ...core.state import DecodeState
from .. import build as B
from ..autotune import DEFAULT_LAUNCH, WRITER_CODES, LaunchConfig
from ..huffman.ops import (EXIT_SMEM_BUDGET, check_out, copy_into,
                           decode_coeffs, exit_args, kernel_fn)

Dev = Dict[str, torch.Tensor]


def decode_coeffs_store_plain(dev: Dev, meta: Dev, entry: DecodeState,
                              write_base: torch.Tensor,
                              write_max: torch.Tensor, n_coef: int, *,
                              s_max: int, min_code_bits: int,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(n_coef,) int32 coefficients: ``core.decode.decode_span(write=True)``."""
    zeros = torch.zeros(n_coef, dtype=torch.int32, device=entry.p.device)
    _, coef = D.decode_span(dev, entry, meta["word_base"], meta["limit"],
                            meta["ts"], meta["upm"], s_max=s_max,
                            min_code_bits=min_code_bits, write=True,
                            out=zeros, write_base=write_base,
                            write_max=write_max)
    return copy_into(out, coef)


def run_store_kernel(dev: Dev, meta: Dev, entry: DecodeState,
                     write_base: torch.Tensor, write_max: torch.Tensor,
                     n_coef: int, *, s_max: int, min_code_bits: int,
                     smem_budget: int,
                     out: Optional[torch.Tensor] = None,
                     launch: LaunchConfig = DEFAULT_LAUNCH,
                     checked: bool = False) -> torch.Tensor:
    """One launch of the store kernel (``rt_decode_store``), uncounted, in
    blocks of ``launch.store_threads`` with ``launch.store_writer``'s
    writer of whole units (``"warp"`` is refused below a warp of lanes).

    Its tables go to shared memory when ``ops.exit_table_bytes`` is at
    most ``smem_budget``, else the kernel reads them from global memory.
    :func:`decode_coeffs_store` passes ``EXIT_SMEM_BUDGET``. ``out``, the
    (n_coef,) int32 target, is zeroed and written in place of a new one.
    """
    args = exit_args(dev, meta, entry)
    c = entry.p.shape[0]
    if launch.store_writer == "warp" and c < 32:
        raise ValueError(f"the warp writer needs a warp of lanes; the "
                         f"launch has {c}")
    for t in (write_base, write_max):
        if t.dtype != torch.int32 or t.shape != (c,) \
                or t.device != entry.p.device or not t.is_contiguous():
            raise ValueError(f"write_base/write_max must be contiguous "
                             f"({c},) int32 tensors on {entry.p.device}")
    if out is None:
        out = torch.zeros(n_coef, dtype=torch.int32, device=entry.p.device)
    else:
        check_out((out,), (n_coef,), entry.p.device)
        out.zero_()
    B.check(kernel_fn("rt_decode_store", checked)(
        *args, B.ptr(write_base), B.ptr(write_max), B.ptr(out), n_coef, c,
        s_max, min_code_bits, smem_budget, launch.store_threads,
        WRITER_CODES[launch.store_writer], B.stream_of(out)),
        "rt_decode_store")
    return out


def decode_coeffs_store(dev: Dev, meta: Dev, entry: DecodeState,
                        write_base: torch.Tensor, write_max: torch.Tensor,
                        n_coef: int, *, s_max: int, min_code_bits: int,
                        out: Optional[torch.Tensor] = None,
                        launch: LaunchConfig = DEFAULT_LAUNCH
                        ) -> torch.Tensor:
    """:func:`decode_coeffs_store_plain`, by the store kernel on the card."""
    if dev["words"].device.type == "cpu":
        return decode_coeffs_store_plain(
            dev, meta, entry, write_base, write_max, n_coef, s_max=s_max,
            min_code_bits=min_code_bits, out=out)
    out = run_store_kernel(dev, meta, entry, write_base, write_max, n_coef,
                           s_max=s_max, min_code_bits=min_code_bits,
                           smem_budget=EXIT_SMEM_BUDGET, out=out,
                           launch=launch)
    decode_coeffs_store.launches += 1
    return out


decode_coeffs_store.launches = 0


def writes_streams(kernels: bool, fuse: str) -> bool:
    """Whether the write pass runs the stream kernel and the scatter; else
    the store kernel (``fuse="full"``) or the plain version writes one
    (n_coef,) target."""
    return kernels and fuse != "full"


def write_coefficients(dev: Dev, meta: Dev, entry: DecodeState,
                       write_base: torch.Tensor, write_max: torch.Tensor,
                       n_coef: int, *, kernels: bool, fuse: str, s_max: int,
                       min_code_bits: int,
                       launch: LaunchConfig = DEFAULT_LAUNCH,
                       buf: Optional[Callable] = None) -> torch.Tensor:
    """The write pass as ``kernels`` and ``fuse`` choose it: the plain
    version (``decode_span(write=True)``), the store kernel, or the stream
    kernel and the scatter (:func:`writes_streams`). ``buf(name)`` gives
    its buffers: ``"store"``, or ``"streams"`` (a pair) and ``"scatter"``;
    None (or no ``buf``) for fresh ones."""
    buf = buf or (lambda name: None)
    kw = dict(s_max=s_max, min_code_bits=min_code_bits)
    if not kernels:
        return decode_coeffs_store_plain(dev, meta, entry, write_base,
                                         write_max, n_coef,
                                         out=buf("store"), **kw)
    if not writes_streams(kernels, fuse):
        return decode_coeffs_store(dev, meta, entry, write_base, write_max,
                                   n_coef, out=buf("store"), launch=launch,
                                   **kw)
    return decode_coeffs(dev, meta, entry, write_base, write_max, n_coef,
                         streams=buf("streams"), out=buf("scatter"),
                         launch=launch, **kw)

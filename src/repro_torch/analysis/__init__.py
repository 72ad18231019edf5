"""Static analysis and the kernel verifier of the port.

``repro_torch.analysis.lint``
    The JAX package's AST linter for the port (``python -m
    repro_torch.analysis lint``): its six rules over ``src/repro_torch``,
    the ones that read traced code in their torch form (code a CUDA graph
    captures, or a block of sync rounds launches). Stdlib only; suppress
    with ``# repro: allow[rule]`` or the checked-in baseline
    (``analysis/baseline.txt``).

``repro_torch.analysis.kernel_check``
    The kernel verifier (``python -m repro_torch.analysis kernels``): the
    JAX verifier's three families (kernel-bounds, kernel-tiling,
    kernel-scatter-race) over the CUDA kernels: their launch geometry on
    the host, their checked build on the card, and the write pass's
    scatter; ``--self-test`` proves it catches the seeded faults. Loaded
    lazily (it imports torch).

``repro_torch.analysis.trace_check``
    The traced-program checker (``python -m repro_torch.analysis
    contracts``): the JAX package's jaxpr checker in torch form. Over a
    grid of decodes it follows the lane-graph taint through every aten op
    (a ``TorchDispatchMode``) and kernel launch, and finds float64 tensors
    and host reads in the entropy stage; on the card it reads the CUDA
    graphs the sync rounds capture and checks, before each replay, the
    buffers their exit-kernel nodes read; and it holds the int32 index
    lattice (``contracts.TRACE_CONTRACTS``). ``--self-test`` proves it
    catches its seeded faults. Loaded lazily (it imports torch).

This package imports nothing of the rest of ``repro_torch`` at module
scope but the stdlib-only contracts.
"""
from __future__ import annotations

from . import contracts  # stdlib-only, safe everywhere
from .lint import Finding, lint_paths, lint_source  # ast/stdlib-only

__all__ = ["contracts", "Finding", "lint_paths", "lint_source"]

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

This package imports nothing of the rest of ``repro_torch`` at module
scope but the stdlib-only contracts.
"""
from __future__ import annotations

from . import contracts  # stdlib-only, safe everywhere
from .lint import Finding, lint_paths, lint_source  # ast/stdlib-only

__all__ = ["contracts", "Finding", "lint_paths", "lint_source"]

"""PyTorch + CUDA port of the parallel JPEG decoder, for Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors its layout
and imports nothing of it. The main path is :func:`decode_batch`: host
parse and plan in numpy, then the Jacobi sync, write pass and fused pixel
stage on the card through the hand-written kernels in
``repro_torch/kernels/csrc``.
"""
from .core.api import DecodeOutput, ParallelDecoder, decode_batch  # noqa: F401

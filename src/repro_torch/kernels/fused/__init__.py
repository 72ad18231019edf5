"""Fused kernels: the in-kernel coefficient store and the pixel stage."""

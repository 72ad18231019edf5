"""LR schedules (warmup + cosine, constant, rsqrt).

The port of the JAX package's ``train/schedule.py``: each takes the step
as an integer tensor and returns the LR scale as an f32 tensor on its
device, computed in f32 as the JAX functions compute it.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, warmup: int = 200,
                  total: int = 10_000, min_ratio: float = 0.1
                  ) -> torch.Tensor:
    s = step.float()
    warm = s / max(1.0, warmup)
    prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def rsqrt(step: torch.Tensor, *, warmup: int = 200) -> torch.Tensor:
    s = torch.clamp_min(step.float(), 1.0)
    # a tensor numerator: torch takes ``scalar / t`` as ``t.reciprocal() *
    # scalar``, an ulp off the division
    return torch.minimum(s / warmup, torch.sqrt(s.new_tensor(warmup) / s))


def constant(step: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(step, dtype=torch.float32)


SCHEDULES = {"cosine": warmup_cosine, "rsqrt": rsqrt, "constant": constant}

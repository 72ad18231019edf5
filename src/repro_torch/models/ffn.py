"""FFN layers: the gated dense variants.

The port of the dense half of the JAX package's ``models/ffn.py``. GeGLU
and ``gelu`` use the tanh approximation, ``jax.nn.gelu``'s default
(:func:`repro_torch.models.layers.gelu`). MoE waits for ROADMAP A11b.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import ParamBuilder, activation_fn, gelu, silu


class DenseFFN(nn.Module):
    """``w_gate``/``w_up`` (d, ff) for the gated activations (swiglu,
    geglu), else ``w_up`` alone; ``w_down`` (ff, d)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig,
                 d_ff: Optional[int] = None):
        super().__init__()
        d = cfg.d_model
        ff = d_ff or cfg.d_ff
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = b.add((d, ff))
        self.w_up = b.add((d, ff))
        self.w_down = b.add((ff, d))


def dense_ffn(p: DenseFFN, cfg: ModelConfig, x: torch.Tensor):
    if cfg.activation in ("swiglu", "geglu"):
        act = silu if cfg.activation == "swiglu" else gelu
        h = act(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = activation_fn(cfg.activation)(x @ p.w_up)
    return h @ p.w_down

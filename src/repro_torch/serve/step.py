"""Serving step builders: prefill / decode with batched requests.

The port of the JAX package's ``serve/step.py``. The steps take the
model (:class:`repro_torch.models.model.Model`) where the JAX ones take
its params; the caches are updated in place and returned. The prefill
builder has no ``max_len``: the caches passed to the step carry it.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.config import ModelConfig
from ..models.model import forward_decode, forward_prefill, init_caches


def _check_model(model, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch: Dict, caches):
        _check_model(model, cfg)
        return forward_prefill(model, batch, caches)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(model, token, pos, caches):
        _check_model(model, cfg)
        logits, caches = forward_decode(model, token, pos, caches)
        next_token = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
        return next_token, logits, caches

    return decode_step


def top_k_logits(l: torch.Tensor, top_k: int) -> torch.Tensor:
    """Logits below the ``top_k``-th largest of their row set to -1e30
    (ties with it stay), as the JAX sampling step masks them."""
    if top_k <= 0:
        return l
    kth = torch.topk(l, top_k, dim=-1).values[:, -1:]
    return torch.where(l < kth, torch.full_like(l, -1e30), l)


def make_sampling_decode_step(cfg: ModelConfig, temperature: float = 0.8,
                              top_k: int = 50) -> Callable:
    def decode_step(model, token, pos, caches,
                    generator: torch.Generator):
        _check_model(model, cfg)
        logits, caches = forward_decode(model, token, pos, caches)
        l = logits[:, -1].float() / max(temperature, 1e-6)
        probs = torch.softmax(top_k_logits(l, top_k), dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)
        return nxt.to(torch.int32), caches

    return decode_step


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int):
    """Shape-only caches (no allocation), on the ``meta`` device."""
    return init_caches(cfg, batch, max_len, device="meta")

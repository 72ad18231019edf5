"""FFN layers: gated dense variants and sort-based capacity MoE.

The port of the JAX package's ``models/ffn.py``. GeGLU and ``gelu`` use
the tanh approximation, ``jax.nn.gelu``'s default
(:func:`repro_torch.models.layers.gelu`).

MoE dispatch is the sort + capacity formulation: each token's k (expert,
rank) slots come from one stable argsort of the flat expert ids, the
tokens go into an ``(E, C, d)`` buffer (a slot past the capacity writes
nothing and is counted in ``aux["dropped_frac"]``), and every expert's
products run over its whole buffer.

Across a model group (``layout``, a ``dist.plan.ShardLayout``) the dense
FFN holds this rank's ``mlp`` columns of ``w_gate``/``w_up`` and rows of
``w_down``, and sums its partial output over the group
(``dist.tensor_parallel.row_parallel``). The MoE FFN, whose experts the
JAX package splits over the model axis, is not split (ROADMAP A15b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..dist import tensor_parallel as TP
from .config import ModelConfig
from .layers import ParamBuilder, activation_fn, gelu, sigmoid, silu


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

class DenseFFN(nn.Module):
    """``w_gate``/``w_up`` (d, ff) for the gated activations (swiglu,
    geglu), else ``w_up`` alone; ``w_down`` (ff, d)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig,
                 d_ff: Optional[int] = None):
        super().__init__()
        d = cfg.d_model
        ff = d_ff or cfg.d_ff
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = b.add((d, ff), ("embed", "mlp"))
        self.w_up = b.add((d, ff), ("embed", "mlp"))
        self.w_down = b.add((ff, d), ("mlp", "embed"))


def dense_ffn(p: DenseFFN, cfg: ModelConfig, x: torch.Tensor,
              layout=None):
    if cfg.activation in ("swiglu", "geglu"):
        act = silu if cfg.activation == "swiglu" else gelu
        h = act(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = activation_fn(cfg.activation)(x @ p.w_up)
    if TP.splits(layout, "mlp"):
        return TP.row_parallel(h, p.w_down, layout, h.dtype)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class MoEFFN(nn.Module):
    """``router`` (d, E) and, for the ``sigmoid_bias`` router,
    ``router_bias`` (E,); the experts' ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d); the shared experts as one :class:`DenseFFN`
    (``shared``) of width ``(shared_ff or expert_ff) * n_shared``."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        e, f = m.n_experts, m.expert_ff
        self.router = b.add((d, e), ("embed", None), scale=0.02)
        self.router_bias = b.add((e,), (None,), init="zeros") \
            if m.router == "sigmoid_bias" else None
        self.w_gate = b.add((e, d, f), ("experts", "embed", "mlp"))
        self.w_up = b.add((e, d, f), ("experts", "embed", "mlp"))
        self.w_down = b.add((e, f, d), ("experts", "mlp", "embed"))
        self.shared = DenseFFN(b, cfg, d_ff=(m.shared_ff or m.expert_ff)
                               * m.n_shared) if m.n_shared else None


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row and their indices, largest first and
    equal values by lower index, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert takes for ``tokens`` tokens: ``capacity_factor *
    tokens * top_k / n_experts``, at least 1, rounded up to a multiple of
    32."""
    m = cfg.moe
    cap = max(1, int(m.capacity_factor * tokens * m.top_k / m.n_experts))
    return -(-cap // 32) * 32


def moe_ffn(p: MoEFFN, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d), aux stats: ``dropped_frac`` and
    ``router_entropy`` as the JAX function gives them, and ``idx``, the
    (B*S, k) experts each token was routed to."""
    m = cfg.moe
    bsz, s, d = x.shape
    t = bsz * s
    xt = x.reshape(t, d)
    e, k = m.n_experts, m.top_k

    logits = (xt @ p.router).float()
    if m.router == "sigmoid_bias":
        # aux-free routing: the bias picks the experts, the unbiased
        # affinities weigh them
        aff = sigmoid(logits)
        _, idx = top_k(aff + p.router_bias.float()[None], k)
        w = torch.gather(aff, 1, idx)
    else:
        w, idx = top_k(torch.softmax(logits, dim=-1), k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    cap = capacity(cfg, t)
    flat_e = idx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device),
                                side="left")
    rank = torch.arange(t * k, device=x.device) - starts[sorted_e]
    keep = rank < cap
    src_tok = order // k

    # dispatch: (E, C, d) expert buffers; a dropped slot writes nothing
    buf = x.new_zeros((e, cap, d))
    buf[sorted_e[keep], rank[keep]] = xt[src_tok[keep]]

    act = silu if cfg.activation == "swiglu" else gelu
    h = act(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    y_buf = torch.bmm(h, p.w_down)

    # combine: each slot's output (zero where dropped) times its gate, and
    # each token's k of them summed in the sorted order, one rounding an
    # add, as the JAX function's scatter-add sums them
    y_sorted = y_buf[sorted_e, torch.where(keep, rank, 0)]
    gate = w.reshape(-1)[order]
    y_sorted = torch.where(keep[:, None],
                           y_sorted * gate[:, None].to(y_sorted.dtype), 0)
    slots = torch.sort(torch.argsort(order).reshape(t, k), dim=-1).values
    out = y_sorted[slots[:, 0]]
    for j in range(1, k):
        out = out + y_sorted[slots[:, j]]

    if p.shared is not None:
        out = out + dense_ffn(p.shared, cfg, xt[None])[0]

    aux = {
        "dropped_frac": 1.0 - keep.float().mean(),
        "router_entropy": -(torch.softmax(logits, -1)
                            * torch.log_softmax(logits, -1)).sum(-1).mean(),
        "idx": idx,
    }
    return out.reshape(bsz, s, d), aux

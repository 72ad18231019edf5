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
(``dist.tensor_parallel.row_parallel``). The MoE FFN holds this rank's
``experts`` (or, where the audit demotes them, every expert's ``mlp``
columns) and the shared experts' ``mlp`` columns: every rank of the group
routes the same tokens alike, fills and runs only its experts' rows of
the ``(E, C, d)`` buffer, and sums its kept slots' weighted outputs a
token in f32; that partial and the shared experts' join before one
``all_reduce``. Over a data group the capacity and the ranks within each
expert count the global batch, as the JAX function's argsort over the
traced global shape does: the routing is gathered over the data group.
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


def _hidden(p: DenseFFN, cfg: ModelConfig, x: torch.Tensor):
    if cfg.activation in ("swiglu", "geglu"):
        act = silu if cfg.activation == "swiglu" else gelu
        return act(x @ p.w_gate) * (x @ p.w_up)
    return activation_fn(cfg.activation)(x @ p.w_up)


def dense_ffn(p: DenseFFN, cfg: ModelConfig, x: torch.Tensor,
              layout=None):
    h = _hidden(p, cfg, x)
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


def moe_splits(layout) -> bool:
    """Whether an MoE FFN runs over the layout's model group: its experts
    split, or (demoted) every expert's ``mlp`` columns."""
    return TP.splits(layout, "experts") or TP.splits(layout, "mlp")


def moe_ffn(p: MoEFFN, cfg: ModelConfig, x: torch.Tensor, layout=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d), aux stats: ``dropped_frac`` and
    ``router_entropy`` as the JAX function gives them (over the global
    batch), and ``idx``, the (B*S, k) experts each of this rank's tokens
    was routed to. With a ``layout`` that cuts the MoE over its model
    group or the batch over its data group, :func:`_moe_split` runs."""
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
    entropy = -(torch.softmax(logits, -1)
                * torch.log_softmax(logits, -1)).sum(-1)
    if TP.data_split(layout) or moe_splits(layout):
        out, aux = _moe_split(p, cfg, xt, w, idx, entropy, layout)
        return out.reshape(bsz, s, d), aux

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

    aux = {"dropped_frac": 1.0 - keep.float().mean(),
           "router_entropy": entropy.mean(), "idx": idx}
    return out.reshape(bsz, s, d), aux


def _moe_split(p: MoEFFN, cfg: ModelConfig, xt: torch.Tensor,
               w: torch.Tensor, idx: torch.Tensor, entropy: torch.Tensor,
               layout) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN of this rank's tokens ``xt`` (T, d), routed to ``idx``
    with gates ``w`` (T, k), over the layout's groups.

    Routing: every data rank's ``idx`` (and router entropies) gathered,
    one stable argsort over the global batch gives each slot its rank
    within its expert, the capacity counts the global tokens, and this
    rank keeps its own tokens' slots. Dispatch: the rows of this rank's
    experts in an ``(E_local, C, d)`` buffer, each slot at its global
    rank. Combine: each token's kept slots of this rank's experts (or,
    with the experts demoted, the partial products over its ``mlp``
    columns), weighted and summed in f32 in the order of their expert
    ids, as the JAX function's scatter-add sums them; the shared experts'
    f32 partial joins, and one ``all_reduce`` over the model group sums
    the parts, rounded once. A part held whole on every rank joins on
    model rank 0 alone."""
    m = cfg.moe
    t, d = xt.shape
    k = m.top_k
    dev = xt.device
    experts = TP.splits(layout, "experts")
    cols = not experts and TP.splits(layout, "mlp")
    e_loc = p.w_gate.shape[0]
    e0 = layout.model_rank * e_loc if experts else 0

    t0, idx_all, ent_all = 0, idx, entropy
    if TP.data_split(layout):
        # routing only: indices, and entropies for the aux stats
        got = TP.gather_rows(torch.cat([idx.float(), entropy[:, None]], 1)
                             .detach(), layout)
        idx_all, ent_all = got[:, :k].long(), got[:, k]
        t0 = layout.data_rank * t
    cap = capacity(cfg, idx_all.shape[0])
    flat_e = idx_all.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(m.n_experts,
                                                       device=dev),
                                side="left")
    rank_all = torch.empty_like(flat_e)
    rank_all[order] = torch.arange(flat_e.numel(), device=dev) \
        - starts[sorted_e]
    keep_all = rank_all < cap
    rank = rank_all[t0 * k:(t0 + t) * k].reshape(t, k)
    keep = keep_all[t0 * k:(t0 + t) * k].reshape(t, k)

    # each token's slots in the order of their expert ids
    by_e = torch.argsort(idx, dim=-1)
    slot_e = torch.gather(idx, 1, by_e) - e0
    rank = torch.gather(rank, 1, by_e)
    gate = torch.gather(w, 1, by_e)
    mine = torch.gather(keep, 1, by_e) & (slot_e >= 0) & (slot_e < e_loc)
    tok = torch.arange(t, device=dev)[:, None].expand(t, k)

    buf = xt.new_zeros((e_loc, cap, d))
    buf[slot_e[mine], rank[mine]] = xt[tok[mine]]
    act = silu if cfg.activation == "swiglu" else gelu
    h = act(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    y_buf = TP.f32_product(h, p.w_down) if cols \
        else torch.bmm(h, p.w_down).float()
    y = y_buf[slot_e.clamp(0, e_loc - 1), rank.clamp(max=cap - 1)]
    y = torch.where(mine[..., None], y * gate[..., None], 0.0)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]

    # with a part split over the model group, the parts held whole join
    # on model rank 0 alone, and one all_reduce sums them all
    reduce = moe_splits(layout)
    lead = not reduce or layout.model_rank == 0
    if not (experts or cols or lead):
        out = torch.zeros_like(out)
    if p.shared is not None and (lead or TP.splits(layout, "mlp")):
        out = out + TP.f32_product(_hidden(p.shared, cfg, xt),
                                   p.shared.w_down)
    if reduce:
        out = TP.reduce_from_group(out, layout)
    out = out.to(xt.dtype)
    aux = {"dropped_frac": 1.0 - keep_all.float().mean(),
           "router_entropy": ent_all.mean(), "idx": idx}
    return out, aux

"""Attention mixers: GQA/MHA (chunked flash-style) and DeepSeek MLA.

The port of the JAX package's ``models/attention.py``: the same functions
and numerics (scores, softmax and the value product in f32; an optional
int8 GQA cache with a scale per position and head; MLA's latent cache of
``(c_kv, k_rope)`` a position, attended in the absorbed form). The
``lax.scan``/``lax.map`` over chunks are Python loops.

A cache here is updated in place: :func:`cache_update` and
:func:`mla_forward` write the new positions into the preallocated tensors
and return a cache that shares them, where the JAX functions return new
arrays.

Across a model group (``layout``, a ``dist.plan.ShardLayout``), GQA runs
this rank's query heads against its kv heads (or, where the audit kept
``kv_heads`` whole, the kv heads its query heads read) and sums ``wo``'s
partial products over the group (``dist.tensor_parallel.row_parallel``);
so do the encoder's bidirectional attention and the decoder's
cross-attention over the encoder's output. MLA runs this rank's heads of
``w_uq``, ``w_uk``, ``w_uv`` and ``wo``; its latent projections, norms
and latent cache are whole on every rank, which each compute the same
latent. Under the ``kv_seq`` rule (``layout.kv_seq``: a decode of a
``decode_kv_shard="seq"`` config) a GQA cache holds this rank's run of
the positions for every kv head: the ranks gather their heads of q, k
and v, each attends over its positions in f32, and the softmax is
merged over the group (one ``all_reduce`` of the row maxima, one of the
rescaled sums and outputs) before ``wo``. MLA keeps its latent cache
whole under the rule: the JAX package's caches stay batch-sharded, and
the values are the same either way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import tensor_parallel as TP
from .config import ModelConfig
from .layers import (ParamBuilder, apply_rope, resolve_model_device,
                     rmsnorm, weak_scalar)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask, softcap):
    """q (B,Sq,H,D) k/v (B,Sk,Hkv,D'); returns (o, m, l) partials in f32.

    The f32 score block is the largest tensor of a prefill with a cache
    ((B, Sq, Hkv, G, Smax) f32), so without gradients it is masked,
    shifted and exponentiated in place: one such block is alive at a
    time. When autograd records the block (training), the same steps run
    out of place, as ``exp``'s backward needs its output and the mask's
    needs nothing overwritten; the values are the same, bit for bit.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    drop = ~mask[:, :, None, None, :]
    if s.requires_grad:
        s = s.masked_fill(drop, NEG_INF)
        m = torch.amax(s, dim=-1)                 # (b,q,hkv,g)
        p = torch.exp(s - m[..., None]).masked_fill(drop, 0.0)
    else:
        s.masked_fill_(drop, NEG_INF)
        m = torch.amax(s, dim=-1)
        p = s.sub_(m[..., None]).exp_()
        p.masked_fill_(drop, 0.0)
    del s
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, -1), m.reshape(b, sq, h), l.reshape(b, sq, h)


def chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,
    sliding_window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    q = q * weak_scalar(scale, q.dtype)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    # pad to chunk multiples
    pq = (-sq) % q_chunk
    pk = (-sk) % kv_chunk
    q = F.pad(q, (0, 0, 0, 0, 0, pq))
    k = F.pad(k, (0, 0, 0, 0, 0, pk))
    v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    dv = v.shape[-1]

    q_pos0 = torch.arange(q.shape[1], device=q.device) + q_offset
    k_pos0 = torch.arange(k.shape[1], device=q.device)
    kv_valid = k_pos0 < sk

    # Sliding-window block skipping: with a causal window only
    # ceil(window/kv_chunk)+1 KV blocks can be unmasked for any query
    # block, so only those are visited: O(S*window) work, not O(S^2).
    windowed = causal and 0 < sliding_window and q_offset == 0
    w_chunks = min(nk, (sliding_window + kv_chunk - 1) // kv_chunk + 1) \
        if windowed else nk

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc, q_pos = q[:, qs], q_pos0[qs]
        if windowed:
            q_hi_chunk = ((qi + 1) * q_chunk - 1) // kv_chunk
            k0 = min(max(q_hi_chunk - w_chunks + 1, 0), nk - w_chunks)
            kidx = range(k0, k0 + w_chunks)
        else:
            kidx = range(nk)
        o = torch.zeros((b, q_chunk, h, dv), dtype=torch.float32,
                        device=q.device)
        m = torch.full((b, q_chunk, h), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, q_chunk, h), dtype=torch.float32, device=q.device)
        for ki in kidx:
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_pos = k_pos0[ks]
            mask = kv_valid[ks][None, None, :].expand(b, q_chunk, kv_chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])[None]
            if sliding_window > 0:
                mask = mask & ((q_pos[:, None] - k_pos[None, :])
                               < sliding_window)[None]
            ob, mb, lb = _attend_block(qc, k[:, ks], v[:, ks], mask, softcap)
            m_new = torch.maximum(m, mb)
            c1 = torch.exp(m - m_new)[..., None]
            c2 = torch.exp(mb - m_new)[..., None]
            o = o * c1 + ob * c2
            l = l * c1[..., 0] + lb * c2[..., 0]
            m = m_new
        outs.append(o / torch.clamp_min(l[..., None], 1e-30))
    out = torch.cat(outs, dim=1)
    return out[:, :sq].to(v.dtype)


# ---------------------------------------------------------------------------
# KV cache (GQA) with optional int8 quantization
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, Smax, Hkv, D) in cache dtype
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # (B, Smax, Hkv, 1) when int8
    v_scale: Optional[torch.Tensor]
    length: int              # current fill


def _quantize(x):
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True).float() / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _dequantize(q, s):
    return q.float() * s.float()


def init_kv_cache(batch, max_len, hkv, d, dtype="bfloat16",
                  device="cuda") -> KVCache:
    device = resolve_model_device(device)
    shape = (batch, max_len, hkv, d)
    if dtype == "int8":
        z = [torch.zeros(shape, dtype=torch.int8, device=device)
             for _ in range(2)]
        s = [torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                         device=device) for _ in range(2)]
        return KVCache(z[0], z[1], s[0], s[1], 0)
    z = [torch.zeros(shape, dtype=torch.bfloat16, device=device)
         for _ in range(2)]
    return KVCache(z[0], z[1], None, None, 0)


def cache_update(cache: KVCache, k_new, v_new, pos: int,
                 offset: int = 0) -> KVCache:
    """Write (B, S_new, Hkv, D) at position ``pos``, in place. A cache
    that holds the positions from ``offset`` on (one rank's run under the
    ``kv_seq`` rule) takes only the new positions that fall in it."""
    s_new = k_new.shape[1]
    lo = max(pos, offset)
    hi = min(pos + s_new, offset + cache.k.shape[1])
    if hi <= lo:
        return cache._replace(length=cache.length + s_new)
    k_new, v_new = k_new[:, lo - pos:hi - pos], v_new[:, lo - pos:hi - pos]
    at = slice(lo - offset, hi - offset)
    if cache.k_scale is not None:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        cache.k[:, at] = kq
        cache.v[:, at] = vq
        cache.k_scale[:, at] = ks
        cache.v_scale[:, at] = vs
    else:
        cache.k[:, at] = k_new.to(cache.k.dtype)
        cache.v[:, at] = v_new.to(cache.v.dtype)
    return cache._replace(length=cache.length + s_new)


def cache_kv(cache: KVCache):
    if cache.k_scale is not None:
        return (_dequantize(cache.k, cache.k_scale),
                _dequantize(cache.v, cache.v_scale))
    return cache.k, cache.v


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """The projections of one GQA layer: ``wq`` (d, H, Dh), ``wk``/``wv``
    (d, Hkv, Dh), ``wo`` (H, Dh, d)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = b.add((d, h, dh), ("embed", "heads", None))
        self.wk = b.add((d, hkv, dh), ("embed", "kv_heads", None))
        self.wv = b.add((d, hkv, dh), ("embed", "kv_heads", None))
        self.wo = b.add((h, dh, d), ("heads", None, "embed"))


def gqa_forward(
    p: GQA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
    causal: bool = True, cache: Optional[KVCache] = None,
    cache_pos: Optional[int] = None, kv_x: Optional[torch.Tensor] = None,
    use_rope: bool = True, layout=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B,S,d). With a cache: writes k/v at ``cache_pos`` and attends
    over the whole cache under the causal (and window) mask. ``kv_x``
    (encoder states) switches to cross-attention (no cache, no causal
    mask); without ``use_rope`` no position is rotated. With a
    ``layout`` that splits the heads, ``p`` holds this rank's heads and
    the output is summed over its model group; under its ``kv_seq`` rule
    a cache holds this rank's positions (:func:`_seq_attention`)."""
    split = TP.splits(layout, "heads")
    kv_src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", kv_src, p.wk)
    v = torch.einsum("bsd,dhk->bshk", kv_src, p.wv)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kv_pos = positions if kv_x is None else torch.arange(
            kv_src.shape[1], device=x.device)[None].expand(
            kv_src.shape[0], -1)
        k = apply_rope(k, kv_pos, cfg.rope_theta)

    new_cache = None
    if cache is not None and layout is not None and layout.kv_seq:
        o, new_cache = _seq_attention(q, k, v, cache, cache_pos, positions,
                                      cfg, layout)
        if split:
            o = o[:, :, layout.local("heads", cfg.n_heads)]
    elif cache is not None:
        new_cache = cache_update(cache, k, v, cache_pos)
        k, v = cache_kv(new_cache)
        kpos = torch.arange(k.shape[1], device=x.device)
        qpos = positions  # (B, Sq) absolute
        mask = kpos[None, None, :] <= qpos[:, :, None]
        if cfg.sliding_window > 0:
            mask &= (qpos[:, :, None] - kpos[None, None, :]) \
                < cfg.sliding_window
        if split:
            k, v = _kv_of_heads(k, v, cfg, layout)
        o = _cached_attention(q, k, v, mask, cfg.attn_logit_softcap)
    else:
        if split:
            k, v = _kv_of_heads(k, v, cfg, layout)
        o = chunked_attention(
            q, k, v, causal=causal and kv_x is None,
            sliding_window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap, q_chunk=cfg.attn_chunk // 2,
            kv_chunk=cfg.attn_chunk,
        )
    return _heads_out(o.to(x.dtype), p.wo, layout), new_cache


def _kv_of_heads(k, v, cfg: ModelConfig, layout):
    """k/v (B, S, Hkv_local, D) laid out for this rank's query heads.

    With ``kv_heads`` split as the heads are, the rank's kv heads serve
    its query heads in the same groups: unchanged. Where the audit kept
    them whole, the kv heads its query heads read: a run of whole groups,
    one kv head shared by all of them, or (the groups straddling the
    rank's heads) one kv head per query head."""
    if layout.splits("kv_heads"):
        return k, v
    heads = layout.local("heads", cfg.n_heads)
    n, g = heads.stop - heads.start, cfg.n_heads // cfg.n_kv_heads
    first = heads.start // g
    if n % g == 0:
        at = slice(first, first + n // g)
        return k[:, :, at], v[:, :, at]
    if g % n == 0:
        return k[:, :, first:first + 1], v[:, :, first:first + 1]
    idx = torch.arange(heads.start, heads.stop, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _seq_attention(q, k, v, cache: KVCache, cache_pos: int,
                   positions: torch.Tensor, cfg: ModelConfig, layout):
    """Attention over a cache whose positions are cut over the model group
    (the ``kv_seq`` rule): every head's q, k and v gathered where the
    layout splits them, the new positions written on the rank that owns
    them, this rank's positions attended in f32, and the softmax merged
    over the group. Returns every head's output and the cache."""
    if TP.splits(layout, "heads"):
        q = TP.all_gather(q, layout, dim=2)
    if TP.splits(layout, "kv_heads"):
        k = TP.all_gather(k, layout, dim=2)
        v = TP.all_gather(v, layout, dim=2)
    offset = layout.model_rank * cache.k.shape[1]
    new_cache = cache_update(cache, k, v, cache_pos, offset)
    k, v = cache_kv(new_cache)
    kpos = offset + torch.arange(k.shape[1], device=q.device)
    qpos = positions
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if cfg.sliding_window > 0:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < cfg.sliding_window
    scale = q.shape[-1] ** -0.5
    ob, mb, lb = _attend_block(q * weak_scalar(scale, q.dtype), k, v, mask,
                               cfg.attn_logit_softcap)
    top = TP.all_reduce_max(mb.clone(), layout)
    c = torch.exp(mb - top)
    part = torch.cat([ob * c[..., None], (lb * c)[..., None]], dim=-1)
    part = TP.all_reduce_sum(part, layout)
    o = part[..., :-1] / torch.clamp_min(part[..., -1:], 1e-30)
    return o.to(v.dtype), new_cache


def _cached_attention(q, k, v, mask, softcap):
    scale = q.shape[-1] ** -0.5
    ob, mb, lb = _attend_block(q * weak_scalar(scale, q.dtype), k, v, mask,
                               softcap)
    return (ob / torch.clamp_min(lb[..., None], 1e-30)).to(v.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, Smax, kv_lora)
    k_rope: torch.Tensor     # (B, Smax, rope_dim)
    length: int


def init_mla_cache(batch, max_len, cfg: ModelConfig, dtype="bfloat16",
                   device="cuda") -> MLACache:
    if dtype == "int8":
        raise NotImplementedError("int8 MLA cache: use kv_seq sharding "
                                  "instead")
    device = resolve_model_device(device)
    m = cfg.mla
    return MLACache(
        torch.zeros((batch, max_len, m.kv_lora), dtype=torch.bfloat16,
                    device=device),
        torch.zeros((batch, max_len, m.rope_dim), dtype=torch.bfloat16,
                    device=device),
        0,
    )


class MLA(nn.Module):
    """The projections of one MLA layer: the query's down (``w_dq``) and
    up (``w_uq``) projections around ``q_norm``; the latent ``w_dkv`` with
    ``kv_norm``, the shared rotary key ``w_kr``; the latent's key and value
    up-projections ``w_uk``/``w_uv``; ``wo``."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig):
        super().__init__()
        d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
        self.w_dq = b.add((d, m.q_lora), ("embed", None))
        self.q_norm = b.add((m.q_lora,), (None,), init="zeros")
        self.w_uq = b.add((m.q_lora, h, m.nope_dim + m.rope_dim),
                          (None, "heads", None))
        self.w_dkv = b.add((d, m.kv_lora), ("embed", None))
        self.kv_norm = b.add((m.kv_lora,), (None,), init="zeros")
        self.w_kr = b.add((d, m.rope_dim), ("embed", None))
        self.w_uk = b.add((m.kv_lora, h, m.nope_dim), (None, "heads", None))
        self.w_uv = b.add((m.kv_lora, h, m.v_dim), (None, "heads", None))
        self.wo = b.add((h, m.v_dim, d), ("heads", None, "embed"))


def mla_forward(
    p: MLA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
    cache: Optional[MLACache] = None, cache_pos: Optional[int] = None,
    layout=None,
) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """x (B,S,d). With a cache (prefill and decode): writes the latent and
    rotary key at ``cache_pos`` and attends in the absorbed form over the
    whole cache, an f32 (B, S, H, Smax) score block. Without one: the
    keys and values expanded per head, through :func:`chunked_attention`.
    With a ``layout`` that splits the heads, ``p`` holds this rank's
    heads (the latent is whole) and the output is summed over its model
    group.
    """
    m = cfg.mla
    bsz, s, _ = x.shape
    h = p.w_uq.shape[1]
    cq = rmsnorm(torch.einsum("bsd,dq->bsq", x, p.w_dq), p.q_norm)
    q = torch.einsum("bsq,qhk->bshk", cq, p.w_uq)
    q_nope, q_rope = q[..., : m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = rmsnorm(torch.einsum("bsd,dc->bsc", x, p.w_dkv), p.kv_norm)
    k_rope = torch.einsum("bsd,dr->bsr", x, p.w_kr)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    scale = (m.nope_dim + m.rope_dim) ** -0.5

    if cache is not None:
        at = slice(cache_pos, cache_pos + s)
        cache.c_kv[:, at] = ckv.to(cache.c_kv.dtype)
        cache.k_rope[:, at] = k_rope.to(cache.k_rope.dtype)
        new_cache = cache._replace(length=cache.length + s)
        ckv_all = cache.c_kv.float()
        # absorbed scores: q_lat = W_uk^T q_nope  (B,S,H,kv_lora)
        q_lat = torch.einsum("bshk,chk->bshc", q_nope, p.w_uk)
        logits = torch.einsum("bshc,btc->bsht", q_lat.float(), ckv_all)
        logits += torch.einsum("bshr,btr->bsht", q_rope.float(),
                               cache.k_rope.float())
        logits *= scale
        kpos = torch.arange(ckv_all.shape[1], device=x.device)
        mask = kpos[None, None, None, :] <= positions[:, :, None, None]
        w = torch.softmax(logits.masked_fill_(~mask, NEG_INF), dim=-1)
        del logits
        o_lat = torch.einsum("bsht,btc->bshc", w, ckv_all)
        o = torch.einsum("bshc,chk->bshk", o_lat.to(x.dtype), p.w_uv)
    else:
        k_nope = torch.einsum("bsc,chk->bshk", ckv, p.w_uk)
        v = torch.einsum("bsc,chk->bshk", ckv, p.w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            bsz, s, h, m.rope_dim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = chunked_attention(
            qq, k, v, causal=True, q_chunk=cfg.attn_chunk // 2,
            kv_chunk=cfg.attn_chunk, scale=scale,
        )
        new_cache = None
    return _heads_out(o.to(x.dtype), p.wo, layout), new_cache


def _heads_out(o: torch.Tensor, wo: torch.Tensor, layout) -> torch.Tensor:
    """``o`` (B, S, H, Dv) through ``wo`` (H, Dv, d): over a model group
    that splits the heads, this rank's heads' partial products summed in
    f32 and rounded once."""
    if TP.splits(layout, "heads"):
        return TP.row_parallel(o.reshape(*o.shape[:2], -1),
                               wo.reshape(-1, wo.shape[-1]), layout, o.dtype)
    return torch.einsum("bshk,hkd->bsd", o, wo)

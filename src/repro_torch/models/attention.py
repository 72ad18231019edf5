"""Attention mixers: GQA/MHA (chunked flash-style) with a KV cache.

The port of the GQA half of the JAX package's ``models/attention.py``:
the same functions and numerics (scores, softmax and the value product in
f32; an optional int8 cache with a scale per position and head). The
``lax.scan``/``lax.map`` over chunks are Python loops. MLA waits for
ROADMAP A11b.

A KV cache here is updated in place: :func:`cache_update` writes the new
positions into the preallocated tensors and returns a cache that shares
them, where the JAX function returns new arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (ParamBuilder, apply_rope, resolve_model_device,
                     weak_scalar)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask, softcap):
    """q (B,Sq,H,D) k/v (B,Sk,Hkv,D'); returns (o, m, l) partials in f32.

    The f32 score block is the largest tensor of a prefill with a cache
    ((B, Sq, Hkv, G, Smax) f32), so it is masked, shifted and
    exponentiated in place: one such block is alive at a time.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    drop = ~mask[:, :, None, None, :]
    s.masked_fill_(drop, NEG_INF)
    m = torch.amax(s, dim=-1)                     # (b,q,hkv,g)
    p = s.sub_(m[..., None]).exp_()
    del s
    p.masked_fill_(drop, 0.0)
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


def cache_update(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Write (B, S_new, Hkv, D) at position ``pos``, in place."""
    at = slice(pos, pos + k_new.shape[1])
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
    return cache._replace(length=cache.length + k_new.shape[1])


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
        self.wq = b.add((d, h, dh))
        self.wk = b.add((d, hkv, dh))
        self.wv = b.add((d, hkv, dh))
        self.wo = b.add((h, dh, d))


def gqa_forward(
    p: GQA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
    causal: bool = True, cache: Optional[KVCache] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B,S,d). With a cache: writes k/v at ``cache_pos`` and attends
    over the whole cache under the causal (and window) mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        new_cache = cache_update(cache, k, v, cache_pos)
        k, v = cache_kv(new_cache)
        kpos = torch.arange(k.shape[1], device=x.device)
        qpos = positions  # (B, Sq) absolute
        mask = kpos[None, None, :] <= qpos[:, :, None]
        if cfg.sliding_window > 0:
            mask &= (qpos[:, :, None] - kpos[None, None, :]) \
                < cfg.sliding_window
        o = _cached_attention(q, k, v, mask, cfg.attn_logit_softcap)
    else:
        o = chunked_attention(
            q, k, v, causal=causal, sliding_window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap, q_chunk=cfg.attn_chunk // 2,
            kv_chunk=cfg.attn_chunk,
        )
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p.wo)
    return out, new_cache


def _cached_attention(q, k, v, mask, softcap):
    scale = q.shape[-1] ** -0.5
    ob, mb, lb = _attend_block(q * weak_scalar(scale, q.dtype), k, v, mask,
                               softcap)
    return (ob / torch.clamp_min(lb[..., None], 1e-30)).to(v.dtype)

"""Mamba-2 SSD (state-space duality) mixer with chunked scan + decode cache.

The port of the JAX package's ``models/ssm.py``. Chunked form (Mamba-2
paper §6): within a chunk the output is a masked "attention" G = (C B^T)
⊙ L; across chunks a size-(H, P, N) state is carried by an exponential
recurrence, here a Python loop over the chunks (the JAX package's
``lax.scan``).

The JAX functions mix bf16 and f32 operands, which ``jnp`` promotes to
f32 (``torch.einsum`` refuses mixed dtypes): each such product is written
here with its operands cast as ``jnp`` casts them, and with the
roundings the JAX functions make (the state rounded to the input's dtype
before the inter-chunk product; the conv summed in f32 and rounded once).
The cache is updated in place.

Across a model group (``layout``, a ``dist.plan.ShardLayout`` that
splits both ``mlp`` and ``heads``: :func:`ssd_split`) each rank holds
its heads' columns of ``w_in`` (``z``, ``x`` and ``dt``) with all of
``B`` and ``C`` (mamba-2 with one group shares them over the heads: the
``Segments`` of each parameter), the conv of its ``x`` channels and of
``B`` and ``C``, its heads' ``a_log``, ``dt_bias``, ``d_skip``,
``out_norm`` and rows of ``w_out``, and the state of its heads. The
gated norm over the whole inner width sums its squares over the group
in f32 (``dist.tensor_parallel.split_rmsnorm``), and ``w_out``'s
partial products are summed over it (``row_parallel``). Where the audit
demotes either axis the SSD is held whole on every rank
(``ShardLayout.whole``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import tensor_parallel as TP
from ..dist.plan import SSD_AXES, Segments
from .config import ModelConfig
from .layers import ParamBuilder, rmsnorm, silu


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_conv_channels) rolling conv input
    state: torch.Tensor   # (B, H, N, P) SSD state


class SSD(nn.Module):
    """One SSD mixer: ``w_in`` (d, 2*di + 2*N + H) to (z, x, B, C, dt);
    the causal depthwise conv ``conv_w`` (d_conv, di + 2*N) and
    ``conv_b``; ``a_log``, ``dt_bias``, ``d_skip`` a head; ``out_norm``
    and ``w_out`` (di, d)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        conv_ch = di + 2 * s.d_state
        n = s.d_state

        def runs(*sizes_split):
            sizes, split = zip(*sizes_split)
            return Segments(sizes, split, SSD_AXES)

        heads = runs((nh, True))
        inner = runs((di, True))
        self.w_in = b.add((d, 2 * di + 2 * n + nh), ("embed", "mlp"),
                          segments=runs((di, True), (di, True), (n, False),
                                        (n, False), (nh, True)))
        xbc = runs((di, True), (n, False), (n, False))
        self.conv_w = b.add((s.d_conv, conv_ch), (None, "mlp"), segments=xbc)
        self.conv_b = b.add((conv_ch,), ("mlp",), init="zeros", segments=xbc)
        self.a_log = b.add((nh,), ("heads",), init="zeros", segments=heads)
        self.dt_bias = b.add((nh,), ("heads",), init="zeros", segments=heads)
        self.d_skip = b.add((nh,), ("heads",), init="zeros", segments=heads)
        self.out_norm = b.add((di,), ("mlp",), init="zeros", segments=inner)
        self.w_out = b.add((di, d), ("mlp", "embed"), segments=inner)


def ssd_split(layout) -> bool:
    """Whether an SSD runs over the layout's model group: both of
    :data:`SSD_AXES` split (else it is held whole)."""
    return all(TP.splits(layout, a) for a in SSD_AXES)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_in(p: SSD, cfg: ModelConfig, proj: torch.Tensor):
    """(z, xbc, dt, di, nh) of ``w_in``'s product, ``di`` and ``nh`` the
    inner width and heads that ``p`` holds."""
    di, nh = p.out_norm.shape[0], p.a_log.shape[0]
    z, xbc, dt = torch.split(proj, [di, di + 2 * cfg.ssm.d_state, nh],
                             dim=-1)
    return z, xbc, dt, di, nh


def _gated_norm(y: torch.Tensor, p: SSD, cfg: ModelConfig, layout):
    """``rmsnorm(y, out_norm)`` over the whole inner width."""
    if ssd_split(layout):
        return TP.split_rmsnorm(y, p.out_norm,
                                cfg.ssm.expand * cfg.d_model, layout)
    return rmsnorm(y, p.out_norm)


def _out(y: torch.Tensor, p: SSD, layout) -> torch.Tensor:
    """``y @ w_out``, summed over the model group when it is cut."""
    if ssd_split(layout):
        return TP.row_parallel(y, p.w_out, layout, y.dtype)
    return torch.einsum("bse,ed->bsd", y, p.w_out)


def _conv(window: torch.Tensor, p: SSD, k: int) -> torch.Tensor:
    """The depthwise conv over ``k`` positions of ``window`` (..., k+i, C)
    for every output i: products and sum in f32, one term a tap in order,
    then the bias, then silu in f32."""
    w = p.conv_w.float()
    n = window.shape[-2] - k + 1
    conv = window[..., 0:n, :].float() * w[0]
    for i in range(1, k):
        conv = conv + window[..., i: i + n, :].float() * w[i]
    return silu(conv + p.conv_b.float())


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """Chunked SSD.

    xh (B,S,H,P)  dt (B,S,H)  a (H,) negative decay
    bmat/cmat (B,S,N) single group. Returns (B,S,H,P) f32 and the final
    state (B,H,N,P) f32.
    """
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    xc = xh.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = bmat.reshape(bsz, nc, chunk, n)
    cc = cmat.reshape(bsz, nc, chunk, n)
    xf = xc.float()

    da = dtc * a[None, None, None, :]              # (B,nc,Q,H) negative
    cum = torch.cumsum(da, dim=2)                  # within-chunk cumulative

    # intra-chunk: G[i,j] = C_i . B_j * exp(cum_i - cum_j) * dt_j  (i >= j).
    # Above the diagonal cum_i - cum_j > 0, and its exp overflows once a
    # chunk's decay passes f32's range: it is masked to -inf before the
    # exp (the JAX package masks the exp after it, the same values), so
    # that the backward multiplies no zero gradient by an infinite exp
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li,
                                  float("-inf")))
    del li
    gb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,nc,Q,Q)
    w = gb.float()[..., None] * decay * dtc[:, :, None, :, :]
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xf)
    del w

    # chunk summary states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H)
    sc = torch.einsum("bcqn,bcqhp->bchnp", bc.float(),
                      (decay_out * dtc)[..., None] * xf)    # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)

    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=xh.device)
    h_in = []
    for c in range(nc):
        h_in.append(hstate)                                  # entering state
        hstate = hstate * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_in = torch.stack(h_in, dim=1)                          # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += C_i exp(cum_i) H_in, the entering
    # state rounded to C's dtype first
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cc.float(),
                           h_in.to(cc.dtype).float())
    y_inter *= torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y, hstate


def ssd_forward(
    p: SSD, cfg: ModelConfig, x: torch.Tensor, *,
    cache: Optional[SSMCache] = None, layout=None,
) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence (prefill) forward. Returns the output and, with a
    cache, the cache holding the last conv inputs and the final state;
    over ``layout``'s model group, of this rank's heads."""
    s_cfg = cfg.ssm
    bsz, s, _ = x.shape
    proj = torch.einsum("bsd,de->bse", x, p.w_in)
    z, xbc, dt, di, nh = _split_in(p, cfg, proj)

    # causal depthwise conv over (x, B, C) channels, accumulated in f32
    # and rounded once, as ssd_decode_step's
    k = s_cfg.d_conv
    pad_in = F.pad(xbc, (0, 0, k - 1, 0))
    conv = _conv(pad_in, p, k).to(xbc.dtype)

    xh, bmat, cmat = torch.split(conv, [di, s_cfg.d_state, s_cfg.d_state],
                                 dim=-1)
    xh = xh.reshape(bsz, s, nh, s_cfg.head_dim)
    a = -torch.exp(p.a_log.float())
    dt = softplus(dt.float() + p.dt_bias.float())

    y, h_final = _ssd_chunked(xh, dt, a, bmat, cmat, s_cfg.chunk)
    y = y + xh.float() * p.d_skip.float()[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = _gated_norm(y * silu(z).float(), p, cfg, layout)
    out = _out(y.to(x.dtype), p, layout)

    new_cache = None
    if cache is not None:
        cache.conv.copy_(pad_in[:, -(k - 1):, :])
        cache.state.copy_(h_final)
        new_cache = cache
    return out, new_cache


def ssd_decode_step(
    p: SSD, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache,
    layout=None,
) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step. x (B, 1, d)."""
    s_cfg = cfg.ssm
    bsz = x.shape[0]
    proj = torch.einsum("bsd,de->bse", x, p.w_in)
    z, xbc, dt, di, nh = _split_in(p, cfg, proj)
    k = s_cfg.d_conv
    wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    window = torch.cat([cache.conv.to(wdt), xbc.to(wdt)], dim=1)  # (B,k,C)
    conv = _conv(window, p, k).to(xbc.dtype)
    xh, bmat, cmat = torch.split(conv, [di, s_cfg.d_state, s_cfg.d_state],
                                 dim=-1)
    xh = xh.reshape(bsz, nh, s_cfg.head_dim).float()         # (B,H,P)
    bmat = bmat[:, 0].float()                                # (B,N)
    cmat = cmat[:, 0].float()
    a = -torch.exp(p.a_log.float())
    dt_ = softplus(dt[:, 0].float() + p.dt_bias.float())
    dec = torch.exp(dt_ * a[None, :])                        # (B,H)
    state = cache.state.float()
    state = state * dec[..., None, None] + (
        dt_[:, :, None, None] * bmat[:, None, :, None] * xh[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cmat, state)
    y = y + xh * p.d_skip.float()[None, :, None]
    y = y.reshape(bsz, 1, di)
    y = _gated_norm(y.to(x.dtype) * silu(z), p, cfg, layout)
    out = _out(y.to(x.dtype), p, layout)
    cache.conv.copy_(window[:, 1:, :])
    cache.state.copy_(state)
    return out, cache

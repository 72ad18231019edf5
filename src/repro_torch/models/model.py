"""Model assembly for serving: decoder-only LMs and the VLM (llava).

The port of the JAX package's ``models/model.py`` for the dense families:
every layer GQA attention (``attn``) with a dense or no FFN, the vision
frontend stub and LayerNorm's learned positions. The layer layout (an
unrolled prefix, then a periodic pattern) becomes one ``ModuleList`` of
blocks, the prefix first and then each period's slots in turn, run by a
Python loop. The model runs on one card: the JAX package's sharding
annotations have no counterpart.

Not yet ported: the ``mla``, ``ssm`` and ``attn_bidir`` mixers, MoE,
cross-attention and the encoder (ROADMAP A11b), and training
(``forward_train``, ROADMAP A11c). Building a model that needs them
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import GQA, KVCache, gqa_forward, init_kv_cache
from .config import ModelConfig
from .ffn import DenseFFN, dense_ffn
from .layers import Norm, ParamBuilder, gelu, matmul, resolve_model_device

A11B = "waits for ROADMAP A11b (MoE, MLA, SSD and encoder-decoder serving)"
A11C = "waits for ROADMAP A11c (training)"


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def check_served(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item a config
    waits for, unless the port can build and serve it."""
    if cfg.is_encdec or cfg.frontend == "audio":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder model "
                                  f"{A11B}")
    for mixer, ffn in cfg.layer_specs:
        if mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: the {mixer!r} mixer "
                                      f"{A11B}")
        if ffn not in ("dense", "none"):
            raise NotImplementedError(f"{cfg.name}: the {ffn!r} FFN {A11B}")
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: the multi-token prediction "
                                  f"head {A11C}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One ``("attn", "dense"|"none")`` layer: ``norm1`` and the attention,
    then ``norm2`` and the FFN, each with a residual (``make_block`` and
    ``block_forward`` of the JAX package)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig, spec):
        super().__init__()
        ffn = spec[1]
        self.cfg = cfg
        self.norm1 = Norm(b, cfg.d_model, cfg.norm)
        self.attn = GQA(b, cfg)
        self.norm2 = self.ffn = None
        if ffn != "none":
            self.norm2 = Norm(b, cfg.d_model, cfg.norm)
            self.ffn = DenseFFN(b, cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[KVCache] = None,
                cache_pos: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        h, new_cache = gqa_forward(self.attn, self.cfg, self.norm1(x),
                                   positions, causal=True, cache=cache,
                                   cache_pos=cache_pos)
        x = x + h
        if self.ffn is not None:
            x = x + dense_ffn(self.ffn, self.cfg, self.norm2(x))
        return x, new_cache


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The parameters of one model; :func:`forward_prefill` and
    :func:`forward_decode` run it. Parameter names follow the JAX
    package's, with ``blocks.{i}.`` for its ``prefix.{i}.`` and for period
    ``p``, slot ``s`` of its stacked ``pattern`` (block ``len(prefix) +
    p * len(pattern) + s``)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig,
                 max_positions: int = 0):
        super().__init__()
        check_served(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = b.add((cfg.vocab, d), scale=0.02)
        self.lm_head = None if cfg.tie_embeddings else b.add((d, cfg.vocab))
        self.final_norm = Norm(b, d, cfg.norm)
        # vision frontend stub: a projection from precomputed embeddings
        self.vis_proj1 = self.vis_proj2 = None
        if cfg.frontend == "vision":
            self.vis_proj1 = b.add((1024, d))
            self.vis_proj2 = b.add((d, d))
        self.dec_pos = None
        if cfg.norm == "layernorm" and max_positions:
            self.dec_pos = b.add((max_positions, d), scale=0.02)
        self.blocks = nn.ModuleList(Block(b, cfg, spec)
                                    for spec in cfg.layer_specs)


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                max_positions: int = 0, device="cuda") -> Model:
    """A model with weights drawn from ``generator`` on ``device`` (which
    must be the generator's). ``device="meta"`` allocates nothing: the
    shapes and dtypes alone, as the JAX package's ``abstract=True``."""
    return Model(ParamBuilder(generator, torch_dtype(cfg.param_dtype),
                              device), cfg, max_positions)


def abstract_params(cfg: ModelConfig, max_positions: int = 0) -> Model:
    """Shape/dtype-only params (no allocation), on the ``meta`` device."""
    return init_params(None, cfg, max_positions, device="meta")


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(model: Model, batch: Dict) -> torch.Tensor:
    cfg = model.cfg
    x = F.embedding(batch["tokens"], model.embed)
    if cfg.frontend == "vision" and "patches" in batch:
        p = matmul(gelu(matmul(batch["patches"], model.vis_proj1)),
                   model.vis_proj2)
        x = torch.cat([p.to(x.dtype), x], dim=1)
    if model.dec_pos is not None:
        pos0 = batch.get("pos_offset", 0)
        x = x + model.dec_pos[pos0: pos0 + x.shape[1]][None]
    return x


def _run_stack(model: Model, x: torch.Tensor, positions: torch.Tensor, *,
               caches: Optional[List] = None, cache_pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[List]]:
    """Every block in turn; with ``caches`` (one a block), each block's
    cache is updated at ``cache_pos``."""
    new_caches = []
    for i, block in enumerate(model.blocks):
        x, nc = block(x, positions,
                      cache=caches[i] if caches is not None else None,
                      cache_pos=cache_pos)
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if model.cfg.tie_embeddings else model.lm_head
    return x @ head


def forward_train(model: Model, batch: Dict):
    raise NotImplementedError(f"forward_train {A11C}")


def _lm_loss(model: Model, x, labels):
    raise NotImplementedError(f"_lm_loss {A11C}")


def _mtp_loss(model: Model, x, batch, positions):
    raise NotImplementedError(f"_mtp_loss {A11C}")


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> List[KVCache]:
    """One KV cache a block, ``max_len`` positions each."""
    device = resolve_model_device(device)
    check_served(cfg)
    return [init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          cfg.kv_cache_dtype, device)
            for _ in cfg.layer_specs]


def forward_prefill(model: Model, batch: Dict, caches: List
                    ) -> Tuple[torch.Tensor, List]:
    """Run the full prompt, fill caches; returns (last-position logits,
    caches). ``batch``: ``tokens`` (B, S) and, for the VLM, ``patches``
    (B, n_patches, 1024), which come first in the sequence."""
    x = _embed_inputs(model, batch)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    x, caches = _run_stack(model, x, positions, caches=caches, cache_pos=0)
    x = model.final_norm(x[:, -1:])
    return _logits(model, x), caches


def forward_decode(model: Model, token: torch.Tensor, pos: int,
                   caches: List) -> Tuple[torch.Tensor, List]:
    """One decode step. token (B, 1) int; pos the step's position."""
    x = F.embedding(token, model.embed)
    if model.dec_pos is not None:
        x = x + model.dec_pos[pos: pos + 1][None]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, new_caches = _run_stack(model, x, positions, caches=caches,
                               cache_pos=pos)
    return _logits(model, model.final_norm(x)), new_caches

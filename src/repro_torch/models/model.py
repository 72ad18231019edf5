"""Model assembly: decoder-only LMs, hybrid SSM/attention stacks, MoE,
encoder-decoder (whisper) and the VLM (llava), for serving and training.

The port of the JAX package's ``models/model.py``. The layer layout (an
unrolled prefix, then a periodic pattern) becomes one ``ModuleList`` of
blocks, the prefix first and then each period's slots in turn, run by a
Python loop; the encoder is a ``ModuleList`` of its own. The multi-token
prediction head serves nothing; :func:`forward_train` adds its loss.

Across cards (:func:`init_sharded`, :func:`shard_model`): each rank of a
``(data, model)`` process mesh holds its slice of the weights, as a
``dist.plan.ShardLayout`` (``model.layout``) says, and its rows of the
batch and caches. The layers split themselves where the JAX package's
``shard()`` calls would make XLA split them: GQA (causal, the encoder's
bidirectional, the cross-attention) and MLA over their heads, SSD over
its heads, the dense FFN over ``mlp``, the MoE FFN over its experts
(``mlp`` where the audit demotes them), the embedding and the logits over
the vocabulary (``dist.tensor_parallel``); under the ``kv_seq`` rule the
GQA caches over their positions. Training splits alike
(:func:`forward_train`): the input of each split sub-layer and of a split
head passes ``copy_to_group``, whose gradient is summed over the model
group, and the loss counts the global batch's labels.

Remat (``cfg.remat`` other than ``"none"``, which the JAX package runs as
``jax.checkpoint`` without a policy, so ``"dots"`` is ``"full"``): under
autograd each prefix layer, and each period of the pattern as one group,
runs in ``torch.utils.checkpoint`` (non-reentrant), keeping only its
input; the encoder is not checkpointed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist import tensor_parallel as TP
from .attention import (GQA, MLA, gqa_forward, init_kv_cache,
                        init_mla_cache, mla_forward)
from .config import ModelConfig
from .ffn import DenseFFN, MoEFFN, dense_ffn, moe_ffn, moe_splits
from .layers import Norm, ParamBuilder, gelu, matmul, resolve_model_device
from .ssm import (SSD, SSMCache, ssd_decode_step, ssd_forward,
                  ssd_split)

MIXERS = ("attn", "attn_bidir", "mla", "ssm")
FFNS = ("dense", "moe", "none")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def check_served(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer the port cannot build: a mixer or
    FFN name outside ``MIXERS``/``FFNS``."""
    for mixer, ffn in cfg.layer_specs:
        if mixer not in MIXERS or ffn not in FFNS:
            raise ValueError(f"{cfg.name}: no {mixer!r} mixer or {ffn!r} "
                             f"FFN in the port (mixers {MIXERS}, FFNs "
                             f"{FFNS})")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One ``(mixer, ffn)`` layer (``make_block`` and ``block_forward`` of
    the JAX package): ``norm1`` and the mixer (``attn``: GQA or MLA;
    ``ssm``: SSD), then with ``cross`` ``norm_x`` and the cross-attention
    ``xattn``, then ``norm2`` and the FFN (dense or MoE), each with a
    residual."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig, spec,
                 cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.mixer, self.ffn_kind = spec
        self.norm1 = Norm(b, cfg.d_model, cfg.norm)
        self.attn = self.ssm = None
        if self.mixer in ("attn", "attn_bidir"):
            self.attn = GQA(b, cfg)
        elif self.mixer == "mla":
            self.attn = MLA(b, cfg)
        elif self.mixer == "ssm":
            self.ssm = SSD(b, cfg)
        self.norm_x = self.xattn = None
        if cross:
            self.norm_x = Norm(b, cfg.d_model, cfg.norm)
            self.xattn = GQA(b, cfg)
        self.norm2 = self.ffn = None
        if self.ffn_kind != "none":
            self.norm2 = Norm(b, cfg.d_model, cfg.norm)
            self.ffn = MoEFFN(b, cfg) if self.ffn_kind == "moe" \
                else DenseFFN(b, cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, cache_pos: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None, decode: bool = False,
                layout=None) -> Tuple[torch.Tensor, object, Dict]:
        """(x, the block's cache, the MoE FFN's aux stats or {}); with a
        ``layout`` its mixers and FFN run over its groups, and the input of
        each that splits passes ``copy_to_group`` (its gradient summed over
        the model group under autograd)."""
        cfg, aux = self.cfg, {}
        h = self.norm1(x)
        if self.mixer == "ssm" and ssd_split(layout) \
                or self.mixer != "ssm" and TP.splits(layout, "heads"):
            h = TP.copy_to_group(h, layout)
        new_cache = cache
        if self.mixer == "attn":
            h, new_cache = gqa_forward(self.attn, cfg, h, positions,
                                       causal=True, cache=cache,
                                       cache_pos=cache_pos, layout=layout)
        elif self.mixer == "attn_bidir":
            h, _ = gqa_forward(self.attn, cfg, h, positions, causal=False,
                               layout=layout)
        elif self.mixer == "mla":
            h, new_cache = mla_forward(self.attn, cfg, h, positions,
                                       cache=cache, cache_pos=cache_pos,
                                       layout=layout)
        elif decode:
            h, new_cache = ssd_decode_step(self.ssm, cfg, h, cache, layout)
        else:
            h, new_cache = ssd_forward(self.ssm, cfg, h, cache=cache,
                                       layout=layout)
        x = x + h
        if enc_out is not None and self.xattn is not None:
            h, kv_x = self.norm_x(x), enc_out
            if TP.splits(layout, "heads"):
                h = TP.copy_to_group(h, layout)
                kv_x = TP.copy_to_group(kv_x, layout)
            h, _ = gqa_forward(self.xattn, cfg, h, positions, kv_x=kv_x,
                               use_rope=False, layout=layout)
            x = x + h
        if self.ffn is not None:
            h = self.norm2(x)
            if moe_splits(layout) if self.ffn_kind == "moe" \
                    else TP.splits(layout, "mlp"):
                h = TP.copy_to_group(h, layout)
            if self.ffn_kind == "moe":
                h, aux = moe_ffn(self.ffn, cfg, h, layout)
            else:
                h = dense_ffn(self.ffn, cfg, h, layout)
            x = x + h
        return x, new_cache, aux


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token prediction head (``mtp.*``): ``norm_h``,
    ``norm_e``, ``proj`` (2d, d) and one ``("attn", "dense")`` block. Its
    loss is training's (:func:`_mtp_loss`)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig):
        super().__init__()
        self.norm_h = Norm(b, cfg.d_model, cfg.norm)
        self.norm_e = Norm(b, cfg.d_model, cfg.norm)
        self.proj = b.add((2 * cfg.d_model, cfg.d_model), (None, "embed"))
        self.block = Block(b, cfg, ("attn", "dense"))


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The parameters of one model; :func:`forward_prefill` and
    :func:`forward_decode` run it. Parameter names follow the JAX
    package's, with ``blocks.{i}.`` for its ``prefix.{i}.`` and for period
    ``p``, slot ``s`` of its stacked ``pattern`` (block ``len(prefix) +
    p * len(pattern) + s``); the encoder's ``enc.{i}.`` and the others
    as they are.

    :meth:`specs` gives each parameter's logical axes, the JAX package's
    ``Model.specs`` under these names; ``layout`` is the ParamBuilder's
    ``ShardLayout`` (None for a whole model)."""

    def __init__(self, b: ParamBuilder, cfg: ModelConfig,
                 max_positions: int = 0):
        super().__init__()
        check_served(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = b.add((cfg.vocab, d), ("vocab", "embed"), scale=0.02)
        self.lm_head = None if cfg.tie_embeddings \
            else b.add((d, cfg.vocab), ("embed", "vocab"))
        self.final_norm = Norm(b, d, cfg.norm)
        # vision frontend stub: a projection from precomputed embeddings
        self.vis_proj1 = self.vis_proj2 = None
        if cfg.frontend == "vision":
            self.vis_proj1 = b.add((1024, d), (None, "embed"))
            self.vis_proj2 = b.add((d, d), ("embed", "embed"))
        # audio frontend stub: a projection from precomputed frames
        self.aud_proj = self.enc_pos = None
        if cfg.frontend == "audio":
            self.aud_proj = b.add((128, d), (None, "embed"))
            if cfg.enc_seq:
                self.enc_pos = b.add((cfg.enc_seq, d), (None, "embed"),
                                     scale=0.02)
        self.dec_pos = None
        if cfg.norm == "layernorm" and max_positions:
            self.dec_pos = b.add((max_positions, d), (None, "embed"),
                                 scale=0.02)
        # encoder stack (whisper)
        self.enc = nn.ModuleList(Block(b, cfg, ("attn_bidir", "dense"))
                                 for _ in range(cfg.n_enc_layers))
        self.enc_norm = Norm(b, d, cfg.norm) if cfg.n_enc_layers else None
        self.blocks = nn.ModuleList(Block(b, cfg, spec, cross=cfg.is_encdec)
                                    for spec in cfg.layer_specs)
        self.mtp = MTPHead(b, cfg) if cfg.mtp else None
        self.layout = b.layout
        self._specs = {name: b.axes_of(p)
                       for name, p in self.named_parameters()}
        self._shapes = {name: b.shape_of(p)
                        for name, p in self.named_parameters()}
        self._segments = {name: b.segments_of(p)
                          for name, p in self.named_parameters()
                          if b.segments_of(p) is not None}

    def specs(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Parameter name -> its logical axes."""
        return dict(self._specs)

    def param_cut(self, name: str, shape, layout):
        """``layout``'s cut of parameter ``name`` of the whole ``shape``
        (``dist.plan.ShardLayout.param_cut`` with its axes and
        segments)."""
        return layout.param_cut(shape, self._specs[name],
                                self._segments.get(name))

    def whole_shape(self, name: str) -> Tuple[int, ...]:
        """The whole shape of parameter ``name``, of which this model may
        hold its layout's part."""
        return self._shapes[name]

    def segments(self, name: str):
        """The ``dist.plan.Segments`` of parameter ``name``, or None."""
        return self._segments.get(name)

    def cut_of(self, name: str):
        """The ``dist.plan.Cut`` of parameter ``name`` this model holds, or
        None where it holds the whole parameter."""
        if self.layout is None:
            return None
        return self.param_cut(name, self._shapes[name], self.layout)


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                max_positions: int = 0, device="cuda") -> Model:
    """A model with weights drawn from ``generator`` on ``device`` (which
    must be the generator's). ``device="meta"`` allocates nothing: the
    shapes and dtypes alone, as the JAX package's ``abstract=True``."""
    return init_sharded(generator, cfg, None, device, max_positions)


def init_sharded(generator: Optional[torch.Generator], cfg: ModelConfig,
                 layout, device="cuda", max_positions: int = 0) -> Model:
    """One rank's slice of the model :func:`init_params` draws from the
    same generator, as ``layout`` (a ``dist.plan.ShardLayout``; None: the
    whole model) cuts it: each tensor is drawn whole on ``device``, in
    the same order, and only the rank's slice is kept, so the largest
    transient is one whole tensor in f32."""
    return Model(ParamBuilder(generator, torch_dtype(cfg.param_dtype),
                              device, layout), cfg, max_positions)


def abstract_params(cfg: ModelConfig, max_positions: int = 0,
                    layout=None) -> Model:
    """Shape/dtype-only params (no allocation), on the ``meta`` device;
    with a ``layout``, one rank's shapes."""
    return init_sharded(None, cfg, layout, "meta", max_positions)


def shard_model(model: Model, layout) -> Model:
    """A model holding ``layout``'s slice of each of ``model``'s (whole)
    parameters, on their device."""
    if model.layout is not None:
        raise ValueError("shard_model takes a whole model")
    maxpos = 0 if model.dec_pos is None else model.dec_pos.shape[0]
    out = abstract_params(model.cfg, maxpos, layout)
    state = {}
    for name, p in model.named_parameters():
        cut = out.param_cut(name, p.shape, layout)
        state[name] = p.detach().clone() if cut is None \
            else cut.take(p.detach()).clone()
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(model: Model, batch: Dict) -> torch.Tensor:
    cfg = model.cfg
    x = TP.vocab_embed(batch["tokens"], model.embed, model.layout)
    if cfg.frontend == "vision" and "patches" in batch:
        p = matmul(gelu(matmul(batch["patches"], model.vis_proj1)),
                   model.vis_proj2)
        x = torch.cat([p.to(x.dtype), x], dim=1)
    if model.dec_pos is not None:
        pos0 = batch.get("pos_offset", 0)
        x = x + model.dec_pos[pos0: pos0 + x.shape[1]][None]
    return x


def _encode(model: Model, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, T, 128); over
    a model group its output is whole on every rank."""
    x = matmul(frames, model.aud_proj)
    if model.enc_pos is not None:
        x = x + model.enc_pos[None, : x.shape[1]]
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], -1)
    for block in model.enc:
        x, _, _ = block(x, pos, layout=model.layout)
    return model.enc_norm(x)


def _blocks_forward(x: torch.Tensor, positions: torch.Tensor,
                    enc_out: Optional[torch.Tensor], layout, *blocks: Block
                    ) -> torch.Tensor:
    for block in blocks:
        x, _, _ = block(x, positions, enc_out=enc_out, layout=layout)
    return x


def remat_groups(model: Model) -> List[List[Block]]:
    """The blocks each checkpoint holds: each prefix layer alone, then
    each period of the pattern, as the JAX package's ``_run_stack``
    checkpoints its prefix bodies and its scanned period body."""
    cfg, blocks = model.cfg, list(model.blocks)
    n_pre, n_pat = len(cfg.prefix_layers), len(cfg.pattern)
    return [blocks[i: i + 1] for i in range(n_pre)] + [
        blocks[i: i + n_pat] for i in range(n_pre, len(blocks), n_pat)]


def _run_stack(model: Model, x: torch.Tensor, positions: torch.Tensor, *,
               caches: Optional[List] = None, cache_pos: Optional[int] = None,
               enc_out: Optional[torch.Tensor] = None, decode: bool = False
               ) -> Tuple[torch.Tensor, Optional[List]]:
    """Every block in turn; with ``caches`` (one a block), each block's
    cache is updated at ``cache_pos``. The blocks' aux stats are dropped,
    as the JAX package's ``_run_stack`` drops them. Without caches and
    under autograd, ``cfg.remat`` checkpoints the groups of
    :func:`remat_groups` (the module docstring)."""
    if caches is None and model.cfg.remat != "none" \
            and torch.is_grad_enabled():
        for group in remat_groups(model):
            # the blocks draw no random numbers: no RNG state to replay;
            # over a model group the recompute runs each group's
            # collectives again inside backward, in the same order on
            # every rank (the ranks' graphs are the same)
            x = checkpoint(_blocks_forward, x, positions, enc_out,
                           model.layout, *group, use_reentrant=False,
                           preserve_rng_state=False)
        return x, None
    new_caches = []
    for i, block in enumerate(model.blocks):
        x, nc, _ = block(x, positions,
                         cache=caches[i] if caches is not None else None,
                         cache_pos=cache_pos, enc_out=enc_out, decode=decode,
                         layout=model.layout)
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if model.cfg.tie_embeddings else model.lm_head
    return TP.vocab_logits(x, head, model.layout)


def forward_train(model: Model, batch: Dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean loss, metrics). ``batch``: ``tokens`` (B, S), ``labels``
    (B, S), and ``patches`` or ``frames`` as :func:`forward_prefill` takes
    them; labels of -100 are masked, and so are the patch positions. With
    ``cfg.mtp`` the loss adds 0.3 x the MTP loss and the metrics say
    ``mtp``; ``metrics["loss"]`` is the LM loss alone, as in the JAX
    package.

    Over a ``(data, model)`` layout (``model.layout``; ``batch`` this
    rank's rows of the global batch) the loss is this data rank's share
    of the global batch's mean: its NLL summed over the labels of its
    rows, over the label count of the global batch (summed over the data
    group), so that the data ranks' gradients sum to the gradient of the
    global mean, which the JAX package takes. Every rank of a model
    group computes the same loss, its split layers each giving their own
    share of the gradients (``dist.tensor_parallel``); the logits' loss
    is vocabulary-parallel where the vocabulary is cut
    (``dist.tensor_parallel.vocab_loss``). ``metrics["loss"]`` and
    ``metrics["tokens"]`` are the global batch's on every rank."""
    cfg = model.cfg
    x = _embed_inputs(model, batch)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    enc_out = _encode(model, batch["frames"]) if cfg.is_encdec else None
    x, _ = _run_stack(model, x, positions, enc_out=enc_out)
    x = model.final_norm(x)

    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        # patch positions carry no next-token loss
        pad = labels.new_full((bsz, x.shape[1] - labels.shape[1]), -100)
        labels = torch.cat([pad, labels], dim=1)

    loss, metrics = _lm_loss(model, x, labels)
    if cfg.mtp and "tokens" in batch:
        loss = loss + 0.3 * _mtp_loss(model, x, batch, positions)
        metrics["mtp"] = True
    return loss, metrics


def _lm_loss(model: Model, x: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the labels >= 0, from f32 logits; over a
    layout, this data rank's share of the global batch's mean
    (:func:`forward_train`)."""
    layout = model.layout
    mask = labels >= 0
    if TP.splits(layout, "vocab"):
        head = model.embed.T if model.cfg.tie_embeddings else model.lm_head
        nll = TP.vocab_loss(x, head, labels, layout)
    else:
        logits = _logits(model, x).float()
        safe = torch.clamp_min(labels, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = (logz - gold) * mask
    count = mask.sum()
    if TP.data_split(layout):
        count = TP.data_sum(count, layout)
    denom = torch.clamp_min(count, 1)
    loss = nll.sum() / denom
    total = TP.data_sum(loss.detach().clone(), layout) \
        if TP.data_split(layout) else loss
    return loss, {"loss": total, "tokens": denom}


def _mtp_loss(model: Model, x: torch.Tensor, batch: Dict,
              positions: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction (depth 1): predict t+2."""
    cfg, mtp = model.cfg, model.mtp
    tokens = batch["tokens"]
    emb_next = TP.vocab_embed(torch.roll(tokens, -1, dims=1), model.embed,
                              model.layout)
    if x.shape[1] != tokens.shape[1]:  # VLM: only the text tail
        x = x[:, -tokens.shape[1]:]
        positions = positions[:, -tokens.shape[1]:]
    h = matmul(torch.cat([mtp.norm_h(x), mtp.norm_e(emb_next.to(x.dtype))],
                         dim=-1), mtp.proj)
    h, _, _ = mtp.block(h, positions, layout=model.layout)
    labels2 = torch.roll(batch["labels"], -2, dims=1)
    labels2[:, -2:] = -100
    loss, _ = _lm_loss(model, h, labels2)
    return loss


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

class Caches(list):
    """One cache a block (a ``KVCache``, ``MLACache`` or ``SSMCache``, or
    None for a block that keeps none) and, for the encoder-decoder,
    ``enc_out``: the encoder's output, which the prefill sets and each
    decode step reads."""

    enc_out: Optional[torch.Tensor] = None


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda", layout=None) -> Caches:
    """One cache a block, ``max_len`` positions each: GQA's in
    ``cfg.kv_cache_dtype``, MLA's latent cache in bf16, and SSD's conv
    inputs in bf16 and state in f32, as the JAX package keeps them. With
    a ``layout``, the rank's rows of a global ``batch`` and its part of
    each cache: GQA's kv heads of its slice (under ``kv_seq``, every kv
    head over its run of the positions), an SSD's state of its heads and
    conv inputs of its ``x`` channels with all of ``B`` and ``C``, MLA's
    latent whole."""
    device = resolve_model_device(device)
    check_served(cfg)
    n_kv, kv_len, parts = cfg.n_kv_heads, max_len, 1
    if layout is not None:
        rows = layout.rows(batch)
        batch = rows.stop - rows.start
        if layout.kv_seq:
            kv_len = -(-max_len // layout.model)
        else:
            kv = layout.local("kv_heads", cfg.n_kv_heads)
            n_kv = kv.stop - kv.start
        parts = layout.model if ssd_split(layout) else 1

    def one(spec):
        mixer, _ = spec
        if mixer == "attn":
            return init_kv_cache(batch, kv_len, n_kv, cfg.head_dim,
                                 cfg.kv_cache_dtype, device)
        if mixer == "mla":
            return init_mla_cache(batch, max_len, cfg, device=device)
        if mixer == "ssm":
            s = cfg.ssm
            di = s.expand * cfg.d_model // parts
            return SSMCache(
                torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                            dtype=torch.bfloat16, device=device),
                torch.zeros((batch, di // s.head_dim, s.d_state,
                             s.head_dim), dtype=torch.float32,
                            device=device))
        return None

    return Caches(one(spec) for spec in cfg.layer_specs)


def forward_prefill(model: Model, batch: Dict, caches: List
                    ) -> Tuple[torch.Tensor, Caches]:
    """Run the full prompt, fill caches; returns (last-position logits,
    caches). ``batch``: ``tokens`` (B, S); for the VLM ``patches``
    (B, n_patches, 1024), which come first in the sequence; for the
    encoder-decoder ``frames`` (B, enc_seq, 128), whose encoding the
    caches then carry."""
    x = _embed_inputs(model, batch)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    enc_out = _encode(model, batch["frames"]) if model.cfg.is_encdec \
        else None
    x, new = _run_stack(model, x, positions, caches=caches, cache_pos=0,
                        enc_out=enc_out)
    caches = Caches(new)
    caches.enc_out = enc_out
    x = model.final_norm(x[:, -1:])
    return _logits(model, x), caches


def forward_decode(model: Model, token: torch.Tensor, pos: int,
                   caches: List) -> Tuple[torch.Tensor, Caches]:
    """One decode step. token (B, 1) int; pos the step's position."""
    x = TP.vocab_embed(token, model.embed, model.layout)
    if model.dec_pos is not None:
        x = x + model.dec_pos[pos: pos + 1][None]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    enc_out = getattr(caches, "enc_out", None)
    x, new = _run_stack(model, x, positions, caches=caches, cache_pos=pos,
                        enc_out=enc_out, decode=True)
    new = Caches(new)
    new.enc_out = enc_out
    return _logits(model, model.final_norm(x)), new

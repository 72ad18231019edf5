"""Unified model configuration covering all assigned architecture families.

A model is: optional modality frontend stub -> embedding -> a prefix of
unrolled layers + a periodic pattern of layers scanned over periods ->
norm -> LM head. Layer spec = (mixer, ffn):
  mixer: "attn" (GQA/MHA), "mla" (DeepSeek latent attention),
         "ssm" (Mamba-2 SSD), "attn_bidir" (encoder), "attn_cross" (decoder)
  ffn  : "dense", "moe", "none"

The port's own copy of the JAX package's ``models/config.py`` (it imports
nothing of ``repro``); the two must describe the same models.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

LayerSpec = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    expert_ff: int = 2048
    n_shared: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"        # "softmax" | "sigmoid_bias" (DSv3 aux-free)
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer layout
    prefix_layers: Tuple[LayerSpec, ...] = ()
    pattern: Tuple[LayerSpec, ...] = (("attn", "dense"),)
    n_periods: int = 1
    # families
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0               # fixed encoder length (audio frames stub)
    # frontends
    frontend: Optional[str] = None  # None | "vision" | "audio"
    n_patches: int = 0              # vision stub tokens per example
    # attention details
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention
    attn_logit_softcap: float = 0.0
    activation: str = "swiglu"     # swiglu | geglu | gelu | sqrelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    mtp: bool = False              # DeepSeek-V3 multi-token prediction head
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # distribution / memory
    remat: str = "full"            # none | full | dots
    attn_chunk: int = 1024         # KV chunk for flash-style attention
    decode_kv_shard: str = "none"  # none | "seq" (SP over cache length)
    kv_cache_dtype: str = "bfloat16"  # or "int8" (quantized cache)

    @property
    def n_layers(self) -> int:
        return len(self.prefix_layers) + len(self.pattern) * self.n_periods

    @property
    def layer_specs(self) -> List[LayerSpec]:
        return list(self.prefix_layers) + list(self.pattern) * self.n_periods

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d = self.d_model
        n = 0
        n += self.vocab * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab * d                  # head
        for mixer, ffn in self.layer_specs:
            n += self._mixer_params(mixer)
            n += self._ffn_params(ffn)
            n += 2 * d                           # norms
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                n += self._mixer_params("attn") + self._ffn_params("dense") + 2 * d
            # cross attention in each decoder layer
            n += len(self.layer_specs) * self._mixer_params("attn")
        return n

    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer == "ssm":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            return d * (2 * di + 2 * s.d_state + nh) + di * d + di * s.d_conv
        if mixer == "mla":
            m = self.mla
            h = self.n_heads
            qd = m.nope_dim + m.rope_dim
            return (
                d * m.q_lora + m.q_lora * h * qd          # q down/up
                + d * (m.kv_lora + m.rope_dim)             # kv down + k_rope
                + m.kv_lora * h * (m.nope_dim + m.v_dim)   # k/v up
                + h * m.v_dim * d                          # out
            )
        # attn variants
        return d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d

    def _ffn_params(self, ffn: str) -> int:
        d = self.d_model
        if ffn == "none":
            return 0
        if ffn == "moe":
            m = self.moe
            n = m.n_experts * 3 * d * m.expert_ff + d * m.n_experts
            if m.n_shared:
                n += 3 * d * (m.shared_ff or m.expert_ff) * m.n_shared
            return n
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        per_expert = 3 * d * m.expert_ff
        n_moe_layers = sum(1 for _, f in self.layer_specs if f == "moe")
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return self.param_count() - inactive

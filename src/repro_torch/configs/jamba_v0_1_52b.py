"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 65536, 16 experts top-2, attention every 8th layer, MoE every other
layer. SSM realized with the Mamba-2 SSD mixer (DESIGN.md notes the
Mamba-1 -> SSD substitution).
"""
from ..models.config import ModelConfig, MoEConfig, SSMConfig

# one Jamba block = 8 layers: attention at slot 4, MoE on odd slots
_PATTERN = tuple(
    ("attn" if i == 4 else "ssm", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    pattern=_PATTERN, n_periods=4,
    moe=MoEConfig(n_experts=16, top_k=2, expert_ff=14336),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=256),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    pattern=tuple(("attn" if i == 1 else "ssm", "moe" if i % 2 else "dense")
                  for i in range(4)),
    n_periods=2,
    moe=MoEConfig(n_experts=4, top_k=2, expert_ff=256),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=32),
    attn_chunk=64,
)

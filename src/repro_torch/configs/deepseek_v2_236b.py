"""DeepSeek-V2 236B — MLA kv_lora=512, 2 shared + 160 routed top-6 MoE.

[arXiv:2405.04434] 60L, d 5120, 128 heads, first layer dense (d_ff 12288),
expert_ff 1536, vocab 102400.
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab=102400,
    prefix_layers=(("mla", "dense"),),
    pattern=(("mla", "moe"),), n_periods=59,
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, expert_ff=1536, n_shared=2,
                  shared_ff=1536),
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
    prefix_layers=(("mla", "dense"),),
    pattern=(("mla", "moe"),), n_periods=2,
    mla=MLAConfig(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=32, v_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=64, n_shared=2,
                  shared_ff=64),
    attn_chunk=64,
)

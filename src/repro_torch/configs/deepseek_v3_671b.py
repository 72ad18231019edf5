"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed top-8)
with aux-loss-free sigmoid routing and multi-token prediction.

[arXiv:2412.19437] 61L, d 7168, 128 heads, MLA kv_lora 512 (+64 rope),
first 3 layers dense (d_ff 18432), 58 MoE layers with expert_ff 2048,
vocab 129280.
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    prefix_layers=(("mla", "dense"),) * 3,
    pattern=(("mla", "moe"),), n_periods=58,
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, expert_ff=2048, n_shared=1,
                  shared_ff=2048, router="sigmoid_bias"),
    mtp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
    prefix_layers=(("mla", "dense"),),
    pattern=(("mla", "moe"),), n_periods=2,
    mla=MLAConfig(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=32, v_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=64, n_shared=1,
                  shared_ff=64, router="sigmoid_bias"),
    mtp=True, attn_chunk=64,
)

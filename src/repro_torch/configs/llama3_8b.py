"""Llama-3 8B — dense GQA with 128k vocab. [arXiv:2407.21783]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    pattern=(("attn", "dense"),), n_periods=32,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2, attn_chunk=64,
)

"""Gemma 7B — GeGLU, head_dim 256, MHA (kv=16), 256k vocab, tied embeddings.
[arXiv:2403.08295]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    pattern=(("attn", "dense"),), n_periods=28,
    activation="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=256, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2,
    activation="geglu", tie_embeddings=True, attn_chunk=64,
)

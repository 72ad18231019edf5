"""Nemotron-4 15B — GQA with squared-ReLU FFN, 256k vocab.
[arXiv:2402.16819]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    pattern=(("attn", "dense"),), n_periods=32,
    activation="sqrelu",
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2,
    activation="sqrelu", attn_chunk=64,
)

"""Command R+ 104B — dense GQA, no-bias, 256k vocab.
[hf:CohereForAI/c4ai-command-r-plus]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000,
    pattern=(("attn", "dense"),), n_periods=64,
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2, attn_chunk=64,
)

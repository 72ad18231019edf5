"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] Backbone: 32L, d 4096, GQA 32/8,
d_ff 14336, vocab 32000, sliding window 4096. Vision frontend is a stub:
input_specs provides 2880 precomputed patch embeddings (5 anyres tiles x
576 patches, CLIP-style 1024-dim) fed through the 2-layer MLP projector.
This is the arch whose input pipeline exercises the paper's JPEG decoder.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=(("attn", "dense"),), n_periods=32,
    sliding_window=4096,
    frontend="vision", n_patches=2880,
)

SMOKE = ModelConfig(
    name="llava-smoke",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2,
    sliding_window=64, frontend="vision", n_patches=8, attn_chunk=64,
)

"""Whisper base — encoder-decoder with conv/audio frontend stub.
[arXiv:2212.04356] 6L enc + 6L dec, d 512, 8 heads, d_ff 2048, vocab 51865,
1500 encoder frames, GELU + LayerNorm, learned positions.
The 32k decode shape is a stress configuration beyond Whisper's native 448
context (noted per DESIGN.md §5)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    pattern=(("attn", "dense"),), n_periods=6,
    n_enc_layers=6, enc_seq=1500,
    frontend="audio", activation="gelu", norm="layernorm",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(("attn", "dense"),), n_periods=2,
    n_enc_layers=2, enc_seq=16,
    frontend="audio", activation="gelu", norm="layernorm", attn_chunk=32,
)

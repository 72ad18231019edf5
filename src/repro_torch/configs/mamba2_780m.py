"""Mamba-2 780M — attention-free SSD stack. [arXiv:2405.21060]
48L, d 1536, state 128, head_dim 64, expand 2, vocab 50280."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=0, vocab=50280,
    pattern=(("ssm", "none"),), n_periods=48,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=0, vocab=512,
    pattern=(("ssm", "none"),), n_periods=3,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=32),
)

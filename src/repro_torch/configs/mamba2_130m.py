"""Mamba2-130M: attention-free SSD (state-space duality). d_inner = 2*d,
24 heads of dim 64, state 128. [arXiv:2405.21060]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_groups=1,
    ssm_expand=2, tie_embeddings=True, rope_theta=0.0,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-130m",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, vocab=256,
                       ssm_heads=4, ssm_head_dim=32, ssm_state=16,
                       ssm_chunk=16)

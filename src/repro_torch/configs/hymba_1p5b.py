"""Hymba-1.5B: parallel attention + Mamba heads per layer, SWA with 3
global-attention layers, 128 meta tokens. [arXiv:2411.13676; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1p5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, d_head=64,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64, ssm_groups=1,
    attn_window=1024, global_layers=(0, 15, 31), n_meta_tokens=128,
    rope_theta=10000.0,
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, d_head=16,
                       ssm_heads=4, ssm_head_dim=16, ssm_state=8,
                       attn_window=32, global_layers=(0,), n_meta_tokens=4,
                       attn_q_chunk=16, attn_kv_chunk=32, ssm_chunk=16)

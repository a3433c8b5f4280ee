"""Qwen1.5-110B: dense GQA with QKV bias. [hf:Qwen/Qwen1.5-110B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1p5_110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, d_head=128, qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-110B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, d_head=16,
                       attn_q_chunk=16, attn_kv_chunk=32)

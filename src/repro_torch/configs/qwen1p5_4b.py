"""Qwen1.5-4B: dense, kv=20 (effectively MHA), QKV bias. [hf:Qwen/Qwen1.5-4B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1p5_4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, d_head=128, qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-4B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab=256, d_head=16,
                       attn_q_chunk=16, attn_kv_chunk=32)

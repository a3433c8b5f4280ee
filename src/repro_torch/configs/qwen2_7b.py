"""Qwen2-7B: dense GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, d_head=128, qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-7B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, d_head=16,
                       attn_q_chunk=16, attn_kv_chunk=32)

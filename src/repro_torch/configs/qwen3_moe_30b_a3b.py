"""Qwen3-MoE-30B-A3B: 128 experts top-8, expert d_ff=768, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_30b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, d_head=128,
    n_experts=128, top_k=8, capacity_factor=1.25,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=32, vocab=256, d_head=16,
                       n_experts=8, top_k=2,
                       attn_q_chunk=16, attn_kv_chunk=32)

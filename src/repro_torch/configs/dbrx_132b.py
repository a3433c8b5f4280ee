"""DBRX-132B: 16 experts top-4 fine-grained MoE, GQA kv=8.
[hf:databricks/dbrx-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, d_head=128,
    n_experts=16, top_k=4, capacity_factor=1.25,
    rope_theta=5e5,
    source="hf:databricks/dbrx-base",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=64, vocab=256, d_head=16,
                       n_experts=4, top_k=2,
                       attn_q_chunk=16, attn_kv_chunk=32)

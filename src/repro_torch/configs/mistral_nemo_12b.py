"""Mistral-Nemo-12B: dense GQA, 128k context, head_dim 128 (not d/H).
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral_nemo_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, d_head=128, rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, d_head=16,
                       attn_q_chunk=16, attn_kv_chunk=32)

"""Whisper-base backbone: 6L encoder + 6L decoder, d=512, 8 heads, MHA.
Conv frontend STUBBED (input_specs feeds precomputed frame embeddings).
[arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, d_head=64, qkv_bias=True,
    act="gelu", rope_theta=0.0, tie_embeddings=True,
    enc_layers=6, enc_seq=1500, max_seq=32768,
    source="arXiv:2212.04356; hf:openai/whisper-base",
)

SMOKE = CONFIG.replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab=256, d_head=16,
                       enc_seq=32, max_seq=512,
                       attn_q_chunk=16, attn_kv_chunk=32)

"""InternVL2-26B backbone: InternViT frontend (STUBBED: input_specs feeds
precomputed patch embeddings) + InternLM2-20B LLM. [arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, d_head=128,
    n_img_tokens=256, rope_theta=1e6,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, d_head=16, n_img_tokens=8,
                       attn_q_chunk=16, attn_kv_chunk=32)

"""Model / run configuration dataclasses and the architecture registry.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package).  Every ported architecture gets one module in
``repro_torch.configs`` exporting ``CONFIG`` (the exact published config)
and ``SMOKE`` (a reduced config of the same family for CPU tests).
``get_config(name)`` resolves either, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input-shape cells (assigned shapes; seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Smoke-sized shape cells (same kinds, tiny dims) used by tests.
SMOKE_SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeCell("long_500k", 256, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, used by whisper/cnn-era)
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_expand: int = 2  # d_inner = expand * d_model (pure-ssm archs)
    ssm_groups: int = 1

    # --- hybrid (parallel attn + ssm heads, Hymba-style) ---
    attn_window: int = 0  # 0 => full attention everywhere
    global_layers: Tuple[int, ...] = ()  # layer indices with full attention
    n_meta_tokens: int = 0  # Hymba learnable prefix tokens

    # --- VLM (frontend stubbed: precomputed patch embeddings) ---
    n_img_tokens: int = 0

    # --- enc-dec (Whisper-style; conv frontend stubbed: frame embeddings) ---
    enc_layers: int = 0
    enc_seq: int = 0  # encoder positions (e.g. 1500 Whisper frames)

    # --- numerics / memory policy ---
    max_seq: int = 8192  # decoder position-table budget (learned-pos archs)
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    # informational
    param_count_hint: float = 0.0  # published N (for 6ND model-flops)
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run the 500k-token cell (SSM / SWA hybrid)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.attn_window > 0
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "internvl2_26b",
    "hymba_1p5b",
    "mistral_nemo_12b",
    "qwen1p5_110b",
    "qwen1p5_4b",
    "qwen2_7b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "mamba2_130m",
    "whisper_base",
]

CNN_IDS = ["vgg16", "googlenet", "resnet50"]

_ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1p5b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen1.5-110b": "qwen1p5_110b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-130m": "mamba2_130m",
    "whisper-base": "whisper_base",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


# architectures whose model path the port serves: every one of ARCH_IDS
PORTED_ARCH_IDS = ["qwen2_7b", "qwen1p5_4b", "mistral_nemo_12b",
                   "qwen1p5_110b", "qwen3_moe_30b_a3b", "dbrx_132b",
                   "internvl2_26b", "mamba2_130m", "hymba_1p5b",
                   "whisper_base"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE if smoke else mod.CONFIG


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Which of the four assigned shape cells this arch runs (see DESIGN.md)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes

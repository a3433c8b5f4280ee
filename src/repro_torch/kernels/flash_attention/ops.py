"""The flash-attention wrapper the model's prefill calls.

A CPU tensor goes to the plain version (``ref.attention``); a CUDA tensor
launches the CUDA kernel and adds one to ``flash_attention.launches``.
There is no fallback: any other device, or a tensor the kernel does not
take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (the default) or bidirectional attention.  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D).  window <= 0 means no window.  Returns
    (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

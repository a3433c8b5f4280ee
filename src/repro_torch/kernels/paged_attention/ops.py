"""The paged decode-attention wrapper the model's decode step calls.

A CPU tensor goes to the plain version (``ref.paged_decode_attention``); a
CUDA tensor launches the CUDA kernel and adds one to
``paged_decode.launches``.  There is no fallback: any other device, or a
tensor the kernel does not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .paged_attention import paged_decode_cuda


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, tables: torch.Tensor,
                 cur_pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int32;
    cur_pos: (B,) int32.  window <= 0 means no window.  Returns (B, Hq, D).
    The new token's K/V row must already be in the pool."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, tables,
                                          cur_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: no kernel for device {q.device}")
    out = paged_decode_cuda(q, k_pages, v_pages, tables, cur_pos,
                            window=window)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0

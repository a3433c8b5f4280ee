"""The flash-decode wrapper the model's dense-slab decode step calls.

A CPU tensor goes to the plain version (``ref.decode_attention``); a CUDA
tensor launches the CUDA kernel and adds one to ``flash_decode.launches``.
There is no fallback: any other device, or a tensor the kernel does not
take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_decode import flash_decode_cuda


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur_pos, *,
                 window: int = 0) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); cur_pos: () or (B,) int32
    (an int is taken as a scalar).  window <= 0 means no window.  Returns
    (B, Hq, D)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, cur_pos,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device)
    out = flash_decode_cuda(q, k_cache, v_cache, cur.contiguous(),
                            window=window)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

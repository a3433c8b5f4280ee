"""The flash-decode wrapper the model's dense-slab decode step calls.

A CPU tensor goes to the plain version (``ref.decode_attention``); a CUDA
tensor launches the kernel of the route ``route_of`` picks (``tma``, the
Hopper kernel, for bf16 operands it takes; ``template`` for the rest) and
adds one to ``flash_decode.launches`` and one to its route's count in
``flash_decode.routes``.  There is no fallback: any other device, or a
tensor the kernels do not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_decode import ROUTES, flash_decode_cuda, route_of


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
    r = route_of(q, k_cache, v_cache)
    out = flash_decode_cuda(q, k_cache, v_cache, cur.contiguous(),
                            window=window, route=r)
    flash_decode.launches += 1
    flash_decode.routes[r] += 1
    return out


flash_decode.launches = 0
flash_decode.routes = dict.fromkeys(ROUTES, 0)

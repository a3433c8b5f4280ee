"""The matmul wrapper the model calls for every projection and the LM head.

A CPU tensor goes to the plain version (``ref.matmul``); a CUDA tensor
launches the CUDA kernel and adds one to ``matmul.launches``.  There is no
fallback: any other device, or a tensor the kernel does not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .matmul import matmul_cuda


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if a.device.type == "cpu":
        return ref.matmul(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    out = matmul_cuda(a, b)
    matmul.launches += 1
    return out


matmul.launches = 0

"""The matmul wrapper the model calls for every projection and the LM head.

A CPU tensor goes to the plain version (``ref.matmul``); a CUDA tensor
launches the CUDA kernel its plan picks, adds one to ``matmul.launches``
and one to that route's count in ``matmul.routes``.  There is no
fallback: any other device, or a tensor the kernel does not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .matmul import launch, plan_for
from .plan import ROUTES


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if a.device.type == "cpu":
        return ref.matmul(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    p = plan_for(a, b)
    out = launch(a, b, p)
    matmul.launches += 1
    matmul.routes[p.route] += 1
    return out


matmul.launches = 0
matmul.routes = dict.fromkeys(ROUTES, 0)   # launches by route

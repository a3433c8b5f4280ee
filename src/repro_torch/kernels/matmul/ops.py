"""The matmul wrapper the model calls for every projection and the LM head.

A CPU tensor goes to the plain version (``ref.matmul``); a CUDA tensor
launches the CUDA kernel its plan picks, adds one to ``matmul.launches``,
one to that route's count in ``matmul.routes`` and, where the plan stages
an operand through its windows (rows not 16-byte aligned), one to
``matmul.staged``.  Either operand may be a row-major matrix or the
``.t()`` view of one: the ``wgmma`` and ``stream`` routes read it in
place, the others read a contiguous copy.  Where grad is enabled and an operand requires it
(training), the call goes through ``MatMul``, an autograd Function whose
forward is the same launch and whose backward is two more products
through this wrapper, dA = dC B^T and dB = A^T dC (each counted; the
transposes are views).  There is no fallback: any other device, or a
tensor the kernel does not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .matmul import launch, plan_for
from .plan import ROUTES


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return MatMul.apply(a, b)
    if a.device.type == "cpu":
        return ref.matmul(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    p = plan_for(a, b)
    out = launch(a, b, p)
    matmul.launches += 1
    matmul.routes[p.route] += 1
    matmul.staged += any(p.staged)
    return out


matmul.launches = 0
matmul.routes = dict.fromkeys(ROUTES, 0)   # launches by route
matmul.staged = 0    # mma launches with an operand staged through windows


class MatMul(torch.autograd.Function):
    """``a @ b`` with its gradient on the matmul kernel."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul(a, b)       # grad mode is off inside forward

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype).contiguous()
        da = matmul(dc, b.t()) if ctx.needs_input_grad[0] else None
        db = matmul(a.t(), dc) if ctx.needs_input_grad[1] else None
        return da, db

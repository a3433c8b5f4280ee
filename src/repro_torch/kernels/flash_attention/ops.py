"""The flash-attention wrappers the model calls.

``flash_attention``: a CPU tensor goes to the plain version
(``ref.attention``); a CUDA tensor launches the CUDA kernel and adds one to
``flash_attention.launches`` and one to its route's count in
``flash_attention.routes`` (``fwd_route``: ``wgmma`` for bf16 from 256
query rows, 768 at D <= 64, ``mma`` for shorter bf16 calls,
``cuda_cores`` for f32).  Where grad is enabled and an input requires
it (training), the call goes through ``FlashAttention``, an autograd
Function: its forward is ``flash_attention_lse`` (the same kernel, also
writing each row's log-sum-exp; one launch, counted as above) and its
backward ``flash_attention_backward`` (the three backward kernels; each
launch adds one to its count in ``flash_attention_backward.kernels``, each
call one to ``flash_attention_backward.launches`` and one to its route's
in ``flash_attention_backward.routes``: ``wgmma`` for bf16, ``cuda_cores``
for f32).  On a CPU tensor
both take their plain versions.  There is no fallback: any other device,
or a tensor the kernels do not take, raises.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import (BWD_KERNELS, BWD_ROUTES, FWD_ROUTES, bwd_route,
                              flash_attention_bwd_cuda, flash_attention_cuda,
                              fwd_route)


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return q.device.type


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (the default) or bidirectional attention.  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D).  window <= 0 means no window.  Returns
    (B, Sq, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    if _device(q) == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    _count(q, k)
    return out


def _count(q, k):
    flash_attention.launches += 1
    flash_attention.routes[fwd_route(q, k)] += 1


flash_attention.launches = 0                               # calls
flash_attention.routes = dict.fromkeys(FWD_ROUTES, 0)      # calls


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """(out, log-sum-exp (B, Sq, Hq) f32): the forward of training."""
    if _device(q) == "cpu":
        return ref.attention_lse(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               lse=True)
    _count(q, k)
    return out


def flash_attention_backward(q, k, v, lse, do, *, causal: bool = True,
                             window: int = 0):
    """(dQ, dK, dV) of ``flash_attention(q, k, v)`` from its log-sum-exp
    ``lse`` and output gradient ``do``."""
    if _device(q) == "cpu":
        return ref.attention_backward(q, k, v, do, causal=causal,
                                      window=window)
    out = flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                   window=window)
    flash_attention_backward.launches += 1
    flash_attention_backward.routes[bwd_route(q)] += 1
    for name in BWD_KERNELS:
        flash_attention_backward.kernels[name] += 1
    return out


flash_attention_backward.launches = 0                      # calls
flash_attention_backward.routes = dict.fromkeys(BWD_ROUTES, 0)   # calls
flash_attention_backward.kernels = dict.fromkeys(BWD_KERNELS, 0)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient on the kernels: saves q, k, v and the
    log-sum-exp; the backward recomputes the softmax weights from them tile
    by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None

"""Plain PyTorch version of the flash-attention kernels: materialized
scores, the same math as ``repro/kernels/flash_attention/ref.py``; the
log-sum-exp the forward kernel writes for training, and the backward
kernels' dQ, dK, dV as autograd through ``attention``."""
import math

import torch

_NEG = -1e30


def _masked_scores(q, k, *, causal: bool, window: int):
    """f32 scores (B, Hkv, G, Sq, Skv), scaled, masked keys at -1e30."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    qr = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window and window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, s, torch.full_like(s, _NEG))


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.  ``causal``
    masks the keys past each query's position; window > 0 = sliding window
    of that many keys (query i sees keys j with i - j < window).  Returns
    (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    p = torch.softmax(_masked_scores(q, k, causal=causal, window=window),
                      dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """(``attention``, each row's log-sum-exp of its scaled, masked scores
    (B, Sq, Hq) f32): what the forward kernel returns for training."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal=causal, window=window),
                          dim=-1)                        # (B, Hkv, G, Sq)
    lse = lse.permute(0, 3, 1, 2).reshape(B, Sq, Hq)
    return attention(q, k, v, causal=causal, window=window), lse


def attention_backward(q, k, v, do, *, causal: bool = True, window: int = 0):
    """(dQ, dK, dV) of ``attention(q, k, v)`` for the output gradient
    ``do``, by autograd through it: what the backward kernels return."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = attention(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, do)

"""Plain PyTorch version of the flash-attention kernel: materialized
scores, the same math as ``repro/kernels/flash_attention/ref.py``."""
import math

import torch

_NEG = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.  ``causal``
    masks the keys past each query's position; window > 0 = sliding window
    of that many keys (query i sees keys j with i - j < window).  Returns
    (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window and window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(ok, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)

"""Plain PyTorch version of the flash-decode kernel: one query token per
slot against a (partially filled) dense KV cache, the math of
``repro/kernels/flash_decode/ref.py``.  ``cur_pos`` is a scalar, as there,
or a (B,) vector of per-slot positions, as the model's dense decode step
passes (the reference's ``models/layers.py::decode_attention``)."""
import math

import torch

_NEG = -1e30


def decode_attention(q, k_cache, v_cache, cur_pos, *, window: int = 0):
    """q: (B, Hq, D); caches: (B, S, Hkv, D); cur_pos: () or (B,) int —
    positions [0, cur_pos[b]] of slot b are valid.  Returns (B, Hq, D)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                     k_cache.float()) / math.sqrt(D)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    cur = torch.as_tensor(cur_pos, dtype=torch.int32,
                          device=q.device).reshape(-1, 1)   # (1,1) or (B,1)
    ok = pos[None, :] <= cur
    if window and window > 0:
        ok &= pos[None, :] > (cur - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)

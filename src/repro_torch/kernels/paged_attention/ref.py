"""Plain PyTorch version of the paged decode-attention kernel: one query
token per slot against block-table-indexed KV pages with per-slot context
lengths, the same math as ``repro/kernels/paged_attention/ref.py``
(``paged_decode_attention``): gather each slot's chain into a dense view,
then masked softmax attention over it."""
import math

import torch

_NEG = -1e30


def _attend(q, kd, vd, cur_pos, window: int):
    """Masked decode attention over a dense (B, S, Hkv, D) view."""
    B, Hq, D = q.shape
    S, Hkv = kd.shape[1], kd.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), kd.float()) / math.sqrt(D)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    cur = cur_pos.to(torch.int32)
    ok = pos[None, :] <= cur[:, None]                   # (B, S)
    if window and window > 0:
        ok &= pos[None, :] > (cur[:, None] - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(vd.dtype).float(), vd.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, tables, cur_pos, *,
                           window: int = 0):
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int block ids
    into the pool; cur_pos: (B,) int — logical positions [0, cur_pos[b]] of
    slot b are valid (block t of slot b covers positions [t*bs, (t+1)*bs)).
    Returns (B, Hq, D)."""
    B = q.shape[0]
    _, bs, Hkv, D = k_pages.shape
    S = tables.shape[1] * bs
    idx = tables.long()
    kd = k_pages[idx].reshape(B, S, Hkv, D)
    vd = v_pages[idx].reshape(B, S, Hkv, D)
    return _attend(q, kd, vd, cur_pos, window)

"""Core layers of the decoder-only LM in PyTorch: the main-path subset of
the reference's ``repro/models/layers.py``.

Conventions follow the reference, so the tests compare like with like:
parameters are nested dicts of tensors, activations flow as
(batch, seq, ...), attention tensors are (B, S, H, D).  Three operations go
through the port's kernel wrappers, which run the hand-written CUDA kernel
on a CUDA tensor and the plain PyTorch version on a CPU tensor:

* every projection and the LM head -> ``kernels.matmul.ops.matmul``;
* prefill attention -> ``kernels.flash_attention.ops.flash_attention``;
* paged decode attention -> ``kernels.paged_attention.ops.paged_decode``.

Families other than the dense one (MoE, SSM, hybrid, VLM, enc-dec) wait for
their slices (ROADMAP.md, Queue 1 items 10-11).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.paged_attention.ops import paged_decode

_NEG = -1e30

# ---------------------------------------------------------------------------
# initializers (same distributions as the reference; torch draws its own bits)
# ---------------------------------------------------------------------------


def dense_init(generator, shape, dtype, device, scale: float | None = None):
    """Normal weights of ``shape = (..., d_in, d_out)`` scaled by
    1/sqrt(d_in), drawn in f32 one leading index at a time (a layer stack
    never holds more than one f32 layer) and stored in ``dtype``."""
    d_in = shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    out = torch.empty(shape, dtype=dtype, device=device)
    for idx in (range(shape[0]) if len(shape) > 2 else [...]):
        out[idx] = torch.randn(shape[-2:], generator=generator,
                               dtype=torch.float32, device=device) * scale
    return out


def embed_init(generator, vocab, d, dtype, device):
    return (torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)


def _proj(x, w):
    """``x @ w`` over the last axis through the matmul kernel wrapper."""
    y = matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _window(window) -> int:
    """None or <= 0 means no window (the reference's ``_window_len``)."""
    return int(window) if window is not None and int(window) > 0 else 0


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding (split-half, f32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, cur_pos, *, window=None):
    """Single-token attention against a dense cache, the plain masked
    version (the reference's ``decode_attention`` without ``head_keep``).

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cur_pos: (B,) int — cache
    entries [0, cur_pos[b]] of slot b are valid."""
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                     k_cache.float()) / math.sqrt(D)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    cur = torch.as_tensor(cur_pos, dtype=torch.int32,
                          device=q.device).reshape(-1, 1)
    ok = pos[None, :] <= cur
    w = _window(window)
    if w:
        ok &= pos[None, :] > (cur - w)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def init_attention(generator, cfg, dtype, device, n_layers: int):
    """Layer-stacked attention parameters (leading axis ``n_layers``)."""
    d, hd, L = cfg.d_model, cfg.head_dim, n_layers
    p = {
        "wq": dense_init(generator, (L, d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(generator, (L, d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(generator, (L, d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(generator, (L, cfg.n_heads * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, cfg.n_heads * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dtype,
                              device=device)
    return p


def attention_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, cfg, x, *, window=None, positions=None):
    """Full-sequence (prefill) causal attention, GQA and optional sliding
    window, through the flash-attention wrapper.  Returns (out, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = attention_qkv(p, cfg, x, positions)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        window=_window(window))
    return _proj(o.reshape(B, S, -1), p["wo"]), (k, v)


def attention_decode_paged(p, cfg, x, k_pages, v_pages, tables, cur_pos, *,
                           window=None):
    """Decode attention against one layer's paged KV pool.

    x: (B, 1, d); pages: (N, bs, Hkv, D); tables: (B, T) int32 block ids
    (null-padded); cur_pos: (B,) int32 per-slot write position.  The new
    token's K/V row is written IN PLACE into the pool first — block
    ``tables[b, cur // bs]``, offset ``cur % bs`` — and then the paged
    attention wrapper reads the pool with it: the reference places the row
    in its gathered view before attending and has the caller persist it
    afterwards (``repro/models/layers.py:390-391``,
    ``repro/models/transformer.py:390-411``); a kernel that streams the
    pool must find the row there.  Returns (out, (k_new, v_new)) like the
    reference, with the row already persisted.
    """
    B = x.shape[0]
    bs, T = k_pages.shape[1], tables.shape[1]
    cur = cur_pos.to(torch.int32)
    q, k, v = attention_qkv(p, cfg, x, cur[:, None])
    blk = tables.gather(1, (cur // bs).clamp(0, T - 1)[:, None].long())[:, 0]
    off = (cur % bs).long()
    k_pages[blk.long(), off] = k[:, 0].to(k_pages.dtype)
    v_pages[blk.long(), off] = v[:, 0].to(v_pages.dtype)
    o = paged_decode(q[:, 0].contiguous(), k_pages, v_pages, tables, cur,
                     window=_window(window))
    return _proj(o.reshape(B, 1, -1), p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model, d_ff, act, dtype, device, n_layers: int):
    if act != "silu":
        raise NotImplementedError(f"mlp act {act!r}: only SwiGLU ('silu') "
                                  "is ported (ROADMAP.md, Queue 1 item 11)")
    L = n_layers
    return {"w1": dense_init(generator, (L, d_model, d_ff), dtype, device),
            "w2": dense_init(generator, (L, d_ff, d_model), dtype, device),
            "w3": dense_init(generator, (L, d_model, d_ff), dtype, device)}


def mlp_block(p, x, act: str):
    if act != "silu":
        raise NotImplementedError(f"mlp act {act!r}: only SwiGLU ('silu') "
                                  "is ported (ROADMAP.md, Queue 1 item 11)")
    h = F.silu(_proj(x, p["w1"])) * _proj(x, p["w3"])
    return _proj(h, p["w2"])

"""Core layers of the LMs in PyTorch: the main-path subset of the
reference's ``repro/models/layers.py``.

Conventions follow the reference, so the tests compare like with like:
parameters are nested dicts of tensors, activations flow as
(batch, seq, ...), attention tensors are (B, S, H, D).  Three operations go
through the port's kernel wrappers, which run the hand-written CUDA kernel
on a CUDA tensor and the plain PyTorch version on a CPU tensor:

* every projection and the LM head -> ``kernels.matmul.ops.matmul``;
* prefill attention -> ``kernels.flash_attention.ops.flash_attention``
  (causal, or bidirectional for the enc-dec family's encoder and cross
  attention);
* paged decode attention -> ``kernels.paged_attention.ops``:
  ``paged_decode`` (float pool), ``paged_decode_sparse`` (float pool,
  blockwise-sparse) and ``paged_decode_quant`` (packed int8/fp8 pool,
  optionally sparse);
* dense-slab decode attention -> ``kernels.flash_decode.ops.flash_decode``.

The MoE FFN is ``models/moe.py``, the Mamba-2 SSD ``models/ssm.py`` and the
enc-dec backbone ``models/encdec.py``, whose LayerNorm and GELU MLP are here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import \
    decode_attention as decode_attention_plain
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.paged_attention.ops import (paged_decode,
                                                     paged_decode_quant,
                                                     paged_decode_sparse)
from repro_torch.kernels.paged_attention.ref import block_keep_mask

# ---------------------------------------------------------------------------
# initializers (same distributions as the reference; torch draws its own bits)
# ---------------------------------------------------------------------------


def dense_init(generator, shape, dtype, device, scale: float | None = None):
    """Normal weights of ``shape = (..., d_in, d_out)`` scaled by
    1/sqrt(d_in), drawn in f32 one (d_in, d_out) matrix at a time, each
    leading index (layer, or layer and expert) its own draw, and stored in
    ``dtype``: a stack never holds more than one f32 matrix (48 x 128
    experts of 2048 x 768 would be 38.7 GB in f32)."""
    d_in = shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:     # shapes only: no per-matrix draws (qwen3-moe has
        return out      # 18,432 expert matrices)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(torch.randn(shape[-2:], generator=generator,
                              dtype=torch.float32, device=device) * scale)
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


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis in f32 with the population variance
    (the reference's ``jnp.var``), cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


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
    version (the reference's ``decode_attention`` without ``head_keep``):
    the flash-decode kernel's plain version with the reference's shapes.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cur_pos: () or (B,) int —
    cache entries [0, cur_pos[b]] of slot b are valid."""
    return decode_attention_plain(q[:, 0], k_cache, v_cache, cur_pos,
                                  window=_window(window))[:, None]


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


def attention_decode_slice(p, cfg, x, k_cache, v_cache, cur_pos, *,
                           window=None):
    """Decode attention against one layer's dense cache slab.

    x: (B, 1, d); caches: (B, S, Hkv, D); cur_pos: (B,) int32 per-slot
    write position.  Each slot's new K/V row is written IN PLACE at its
    own position (clamped to the slab, as the reference's
    ``dynamic_update_slice`` clamps), then the flash-decode wrapper attends
    over the cache with it: the reference's ``_cache_write``-then-attend
    order.  Returns (out, (k_new, v_new)) like the reference, with the row
    already persisted."""
    B = x.shape[0]
    cur = cur_pos.to(torch.int32)
    q, k, v = attention_qkv(p, cfg, x, cur[:, None])
    b_idx = torch.arange(B, device=x.device)
    row = cur.long().clamp(0, k_cache.shape[1] - 1)
    k_cache[b_idx, row] = k[:, 0].to(k_cache.dtype)
    v_cache[b_idx, row] = v[:, 0].to(v_cache.dtype)
    o = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, cur,
                     window=_window(window))
    return _proj(o.reshape(B, 1, -1), p["wo"]), (k, v)


def current_block(tables, cur, bs: int):
    """(B,) int64: each slot's block holding position ``cur[b]``,
    ``tables[b, cur // bs]`` (clamped to the table)."""
    t = (cur // bs).clamp(0, tables.shape[1] - 1)[:, None].long()
    return tables.gather(1, t)[:, 0].long()


def attention_decode_paged(p, cfg, x, k_pages, v_pages, tables, cur_pos, *,
                           window=None, k_scales=None, v_scales=None,
                           sparse_threshold=0.0):
    """Decode attention against one layer's paged KV pool.

    x: (B, 1, d); pages: (N, bs, Hkv, D); tables: (B, T) int32 block ids
    (null-padded); cur_pos: (B,) int32 per-slot write position.  Returns
    (out, (k_new, v_new)) like the reference.

    ``k_scales``/``v_scales`` ((N, Hkv) f32) mark a packed int8/fp8 pool. A
    positive ``sparse_threshold`` drops whole KV blocks whose estimated
    attention mass falls below it (``block_keep_mask``).  The order of
    operations keeps the reference's results
    (``repro/models/layers.py:356-400``), which attends over the pool as
    the step found it with the exact new row placed in its gathered view:

    1. the keep mask is computed from the pool BEFORE this step's row is
       persisted (with the old scales): writing first would move the
       current block's mean key and could flip blocks;
    2. float pool: the new row is written IN PLACE into the pool — block
       ``tables[b, cur // bs]``, offset ``cur % bs`` — and the kernel reads
       it there, so the row comes back already persisted;
    3. packed pool: the pool is left untouched and the kernel takes the
       exact row as ``k_row``/``v_row``; the CALLER then requantizes each
       slot's current block with the row (``decode_step_paged``).
    """
    B = x.shape[0]
    bs = k_pages.shape[1]
    cur = cur_pos.to(torch.int32)
    w = _window(window)
    q, k, v = attention_qkv(p, cfg, x, cur[:, None])
    qd = q[:, 0].contiguous()
    keep = None
    if sparse_threshold:
        keep = block_keep_mask(qd, k_pages, tables, cur,
                               threshold=sparse_threshold, window=w,
                               k_scales=k_scales)
    if k_scales is not None:
        o = paged_decode_quant(qd, k_pages, v_pages, k_scales, v_scales,
                               tables, cur, window=w, k_row=k[:, 0],
                               v_row=v[:, 0], keep=keep)
    else:
        blk, off = current_block(tables, cur, bs), (cur % bs).long()
        k_pages[blk, off] = k[:, 0].to(k_pages.dtype)
        v_pages[blk, off] = v[:, 0].to(v_pages.dtype)
        if keep is not None:
            o = paged_decode_sparse(qd, k_pages, v_pages, tables, cur,
                                    window=w, keep=keep)
        else:
            o = paged_decode(qd, k_pages, v_pages, tables, cur, window=w)
    return _proj(o.reshape(B, 1, -1), p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model, d_ff, act, dtype, device, n_layers: int):
    """``w1``, ``w2`` and, for SwiGLU (``act == "silu"``), the gate ``w3``;
    any other act is the plain GELU MLP, as in the reference."""
    L = n_layers
    p = {"w1": dense_init(generator, (L, d_model, d_ff), dtype, device),
         "w2": dense_init(generator, (L, d_ff, d_model), dtype, device)}
    if act == "silu":
        p["w3"] = dense_init(generator, (L, d_model, d_ff), dtype, device)
    return p


def mlp_block(p, x, act: str):
    """SwiGLU for ``act == "silu"``, else GELU in its tanh approximation
    (``jax.nn.gelu``'s default, which the reference calls)."""
    if act == "silu":
        h = F.silu(_proj(x, p["w1"])) * _proj(x, p["w3"])
    else:
        h = F.gelu(_proj(x, p["w1"]), approximate="tanh")
    return _proj(h, p["w2"])

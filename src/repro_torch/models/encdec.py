"""Whisper-style encoder-decoder backbone in PyTorch: the port of the
reference's ``repro/models/encdec.py``, function by function.

The audio conv frontend is a stub there and here: the batch carries
precomputed frame embeddings (B, enc_seq, d), the output of Whisper's two
strided convs.  Everything downstream is the reference's: sinusoidal
encoder positions, a bidirectional encoder, a causal decoder with cross
attention, learned decoder positions and a tied output head; LayerNorm
with bias, no rotary.

Parameters are the reference's pytree as nested dicts of layer-stacked
tensors (``enc_blocks`` and ``dec_blocks`` carry a leading layer axis), so
weights cross between the packages by a tree map (``repro_torch.bridge``);
where the reference scans over a stack, the port loops over layers.  Every
projection and the head go through the matmul wrapper, the encoder's and
the teacher-forced decoder's attention through the flash-attention
wrapper (``causal=False`` for the encoder and the cross attention), and a
decode step's self and cross attention through the flash-decode wrapper.

Public entry points
-------------------
sinusoids(length, channels)                   -> np.ndarray (f32)
init_encdec(cfg, generator, device, max_dec_len=0) -> params
encode(params, cfg, enc_embeds)               -> (B, T, d)
forward_encdec(params, cfg, batch)            -> (logits f32, aux 0)
init_encdec_cache(params, cfg, enc_out, max_len) -> cache
decode_step_encdec(params, cfg, token, cache) -> (logits (B, 1, V) f32,
                                                  cache)
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.matmul.ops import matmul

from . import layers as L
from .transformer import _dtype, _head, _layer


def sinusoids(length: int, channels: int) -> np.ndarray:
    """The encoder's (length, channels) position table, f32 (the
    reference's own numpy computation)."""
    assert channels % 2 == 0
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(length: int, channels: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """``sinusoids`` on ``device`` in ``dtype``, made once: a prefill
    captured as a CUDA graph reads it and copies nothing from the host
    (its first, eager run makes it)."""
    return torch.from_numpy(sinusoids(length, channels)).to(device, dtype)


def _ln_init(shape, dt, dev):
    return {"w": torch.ones(shape, dtype=dt, device=dev),
            "b": torch.zeros(shape, dtype=dt, device=dev)}


def _ln(x, p, eps):
    return L.layer_norm(x, p["w"], p["b"], eps)


def init_encdec(cfg, generator: torch.Generator, device=DEFAULT_DEVICE,
                max_dec_len: int = 0):
    """Random parameters from the reference's distributions (normal /
    sqrt(d_in) weights drawn one matrix at a time, 0.02-scaled embedding,
    0.01-scaled decoder positions, zero qkv biases, unit LayerNorms with
    zero bias) with ``generator``, which must live on ``device``.
    ``pos_dec`` has ``max_dec_len`` rows (default ``cfg.max_seq``)."""
    dev = resolve(device)
    dt = _dtype(cfg)
    d, ne, nd = cfg.d_model, cfg.enc_layers, cfg.n_layers
    max_dec = max_dec_len or cfg.max_seq
    embed = L.embed_init(generator, cfg.vocab, d, dt, dev)
    pos_dec = (torch.randn((max_dec, d), generator=generator,
                           dtype=torch.float32, device=dev) * 0.01).to(dt)
    enc = {"ln1": _ln_init((ne, d), dt, dev),
           "attn": L.init_attention(generator, cfg, dt, dev, ne),
           "ln2": _ln_init((ne, d), dt, dev),
           "mlp": L.init_mlp(generator, d, cfg.d_ff, "gelu", dt, dev, ne)}
    dec = {"ln1": _ln_init((nd, d), dt, dev),
           "self_attn": L.init_attention(generator, cfg, dt, dev, nd),
           "ln2": _ln_init((nd, d), dt, dev),
           "cross_attn": L.init_attention(generator, cfg, dt, dev, nd),
           "ln3": _ln_init((nd, d), dt, dev),
           "mlp": L.init_mlp(generator, d, cfg.d_ff, "gelu", dt, dev, nd)}
    return {"embed": embed, "pos_dec": pos_dec, "enc_blocks": enc,
            "dec_blocks": dec, "ln_enc": _ln_init((d,), dt, dev),
            "ln_dec": _ln_init((d,), dt, dev)}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _kv(p, cfg, kv_x):
    """The K and V of ``kv_x`` (B, T, d) -> (B, T, Hkv, D) each."""
    B, T, _ = kv_x.shape
    k = L._proj(kv_x, p["wk"])
    v = L._proj(kv_x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim))


def _mha(p, cfg, q_x, kv_x, *, causal):
    """Attention with q from ``q_x`` and k / v from ``kv_x`` (cross
    attention when they differ) through the flash-attention wrapper.
    Returns (out, (k, v))."""
    B, Sq, _ = q_x.shape
    q = L._proj(q_x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    k, v = _kv(p, cfg, kv_x)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal)
    return L._proj(o.reshape(B, Sq, -1), p["wo"]), (k, v)


def encode(params, cfg, enc_embeds):
    """enc_embeds: (B, T, d) stub frontend output, in the model dtype ->
    (B, T, d): sinusoidal positions, the bidirectional blocks, LayerNorm."""
    dt = enc_embeds.dtype
    pos = _sinusoid_table(enc_embeds.shape[1], cfg.d_model,
                          enc_embeds.device, dt)
    x = enc_embeds + pos[None]
    for li in range(cfg.enc_layers):
        bp = _layer(params["enc_blocks"], li)
        h = _ln(x, bp["ln1"], cfg.norm_eps)
        x = x + _mha(bp["attn"], cfg, h, h, causal=False)[0]
        h = _ln(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_block(bp["mlp"], h, "gelu")
    return _ln(x, params["ln_enc"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder (teacher-forced full sequence)
# ---------------------------------------------------------------------------


def forward_encdec(params, cfg, batch):
    """batch: ``enc_embeds`` (B, T, d), ``tokens`` (B, S).  Returns (logits
    (B, S, V) f32, aux 0): the teacher-forced decoder, causal self
    attention and bidirectional cross attention to the encoder."""
    enc_out = encode(params, cfg, batch["enc_embeds"].to(_dtype(cfg)))
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    x = params["embed"][tokens] + params["pos_dec"][None, :S]
    for li in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], li)
        h = _ln(x, bp["ln1"], cfg.norm_eps)
        x = x + _mha(bp["self_attn"], cfg, h, h, causal=True)[0]
        h = _ln(x, bp["ln2"], cfg.norm_eps)
        x = x + _mha(bp["cross_attn"], cfg, h, enc_out, causal=False)[0]
        h = _ln(x, bp["ln3"], cfg.norm_eps)
        x = x + L.mlp_block(bp["mlp"], h, "gelu")
    x = _ln(x, params["ln_dec"], cfg.norm_eps)
    logits = matmul(x.reshape(B * S, -1).contiguous(), _head(params, cfg))
    return logits.float().reshape(B, S, -1), torch.zeros(
        (), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode with the self KV cache and the precomputed cross K/V
# ---------------------------------------------------------------------------


def init_encdec_cache(params, cfg, enc_out, max_len):
    """The decode cache of one wave: each layer's cross-attention K/V of
    ``enc_out`` (biases included), ``xk`` / ``xv`` (L, B, T, Hkv, D); a
    zero self cache ``k`` / ``v`` (L, B, max_len, Hkv, D); ``len``, the
    step position, a 0-dim int32 0; and ``xpos``, the cross attention's
    read position T - 1 as a 0-dim int32 device tensor, so that a decode
    step captured as a CUDA graph reads it rather than copying a host int
    (the reference passes ``xk.shape[1] - 1`` at each step)."""
    B, T, _ = enc_out.shape
    dt, dev = enc_out.dtype, enc_out.device
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    xk, xv = zip(*(_kv(_layer(params["dec_blocks"], li)["cross_attn"], cfg,
                       enc_out) for li in range(cfg.n_layers)))
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "xk": torch.stack(xk), "xv": torch.stack(xv),
            "len": torch.zeros((), dtype=torch.int32, device=dev),
            "xpos": torch.full((), T - 1, dtype=torch.int32, device=dev)}


def decode_step_encdec(params, cfg, token, cache):
    """One decode step.  token: (B, 1) int.  cache: ``init_encdec_cache``'s;
    ``len`` is the step position, 0-dim (the reference's scalar) or a (B,)
    int32 vector of one value (the serving engine's static buffer).  Each
    layer writes the new self K/V row at the position IN PLACE (where the
    reference donates the cache to its jitted step), attends over the self
    cache up to it and over the whole cross K/V (``xpos``), both through
    the flash-decode wrapper.  Returns (logits (B, 1, V) f32, new cache
    dict holding the same tensors) with ``len`` advanced by one."""
    x = params["embed"][token.long()]                      # (B, 1, d)
    B = x.shape[0]
    pos = torch.as_tensor(cache["len"], dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    # the row at the position, clamped to the table as the reference's
    # dynamic_slice clamps
    row = pos.long().clamp(0, params["pos_dec"].shape[0] - 1)
    x = x + params["pos_dec"].index_select(0, row)[:, None]
    hd = cfg.head_dim
    xpos = cache["xpos"]
    for li in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], li)
        h = _ln(x, bp["ln1"], cfg.norm_eps)
        a, _ = L.attention_decode_slice(bp["self_attn"], cfg, h,
                                        cache["k"][li], cache["v"][li], pos)
        x = x + a
        h = _ln(x, bp["ln2"], cfg.norm_eps)
        cp = bp["cross_attn"]
        q = L._proj(h, cp["wq"])
        if cfg.qkv_bias:
            q = q + cp["bq"]
        o = flash_decode(q.reshape(B, cfg.n_heads, hd).contiguous(),
                         cache["xk"][li], cache["xv"][li], xpos)
        x = x + L._proj(o.reshape(B, 1, -1), cp["wo"])
        h = _ln(x, bp["ln3"], cfg.norm_eps)
        x = x + L.mlp_block(bp["mlp"], h, "gelu")
    x = _ln(x, params["ln_dec"], cfg.norm_eps)
    logits = matmul(x.reshape(B, -1), _head(params, cfg)).float()
    new = dict(cache)
    new["len"] = torch.as_tensor(cache["len"], device=x.device) + 1
    return logits.reshape(B, 1, -1), new

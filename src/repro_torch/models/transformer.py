"""Decoder-only LM in PyTorch: the dense, MoE, VLM, SSM and hybrid
families of the reference's ``repro/models/transformer.py``.

Parameters are the reference's pytree as nested dicts of layer-stacked
tensors (per-layer parameters carry a leading ``L`` axis), with the same
keys and shapes as ``repro.models.transformer.init_lm``, so weights cross
between the packages by a tree map (``repro_torch.bridge``).  Where the
reference scans over the stack, the port runs a Python loop over layers.
A block holds attention (every family but SSM), the Mamba-2 SSD
(``models/ssm.py``: SSM and hybrid; a hybrid block runs both on the same
normed input and takes their mean) and an MLP or MoE FFN (neither for
SSM).  The SSM state and conv window are per-slot cache tensors beside
the KV cache or pool, updated in place each decode step.

Training runs the full sequence once: ``forward_hidden`` loops over the
layers of a stack unbound once per call (``unbind(0)``, whose backward
stacks each parameter's gradient once), each block under
``torch.utils.checkpoint`` when ``cfg.remat == "full"`` (the reference's
``jax.checkpoint``), and ``loss_fn`` takes the cross entropy chunk by chunk
(``chunked_ce``).  Gradients reach the matmul and flash-attention kernels
through their wrappers' autograd Functions.

Public entry points
-------------------
init_lm(cfg, generator, device)                -> params
forward_lm(params, cfg, batch)                 -> (logits f32, aux)
loss_fn(params, cfg, batch)                    -> (loss, metrics)
init_cache(cfg, batch, max_len, device=...)    -> dense cache dict
prefill(params, cfg, batch, max_len, lens)     -> (logits_last, cache)
decode_step(params, cfg, token, cache)         -> (logits, cache)
decode_step_paged(params, cfg, token, pcache, sparse_threshold=0.0)
                                               -> (logits, pcache)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.serving.kv_pool import (dequantize_kv, kv_dtype_name,
                                         quantize_kv)

from . import layers as L
from . import moe as MOE
from . import ssm as SSM


def has_attn(cfg) -> bool:
    return cfg.family != "ssm"


def has_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def has_mlp(cfg) -> bool:
    return cfg.family not in ("ssm",) and cfg.n_experts == 0


def layer_windows(cfg) -> np.ndarray:
    """(L,) int32; 0 => full attention, >0 => sliding window."""
    w = np.zeros((cfg.n_layers,), np.int32)
    if cfg.attn_window > 0:
        w[:] = cfg.attn_window
        for i in cfg.global_layers:
            w[i % cfg.n_layers] = 0
    return w


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(
            f"model family {cfg.family!r} is not a decoder-only LM: "
            "enc-dec runs through models/encdec.py (models.api.build picks "
            "it), and no other family exists")


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _head(params, cfg):
    return params["embed"].T.contiguous() if cfg.tie_embeddings \
        else params["lm_head"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_lm(cfg, generator: torch.Generator, device=DEFAULT_DEVICE):
    """Random parameters drawn from the reference's distributions
    (normal / sqrt(d_in) weights, 0.02-scaled embeddings and meta tokens,
    zero qkv biases, unit norms; the SSM's in ``models/ssm.py``) with
    ``generator``, which must live on ``device``."""
    _check_family(cfg)
    dev = resolve(device, shapes=True)
    dt = _dtype(cfg)
    d, n = cfg.d_model, cfg.n_layers
    blocks = {"ln1": torch.ones((n, d), dtype=dt, device=dev)}
    if has_attn(cfg):
        blocks["attn"] = L.init_attention(generator, cfg, dt, dev, n)
    if has_ssm(cfg):
        blocks["ssm"] = SSM.init_ssm(generator, cfg, dt, dev, n)
    if cfg.n_experts:
        blocks["ln2"] = torch.ones((n, d), dtype=dt, device=dev)
        blocks["moe"] = MOE.init_moe(generator, cfg, dt, dev, n)
    elif has_mlp(cfg) and cfg.d_ff > 0:
        blocks["ln2"] = torch.ones((n, d), dtype=dt, device=dev)
        blocks["mlp"] = L.init_mlp(generator, d, cfg.d_ff, cfg.act, dt, dev, n)
    params = {
        "embed": L.embed_init(generator, cfg.vocab, d, dt, dev),
        "blocks": blocks,
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (d, cfg.vocab), dt, dev)
    if cfg.n_meta_tokens:
        params["meta"] = (torch.randn((cfg.n_meta_tokens, d),
                                      generator=generator,
                                      dtype=torch.float32, device=dev)
                          * 0.02).to(dt)
    return params


# ---------------------------------------------------------------------------
# full-sequence forward and the loss (training)
# ---------------------------------------------------------------------------


def unbind_layers(tree):
    """A layer-stacked parameter tree -> a list of per-layer trees, by one
    ``unbind(0)`` per tensor (indexing ``v[i]`` layer by layer would give
    each index its own full-size zero gradient of the stack)."""
    flat = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v.unbind(0)

    walk(tree, ())
    n = len(next(iter(flat.values())))
    layers = []
    for i in range(n):
        layer = {}
        for path, parts in flat.items():
            node = layer
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = parts[i]
        layers.append(layer)
    return layers


def apply_block(bp, cfg, x, window: int, positions):
    """One block on a full sequence.  Returns (x, aux): the MoE FFN's load
    balance loss, 0 for every other block."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    a_out = s_out = None
    if has_attn(cfg):
        a_out, _ = L.attention_block(bp["attn"], cfg, h, window=window,
                                     positions=positions)
    if has_ssm(cfg):
        s_out, _ = SSM.ssm_block(bp["ssm"], cfg, h)
    x = x + _mix(a_out, s_out)
    if "moe" in bp:
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        m_out, aux = MOE.moe_block(bp["moe"], cfg, h)
        x = x + m_out
    elif "mlp" in bp:
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_block(bp["mlp"], h, cfg.act)
    return x, aux


def _remat(cfg, fn):
    """``cfg.remat``: "full" recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``; the
    forward kernels run twice), "none" keeps its activations.  The
    reference's "dots" is a JAX checkpoint policy (save the matmul outputs)
    that no config uses and PyTorch has no counterpart of: it raises."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        raise ValueError(
            "remat='dots' is JAX's dots_with_no_batch_dims_saveable policy; "
            "the port has no counterpart (no config uses it): use 'full' or "
            "'none'")
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def forward_hidden(params, cfg, batch):
    """Full-sequence forward up to the final norm.  ``batch``: ``tokens``
    (B, S_text) and, for a VLM, ``img_embeds``.  Returns (hidden (B, S_text,
    d), aux averaged over the layers)."""
    _check_family(cfg)
    x, n_prefix = _embed_input(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    windows = layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(bp, x, li):
        return apply_block(bp, cfg, x, int(windows[li]), positions)

    run = _remat(cfg, body)
    for li, bp in enumerate(unbind_layers(params["blocks"])[:cfg.n_layers]):
        x, a = run(bp, x, li)
        aux = aux + a
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    return x, aux / cfg.n_layers


def forward_lm(params, cfg, batch):
    """Full-sequence forward.  Returns (logits (B, S_text, V) f32, aux)."""
    x, aux = forward_hidden(params, cfg, batch)
    B, S, d = x.shape
    logits = matmul(x.reshape(B * S, d).contiguous(), _head(params, cfg))
    return logits.float().reshape(B, S, -1), aux


def _ce_chunk(xc, head, lc, mc):
    """One chunk's summed masked cross entropy: xc (B, c, d)."""
    B, c, d = xc.shape
    logits = matmul(xc.reshape(B * c, d).contiguous(), head).float()
    logits = logits.reshape(B, c, -1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((logz - gold) * mc).sum()


def chunked_ce(x, head, labels, mask, chunk: int = 512):
    """Cross entropy without materializing (B, S, V) logits: the sequence
    in chunks of c = min(chunk, S), lowered until it divides S, each
    chunk's logits recomputed in the backward (the reference's checkpointed
    scan body), the chunk sums added in order.  Returns the f32 sum."""
    B, S, d = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_ce_chunk, x[:, sl], head, labels[:, sl],
                                   mask[:, sl], use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def loss_fn(params, cfg, batch, *, loss_chunk: int = 256):
    """Causal-LM cross entropy (+ the MoE aux term).  ``batch``: tokens,
    labels[, mask].  Returns (total, {"loss", "aux"})."""
    x, aux = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll = chunked_ce(x, _head(params, cfg), labels, mask, loss_chunk)
    loss = nll / torch.clamp(mask.sum(), min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# KV cache, prefill, paged decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_len, dtype=None, *, device=DEFAULT_DEVICE):
    """Dense cache stacked over layers, with a per-slot (B,) ``len``: K/V
    (L, B, max_len, Hkv, D) for attention, and for the SSM the per-slot
    ``ssm_state`` (L, B, H, P, N) and ``ssm_conv`` (L, B, ssm_conv - 1,
    conv_dim); ``max_len`` counts any prefix positions."""
    _check_family(cfg)
    dev = resolve(device, shapes=True)
    dt = dtype or _dtype(cfg)
    c = {"len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if has_attn(cfg):
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=dt, device=dev)
        c["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if has_ssm(cfg):
        _, conv_dim = SSM.ssm_dims(cfg)
        c["ssm_state"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=dt, device=dev)
        c["ssm_conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dt,
            device=dev)
    return c


def _ffn_residual(bp, cfg, x):
    """The block's second residual: the MoE FFN on every row (a ragged
    wave's pad positions and a decode step's idle slots are routed too, and
    take capacity, as in the reference), or the dense MLP."""
    if "moe" in bp:
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + MOE.moe_block(bp["moe"], cfg, h, aux=False)[0]
    if "mlp" in bp:
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + L.mlp_block(bp["mlp"], h, cfg.act)
    return x


def _embed_input(params, cfg, batch):
    """The input embedding sequence, prefixes included: a VLM's
    ``batch["img_embeds"]`` (B, n_img_tokens, d) goes before the text and
    the learned meta tokens ``params["meta"]`` (n_meta_tokens, d) before
    everything.  Returns (x (B, S_total, d), n_prefix)."""
    x = params["embed"][batch["tokens"].long()]
    n_prefix = 0
    if cfg.n_img_tokens:
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
        n_prefix += cfg.n_img_tokens
    if cfg.n_meta_tokens:
        meta = params["meta"][None].expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
        n_prefix += cfg.n_meta_tokens
    return x, n_prefix


def _mix(attn_out, ssm_out):
    """The token mixers' sum into the residual: one path alone, or a
    hybrid's mean of its parallel attention and SSM paths in the model
    dtype."""
    if ssm_out is None:
        return attn_out
    if attn_out is None:
        return ssm_out
    return (attn_out + ssm_out) * 0.5


def prefill(params, cfg, batch, max_len=None, lens=None):
    """Run the prompt through the model, building a dense decode cache.

    ``batch["tokens"]``: (B, S) integer tensor; a VLM's batch adds
    ``img_embeds`` (B, n_img_tokens, d), the prefix before the text (a
    hybrid's meta tokens come from the weights and go before both), and
    positions run over the whole sequence.  ``lens`` (optional, (B,)
    int): per-slot valid text-token counts for a ragged wave — prompts
    shorter than the padded width take their logits at their own final
    token (causal masking hides the pad after a slot's length), and the
    cache ``len`` vector records each slot's true context, prefix
    included.  An SSM's state integrates the pad as well, as in the
    reference, so the serving engine prefills those families one prompt
    length at a time.  Returns (last-position logits (B, V) f32, cache
    with k/v (L, B, max_len, Hkv, D) and, for the SSM, each layer's final
    ``ssm_state`` and ``ssm_conv`` tail).
    """
    _check_family(cfg)
    x, n_prefix = _embed_input(params, cfg, batch)
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len={max_len} is shorter than the prompt "
                         f"width {S}")
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    windows = layer_windows(cfg)
    outs = {key: [] for key in ("k", "v", "ssm_state", "ssm_conv")}
    for li in range(cfg.n_layers):
        bp = _layer(params["blocks"], li)
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        a_out = s_out = None
        if has_attn(cfg):
            a_out, (k, v) = L.attention_block(bp["attn"], cfg, h,
                                              window=int(windows[li]),
                                              positions=positions)
            pad = (0, 0, 0, 0, 0, max_len - S)
            outs["k"].append(F.pad(k, pad))
            outs["v"].append(F.pad(v, pad))
        if has_ssm(cfg):
            s_out, st = SSM.ssm_block(bp["ssm"], cfg, h)
            outs["ssm_state"].append(st["state"])
            outs["ssm_conv"].append(st["conv"])
        x = _ffn_residual(bp, cfg, x + _mix(a_out, s_out))
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = _head(params, cfg)
    if lens is None:
        last = x[:, -1]
        len_vec = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        lens = torch.as_tensor(lens, dtype=torch.int32, device=x.device)
        idx = (n_prefix + lens - 1).clamp(0, S - 1).long()
        last = x[torch.arange(B, device=x.device), idx]
        len_vec = n_prefix + lens
    logits = matmul(last.contiguous(), head).float()
    dt = _dtype(cfg)
    cache = {"len": len_vec}
    cache.update({key: torch.stack(ts).to(dt) for key, ts in outs.items()
                  if ts})
    return logits, cache


def _logits(params, cfg, x):
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    B = x.shape[0]
    logits = matmul(x.reshape(B, -1), _head(params, cfg)).float()
    return logits.reshape(B, 1, -1)


def decode_step(params, cfg, token, cache):
    """One decode step against the dense cache slab.

    token: (B, 1) int.  cache: ``k``/``v`` (L, B, S, Hkv, D), for the SSM
    ``ssm_state``/``ssm_conv``, and ``len`` — a scalar (one shared
    position) or a (B,) vector of per-slot write positions.  Same math as
    the reference's ``decode_step``: each layer writes every slot's new row
    at its own position, then attends through the flash-decode wrapper;
    the SSM advances every slot's state by one token, idle slots
    included.  The cache tensors are updated IN PLACE (where the reference
    donates them to its jitted step).  Returns (logits (B, 1, V) f32, new
    cache dict holding the same tensors) with ``len`` advanced by one.
    """
    _check_family(cfg)
    x = params["embed"][token.long()]                 # (B, 1, d)
    B = x.shape[0]
    pos = torch.as_tensor(cache["len"], dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    windows = layer_windows(cfg)
    for li in range(cfg.n_layers):
        bp = _layer(params["blocks"], li)
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        a_out = None
        if has_attn(cfg):
            a_out, _ = L.attention_decode_slice(
                bp["attn"], cfg, h, cache["k"][li], cache["v"][li], pos,
                window=int(windows[li]))
        x = _ffn_residual(bp, cfg, x + _mix(a_out, _ssm_step(
            bp, cfg, h, cache, li)))
    new_cache = dict(cache)
    new_cache["len"] = torch.as_tensor(cache["len"], device=x.device) + 1
    return _logits(params, cfg, x), new_cache


def decode_step_paged(params, cfg, token, pcache, *, sparse_threshold=0.0):
    """One decode step against a paged (block-table) KV pool.

    token: (B, 1) int.  pcache:
      k_pages/v_pages : (L, N, bs, Hkv, D) shared block pool
      tables          : (B, T) int32 per-slot block chains (null-padded)
      lens            : (B,) int32 per-slot write positions
      k_scales/v_scales (packed pools): (L, N, Hkv) f32 per-(block,
        kv-head) scales; their presence marks packed int8/fp8 pages
      ssm_state/ssm_conv (families with SSM): per-slot, as in the dense
        cache, updated in place like the pool (an SSM-only model has no
        pages)
    Same math as the reference's ``decode_step_paged``.  The pool is
    updated IN PLACE (this stands where the reference has
    ``donate_argnums`` on the jitted step: the caller's pool tensors are
    the step's output).  On a float pool each layer writes the slots' new
    K/V rows before attending; on a packed pool each layer attends first
    (with the exact new row) and then runs the reference's read-modify-
    write: each slot's current block is dequantized, the new row set, and
    the whole block requantized with a fresh scale
    (``repro/models/transformer.py:396-408``).  A positive
    ``sparse_threshold`` makes attention skip low-mass KV blocks.  Returns
    (logits (B, 1, V) f32, new pcache dict holding the same pool tensors)
    with every ``lens`` advanced by one (the engine overrides lengths for
    inactive slots from host bookkeeping).
    """
    _check_family(cfg)
    x = params["embed"][token.long()]                 # (B, 1, d)
    B = x.shape[0]
    pos = pcache["lens"].to(torch.int32)
    tables = pcache["tables"].to(torch.int32).contiguous()
    kp_all, vp_all = pcache.get("k_pages"), pcache.get("v_pages")
    quant = "k_scales" in pcache
    if quant:
        ks_all, vs_all = pcache["k_scales"], pcache["v_scales"]
        kv_name = kv_dtype_name(kp_all)
        bs = kp_all.shape[2]
        blk = L.current_block(tables, pos, bs)
        row, off = torch.arange(B, device=x.device), (pos % bs).long()
    windows = layer_windows(cfg)
    for li in range(cfg.n_layers):
        bp = _layer(params["blocks"], li)
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        a_out = None
        if has_attn(cfg):
            ks = vs = None
            if quant:
                ks, vs = ks_all[li], vs_all[li]
            a_out, (k_new, v_new) = L.attention_decode_paged(
                bp["attn"], cfg, h, kp_all[li], vp_all[li], tables, pos,
                window=int(windows[li]), k_scales=ks, v_scales=vs,
                sparse_threshold=sparse_threshold)
            if quant:
                for pages, scales, new in ((kp_all[li], ks, k_new),
                                           (vp_all[li], vs, v_new)):
                    _requant_rows(pages, scales, blk, row, off, new[:, 0],
                                  kv_name)
        x = _ffn_residual(bp, cfg, x + _mix(a_out, _ssm_step(
            bp, cfg, h, pcache, li)))
    new_pcache = dict(pcache)
    new_pcache["lens"] = pos + 1
    return _logits(params, cfg, x), new_pcache


def _ssm_step(bp, cfg, h, cache, li: int):
    """Layer ``li``'s SSM decode on every slot, writing the new state and
    conv window IN PLACE into ``cache["ssm_state"][li]`` and
    ``cache["ssm_conv"][li]`` (a captured step reads their addresses);
    the layer's SSM output, or None for a family without one."""
    if not has_ssm(cfg):
        return None
    st, cv = cache["ssm_state"][li], cache["ssm_conv"][li]
    out, new = SSM.ssm_decode(bp["ssm"], cfg, h, {"state": st, "conv": cv})
    st.copy_(new["state"])
    cv.copy_(new["conv"])
    return out


def _requant_rows(pages, scales, blk, row, off, new, kv_name) -> None:
    """Read-modify-write of each slot's current block of one packed pool
    layer, in place: dequantize ``pages[blk]`` (B, bs, Hkv, D), set row
    ``off`` to ``new`` (B, Hkv, D), requantize with a fresh per-head
    scale.  Inactive slots all land in null block 0, which no live slot
    reads."""
    byte_pages = pages.view(torch.uint8)
    f = dequantize_kv(byte_pages[blk].view(pages.dtype), scales[blk])
    f[row, off] = new.float()
    q, sc = quantize_kv(f, kv_name)
    byte_pages[blk] = q.view(torch.uint8)
    scales[blk] = sc

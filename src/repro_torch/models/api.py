"""Model API over the ported families: the decoder-only LMs (dense, MoE,
VLM, SSM and hybrid) and the enc-dec family (whisper).

``build(cfg, device)`` returns a ``ModelAPI`` bound to one device:
  init(generator)                        -> params
  loss(params, batch)                    -> (loss, metrics)   (training)
  forward(params, batch)                 -> (logits f32, aux)
  prefill_batch(tokens)                  -> prefill batch of a (B, S)
                                            token tensor
  prefill(params, batch, max_len, lens)  -> (logits, cache)
  decode(params, token, cache)           -> (logits, cache)   (dense slab)
  decode_paged(params, token, pcache, sparse_threshold=0.0)
                                         -> (logits, pcache)
  init_cache(batch, max_len)             -> dense cache dict (the SSM's
                                            per-slot state and conv
                                            window included)

The port's counterpart of ``repro.models.api._build_lm`` and
``_build_encdec``.  An enc-dec api's ``prefill_batch(frames)`` carries the
stubbed frontend's frame embeddings (B, enc_seq, d), its ``prefill``
returns ``(None, cache)`` (the encoder and each layer's cross K/V), ``decode_paged`` is None
and ``init_cache`` returns None (the cache is built from the frames), as
in the reference.  ``loss`` and ``forward`` take a training batch of
tensors (``tokens``, ``labels``, a VLM's ``img_embeds``, an enc-dec's
``enc_embeds``).

  input_specs(shape)                     -> {name: meta tensor} of a
                                            shape cell's batch
  cache_specs(shape)                     -> the cell's decode cache as
                                            meta tensors

The shape helpers return tensors on ``"meta"`` (shape and dtype, no
storage) with the reference's shapes and dtypes
(``repro/models/api.py:90-111, 145-170``), whatever device the api is
bound to; ``build(cfg, "meta")`` gives an api whose ``init`` draws
nothing, for the dry run and the sharding rules at full width.  A cell's
``seq_len`` is the TOTAL context: a VLM's image rows and a hybrid's meta
tokens come out of it, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve

from . import encdec as ED
from . import transformer as TF


@dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss: Callable
    forward: Callable
    prefill_batch: Callable
    prefill: Callable
    decode: Callable
    decode_paged: Callable
    init_cache: Callable
    input_specs: Callable
    cache_specs: Callable


def build(cfg: ModelConfig, device=DEFAULT_DEVICE) -> ModelAPI:
    """The api of ``cfg`` on ``device`` (``"meta"`` when named: shapes
    only)."""
    if cfg.family == "encdec":
        return _build_encdec(cfg, resolve(device, shapes=True))
    return _build_lm(cfg, resolve(device, shapes=True))


META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    s = seq_len
    if cfg.n_img_tokens:
        s -= cfg.n_img_tokens
    if cfg.n_meta_tokens:
        s -= cfg.n_meta_tokens
    return max(s, 1)


def _build_lm(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    TF._check_family(cfg)

    def init(generator: torch.Generator):
        return TF.init_lm(cfg, generator, device)

    def loss(params, batch):
        return TF.loss_fn(params, cfg, batch)

    def forward(params, batch):
        return TF.forward_lm(params, cfg, batch)

    def prefill_batch(tokens):
        """``{"tokens": tokens}``, and for a VLM the serving engine's
        stand-in for the stubbed vision frontend, zero patch embeddings
        (B, n_img_tokens, d) f32 (``repro/serving/engine.py:716-718``)."""
        batch = {"tokens": tokens}
        if cfg.n_img_tokens:
            batch["img_embeds"] = torch.zeros(
                (tokens.shape[0], cfg.n_img_tokens, cfg.d_model),
                dtype=torch.float32, device=tokens.device)
        return batch

    def prefill(params, batch, max_len=None, lens=None):
        return TF.prefill(params, cfg, batch, max_len, lens=lens)

    def decode(params, token, cache):
        return TF.decode_step(params, cfg, token, cache)

    def decode_paged(params, token, pcache, *, sparse_threshold=0.0):
        return TF.decode_step_paged(params, cfg, token, pcache,
                                    sparse_threshold=sparse_threshold)

    def init_cache(batch, max_len):
        return TF.init_cache(cfg, batch, max_len, device=device)

    def input_specs(shape):
        B = shape.global_batch
        if shape.kind == "decode":
            return {"token": _spec((B, 1), torch.int32)}
        S = _text_len(cfg, shape.seq_len)
        specs = {"tokens": _spec((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        if cfg.n_img_tokens:
            specs["img_embeds"] = _spec((B, cfg.n_img_tokens, cfg.d_model),
                                        getattr(torch, cfg.dtype))
        return specs

    def cache_specs(shape):
        return TF.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=META)

    return ModelAPI(cfg, device, init, loss, forward, prefill_batch,
                    prefill, decode, decode_paged, init_cache, input_specs,
                    cache_specs)


def _build_encdec(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    dt = getattr(torch, cfg.dtype)

    def init(generator: torch.Generator):
        return ED.init_encdec(cfg, generator, device, max_dec_len=cfg.max_seq)

    def loss(params, batch):
        return ED.loss_encdec(params, cfg, batch)

    def forward(params, batch):
        return ED.forward_encdec(params, cfg, batch)

    def prefill_batch(frames):
        """``{"enc_embeds": frames}``: the frames (B, enc_seq, d) f32 stand
        in for the stubbed audio frontend (the serving engine draws them,
        ``repro/serving/engine.py:719-721``); the prompts are not
        consumed."""
        return {"enc_embeds": frames}

    def prefill(params, batch, max_len=None):
        enc_out = ED.encode(params, cfg, batch["enc_embeds"].to(dt))
        cache = ED.init_encdec_cache(params, cfg, enc_out,
                                     max_len or cfg.max_seq)
        return None, cache

    def decode(params, token, cache):
        return ED.decode_step_encdec(params, cfg, token, cache)

    def init_cache(batch, max_len):
        return None     # an enc-dec cache is built from the frames: prefill

    def input_specs(shape):
        B = shape.global_batch
        if shape.kind == "decode":
            return {"token": _spec((B, 1), torch.int32)}
        S = shape.seq_len
        specs = {"enc_embeds": _spec((B, cfg.enc_seq, cfg.d_model), dt),
                 "tokens": _spec((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        return specs

    def cache_specs(shape):
        """The self and cross K/V of every decoder layer and the position,
        as the reference declares them."""
        B, hd, Lc = shape.global_batch, cfg.head_dim, cfg.n_layers
        self_kv = (Lc, B, shape.seq_len, cfg.n_kv_heads, hd)
        cross_kv = (Lc, B, cfg.enc_seq, cfg.n_kv_heads, hd)
        return {"k": _spec(self_kv, dt), "v": _spec(self_kv, dt),
                "xk": _spec(cross_kv, dt), "xv": _spec(cross_kv, dt),
                "len": _spec((), torch.int32)}

    return ModelAPI(cfg, device, init, loss, forward, prefill_batch, prefill,
                    decode, None, init_cache, input_specs, cache_specs)

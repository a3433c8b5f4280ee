"""Model API over the ported families: the decoder-only LMs (dense, MoE,
VLM, SSM and hybrid) and the enc-dec family (whisper).

``build(cfg, device)`` returns a ``ModelAPI`` bound to one device:
  init(generator)                        -> params
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
in the reference.  The loss, forward and the shape-spec helpers wait for
their slices (ROADMAP.md, Queue 1 items 13 and 15).
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
    prefill_batch: Callable
    prefill: Callable
    decode: Callable
    decode_paged: Callable
    init_cache: Callable


def build(cfg: ModelConfig, device=DEFAULT_DEVICE) -> ModelAPI:
    if cfg.family == "encdec":
        return _build_encdec(cfg, resolve(device))
    return _build_lm(cfg, resolve(device))


def _build_lm(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    TF._check_family(cfg)

    def init(generator: torch.Generator):
        return TF.init_lm(cfg, generator, device)

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

    return ModelAPI(cfg, device, init, prefill_batch, prefill, decode,
                    decode_paged, init_cache)


def _build_encdec(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    dt = getattr(torch, cfg.dtype)

    def init(generator: torch.Generator):
        return ED.init_encdec(cfg, generator, device, max_dec_len=cfg.max_seq)

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

    return ModelAPI(cfg, device, init, prefill_batch, prefill, decode, None,
                    init_cache)

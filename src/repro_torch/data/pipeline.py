"""Deterministic, resumable synthetic data (the port of
``repro/data/pipeline.py``, numpy for numpy: the same seed and step give
the same arrays, element for element).

Every batch is a pure function of (seed, step), so the data cursor a
checkpoint keeps is the step counter and a resume is exact.  Batches are
numpy arrays; the train step moves them to its device.
"""
from __future__ import annotations

import numpy as np


def synth_lm_batch(cfg, shape, step: int, seed: int = 0,
                   partitions: int = 1):
    """Zipf tokens with local repetition (so losses fall): ``tokens`` and
    ``labels`` (the tokens shifted by one), int32 (B, S_text), S_text the
    cell's length less any image or meta prefix; a VLM's ``img_embeds`` and
    an enc-dec's ``enc_embeds`` f32.  With ``partitions`` > 1 every array
    gains a leading (partitions,) axis over the batch."""
    B = shape.global_batch
    S_text = shape.seq_len
    if cfg.n_img_tokens:
        S_text -= cfg.n_img_tokens
    if cfg.n_meta_tokens:
        S_text -= cfg.n_meta_tokens
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    ranks = rng.zipf(1.3, size=(B, S_text + 1)).astype(np.int64)
    toks = np.minimum(ranks, cfg.vocab - 1).astype(np.int32)
    rep = rng.random((B, S_text + 1)) < 0.3
    toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    if partitions > 1:
        batch = {k: v.reshape((partitions, B // partitions) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def synth_image_batch(batch: int, img: int, step: int, seed: int = 0):
    """NHWC f32 images and int32 labels in [0, 1000)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(7_919)
                                + np.uint64(step))
    x = rng.standard_normal((batch, img, img, 3), dtype=np.float32)
    y = rng.integers(0, 1000, size=(batch,)).astype(np.int32)
    return {"images": x, "labels": y}

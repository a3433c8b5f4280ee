"""int8 gradient compression with error feedback (EF-SGD style), the port
of ``repro/optim/compression.py``.

Meant for the cross-partition parameter sync of the traffic-shaping
runtime: per-tensor symmetric int8 before the all-reduce, the
quantization residual carried into the next sync's error buffer.  Trees
are nested dicts of tensors; a compressed leaf is an (int8, scale) pair.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


def _pick(tree, i):
    """Item ``i`` of every tuple leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def compress_grads(grads, error):
    """Returns (tree of (int8, scale), new error tree)."""
    def one(g, e):
        x = g.float() + e
        q, s = _quant(x)
        return (q, s), x - _dequant(q, s)

    out = tree_map(one, grads, error)
    return _pick(out, 0), _pick(out, 1)


def decompress_grads(qs, like=None):
    if isinstance(qs, dict):
        return {k: decompress_grads(v) for k, v in qs.items()}
    return _dequant(*qs)

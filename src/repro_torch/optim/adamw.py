"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule
(the port of ``repro/optim/adamw.py``).

Moments are f32 whatever the parameter dtype; the update is computed in
f32 and cast back, the standard mixed-precision recipe.  Unlike the
reference's pure function, ``adamw_update`` writes the new parameters and
moments IN PLACE (under ``torch.no_grad``): at full width a second copy of
the parameters and both moments does not fit one card.  It still returns
``(params, state, metrics)``, holding the same tensors.  The schedule and
the bias corrections are f32 tensors, as the reference's weak-typed f32
scalars are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: dict
    v: dict


def adamw_init(params) -> AdamWState:
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree):
        total = total + (g.float() ** 2).sum()
    return torch.sqrt(total)


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), f32: linear warmup from 0,
    then a cosine from ``peak`` down to ``floor_frac * peak``."""
    step = step.to(torch.float32)
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One step; params and moments updated in place.  Returns
    (params, new_state, {"grad_norm"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = 1 - (one * b1) ** t
    bc2 = 1 - (one * b2) ** t
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        delta.add_(weight_decay * p32)
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}

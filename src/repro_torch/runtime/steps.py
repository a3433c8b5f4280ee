"""Step functions: train, prefill and decode, and the cross-partition
parameter sync (the port of ``repro/runtime/steps.py``).

A train step takes params, an ``AdamWState`` and a batch (numpy arrays or
tensors; moved to the api's device) and returns (params, state, metrics).
Gradients come from ``torch.autograd.grad`` through the model's kernel
wrappers; the optimizer updates the parameters and moments IN PLACE, so
the returned trees hold the caller's tensors (the reference's jitted step
is called with its buffers donated).

``make_partitioned_train_step`` is the reference's ``jax.vmap`` of the
step over partition-stacked (P, ...) params, optimizer state and batch.
``torch.func.vmap`` cannot carry the kernels' ctypes launches or the
in-place AdamW, so a loop over the leading axis computes the vmap's
function: partition i's step runs on views of slice i, which it updates
in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamWState, adamw_update, cosine_lr
from repro_torch.tree import leaves, tree_map, unflatten


def to_device(batch, device):
    """A batch dict of numpy arrays or tensors -> tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(api, *, peak_lr=3e-4, warmup=100, total=10_000,
                    weight_decay=0.1, clip_norm=1.0, accum: int = 1):
    """``accum`` > 1 splits the step's batch into microbatches and sums
    their gradients in f32 (activation memory / ``accum``): each
    microbatch adds ``g.float() / accum`` into an f32 accumulator shaped
    like the params, and ``loss / accum`` into the loss; the metrics are
    the last microbatch's, as the reference's scan leaves them."""

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = leaves(live)
        with torch.enable_grad():
            loss, metrics = api.loss(live, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten(params, grads)

    def train_step(params, opt_state, batch):
        batch = to_device(batch, api.device)
        if accum > 1:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            gacc = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            for i in range(accum):
                (mloss, metrics), g = grads_of(
                    params, {k: v[i] for k, v in micro.items()})
                for a, b in zip(leaves(gacc), leaves(g)):
                    a.add_(b.float() / accum)
                loss = loss + mloss / accum
                del g
            grads = tree_map(lambda g, p: g.to(p.dtype), gacc, params)
            del gacc
        else:
            (loss, metrics), grads = grads_of(params, batch)
        lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup,
                       total=total)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            clip_norm=clip_norm)
        return params, opt_state, {**metrics, **om, "lr": lr, "loss": loss}

    return train_step


def make_prefill_step(api, max_len: int):
    def prefill_step(params, batch):
        return api.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(api):
    def decode_step(params, token, cache):
        return api.decode(params, token, cache)

    return decode_step


# ---------------------------------------------------------------------------
# partitioned (statistical traffic shaping) helpers
# ---------------------------------------------------------------------------


def make_partitioned_train_step(api, stack_axis: str = "part", **kw):
    """The per-partition step over stacked (P, ...) params, ``AdamWState``
    (its ``step`` of shape (P,)) and batch (each leaf (P, B/P, ...)):
    ``make_train_step(api, **kw)`` on partition i's slice of each, for i
    in order.  Params and moments are updated in place (views of the
    stacked tensors); returns (params, state with the stacked new steps,
    metrics stacked along a leading P axis), what the reference's vmap
    returns.  ``stack_axis`` names the mesh axis the stacked dim lies on
    (the reference's ``spmd_axis_name``); one process holds every
    partition here, so it changes nothing."""
    del stack_axis
    base = make_train_step(api, **kw)

    def partitioned_step(params, opt_state, batch):
        batch = to_device(batch, api.device)
        n = opt_state.step.shape[0]
        steps, metrics = [], []
        for i in range(n):
            _, st, m = base(tree_map(lambda x: x[i], params),
                            AdamWState(opt_state.step[i],
                                       tree_map(lambda x: x[i], opt_state.m),
                                       tree_map(lambda x: x[i], opt_state.v)),
                            {k: v[i] for k, v in batch.items()})
            steps.append(st.step)
            metrics.append(m)
        out = {k: torch.stack([torch.as_tensor(m[k]) for m in metrics])
               for k in metrics[0]}
        return params, AdamWState(torch.stack(steps), opt_state.m,
                                  opt_state.v), out

    return partitioned_step


def _mean0(x):
    return x.float().mean(0, keepdim=True).expand(x.shape).to(x.dtype)


def sync_params(stacked_params, stacked_opt=None):
    """Periodic cross-partition parameter averaging over the leading
    partition axis, in f32 (Local-SGD / DiLoCo style); the optimizer
    moments are averaged too, the step counter kept."""
    avg = tree_map(_mean0, stacked_params)
    if stacked_opt is None:
        return avg
    return avg, tree_map(lambda x: _mean0(x) if x.ndim > 0 else x,
                         stacked_opt)


def stack_tree(tree, n: int):
    """Replicate a tree along a new leading partition axis (copies)."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)).clone(),
                    tree)

"""Mixture-of-Experts FFN with capacity-based top-k routing, in PyTorch:
the port of the reference's ``repro/models/moe.py``.

The reference's gather-formulated dispatch, operation for operation:

  tokens (T, d) --f32 router, softmax, top-k--> (T, k) expert ids, gates
  stable sort of the ids -> slot assignment with per-expert capacity C
  buffer (E, C, d) = tokens[buffer_token_idx]           # gather
  expert FFN on the buffer (batched products over E)
  out (T, d) = sum_k gate * buffer_out[inv_slot]        # gather + weighted sum

and the Switch auxiliary load-balance loss, E * sum_e f_e * p_e.  Every
expert computes its C buffer rows whether or not a token was routed to it
(an empty row is a zero row and yields zero), so a decode step reads every
expert's weights, as the reference's dense einsum over E does.

Two things differ from a literal copy, neither in the result:

* The reference fills ``buffer_token_idx`` with one scatter whose clipped
  indices collide: every token past an expert's capacity writes the
  sentinel T to slot ``e*C + C-1``, the slot of the token kept at position
  C-1.  On the CPU the last write wins, so an expert that overflows
  computes only C-1 rows and the token at C-1 gets nothing from it
  (``moe.py:101-107``); on a card the order of colliding writes is not
  fixed.  The port builds the same table by a gather, no index written
  twice: slot c of expert e holds the token of its c-th sorted entry when
  c < held_e, else T, with held_e = C-1 for an expert over capacity (the
  CPU reference's result, on any device) and its load otherwise.
* The dispatch reads nothing back to the host (no ``.item()``, ``nonzero``
  or boolean-mask indexing; C follows from the token count, a shape), so
  a decode step or a prefill that routes can be captured as a CUDA graph.

The router stays f32, weight and product, with TF32 off on the card as on
the CPU: a top-k choice flips on a difference in the last bits.  The expert
products are ``torch.bmm`` (the reference computes them with XLA, outside
any Pallas kernel); the shared experts go through the matmul kernel's
wrapper, as the dense MLP does.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from .layers import _proj, dense_init


def capacity(n_tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(-(-top_k * n_tokens * cf // n_experts))  # ceil
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def init_moe(generator, cfg, dtype, device, n_layers: int):
    """Layer-stacked MoE parameters (leading axis ``n_layers``): the f32
    router (L, d, E), experts w1 / w3 (L, E, d, f) and w2 (L, E, f, d) in
    ``dtype``, each (layer, expert) matrix its own draw, and the shared
    experts ws1 / ws3 (L, d, f * n_shared), ws2 (L, f * n_shared, d)."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.n_experts, n_layers
    p = {"router": dense_init(generator, (L, d, e), torch.float32, device),
         "w1": dense_init(generator, (L, e, d, f), dtype, device),
         "w2": dense_init(generator, (L, e, f, d), dtype, device),
         "w3": dense_init(generator, (L, e, d, f), dtype, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["ws1"] = dense_init(generator, (L, d, fs), dtype, device)
        p["ws3"] = dense_init(generator, (L, d, fs), dtype, device)
        p["ws2"] = dense_init(generator, (L, fs, d), dtype, device)
    return p


@contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(p, cfg, xf):
    """The router on tokens ``xf`` (T, d): (probs (T, E) f32, gate (T, K)
    renormalised, eid (T, K) int64), the K largest probabilities in
    descending order."""
    with _no_tf32():
        logits = torch.matmul(xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, eid


def expert_ffn(buf, w1, w2, w3):
    """SwiGLU of every expert on its buffer rows: buf (E, C, d) ->
    (E, C, d)."""
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def moe_block(p, cfg, x, group_tokens: int = 32768, *, aux: bool = True):
    """x: (B, S, d) -> (out (B, S, d), aux f32 scalar, or None without
    ``aux``).

    GShard-style grouping as in the reference: tokens are processed in
    sequential groups of ~``group_tokens`` (capacity applies per group);
    one group is the classic dropping MoE.  Serving passes ``aux=False``
    (the reference's jitted steps drop the unused loss)."""
    B, S, d = x.shape
    T = B * S
    n_groups = max(1, -(-T // group_tokens))
    while T % n_groups:
        n_groups += 1
    outs, total = [], None
    for xg in x.reshape(n_groups, T // n_groups, d):
        out, a = _moe_group(p, cfg, xg, aux)
        outs.append(out)
        total = a if total is None else total + a
    out = torch.stack(outs).reshape(B, S, d)
    return out, (total / n_groups if aux else None)


def _moe_group(p, cfg, xf, want_aux: bool):
    """One capacity group. xf: (T, d) -> (out (T, d), aux or None)."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, E, K, cfg.capacity_factor)
    probs, gate, eid = route(p, cfg, xf)
    inv_slot, buf_tok = dispatch(eid, E, C)

    # ---- dispatch (gather), expert FFN, combine (gather back) ----
    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    y = expert_ffn(x_pad[buf_tok].reshape(E, C, d), p["w1"], p["w2"],
                   p["w3"])
    y_pad = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
    yk = y_pad[inv_slot].reshape(T, K, d)
    out = (yk.float() * gate.float()[..., None]).sum(1).to(xf.dtype)

    if cfg.n_shared_experts:
        hs = F.silu(_proj(xf, p["ws1"])) * _proj(xf, p["ws3"])
        out = out + _proj(hs, p["ws2"]).to(out.dtype)
    if not want_aux:
        return out, None

    # ---- aux load-balance loss (Switch) ----
    me = probs.mean(dim=0)                          # avg router prob
    fe = F.one_hot(eid[:, 0], E).float().mean(dim=0)  # routed share, top-1
    return out, E * torch.sum(me * fe)


def dispatch(eid, E: int, C: int):
    """The slot tables of one group from its expert ids eid (T, K):
    inv_slot (T*K,), each token copy's buffer slot (sentinel E*C: dropped),
    and buf_tok (E*C,), each buffer slot's source token (sentinel T: a zero
    row)."""
    T, K = eid.shape
    dev = eid.device
    e_flat = eid.reshape(-1)                            # (T*K,)
    order = torch.argsort(e_flat, stable=True)          # grouped by expert
    e_sorted = e_flat[order]
    experts = torch.arange(E, dtype=e_sorted.dtype, device=dev)
    start = torch.searchsorted(e_sorted, experts)       # (E,)
    load = torch.searchsorted(e_sorted, experts, right=True) - start
    pos = torch.arange(T * K, device=dev) - start[e_sorted]
    slot = e_sorted * C + pos.clamp(0, C - 1)
    # token copy -> buffer slot (sentinel E*C => zero row); ``order`` is a
    # permutation, so no index is written twice
    inv_slot = torch.empty_like(order)
    inv_slot[order] = torch.where(pos < C, slot, E * C)
    # buffer slot -> source token (sentinel T => zero row), the table the
    # CPU reference's colliding scatter leaves (module docstring)
    c = torch.arange(C, device=dev)
    held = torch.where(load > C, C - 1, load)
    src = order[(start[:, None] + c).clamp(max=T * K - 1)] // K
    buf_tok = torch.where(c < held[:, None], src, T).reshape(-1)
    return inv_slot, buf_tok

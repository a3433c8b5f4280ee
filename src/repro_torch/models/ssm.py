"""Mamba-2 (SSD, state-space duality) block in PyTorch: the port of the
reference's ``repro/models/ssm.py``, function by function.

The chunked SSD of arXiv:2405.21060: within a chunk of Q positions an
attention-like term with a decay mask; across chunks a recurrence over the
per-chunk states, here a Python loop over the chunks (the reference's
``lax.scan``).  The two projections go through the matmul kernel's wrapper
(the reference computes them as ``x @ W``); the SSD's batched einsums, the
depthwise causal conv and the recurrence are plain torch ops, as in the
reference, where XLA computes them outside any Pallas kernel.  Nothing
reads back to the host, so a decode step or a prefill holding these
blocks can be captured as a CUDA graph.

Parameters are layer-stacked (leading axis ``n_layers``) under the
reference's keys and shapes; ``dt_bias``, ``A_log`` and ``D`` are float32
in a tree of the model dtype, as there.

Shapes: x (B, S, d_model); H heads of head dim P; state size N; the B / C
projections shared across G groups (as GQA shares K / V).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _proj, dense_init, rms_norm


def ssm_dims(cfg):
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, conv_dim


def init_ssm(generator, cfg, dtype, device, n_layers: int):
    """Layer-stacked SSM parameters with the reference's distributions:
    ``in_proj`` -> [z, x, B, C, dt] and ``out_proj`` normal / sqrt(d_in),
    the conv taps normal * 0.1, zero conv bias and ``dt_bias``,
    ``A_log = log(linspace(1, 16, H))``, unit ``D`` and norm."""
    d, L = cfg.d_model, n_layers
    d_inner, conv_dim = ssm_dims(cfg)
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": dense_init(generator, (L, d, 2 * d_inner + 2 * G * N + H),
                              dtype, device),
        "conv_w": (torch.randn((L, cfg.ssm_conv, conv_dim),
                               generator=generator, **f32) * 0.1).to(dtype),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "dt_bias": torch.zeros((L, H), **f32),
        "A_log": a_log.expand(L, H).contiguous(),
        "D": torch.ones((L, H), **f32),
        "norm_w": torch.ones((L, d_inner), dtype=dtype, device=device),
        "out_proj": dense_init(generator, (L, d_inner, d), dtype, device),
    }


def _split_proj(cfg, proj):
    d_inner, _ = ssm_dims(cfg)
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [d_inner, d_inner + 2 * G * N, H], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0), with no
    linear cut-off above a threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d along seq. xbc: (B, S, C), w: (K, C); the
    taps summed in the reference's order."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _segsum(a):
    """Cumulative-sum decay matrix: out[..., i, j] = sum_{j<k<=i} a_k on
    and below the diagonal, -inf above it (every row keeps its diagonal,
    so exp of a row is never all zero)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return dif.masked_fill(~mask, float("-inf"))


def chunk_len(cfg, S: int) -> int:
    """The reference's chunk: ``min(ssm_chunk, S)`` lowered until it
    divides S (a prime S gives 1), so the sums run in its order."""
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssm_block(p, cfg, x, initial_state=None):
    """Full-sequence SSD. x: (B, S, d).

    Returns (out, cache) where cache = {"state": the final SSM state in
    x's dtype, "conv": the last (ssm_conv - 1) raw pre-conv xbc values},
    from which ``ssm_decode`` continues.  A sequence shorter than that
    tail raises: the reference keeps a shorter tail there, and its next
    decode step fails on the shape.
    """
    B_, S, _ = x.shape
    H, N, G, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    d_inner, _ = ssm_dims(cfg)
    tail = cfg.ssm_conv - 1
    if S < tail:
        raise ValueError(
            f"ssm_block: a sequence of {S} positions is shorter than the "
            f"conv tail of ssm_conv - 1 = {tail} positions that decoding "
            f"continues from; prompts of an SSM-bearing model need at least "
            f"{tail} positions (the reference keeps a short tail and its "
            "first decode step fails)")
    Q = chunk_len(cfg, S)
    nc = S // Q

    proj = _proj(x, p["in_proj"])
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    conv_tail = xbc_raw[:, S - tail:, :]
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)

    xs = xs.reshape(B_, S, H, P).float()
    Bc = Bc.reshape(B_, S, G, N).float()
    Cc = Cc.reshape(B_, S, G, N).float()
    rep = H // G
    Bh = torch.repeat_interleave(Bc, rep, dim=2)          # (B,S,H,N)
    Ch = torch.repeat_interleave(Cc, rep, dim=2)

    dt = _softplus(dt_raw.float() + p["dt_bias"])          # (B,S,H)
    A = -torch.exp(p["A_log"])                             # (H,)
    a = dt * A                                             # log-decay a step
    xdt = xs * dt[..., None]                               # (B,S,H,P)

    def ch(t):
        return t.reshape((B_, nc, Q) + tuple(t.shape[2:]))

    a_c, x_c, B_ck, C_ck = ch(a), ch(xdt), ch(Bh), ch(Ch)
    a_cum = torch.cumsum(a_c, dim=2)                       # (B,nc,Q,H)
    a_sum = a_cum[:, :, -1]                                # (B,nc,H)

    # within-chunk (diagonal) term
    L = torch.exp(_segsum(a_c.permute(0, 1, 3, 2)))        # (B,nc,H,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bchls", C_ck, B_ck) * L
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, x_c)

    # chunk states
    decay_end = torch.exp(a_sum[:, :, None, :] - a_cum)    # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", B_ck, decay_end, x_c)

    # inter-chunk recurrence (the reference's lax.scan)
    carry = torch.zeros((B_, H, P, N), dtype=torch.float32,
                        device=x.device) if initial_state is None \
        else initial_state.float()
    decay_chunk = torch.exp(a_sum)                         # (B,nc,H)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * decay_chunk[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    # off-diagonal (cross-chunk) term
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", C_ck, prev_states,
                         torch.exp(a_cum))

    y = (y_diag + y_off).reshape(B_, S, H, P)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(B_, S, d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm_w"],
                 cfg.norm_eps)
    cache = {"state": carry.to(x.dtype), "conv": conv_tail}
    return _proj(y, p["out_proj"]), cache


def init_ssm_cache(cfg, batch, dtype, device):
    d_inner, conv_dim = ssm_dims(cfg)
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def ssm_decode(p, cfg, x, cache):
    """Single-token SSD step. x: (B, 1, d).  Returns (out, new cache): the
    state computed in f32 and stored in the cache's dtype (rounded there
    every token, as in the reference), the conv window rolled by one."""
    B_ = x.shape[0]
    H, N, G, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    d_inner, _ = ssm_dims(cfg)

    proj = _proj(x[:, 0], p["in_proj"])                    # (B, ...)
    z, xbc, dt_raw = _split_proj(cfg, proj)

    # causal conv via the rolling cache
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B,K,C)
    w = p["conv_w"]                                        # (K,C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in.float(), w.float())
                 + p["conv_b"].float())
    new_conv = conv_in[:, 1:].to(cache["conv"].dtype)

    xs, Bc, Cc = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, H, P)
    Bh = torch.repeat_interleave(Bc.reshape(B_, G, N), H // G, dim=1)
    Ch = torch.repeat_interleave(Cc.reshape(B_, G, N), H // G, dim=1)

    dt = _softplus(dt_raw.float() + p["dt_bias"])          # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                              # (B,H)

    st = cache["state"].float()
    st = st * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs, Bh)
    y = torch.einsum("bhpn,bhn->bhp", st, Ch) + xs * p["D"][None, :, None]
    y = y.reshape(B_, d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm_w"],
                 cfg.norm_eps)
    out = _proj(y, p["out_proj"])[:, None, :]
    return out, {"state": st.to(cache["state"].dtype), "conv": new_conv}

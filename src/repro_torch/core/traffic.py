"""Per-layer (FLOPs, bytes) traffic traces for LM phases.

The LM half of the reference's ``core/traffic.py``, copied: the analytic
per-layer decomposition the serving cost model prices prefill and decode
from (``lm_layer_traces``, ``decode_kv_bytes``).  ``LayerTrace`` is copied
from the reference's ``models/cnn.py``, where the paper's CNN traces live.

Conventions: FLOPs = 2 x MACs; bf16 weights/activations (2 bytes) for LMs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class LayerTrace:
    name: str
    kind: str           # conv | fc | bn | relu | pool | concat
    flops_per_img: float
    weight_bytes: float   # loaded once per (partition, batch) pass
    act_bytes_per_img: float  # read input + write output

    def bw_demand(self, batch, gflops_per_s):
        """Bandwidth demand (B/s) when compute-bound at given FLOP rate."""
        t = self.flops_per_img * batch / (gflops_per_s * 1e9)
        byt = self.weight_bytes + self.act_bytes_per_img * batch
        return byt / max(t, 1e-12)


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------


def attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim
    p = cfg.d_model * (cfg.n_heads * hd) * 2  # wq + wo
    p += cfg.d_model * (cfg.n_kv_heads * hd) * 2  # wk + wv
    if cfg.qkv_bias:
        p += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return p


def mlp_params(cfg: ModelConfig, d_ff=None) -> int:
    f = d_ff or cfg.d_ff
    mult = 3 if cfg.act == "silu" else 2
    return mult * cfg.d_model * f


def ssm_params(cfg: ModelConfig) -> int:
    di = cfg.ssm_heads * cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    p = cfg.d_model * (2 * di + 2 * gn + cfg.ssm_heads)  # in_proj
    p += cfg.ssm_conv * (di + 2 * gn)                    # conv
    p += di * cfg.d_model                                # out_proj
    p += 3 * cfg.ssm_heads + di                          # A, D, dt_bias, norm
    return p


def layer_params(cfg: ModelConfig) -> dict:
    """Per-layer parameter counts by component, plus active (MoE) counts."""
    out = {"attn": 0, "mlp": 0, "moe": 0, "moe_active": 0, "ssm": 0,
           "norms": 2 * cfg.d_model}
    if cfg.family != "ssm":
        out["attn"] = attn_params(cfg)
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = ssm_params(cfg)
    if cfg.n_experts:
        e = mlp_params(cfg)
        out["moe"] = cfg.n_experts * e + cfg.d_model * cfg.n_experts
        out["moe_active"] = cfg.top_k * e + cfg.d_model * cfg.n_experts
        if cfg.n_shared_experts:
            sh = mlp_params(cfg, cfg.d_ff * cfg.n_shared_experts)
            out["moe"] += sh
            out["moe_active"] += sh
    elif cfg.d_ff:
        out["mlp"] = mlp_params(cfg)
    return out


# ---------------------------------------------------------------------------
# analytic attention / SSD FLOPs per layer
# ---------------------------------------------------------------------------


def attn_flops_per_layer(cfg, S, B, causal=True, window=0, decode=False):
    """Score + PV einsum FLOPs (projections are counted via params)."""
    hd = cfg.head_dim
    if decode:  # one token against S cache entries
        kv = min(window, S) if window else S
        return 2.0 * B * cfg.n_heads * hd * kv * 2
    if window:
        kv_per_q = min(window, S)
        eff = S * kv_per_q
    else:
        eff = S * S / 2 if causal else S * S
    return 2.0 * B * cfg.n_heads * hd * eff * 2  # QK^T and PV


def ssd_flops_per_layer(cfg, S, B, decode=False):
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    if decode:
        return 2.0 * B * H * P * N * 2
    Q = min(cfg.ssm_chunk, S)
    per_chunk = (2.0 * Q * Q * H * N      # CB^T scores
                 + 2.0 * Q * Q * H * P    # y_diag
                 + 2.0 * Q * H * P * N * 2  # states in/out
                 + 2.0 * Q * H * P * N)   # y_off
    return B * (S / Q) * per_chunk


# ---------------------------------------------------------------------------
# LM layer traces for the shaping simulator (beyond-paper analysis)
# ---------------------------------------------------------------------------


def lm_layer_traces(cfg: ModelConfig, seq: int, dtype_bytes: int = 2):
    """Per-layer-component LayerTrace list for ONE sequence (batch=1 image
    equivalent): the LM analogue of the CNN traces the paper profiles."""
    lp = layer_params(cfg)
    d = cfg.d_model
    out = []
    act = seq * d * dtype_bytes

    for i in range(cfg.n_layers):
        win = cfg.attn_window if (cfg.attn_window and
                                  i not in cfg.global_layers) else 0
        if lp["attn"]:
            fl = (2.0 * seq * lp["attn"]
                  + attn_flops_per_layer(cfg, seq, 1, window=win))
            out.append(LayerTrace(f"l{i}.attn", "attn", fl,
                                  lp["attn"] * dtype_bytes, 4 * act))
        if lp["ssm"]:
            fl = 2.0 * seq * lp["ssm"] + ssd_flops_per_layer(cfg, seq, 1)
            out.append(LayerTrace(f"l{i}.ssm", "ssm", fl,
                                  lp["ssm"] * dtype_bytes, 4 * act))
        if lp["moe_active"]:
            fl = 2.0 * seq * lp["moe_active"]
            # weights: active experts' slices must stream per pass
            wb = lp["moe_active"] * dtype_bytes
            out.append(LayerTrace(f"l{i}.moe", "moe", fl, wb, 6 * act))
        elif lp["mlp"]:
            fl = 2.0 * seq * lp["mlp"]
            out.append(LayerTrace(f"l{i}.mlp", "mlp", fl,
                                  lp["mlp"] * dtype_bytes, 4 * act))
        # norm/residual: memory-bound phase (the BN analogue)
        out.append(LayerTrace(f"l{i}.norm", "bn", 8.0 * seq * d, 0.0, 3 * act))
    # head
    out.append(LayerTrace("head", "fc", 2.0 * seq * d * cfg.vocab,
                          cfg.vocab * d * dtype_bytes,
                          act + seq * cfg.vocab * 4))
    return out


def decode_kv_bytes(cfg: ModelConfig, ctx: int, dtype_bytes: int = 2, *,
                    kv_dtype_bytes: float = None,
                    kv_keep: float = 1.0) -> float:
    """Per-sequence cache bytes touched by ONE decode step: the whole KV
    cache (or SSM state) is re-read every token, which is what makes decode
    the bandwidth-bound serving phase (the BN analogue for LM scheduling).

    ``kv_dtype_bytes`` reprices the *attention KV* term for a quantized
    pool layout (int8/fp8 pages move 1 byte/element instead of the model
    dtype's); ``kv_keep`` scales the same term for blockwise-sparse decode
    (the fraction of KV blocks actually read).  Neither touches the SSM
    recurrent-state term — that state is not paged KV.  The defaults
    (``None`` -> the model dtype, keep 1.0) are bit-for-bit the historical
    pricing."""
    L = cfg.n_layers
    by = 0.0
    if cfg.family != "ssm":
        hd = cfg.head_dim
        if cfg.attn_window:
            full = len(cfg.global_layers)
            w_eff = min(cfg.attn_window, ctx)
            eff_ctx = full * ctx + (L - full) * w_eff
        else:
            eff_ctx = L * ctx
        kb = dtype_bytes if kv_dtype_bytes is None else kv_dtype_bytes
        by += 2.0 * cfg.n_kv_heads * hd * kb * eff_ctx * kv_keep
    if cfg.family in ("ssm", "hybrid"):
        # recurrent state read + write per layer
        by += 2.0 * L * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state \
            * dtype_bytes
    return by

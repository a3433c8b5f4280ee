"""Phase cost models: the analytic half.

The port's own copy of the reference's ``profiling/cost_model.py`` up to
``AnalyticCostModel`` (logic unchanged, so the virtual clock prices every
op exactly as the reference does).  A ``PhaseCost`` is (FLOPs, bytes,
full-speed duration); its ``demand`` (bytes/s while running) is the
quantity the scheduler's demand policy and the fluid simulator price their
spacing and contention from.  ``AnalyticCostModel`` derives durations from
the per-layer (FLOPs, bytes) decomposition (``core.traffic``) priced at
``KIND_EFF`` efficiencies.  The measured model and profile persistence wait
for their slice (ROADMAP.md, Queue 1 item 9).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hw
from repro_torch.core.shaping_sim import KIND_EFF
from repro_torch.core.traffic import decode_kv_bytes, lm_layer_traces
from repro_torch.profiling.timer import PhaseTimer

# Pricing-side byte width of one KV-cache element per pool layout.  ``None``
# means "the model's own dtype_bytes" — the unquantized layout and the exact
# historical pricing.  Kept here (not imported from ``serving.kv_pool``,
# which owns the same names on the storage side) so pricing never pulls in
# the serving package.  See ``docs/kv_quantization.md``.
KV_PRICE_BYTES = {"fp32": None, "int8": 1, "fp8": 1}


def _check_kv_pricing(kv_dtype: str, sparse_keep: float) -> None:
    if kv_dtype not in KV_PRICE_BYTES:
        raise ValueError(f"kv_dtype must be one of "
                         f"{sorted(KV_PRICE_BYTES)}, got {kv_dtype!r}")
    if not 0.0 < sparse_keep <= 1.0:
        raise ValueError(f"sparse_keep must be in (0, 1], got {sparse_keep}")


# ---------------------------------------------------------------------------
# the cost record
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PhaseCost:
    flops: float
    byts: float
    duration: float   # seconds at the partition's achieved compute rate

    @property
    def demand(self) -> float:
        """Bytes/s wanted while the phase runs (unconstrained)."""
        return self.byts / max(self.duration, 1e-15)

    def merge(self, other: Optional["PhaseCost"]) -> "PhaseCost":
        """Sequential composition (a refill prefill billed into a tick)."""
        if other is None:
            return self
        return PhaseCost(self.flops + other.flops, self.byts + other.byts,
                         self.duration + other.duration)


# ---------------------------------------------------------------------------
# analytic phase pricing (moved verbatim from serving.engine)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _traces(cfg: ModelConfig, seq: int, dtype_bytes: int) -> tuple:
    """Memoized per-layer traces: cost estimates run every scheduler tick,
    and the trace list is a pure function of a frozen config."""
    return tuple(lm_layer_traces(cfg, seq, dtype_bytes))


def _cost_from_traces(traces, batch: int, peak_flops: float,
                      extra_bytes: float = 0.0) -> PhaseCost:
    fl = by = dur = 0.0
    for tr in traces:
        eff = KIND_EFF.get(tr.kind, 0.4)
        f = tr.flops_per_img * batch
        fl += f
        by += tr.weight_bytes + tr.act_bytes_per_img * batch
        dur += f / (peak_flops * eff)
    return PhaseCost(fl, by + extra_bytes, max(dur, 1e-15))


def _eff_len(prompt_len: int, cached: int) -> int:
    """Prompt tokens a prefill actually computes after a prefix-cache hit:
    the uncached tail, floored at 1 (even a full hit recomputes the last
    position to emit the first token).  ``cached=0`` — the cold path — is
    the identity, so pre-caching pricing is bit-for-bit unchanged."""
    return max(int(prompt_len) - max(int(cached), 0), 1)


def _kv_write_delta(cfg: ModelConfig, total_tokens: float, dtype_bytes: int,
                    kv_dtype_bytes) -> float:
    """Byte adjustment to a prefill's traffic when its KV-cache *write*
    lands in a quantized pool: the per-layer K+V rows shrink from the model
    dtype to ``kv_dtype_bytes`` per element.  Zero (exactly) when the pool
    stores at model dtype — the historical pricing."""
    if kv_dtype_bytes is None or cfg.family == "ssm":
        return 0.0
    return (2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * total_tokens * (float(kv_dtype_bytes) - float(dtype_bytes)))


def prefill_cost(cfg: ModelConfig, batch: int, prompt_len: int,
                 peak_flops: float = hw.H100_PEAK_FLOPS,
                 dtype_bytes: int = 2, cached: int = 0, *,
                 kv_dtype_bytes=None) -> PhaseCost:
    """One prefill wave of ``batch`` equal-length prompts (compute-bound).
    ``cached`` prompt tokens (a prefix-cache hit) are priced as free: only
    the divergent tail costs FLOPs and traffic.  ``kv_dtype_bytes``
    reprices the KV-cache write for a quantized pool layout."""
    eff = _eff_len(prompt_len, cached)
    extra = _kv_write_delta(cfg, eff * batch, dtype_bytes, kv_dtype_bytes)
    return _cost_from_traces(_traces(cfg, eff, dtype_bytes), batch,
                             peak_flops, extra_bytes=extra)


def prefill_cost_ragged(cfg: ModelConfig, lens: Sequence[int],
                        peak_flops: float = hw.H100_PEAK_FLOPS,
                        dtype_bytes: int = 2,
                        cached_lens: Optional[Sequence[int]] = None, *,
                        kv_dtype_bytes=None) -> PhaseCost:
    """One fused prefill wave over ragged prompt lengths.

    FLOPs and activation traffic accumulate per prompt at its own length;
    the weight stream is shared by the fused wave and counted once —
    reduces exactly to ``prefill_cost`` when all lengths are equal.
    ``cached_lens`` (per-prompt prefix-cache hit lengths, aligned with
    ``lens``) shrinks each prompt to its uncached tail before pricing, so
    the demand policy spaces from post-hit phase costs."""
    if cached_lens is not None:
        assert len(cached_lens) == len(lens), (len(cached_lens), len(lens))
        lens = [_eff_len(l, c) for l, c in zip(lens, cached_lens)]
    counts = Counter(int(l) for l in lens)
    longest = max(counts)
    w_by = sum(tr.weight_bytes for tr in _traces(cfg, longest, dtype_bytes))
    fl = by = dur = 0.0
    for plen, n in counts.items():
        for tr in _traces(cfg, plen, dtype_bytes):
            eff = KIND_EFF.get(tr.kind, 0.4)
            f = tr.flops_per_img * n
            fl += f
            by += tr.act_bytes_per_img * n
            dur += f / (peak_flops * eff)
    by += _kv_write_delta(cfg, sum(int(l) for l in lens), dtype_bytes,
                          kv_dtype_bytes)
    return PhaseCost(fl, by + w_by, max(dur, 1e-15))


def decode_cost(cfg: ModelConfig, batch: int,
                ctx: Union[int, Sequence[int]],
                peak_flops: float = hw.H100_PEAK_FLOPS,
                dtype_bytes: int = 2, *, kv_dtype_bytes=None,
                kv_keep: float = 1.0) -> PhaseCost:
    """One decode step over ``batch`` slots — the KV-cache read makes this
    the bandwidth-bound phase.  ``ctx`` is either one shared context length
    or a per-slot vector; ragged batches price the KV read as the SUM of
    per-slot contexts (a shared scalar over- or under-priced them).
    ``kv_dtype_bytes`` / ``kv_keep`` reprice the KV read for quantized /
    blockwise-sparse pool layouts (see ``core.traffic.decode_kv_bytes``)."""
    if np.ndim(ctx) == 0:
        kv = decode_kv_bytes(cfg, int(ctx), dtype_bytes,
                             kv_dtype_bytes=kv_dtype_bytes,
                             kv_keep=kv_keep) * batch
    else:
        assert len(ctx) == batch, (len(ctx), batch)
        kv = sum(decode_kv_bytes(cfg, int(c), dtype_bytes,
                                 kv_dtype_bytes=kv_dtype_bytes,
                                 kv_keep=kv_keep) for c in ctx)
    return _cost_from_traces(_traces(cfg, 1, dtype_bytes),
                             batch, peak_flops, extra_bytes=kv)


# ---------------------------------------------------------------------------
# the cost-model interface
# ---------------------------------------------------------------------------


class CostModel:
    """What an engine asks about phase costs, in one interface.

    ``prefill(batch, prompt_len, cached=0)``
        — one equal-length prefill wave (also batch-1 slot refills);
          ``cached`` prompt tokens were a prefix-cache hit and only the
          uncached tail is priced;
    ``prefill_ragged(lens, cached_lens=None)``
        — one fused ragged prefill wave, per-prompt hit lengths optional;
    ``decode(ctxs)``
        — one decode step over the per-slot context vector ``ctxs``.

    ``kind`` identifies the pricing source ("analytic" | "measured") —
    carried worker-side in ``cluster.protocol.WorkerStatus.cost_source`` so
    the controller can tell what every worker's spacing ingredients were
    priced from.  ``timer`` is the live ``PhaseTimer`` the engine should
    feed with wall-clocked op durations, or None when the model is frozen
    (analytic, or a replayed profile).
    """

    kind = "abstract"
    timer: Optional[PhaseTimer] = None

    def prefill(self, batch: int, prompt_len: int,
                cached: int = 0) -> PhaseCost:
        raise NotImplementedError

    def prefill_ragged(self, lens: Sequence[int],
                       cached_lens: Optional[Sequence[int]] = None
                       ) -> PhaseCost:
        raise NotImplementedError

    def decode(self, ctxs: Sequence[int]) -> PhaseCost:
        raise NotImplementedError


class AnalyticCostModel(CostModel):
    """Today's deterministic pricing behind the ``CostModel`` interface —
    a direct delegation to the module-level analytic functions, so it is
    bit-for-bit the pre-cost-model behaviour (pinned by tests)."""

    kind = "analytic"

    def __init__(self, cfg: ModelConfig,
                 peak_flops: float = hw.H100_PEAK_FLOPS,
                 dtype_bytes: int = 2, *, kv_dtype: str = "fp32",
                 sparse_keep: float = 1.0):
        _check_kv_pricing(kv_dtype, sparse_keep)
        self.cfg = cfg
        self.peak_flops = float(peak_flops)
        self.dtype_bytes = int(dtype_bytes)
        # KV-layout pricing knobs: bytes/element of the paged KV store
        # (None = model dtype) and the blockwise-sparse read fraction.
        # Defaults reproduce the historical pricing bit-for-bit.
        self.kv_dtype = kv_dtype
        self.sparse_keep = float(sparse_keep)
        self._kv_bytes = KV_PRICE_BYTES[kv_dtype]

    def prefill(self, batch: int, prompt_len: int,
                cached: int = 0) -> PhaseCost:
        return prefill_cost(self.cfg, batch, prompt_len, self.peak_flops,
                            self.dtype_bytes, cached,
                            kv_dtype_bytes=self._kv_bytes)

    def prefill_ragged(self, lens: Sequence[int],
                       cached_lens: Optional[Sequence[int]] = None
                       ) -> PhaseCost:
        return prefill_cost_ragged(self.cfg, lens, self.peak_flops,
                                   self.dtype_bytes, cached_lens,
                                   kv_dtype_bytes=self._kv_bytes)

    def decode(self, ctxs: Sequence[int]) -> PhaseCost:
        return decode_cost(self.cfg, len(ctxs), ctxs, self.peak_flops,
                           self.dtype_bytes, kv_dtype_bytes=self._kv_bytes,
                           kv_keep=self.sparse_keep)

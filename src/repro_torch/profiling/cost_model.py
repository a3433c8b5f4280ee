"""Phase cost models: analytic pricing, measured pricing, JSON profiles.

The port's own copy of the reference's ``profiling/cost_model.py``, logic
unchanged, so the virtual clock prices every op exactly as the reference
does; only the import paths and the default pricing rate
(``hw.H100_PEAK_FLOPS``, the H100 data sheet's) differ.  A ``PhaseCost`` is
(FLOPs, bytes, full-speed duration); its ``demand`` (bytes/s while
running) is the quantity the scheduler's demand policy and the fluid
simulator price their spacing and contention from.

``AnalyticCostModel`` derives durations from the per-layer (FLOPs, bytes)
decomposition (``core.traffic``) priced at ``KIND_EFF`` efficiencies: the
deterministic default.

``MeasuredCostModel`` keeps FLOPs and bytes analytic (shape arithmetic)
but replaces the DURATION by the ``PhaseTimer`` EMA of the op's shape
bucket once that bucket is warm (``min_samples`` observations), optionally
blended with the analytic duration (``blend`` = weight of the measured
term); cold buckets fall back to the analytic duration exactly.  On the
card the engine feeds the timer from wall-clocked phase ops
(``PartitionEngine._run_timed``), decode steps as graph replays.

Profiles: ``save_profile`` writes the timer's EMA table (plus the config
identity and pricing parameters) as JSON in the reference's format;
``load_profile`` rebuilds a frozen, timer-less ``MeasuredCostModel`` from
it, so one calibration run replays deterministically.
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hw
from repro_torch.core.shaping_sim import KIND_EFF
from repro_torch.core.traffic import decode_kv_bytes, lm_layer_traces
from repro_torch.profiling.timer import PhaseTimer, shape_key

PROFILE_VERSION = 1
COST_MODELS = ("analytic", "measured")

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


class MeasuredCostModel(CostModel):
    """Measured durations over the analytic bytes/FLOPs decomposition.

    Every query first prices the op analytically, then replaces the
    *duration* with the timer's EMA for the op's shape bucket when that
    bucket is warm:

        duration = blend * ema + (1 - blend) * analytic      (warm bucket)
        duration = analytic                                  (cold bucket)

    ``blend`` defaults to 1.0 (fully measured once warm); lower it to keep
    the analytic prior in the mix on noisy devices.  Bytes and FLOPs stay
    analytic (shape arithmetic), so ``demand = bytes / duration`` tracks
    the measurement: an op the device runs slower than the roofline claims
    demands fewer bytes/s but occupies the pipe longer — exactly the
    correction the demand-spacing rule needs to see.
    """

    kind = "measured"

    def __init__(self, cfg: ModelConfig,
                 peak_flops: float = hw.H100_PEAK_FLOPS,
                 dtype_bytes: int = 2, *,
                 timer: Optional[PhaseTimer] = None, blend: float = 1.0,
                 kv_dtype: str = "fp32", sparse_keep: float = 1.0):
        if not 0.0 <= blend <= 1.0:
            raise ValueError(f"blend must be in [0, 1], got {blend}")
        self.analytic = AnalyticCostModel(cfg, peak_flops, dtype_bytes,
                                          kv_dtype=kv_dtype,
                                          sparse_keep=sparse_keep)
        self.cfg = cfg
        self.peak_flops = float(peak_flops)
        self.dtype_bytes = int(dtype_bytes)
        self.kv_dtype = kv_dtype
        self.sparse_keep = float(sparse_keep)
        # a frozen (replay) model has estimates but no live timer; keep the
        # estimate store separate from the observation hook so both modes
        # read through the same path
        self._store = timer if timer is not None else PhaseTimer()
        self.timer = timer
        self.blend = float(blend)

    # -- pricing -------------------------------------------------------------
    def _priced(self, ana: PhaseCost, phase: str, batch: int,
                tokens: int) -> PhaseCost:
        ema = self._store.estimate(shape_key(phase, batch, tokens))
        if ema is None:
            return ana  # cold start: the analytic duration, exactly
        dur = self.blend * ema + (1.0 - self.blend) * ana.duration
        return PhaseCost(ana.flops, ana.byts, max(dur, 1e-15))

    def prefill(self, batch: int, prompt_len: int,
                cached: int = 0) -> PhaseCost:
        # bucket on the EFFECTIVE (post-hit) length: a cached-prefix wave
        # runs like a short one, and must share the short waves' EMA
        eff = _eff_len(prompt_len, cached)
        return self._priced(self.analytic.prefill(batch, prompt_len, cached),
                            "prefill", batch, eff)

    def prefill_ragged(self, lens: Sequence[int],
                       cached_lens: Optional[Sequence[int]] = None
                       ) -> PhaseCost:
        effs = [int(l) for l in lens] if cached_lens is None else \
            [_eff_len(l, c) for l, c in zip(lens, cached_lens)]
        return self._priced(self.analytic.prefill_ragged(lens, cached_lens),
                            "prefill", len(lens), max(effs))

    def decode(self, ctxs: Sequence[int]) -> PhaseCost:
        return self._priced(self.analytic.decode(ctxs),
                            "decode", len(ctxs), sum(int(c) for c in ctxs))

    # -- calibration state ---------------------------------------------------
    @property
    def n_observations(self) -> int:
        return self._store.n_observations

    @property
    def n_warm(self) -> int:
        return self._store.n_warm

    def observe(self, phase: str, batch: int, tokens: int,
                seconds: float) -> None:
        """Inject one observation directly (tests / synthetic calibration;
        the engine feeds the live ``timer`` itself)."""
        self._store.observe(shape_key(phase, batch, tokens), seconds)


# ---------------------------------------------------------------------------
# profile persistence + factory
# ---------------------------------------------------------------------------


def save_profile(model: MeasuredCostModel, path) -> Path:
    """Write the model's calibration state as JSON (deterministic layout:
    sorted keys, so identical calibrations diff clean)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)  # a calibration run
    # must never lose its data to a missing output directory at exit
    doc = {
        "version": PROFILE_VERSION,
        "arch": getattr(model.cfg, "name", str(model.cfg)),
        "peak_flops": model.peak_flops,
        "dtype_bytes": model.dtype_bytes,
        "kv_dtype": model.kv_dtype,
        "sparse_keep": model.sparse_keep,
        "blend": model.blend,
        "alpha": model._store.alpha,
        "min_samples": model._store.min_samples,
        "stats": model._store.to_dict(),
    }
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return path


def load_profile(path, cfg: ModelConfig, *,
                 peak_flops: Optional[float] = None,
                 live: bool = False) -> MeasuredCostModel:
    """Rebuild a ``MeasuredCostModel`` from a saved profile.

    The default is a FROZEN model (``timer is None``): it prices from the
    saved EMAs and never changes — the deterministic replay mode simulation
    and CI use.  ``live=True`` re-attaches the loaded store as a live timer
    so a new run keeps calibrating on top of the profile.

    ``peak_flops`` overrides the saved pricing rate for the analytic
    fallback/bytes side (a profile calibrated at P=4's 1/4-device rate
    replayed in a differently sized fleet); the measured EMAs are raw
    seconds and carry over as-is.  A profile saved for a different arch is
    rejected — durations do not transfer across models.
    """
    path = Path(path)
    doc = json.loads(path.read_text())
    if doc.get("version") != PROFILE_VERSION:
        raise ValueError(f"{path}: unsupported profile version "
                         f"{doc.get('version')!r} (want {PROFILE_VERSION})")
    arch = getattr(cfg, "name", str(cfg))
    if doc.get("arch") != arch:
        raise ValueError(f"{path}: profile was calibrated for "
                         f"{doc.get('arch')!r}, not {arch!r}")
    store = PhaseTimer.from_dict(doc["stats"], alpha=doc.get("alpha", 0.25),
                                 min_samples=doc.get("min_samples", 3))
    model = MeasuredCostModel(
        cfg,
        peak_flops=float(peak_flops if peak_flops is not None
                         else doc["peak_flops"]),
        dtype_bytes=int(doc.get("dtype_bytes", 2)),
        timer=store, blend=float(doc.get("blend", 1.0)),
        kv_dtype=doc.get("kv_dtype", "fp32"),
        sparse_keep=float(doc.get("sparse_keep", 1.0)))
    if not live:
        model.timer = None  # frozen: estimates stay, observation hook off
    return model


def make_cost_model(name: str, cfg: ModelConfig,
                    peak_flops: float = hw.H100_PEAK_FLOPS, *,
                    profile=None, dtype_bytes: int = 2,
                    blend: Optional[float] = None,
                    kv_dtype: str = "fp32",
                    sparse_keep: float = 1.0) -> CostModel:
    """One factory for the CLI / WorkerSpec axis.

    ``analytic``                    -> the deterministic default;
    ``measured``                    -> live calibration (fresh PhaseTimer);
    ``measured`` + existing profile -> frozen deterministic replay.

    ``blend=None`` means "the profile's saved value" on replay and the
    fully-measured 1.0 for a fresh calibration; an explicit ``blend``
    overrides either (a loaded profile keeps its saved ``dtype_bytes`` —
    durations were calibrated against that layout).  ``kv_dtype`` /
    ``sparse_keep`` reprice KV traffic for quantized / blockwise-sparse
    pool layouts; non-default values override a loaded profile's saved
    layout (bytes are shape arithmetic — the calibrated durations still
    apply)."""
    if name not in COST_MODELS:
        raise ValueError(f"cost model must be one of {COST_MODELS}, "
                         f"got {name!r}")
    _check_kv_pricing(kv_dtype, sparse_keep)
    if name == "analytic":
        return AnalyticCostModel(cfg, peak_flops, dtype_bytes,
                                 kv_dtype=kv_dtype, sparse_keep=sparse_keep)
    if profile is not None and Path(profile).exists():
        model = load_profile(profile, cfg, peak_flops=peak_flops)
        if blend is not None:
            if not 0.0 <= blend <= 1.0:
                raise ValueError(f"blend must be in [0, 1], got {blend}")
            model.blend = float(blend)
        if kv_dtype != "fp32" or sparse_keep != 1.0:
            model.kv_dtype = kv_dtype
            model.sparse_keep = float(sparse_keep)
            model.analytic = AnalyticCostModel(
                cfg, model.peak_flops, model.dtype_bytes,
                kv_dtype=kv_dtype, sparse_keep=sparse_keep)
        return model
    return MeasuredCostModel(cfg, peak_flops, dtype_bytes,
                             timer=PhaseTimer(),
                             blend=1.0 if blend is None else blend,
                             kv_dtype=kv_dtype, sparse_keep=sparse_keep)

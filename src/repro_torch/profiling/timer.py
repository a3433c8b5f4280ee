"""On-device phase timing: wall-clock observations folded into EMAs.

``PhaseTimer`` is the measurement half of the measured cost model
(``repro_torch.profiling.cost_model.MeasuredCostModel``).  The engine wraps each
device phase op (``issue_prefill`` / ``issue_decode`` / slot refill) with a
wall-clock measurement — JAX dispatch is asynchronous, so the stop edge
must block on the op's outputs (``jax.block_until_ready``) before reading
the clock — and folds the observed duration into a per-*shape-bucket*
exponential moving average.

Buckets, not exact shapes: a serving run visits a long tail of decode
context vectors (every step grows each slot's context by one), so keying
EMAs by the exact shape would leave every bucket with one sample and the
model permanently cold.  ``shape_key`` therefore buckets the token
dimension to the next power of two — shapes that compile to the same class
of executable and move within ~2x the same bytes share one estimate.  The
batch dimension stays exact (it changes the executable and the cost
roughly linearly).

The timer is deliberately dumb: it never prices anything.  Pricing —
blending observed durations with the analytic bytes/FLOPs decomposition,
cold-start fallback, JSON persistence — lives in the cost model, so a
timer-less ``MeasuredCostModel`` loaded from a saved profile replays a
calibration run deterministically (simulation and CI need no device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

ShapeKey = Tuple[str, int, int]   # (phase, batch, token_bucket)


def bucket_tokens(n: int) -> int:
    """Round ``n`` up to the next power of two (minimum 1).

    The token-dimension bucketing rule shared by the observation edge
    (engine timing) and the pricing edge (``MeasuredCostModel`` lookups) —
    both sides MUST key buckets identically or measurements would never be
    found again."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def shape_key(phase: str, batch: int, tokens: int) -> ShapeKey:
    """The EMA bucket for one phase op.

    ``phase``  — "prefill" | "decode" (refill prefills are batch-1
                 prefills and share the prefill buckets);
    ``batch``  — exact op batch (wave size / active decode slots);
    ``tokens`` — the op's token extent, bucketed: prompt length (max over
                 a ragged wave) for prefill, TOTAL context (sum over the
                 active slots — what sizes the KV read) for decode.
    """
    return (str(phase), int(batch), bucket_tokens(tokens))


@dataclass
class PhaseStat:
    """One bucket's running estimate: EMA of observed seconds + count."""
    ema: float = 0.0
    count: int = 0

    def fold(self, seconds: float, alpha: float) -> None:
        if self.count == 0:
            self.ema = float(seconds)
        else:
            self.ema = alpha * float(seconds) + (1.0 - alpha) * self.ema
        self.count += 1


class PhaseTimer:
    """Per-(phase, batch-shape) EMA store for wall-clocked phase ops.

    ``alpha`` is the EMA smoothing factor (weight of the newest sample);
    ``min_samples`` is the warm threshold the cost model consults — a
    bucket with fewer observations is "cold" and the model falls back to
    the analytic duration.
    """

    def __init__(self, alpha: float = 0.25, min_samples: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.stats: Dict[ShapeKey, PhaseStat] = {}

    def observe(self, key: ShapeKey, seconds: float) -> None:
        """Fold one wall-clocked duration into its bucket's EMA."""
        if seconds < 0:
            raise ValueError(f"negative duration {seconds} for {key}")
        self.stats.setdefault(key, PhaseStat()).fold(seconds, self.alpha)

    def estimate(self, key: ShapeKey) -> Optional[float]:
        """The bucket's EMA duration, or None while the bucket is cold
        (fewer than ``min_samples`` observations)."""
        st = self.stats.get(key)
        if st is None or st.count < self.min_samples:
            return None
        return st.ema

    @property
    def n_observations(self) -> int:
        return sum(st.count for st in self.stats.values())

    @property
    def n_warm(self) -> int:
        return sum(1 for st in self.stats.values()
                   if st.count >= self.min_samples)

    # -- (de)serialization: the profile's "stats" payload --------------------
    def to_dict(self) -> dict:
        """JSON-friendly snapshot (keys flattened to "phase/batch/tokens")."""
        return {f"{k[0]}/{k[1]}/{k[2]}": {"ema": st.ema, "count": st.count}
                for k, st in sorted(self.stats.items())}

    @classmethod
    def from_dict(cls, d: dict, *, alpha: float = 0.25,
                  min_samples: int = 3) -> "PhaseTimer":
        t = cls(alpha=alpha, min_samples=min_samples)
        for flat, st in d.items():
            phase, batch, tokens = flat.split("/")
            t.stats[(phase, int(batch), int(tokens))] = PhaseStat(
                ema=float(st["ema"]), count=int(st["count"]))
        return t

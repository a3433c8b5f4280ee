"""Serving observables: per-span bandwidth demand + request latencies.

The span trace is the serving analogue of the paper's Fig. 1 bandwidth
curve: each observed span is one op's (t_start, duration, unconstrained
HBM demand).  Under the lockstep clock spans are the scheduler's ticks
(contiguous, non-overlapping — ``observe_tick`` is kept as a shim); under
the event clock every partition's op is its own span and spans *overlap*.
Statistics are computed on the piecewise-constant overlay of all spans —
aggregate demand between span boundaries, time-weighted — which reduces
exactly to the old per-tick weighting when spans do not overlap.  Mean/std
of that overlay are the shaping metrics the stagger policies are judged
on; TTFT/TPOT/throughput are the serving-quality side of the tradeoff.
All times are virtual seconds on the scheduler clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.timeline import bin_bw_samples
from repro_torch.serving.queue import Request


def achieved_bw_stats(bw_samples, t_end: float, *,
                      window: Optional[float] = None, trim: float = 0.0,
                      ) -> Tuple[float, float]:
    """(mean, std) of the ALLOCATED aggregate bandwidth over fixed windows
    — the exact observable of ``core.shaping_sim`` (Fig. 5), measured on a
    live contention clock (``EventScheduler`` and the cluster controller
    both delegate here).  ``trim`` drops windows within that many seconds
    of both ends (warmup/cooldown exclusion).

    Degenerate traces are hardened to empty-trace stats (0.0, 0.0) instead
    of NaN or an exception: an empty sample list, a zero-length clock, or a
    trim window that meets/exceeds the trace span all mean "no steady
    state was observed"."""
    if not bw_samples or t_end <= 0.0:
        return 0.0, 0.0
    if trim > 0 and 2 * trim >= t_end:
        return 0.0, 0.0
    if window is None:
        window = max(t_end / 400.0, 1e-12)
    edges, bw = bin_bw_samples(bw_samples, t_end, window)
    centers = edges[:-1] + window / 2
    if trim > 0:
        # unconditional: if the trim excludes every window the answer is
        # the empty-trace stats, never a silently untrimmed average
        bw = bw[(centers > trim) & (centers < t_end - trim)]
    if len(bw) == 0:
        return 0.0, 0.0
    return float(bw.mean()), float(bw.std())


@dataclass
class ServingMetrics:
    spans: List[Tuple[float, float, float]] = field(default_factory=list)
    # (t_start, duration, unconstrained_demand_bytes_per_s)
    requests: List[Request] = field(default_factory=list)
    wall_seconds: float = 0.0
    virtual_seconds: float = 0.0

    def observe_span(self, t: float, dt: float, demand: float) -> None:
        self.spans.append((t, dt, demand))

    def observe_tick(self, t: float, dt: float, demand: float) -> None:
        """Legacy per-tick API (lockstep clock): a tick is just a span."""
        self.observe_span(t, dt, demand)

    @property
    def ticks(self) -> List[Tuple[float, float, float]]:
        """Back-compat alias for the span trace."""
        return self.spans

    def observe_request(self, req: Request) -> None:
        self.requests.append(req)

    # -- bandwidth-demand statistics (time-weighted span overlay) -----------
    def _weighted(self, trim: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Aggregate-demand value + width per overlay segment: the span
        boundaries cut time into segments, each segment's demand is the sum
        of the spans covering it.  Non-overlapping spans (lockstep ticks)
        reduce to the per-tick (demand, dt) weighting unchanged.  ``trim``
        drops segments whose centre lies within that many seconds of either
        end of the observed range (warmup/cooldown exclusion, as the fluid
        simulator does per pass)."""
        if not self.spans:
            return np.zeros(1), np.ones(1)
        arr = np.asarray(self.spans)
        span = float((arr[:, 0] + np.maximum(arr[:, 1], 1e-15)).max()
                     - arr[:, 0].min())
        if trim > 0 and 2 * trim >= span:
            # the trim window swallows the whole trace: no steady state was
            # observed — report empty-trace stats, never NaN or a silently
            # untrimmed answer
            return np.zeros(1), np.ones(1)
        t0 = arr[:, 0]
        t1 = arr[:, 0] + np.maximum(arr[:, 1], 1e-15)
        edges = np.unique(np.concatenate([t0, t1]))
        if len(edges) < 2:
            return arr[:, 2], np.maximum(arr[:, 1], 1e-15)
        vals = np.zeros(len(edges) - 1)
        for a, b, d in zip(t0, t1, arr[:, 2]):
            i0 = np.searchsorted(edges, a, side="left")
            i1 = np.searchsorted(edges, b, side="left")
            vals[i0:i1] += d
        widths = np.diff(edges)
        keep = widths > 1e-18
        if trim > 0:
            # unconditional, like ``achieved_bw_stats``: a trim that
            # excludes every segment yields empty-trace stats, never a
            # silently untrimmed answer
            centers = (edges[:-1] + edges[1:]) / 2
            keep &= (centers > edges[0] + trim) & (centers < edges[-1] - trim)
            if not keep.any():
                return np.zeros(1), np.ones(1)
        if not keep.any():
            return vals, np.maximum(widths, 1e-15)
        return vals[keep], widths[keep]

    def bw_stats(self, trim: float = 0.0) -> Tuple[float, float]:
        """(mean, std) of the aggregate-demand overlay, optionally with the
        warmup/cooldown ``trim`` applied — the serving Fig. 5 observable."""
        v, w = self._weighted(trim)
        m = np.average(v, weights=w)
        return float(m), float(np.sqrt(np.average((v - m) ** 2, weights=w)))

    @property
    def bw_demand_mean(self) -> float:
        return self.bw_stats()[0]

    @property
    def bw_demand_std(self) -> float:
        return self.bw_stats()[1]

    # -- latency / throughput ----------------------------------------------
    def _done(self) -> List[Request]:
        return [r for r in self.requests if r.t_done is not None]

    def ttft(self) -> np.ndarray:
        return np.asarray([r.t_first_token - r.arrival for r in self._done()
                           if r.t_first_token is not None])

    def tpot(self) -> np.ndarray:
        """Per-request mean time per output token after the first."""
        out = []
        for r in self._done():
            n = len(r.tokens)
            if n > 1 and r.t_first_token is not None:
                out.append((r.t_done - r.t_first_token) / (n - 1))
        return np.asarray(out)

    def percentiles(self, arr: np.ndarray, ps=(50, 95)) -> Dict[str, float]:
        if len(arr) == 0:
            return {f"p{p}": float("nan") for p in ps}
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}

    @property
    def completed_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self._done()))

    @property
    def deadline_misses(self) -> int:
        return sum(1 for r in self._done()
                   if r.deadline is not None and r.t_done > r.deadline)

    def throughput(self, wall: bool = False) -> float:
        den = self.wall_seconds if wall else self.virtual_seconds
        return self.completed_tokens / max(den, 1e-12)

    def summary(self) -> Dict[str, float]:
        bw_mean, bw_std = self.bw_stats()  # one overlay build for both
        return {
            "requests_completed": len(self._done()),
            "tokens": self.completed_tokens,
            "virtual_s": self.virtual_seconds,
            "tok_per_s_virtual": self.throughput(),
            "tok_per_s_wall": self.throughput(wall=True),
            "bw_demand_mean": bw_mean,
            "bw_demand_std": bw_std,
            "deadline_misses": self.deadline_misses,
            **{f"ttft_{k}": v for k, v in
               self.percentiles(self.ttft()).items()},
            **{f"tpot_{k}": v for k, v in
               self.percentiles(self.tpot()).items()},
        }

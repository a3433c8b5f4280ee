"""Open-loop load generation: the million-user traffic model.

Closed-loop sweeps (everything queued at t=0) measure steady-state
throughput; production traffic does not look like that.  This module
generates *open-loop* arrival processes — requests land on the virtual
clock whether or not the fleet is keeping up — with the statistical
structure real serving sees:

  * arrival processes (all seeded, all deterministic):
      poisson — homogeneous Poisson at ``rate`` req/s;
      diurnal — nonhomogeneous Poisson whose intensity sweeps a cosine
                valley->peak cycle (mean ``rate``; ``peak_ratio`` =
                intensity max/min), via thinning;
      bursty  — on/off modulated Poisson (mean ``rate``): each ``period``
                opens with a ``duty``-fraction burst window running
                ``burst_ratio`` times hotter than the trough — the
                traffic shape statistical shaping exists to absorb;
  * heavy-tailed prompt/decode length mixes (bounded Pareto: most
    requests short, a fat tail of huge ones — ``LengthMix``);
  * per-request deadline SLOs (``SloSpec``: TTFT budget + per-token
    budget) and ``goodput_stats`` — the fraction of OFFERED load served
    within its deadline.  Shed load (admission rejects) and late
    completions both count against goodput, so "reject everything hard"
    cannot game the metric.

``schedule_arrivals`` injects a trace into a running fleet at virtual
arrival instants (``ContentionTimeline.call_at``), which is what makes the
load open-loop: the cluster controller's clock advances through idle gaps
and burst pile-ups exactly as a wall clock would.  A copy of the
reference's module (the reference's ``benchmarks/serving_soak.py`` builds
its sustained-RPS soak on it; ``docs/multi_host.md`` has the knobs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

ARRIVALS = ("poisson", "diurnal", "bursty")


# ---------------------------------------------------------------------------
# arrival processes (seeded, deterministic, open-loop)
# ---------------------------------------------------------------------------


def _poisson_times(rng, rate: float, horizon: float) -> np.ndarray:
    """Event times of a homogeneous Poisson process on [0, horizon)."""
    if rate <= 0 or horizon <= 0:
        return np.empty(0)
    out = []
    t, chunk = 0.0, max(int(rate * horizon * 1.5) + 16, 16)
    while t < horizon:
        arr = t + np.cumsum(rng.exponential(1.0 / rate, size=chunk))
        out.append(arr)
        t = float(arr[-1])
    ts = np.concatenate(out)
    return ts[ts < horizon]


def poisson_arrivals(rate: float, horizon: float, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` req/s on [0, horizon)."""
    return _poisson_times(np.random.default_rng(seed), rate, horizon)


def _thinned(rate_max: float, horizon: float, seed: int,
             accept: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Nonhomogeneous Poisson by thinning: candidates at ``rate_max``,
    kept with probability ``accept(t)`` = intensity(t) / rate_max."""
    rng = np.random.default_rng(seed)
    cand = _poisson_times(rng, rate_max, horizon)
    if not len(cand):
        return cand
    return cand[rng.random(len(cand)) < accept(cand)]


def diurnal_arrivals(rate: float, horizon: float, seed: int = 0, *,
                     peak_ratio: float = 3.0,
                     period: Optional[float] = None) -> np.ndarray:
    """Diurnal cycle: intensity ``rate * (1 - a*cos(2*pi*t/period))`` with
    ``a = (peak_ratio-1)/(peak_ratio+1)`` — mean ``rate``, max/min =
    ``peak_ratio``, valley at t=0, peak half a period in."""
    if peak_ratio < 1:
        raise ValueError(f"peak_ratio must be >= 1, got {peak_ratio}")
    period = horizon if period is None else float(period)
    a = (peak_ratio - 1.0) / (peak_ratio + 1.0)
    rate_max = rate * (1.0 + a)

    def accept(t: np.ndarray) -> np.ndarray:
        lam = rate * (1.0 - a * np.cos(2.0 * np.pi * t / period))
        return lam / rate_max

    return _thinned(rate_max, horizon, seed, accept)


def bursty_rates(rate: float, burst_ratio: float,
                 duty: float) -> "tuple[float, float]":
    """(burst, trough) intensities with overall mean ``rate``."""
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if burst_ratio < 1:
        raise ValueError(f"burst_ratio must be >= 1, got {burst_ratio}")
    trough = rate / (duty * burst_ratio + (1.0 - duty))
    return burst_ratio * trough, trough


def bursty_arrivals(rate: float, horizon: float, seed: int = 0, *,
                    burst_ratio: float = 8.0, duty: float = 0.25,
                    period: Optional[float] = None) -> np.ndarray:
    """On/off modulated Poisson, mean ``rate``: the first ``duty`` fraction
    of every ``period`` runs at the burst intensity (``burst_ratio`` times
    the trough).  Deterministic burst windows make the envelope property-
    testable: phase(t) < duty  <=>  t is inside a burst."""
    period = horizon / 4.0 if period is None else float(period)
    hot, cold = bursty_rates(rate, burst_ratio, duty)

    def accept(t: np.ndarray) -> np.ndarray:
        in_burst = (t % period) / period < duty
        return np.where(in_burst, 1.0, cold / hot)

    return _thinned(hot, horizon, seed, accept)


def make_arrivals(kind: str, rate: float, horizon: float, seed: int = 0,
                  **kw) -> np.ndarray:
    """Build an arrival-time array by process name (the CLI axis)."""
    if kind == "poisson":
        return poisson_arrivals(rate, horizon, seed, **kw)
    if kind == "diurnal":
        return diurnal_arrivals(rate, horizon, seed, **kw)
    if kind == "bursty":
        return bursty_arrivals(rate, horizon, seed, **kw)
    raise ValueError(f"arrival kind must be one of {ARRIVALS}, got {kind!r}")


# ---------------------------------------------------------------------------
# heavy-tailed length mixes
# ---------------------------------------------------------------------------


def heavy_tail_lengths(n: int, seed: int = 0, *, median: float = 64.0,
                       alpha: float = 1.2, lo: int = 1,
                       hi: int = 4096) -> np.ndarray:
    """Bounded-Pareto lengths: ``P[L > x] ~ x**-alpha`` with the scale
    pinned so the (unclipped) median is ``median``, clipped to [lo, hi].
    Small ``alpha`` = fatter tail (alpha <= 1 has infinite mean before
    clipping — the classic elephant-and-mice prompt mix)."""
    rng = np.random.default_rng(seed)
    xm = median * 2.0 ** (-1.0 / alpha)
    x = xm / (1.0 - rng.random(n)) ** (1.0 / alpha)
    return np.clip(np.round(x), lo, hi).astype(np.int64)


@dataclass(frozen=True)
class LengthMix:
    """Heavy-tailed prompt/decode length distributions for one workload."""
    prompt_median: float = 48.0
    prompt_alpha: float = 1.2
    prompt_min: int = 4
    prompt_max: int = 512
    gen_median: float = 8.0
    gen_alpha: float = 1.6
    gen_min: int = 1
    gen_max: int = 128

    def prompt_lengths(self, n: int, seed: int) -> np.ndarray:
        return heavy_tail_lengths(n, seed, median=self.prompt_median,
                                  alpha=self.prompt_alpha,
                                  lo=self.prompt_min, hi=self.prompt_max)

    def gen_lengths(self, n: int, seed: int) -> np.ndarray:
        return heavy_tail_lengths(n, seed, median=self.gen_median,
                                  alpha=self.gen_alpha,
                                  lo=self.gen_min, hi=self.gen_max)


# ---------------------------------------------------------------------------
# SLOs + the offered trace
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SloSpec:
    """Per-request completion deadline: ``arrival + ttft_budget +
    tpot_budget * max_new_tokens`` (a TTFT allowance plus a per-token
    generation allowance, both in virtual seconds)."""
    ttft_budget: float
    tpot_budget: float

    def deadline(self, arrival: float, max_new_tokens: int) -> float:
        return arrival + self.ttft_budget \
            + self.tpot_budget * int(max_new_tokens)


@dataclass(frozen=True)
class OfferedRequest:
    """One offered unit of load, pre-deadline-stamped."""
    arrival: float
    prompt: np.ndarray = field(repr=False)
    max_new_tokens: int
    deadline: Optional[float]


def make_trace(kind: str, rate: float, horizon: float, *, seed: int = 0,
               mix: Optional[LengthMix] = None,
               slo: Optional[SloSpec] = None, vocab: int = 32000,
               max_len: Optional[int] = None,
               arrival_kw: Optional[dict] = None) -> List[OfferedRequest]:
    """Generate one seeded offered-load trace: arrivals from the named
    process, lengths from the mix (prompt capped at ``max_len`` minus the
    decode budget when given), deadlines from the SLO.  Same seed ->
    byte-identical trace, whatever transport or router serves it."""
    mix = mix if mix is not None else LengthMix()
    arrivals = make_arrivals(kind, rate, horizon, seed, **(arrival_kw or {}))
    n = len(arrivals)
    plens = mix.prompt_lengths(n, seed + 1)
    gens = mix.gen_lengths(n, seed + 2)
    if max_len is not None:
        plens = np.minimum(plens, np.maximum(max_len - gens, 1))
    rng = np.random.default_rng(seed + 3)
    out: List[OfferedRequest] = []
    for t, pl, g in zip(arrivals, plens, gens):
        prompt = rng.integers(0, vocab, int(pl)).astype(np.int32)
        dl = slo.deadline(float(t), int(g)) if slo is not None else None
        out.append(OfferedRequest(arrival=float(t), prompt=prompt,
                                  max_new_tokens=int(g), deadline=dl))
    return out


# ---------------------------------------------------------------------------
# injection + goodput
# ---------------------------------------------------------------------------


def submit_trace(queue, trace: List[OfferedRequest]) -> int:
    """Closed-loop fallback: submit the whole trace up front (arrival
    stamps preserved).  Returns the number admitted."""
    n = 0
    for r in trace:
        if queue.submit(r.prompt, r.max_new_tokens, arrival=r.arrival,
                        deadline=r.deadline) is not None:
            n += 1
    return n


def schedule_arrivals(timeline, queue, trace: List[OfferedRequest],
                      on_arrival: Optional[Callable[[float], None]] = None
                      ) -> int:
    """Open-loop injection: every offered request submits at its arrival
    instant on the virtual clock, then ``on_arrival(t)`` (typically the
    cluster controller's ``pump``) offers it to the fleet.  The clock
    stays live through idle gaps — bursts pile up and lulls drain exactly
    as they would against a wall clock.  Returns the trace length."""
    for r in trace:
        def _fire(t: float, r: OfferedRequest = r) -> None:
            queue.submit(r.prompt, r.max_new_tokens, arrival=r.arrival,
                         deadline=r.deadline)
            if on_arrival is not None:
                on_arrival(t)

        timeline.call_at(r.arrival, _fire)
    return len(trace)


def goodput_stats(queue) -> Dict[str, float]:
    """SLO attainment over OFFERED load.

    ``goodput`` = requests completed within their deadline / requests
    offered (admitted + rejected).  Rejected (shed) load and late
    completions both count against it — goodput only rises by actually
    serving requests on time.  Requests without a deadline count as
    attained when completed."""
    offered = queue.n_submitted + queue.n_rejected
    attained = sum(1 for r in queue.completed
                   if r.t_done is not None
                   and (r.deadline is None or r.t_done <= r.deadline))
    completed = len(queue.completed)
    return {
        "offered": float(offered),
        "completed": float(completed),
        "rejected": float(queue.n_rejected),
        "attained": float(attained),
        "late": float(completed - attained),
        "goodput": attained / max(offered, 1),
    }

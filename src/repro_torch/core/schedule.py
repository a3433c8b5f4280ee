"""Phase-offset schedules for asynchronous partitions.

The port's copy of the reference's ``core/schedule.py``.  The paper relies
on *statistical* decorrelation of partition phases.  Beyond the paper: when
the per-pass bandwidth-demand profile b(t) is known (it is — we have the
traces), offsets can be chosen to actively minimize the variance of the
aggregate demand sum_p b(t - o_p).  Greedy sequential assignment over a
discretized offset grid, evaluated with FFT cross-correlation, gives a
measurable improvement over uniform staggering.  Pure numpy; the defaults
are the paper's KNL platform, as in the reference.
"""
from __future__ import annotations

import numpy as np

from . import hw
from .shaping_sim import ACT_AMP, KIND_EFF, tasks_from_traces


def demand_profile(traces, batch: int, cores: int, n_bins: int = 2048,
                   flops_per_core: float = hw.KNL_FLOPS_PER_CORE,
                   kind_eff=KIND_EFF, act_amp=ACT_AMP):
    """Unconstrained bandwidth-demand profile b(t) of one pass, resampled to
    ``n_bins`` equal time bins.  Returns (profile bytes/s, pass_time s)."""
    tasks = tasks_from_traces(traces, batch, cores, flops_per_core,
                              kind_eff, act_amp)
    pass_time = sum(t.dur for t in tasks)
    prof = np.zeros(n_bins)
    t = 0.0
    for task in tasks:
        i0 = int(t / pass_time * n_bins)
        i1 = max(int((t + task.dur) / pass_time * n_bins), i0 + 1)
        prof[i0:min(i1, n_bins)] += task.demand
        t += task.dur
    return prof, pass_time


def optimize_offsets(traces, partitions: int, batch_per_part: int,
                     cores_per_part: int, n_bins: int = 2048,
                     **kw) -> np.ndarray:
    """Greedy anti-correlated offset assignment (fractions of one pass).

    Partition 0 at offset 0; each next partition picks the circular shift
    that minimizes the variance of the running aggregate profile.  FFT
    correlation makes each step O(n log n).
    """
    prof, _ = demand_profile(traces, batch_per_part, cores_per_part,
                             n_bins, **kw)
    fprof = np.fft.rfft(prof)
    agg = prof.copy()
    offsets = [0.0]
    for _ in range(1, partitions):
        # var(agg + shift(prof, s)) minimized <=> cross-correlation
        # corr(agg, prof)(s) minimized (means are shift-invariant)
        corr = np.fft.irfft(np.fft.rfft(agg) * np.conj(fprof), n=n_bins)
        s = int(np.argmin(corr))
        agg += np.roll(prof, s)
        offsets.append(s / n_bins)
    return np.asarray(offsets)


def aggregate_profile_std(traces, offsets, batch_per_part: int,
                          cores_per_part: int, n_bins: int = 2048, **kw):
    """Std of the aggregate unconstrained demand for given offsets —
    the analytic (pre-contention) objective the optimizer minimizes."""
    prof, _ = demand_profile(traces, batch_per_part, cores_per_part,
                             n_bins, **kw)
    agg = np.zeros(n_bins)
    for o in offsets:
        agg += np.roll(prof, int(o * n_bins))
    return float(agg.std()), float(agg.mean())

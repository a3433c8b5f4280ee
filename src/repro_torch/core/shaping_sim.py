"""Fluid-simulator pieces the serving trace validation needs.

The port's own copy of the serving half of the reference's
``core/shaping_sim.py``: ``KIND_EFF`` (achieved-FLOPs efficiency per layer
kind, which the analytic cost model prices with), ``Task``, ``SimResult``
and ``simulate_tasks`` (P finite per-partition task lists run once on the
shared ``core.timeline`` contention clock).  The paper's CNN sweep
(``simulate``, ``partition_sweep``) waits for its slice (ROADMAP.md,
Queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core import hw
from repro_torch.core.timeline import ContentionTimeline, bin_bw_samples

# Achieved-FLOPs efficiency per layer kind, calibrated in the reference
# against the paper's Fig. 5 numbers (see repro.core.shaping_sim).
KIND_EFF = {"conv": 0.35, "fc": 0.30, "bn": 0.22, "relu": 0.22,
            "pool": 0.22, "concat": 0.22,
            "attn": 0.45, "ssm": 0.40, "mlp": 0.55, "moe": 0.45}


@dataclass
class Task:
    dur: float    # seconds at full compute speed
    byts: float   # bytes to move while running
    name: str = ""

    @property
    def demand(self) -> float:  # bytes/s wanted when compute-bound
        return self.byts / max(self.dur, 1e-15)


@dataclass
class SimResult:
    time: np.ndarray          # window centers (s)
    bw: np.ndarray            # aggregate bytes/s per window
    images: float             # images completed
    elapsed: float            # seconds simulated
    passes: int               # per-partition passes completed
    steady_rate: float = 0.0  # images/s measured between first & last pass
                              # completion per partition (startup excluded)

    @property
    def throughput(self) -> float:
        if self.steady_rate > 0:
            return self.steady_rate
        return self.images / max(self.elapsed, 1e-12)

    @property
    def bw_mean(self) -> float:
        return float(self.bw.mean()) if len(self.bw) else 0.0

    @property
    def bw_std(self) -> float:
        return float(self.bw.std()) if len(self.bw) else 0.0


def simulate_tasks(tasklists: Sequence[Sequence[Task]], *,
                   bandwidth: float = hw.H100_HBM_BW,
                   offsets: Sequence[float] | None = None,
                   window: float | None = None,
                   trim: float = 0.0) -> SimResult:
    """Event-driven max-min-fair simulation of P partitions each executing a
    FINITE per-partition task list exactly once.

    This is the serving analogue of ``simulate``: instead of P copies of one
    CNN layer trace looping for ``n_passes``, every partition gets its own
    interleaved prefill/decode task sequence (built by ``repro_torch.serving``),
    so phase-staggered continuous batching can be validated with the same
    Fig. 5 methodology (aggregate-bandwidth mean/std over time windows).

    ``offsets`` are absolute start delays in seconds per partition.
    ``window`` defaults to 1/400 of the longest unconstrained tasklist time.
    ``trim`` drops windows within that many seconds of both ends before the
    bw statistics (warmup/cooldown exclusion, as ``simulate`` does by pass).
    """
    P = len(tasklists)
    off = np.asarray(offsets, float) if offsets is not None else np.zeros(P)
    span = max(sum(t.dur for t in tl) for tl in tasklists)
    if window is None:
        window = max(span / 400.0, 1e-12)

    n_tasks = np.array([len(tl) for tl in tasklists])
    tlc = ContentionTimeline(bandwidth)
    for p, tl in enumerate(tasklists):
        tlc.run_chain(tl, offset=float(off[p]), key=p)

    max_t = (span + off.max()) * (P + 2) * 3  # hard stop
    t = tlc.run(until=max_t)

    edges, bw_win = bin_bw_samples(tlc.bw_samples, t, window)
    centers = (edges[:-1] + window / 2) if len(edges) > 1 else np.zeros(1)
    if trim > 0:
        keep = (centers > trim) & (centers < t - trim)
        if keep.sum() >= 4:
            centers, bw_win = centers[keep], bw_win[keep]
    return SimResult(time=centers, bw=bw_win, images=int(n_tasks.sum()),
                     elapsed=t, passes=1)

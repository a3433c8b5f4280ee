"""Statistical memory traffic shaping: the bandwidth-contention fluid
simulator.

The port's own copy of the reference's ``core/shaping_sim.py``.  P
partitions each run a task list on the shared ``core.timeline`` contention
clock and contend for one memory pipe (max-min fair); the aggregate
bandwidth over time (mean, std) and the images/s are the paper's
Fig. 4/5/6 metrics.

* The paper's CNN sweep: ``tasks_from_traces`` (per-layer tasks at a
  partition's compute rate, with the calibrated ``KIND_EFF`` / ``ACT_AMP``),
  ``simulate`` (P partitions looping a CNN's layer trace for ``n_passes``)
  and ``partition_sweep`` (the Fig. 5 protocol).  Their defaults are the
  paper's KNL platform (``hw.KNL_*``), as in the reference, so the numbers
  equal the reference's exactly.
* The serving validation: ``simulate_tasks`` (P finite per-partition task
  lists run once), defaulting to the H100's bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core import hw
from repro_torch.core.timeline import ContentionTimeline, bin_bw_samples

# Achieved-FLOPs efficiency per layer kind and conv input re-read
# amplification (blocked conv re-reads input tiles; Yang et al., the paper's
# ref [16]), calibrated in the reference against the paper's Fig. 5 numbers
# (see repro.core.shaping_sim).
KIND_EFF = {"conv": 0.35, "fc": 0.30, "bn": 0.22, "relu": 0.22,
            "pool": 0.22, "concat": 0.22,
            "attn": 0.45, "ssm": 0.40, "mlp": 0.55, "moe": 0.45}

# activation-traffic amplification by kind (input re-reads under blocking)
ACT_AMP = {"conv": 1.6}


@dataclass
class Task:
    dur: float    # seconds at full compute speed
    byts: float   # bytes to move while running
    name: str = ""

    @property
    def demand(self) -> float:  # bytes/s wanted when compute-bound
        return self.byts / max(self.dur, 1e-15)


def tasks_from_traces(traces, batch: int, cores: int,
                      flops_per_core: float = hw.KNL_FLOPS_PER_CORE,
                      kind_eff=KIND_EFF, act_amp=ACT_AMP) -> List[Task]:
    """One pass of a partition: per-layer tasks at the partition's rate."""
    rate = cores * flops_per_core
    out = []
    for t in traces:
        eff = kind_eff.get(t.kind, 0.4)
        amp = act_amp.get(t.kind, 1.0)
        fl = max(t.flops_per_img * batch, 1.0)
        byts = t.weight_bytes + t.act_bytes_per_img * batch * amp
        out.append(Task(dur=fl / (rate * eff), byts=byts, name=t.name))
    return out


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


def simulate(traces, *, partitions: int, total_batch: int,
             total_cores: int = hw.KNL_CORES,
             bandwidth: float = hw.KNL_MEM_BW,
             flops_per_core: float = hw.KNL_FLOPS_PER_CORE,
             n_passes: int = 12, window: float = 1e-3,
             stagger: str = "uniform", offsets: Sequence[float] | None = None,
             kind_eff=KIND_EFF, act_amp=ACT_AMP, seed: int = 0) -> SimResult:
    """Event-driven simulation of P partitions over ``n_passes`` batch passes.

    Each partition gets ``total_batch / P`` images and ``total_cores / P``
    cores, loops the layer task list on the shared contention clock, and
    contends for ``bandwidth``.  stagger: "none" (all aligned — the
    degenerate synchronous case), "uniform" (p * pass_time / P — the
    paper's static offsets), "random", or "custom" with explicit
    ``offsets`` (fractions of one pass) from the schedule optimizer
    (``core.schedule``).

    Returns a ``SimResult``: aggregate bandwidth per window (warmup and
    cooldown passes trimmed), images completed, and the steady-state
    throughput measured between each partition's first and last pass
    completion (startup transient excluded) — mean/std of ``result.bw``
    and ``result.throughput`` are the paper's Fig. 5 metrics.
    """
    P = partitions
    b = total_batch // P
    cores = total_cores // P
    tasks = tasks_from_traces(traces, b, cores, flops_per_core, kind_eff,
                              act_amp)
    n_tasks = len(tasks)
    pass_time = sum(t.dur for t in tasks)  # unconstrained single-pass time

    rng = np.random.default_rng(seed)
    if offsets is not None:
        off = np.asarray(offsets, float) * pass_time
    elif stagger == "none":
        off = np.zeros(P)
    elif stagger == "random":
        off = rng.uniform(0, pass_time, P)
    else:  # uniform
        off = np.arange(P) * pass_time / P

    # per-partition state on the shared timeline: each partition cycles
    # through the task list; completion callbacks start the next task and
    # stamp pass boundaries
    passes_done = np.zeros(P, int)
    first_pass_t = np.full(P, np.nan)
    last_pass_t = np.full(P, np.nan)

    tlc = ContentionTimeline(bandwidth)

    def _start(p: int, i: int) -> None:
        def _done(_sp, t_now: float) -> None:
            j = i + 1
            if j == n_tasks:
                j = 0
                passes_done[p] += 1
                if passes_done[p] == 1:
                    first_pass_t[p] = t_now
                last_pass_t[p] = t_now
            _start(p, j)
        tlc.start(tasks[i].dur, tasks[i].byts, key=p, on_complete=_done)

    for p in range(P):
        tlc.call_at(off[p], lambda _t, p=p: _start(p, 0))

    max_t = pass_time * (n_passes + 2) * 3  # hard stop
    t = tlc.run(until=max_t,
                stop=lambda: passes_done.min() >= n_passes)

    # resample into fixed windows
    edges, bw_win = bin_bw_samples(tlc.bw_samples, t, window)
    # trim warmup/cooldown windows (first/last pass)
    lo = min(int(pass_time / window) + 1, max(len(bw_win) - 2, 0))
    hi = max(len(bw_win) - lo, lo + 1)
    bw_trim = bw_win[lo:hi]
    centers = (edges[:-1] + window / 2)[lo:hi]

    images = int(passes_done.sum()) * b
    # steady-state rate: passes after the first, per partition
    steady = 0.0
    span = last_pass_t - first_pass_t
    valid = (passes_done > 1) & (span > 0)
    if valid.any():
        rates = (passes_done[valid] - 1) * b / span[valid]
        steady = float(rates.sum() + (~valid).sum() * (rates.mean() if len(rates) else 0))
    return SimResult(time=centers, bw=bw_trim, images=images,
                     elapsed=t, passes=int(passes_done.min()),
                     steady_rate=steady)


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


def partition_sweep(traces, partitions_list, *, total_batch: int = 64,
                    n_passes: int = 12, stagger: str = "uniform",
                    offsets_map=None, **kw) -> dict:
    """The paper's Fig. 5 protocol: sweep P, report relative performance,
    bandwidth mean, bandwidth std (all relative to P=1)."""
    base = simulate(traces, partitions=1, total_batch=total_batch,
                    n_passes=n_passes, stagger="none", **kw)
    rows = {1: {"perf": 1.0, "bw_mean": base.bw_mean, "bw_std": base.bw_std,
                "throughput": base.throughput}}
    for p in partitions_list:
        if p == 1:
            continue
        off = offsets_map.get(p) if offsets_map else None
        r = simulate(traces, partitions=p, total_batch=total_batch,
                     n_passes=n_passes, stagger=stagger, offsets=off, **kw)
        rows[p] = {"perf": r.throughput / base.throughput,
                   "bw_mean": r.bw_mean, "bw_std": r.bw_std,
                   "throughput": r.throughput}
    return rows

"""Serving-trace validation: the Fig. 5 methodology applied to LM serving.

Builds per-partition task lists of interleaved prefill/decode phases for a
given request load and stagger policy, then runs them through the
contention-aware fluid simulator (``core.shaping_sim.simulate_tasks``).
This validates the scheduler's std-reduction claim the same way the paper
validates partitioned CNN inference: identical total work, identical
per-task (FLOPs, bytes) pricing, only the phase alignment differs.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hw
from repro_torch.core.shaping_sim import Task, simulate_tasks
from repro_torch.serving.engine import decode_cost, prefill_cost


def serving_tasklists(cfg: ModelConfig, *, partitions: int, total_slots: int,
                      n_requests: int, prompt_len: int, gen: int,
                      policy: str = "uniform",
                      peak_flops_total: float = hw.H100_PEAK_FLOPS,
                      dtype_bytes: int = 2,
                      ) -> Tuple[List[List[Task]], np.ndarray]:
    """Per-partition finite task lists + policy start offsets.

    The fleet's ``total_slots`` and ``n_requests`` are split evenly over
    partitions (P=1 keeps everything in one partition — the synchronous
    baseline), so total FLOPs and bytes are partition-count invariant.
    Decode context grows per emitted token, as in the real engine.
    """
    P = partitions
    slots = max(total_slots // P, 1)
    reqs = int(math.ceil(n_requests / P))
    waves = int(math.ceil(reqs / slots))
    peak = peak_flops_total / P

    pre = prefill_cost(cfg, slots, prompt_len, peak, dtype_bytes)
    wave_tasks = [Task(pre.duration, pre.byts, "prefill")]
    for i in range(gen):
        dc = decode_cost(cfg, slots, prompt_len + i, peak, dtype_bytes)
        wave_tasks.append(Task(dc.duration, dc.byts, f"decode{i}"))
    tasklist = wave_tasks * waves
    wave_time = sum(t.dur for t in wave_tasks)

    if policy == "none" or P == 1:
        off = np.zeros(P)
    elif policy == "uniform":
        off = np.arange(P) * wave_time / P
    elif policy == "demand":
        # static analogue of the scheduler's admission rule: successive
        # partitions start at least one full prefill apart, so the
        # compute-bound phases never overlap on the pipe
        off = np.arange(P) * max(pre.duration, wave_time / P)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return [list(tasklist) for _ in range(P)], off


def phase_balanced_bandwidth(cfg: ModelConfig, *, total_slots: int,
                             prompt_len: int, gen: int,
                             peak_flops_total: float = hw.H100_PEAK_FLOPS,
                             ) -> float:
    """Pipe sized inside the load's phase dynamic range: the geometric mean
    of the synchronous fleet's prefill and decode demands.  At production
    scale the physical HBM bandwidth already sits between compute-bound
    prefill and cache-streaming decode; smoke-sized models put BOTH phases
    over (or under) the physical pipe, which hides the phase structure the
    shaping claim is about — this keeps the validation scale-invariant."""
    pre = prefill_cost(cfg, total_slots, prompt_len, peak_flops_total)
    dec = decode_cost(cfg, total_slots, prompt_len + gen // 2,
                      peak_flops_total)
    return float(np.sqrt(pre.demand * dec.demand))


def serving_trace_report(cfg: ModelConfig, *, partitions: int,
                         policy: str = "uniform", total_slots: int = 4,
                         n_requests: int = 16, prompt_len: int = 32,
                         gen: int = 16,
                         bandwidth: float | None = None,
                         peak_flops_total: float = hw.H100_PEAK_FLOPS) -> dict:
    """Simulate the same request load as P staggered partitions and as the
    P=1 synchronous baseline; report steady-state bandwidth stats for both
    (one wave plus the stagger offsets trimmed from each end).

    Note the honest tradeoff this surfaces: per-partition weight streaming
    multiplies decode bytes by P (the paper's reuse loss, §3), so at
    weight-dominated smoke scale ``perf_rel`` can dip below 1 even while
    the std drops; KV-dominated production decode amortizes it.
    """
    if bandwidth is None:
        bandwidth = phase_balanced_bandwidth(
            cfg, total_slots=total_slots, prompt_len=prompt_len, gen=gen,
            peak_flops_total=peak_flops_total)
    kw = dict(total_slots=total_slots, n_requests=n_requests,
              prompt_len=prompt_len, gen=gen,
              peak_flops_total=peak_flops_total)
    base_tl, base_off = serving_tasklists(cfg, partitions=1, policy="none",
                                          **kw)
    tl, off = serving_tasklists(cfg, partitions=partitions, policy=policy,
                                **kw)
    wave_time = sum(t.dur for t in tl[0][:gen + 1])
    trim = wave_time + float(off.max())
    base = simulate_tasks(base_tl, bandwidth=bandwidth, offsets=base_off,
                          trim=trim)
    r = simulate_tasks(tl, bandwidth=bandwidth, offsets=off, trim=trim)
    return {
        "partitions": partitions, "policy": policy, "bandwidth": bandwidth,
        "bw_mean": r.bw_mean, "bw_std": r.bw_std, "elapsed": r.elapsed,
        "base_bw_mean": base.bw_mean, "base_bw_std": base.bw_std,
        "base_elapsed": base.elapsed,
        "std_rel": r.bw_std / max(base.bw_std, 1e-15),
        "mean_rel": r.bw_mean / max(base.bw_mean, 1e-15),
        "perf_rel": base.elapsed / max(r.elapsed, 1e-15),
    }

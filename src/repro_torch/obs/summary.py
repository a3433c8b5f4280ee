"""One summary formatter for both launch CLIs.

``serve.py`` (in-process fleet) and ``cluster.py`` (controller + worker
processes) used to hand-roll their exit summaries, and they drifted: the
cluster CLI never printed the prefix-cache hit/COW/evict counters the
in-process CLI did.  Both now build a ``MetricsRegistry`` — in-process
directly from the engines (``registry_from_engines``), the cluster from
the worker snapshots piggybacked on ``WorkerStatus`` — and print
``format_summary``'s lines, so every metric either CLI knows about shows
up in both.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs.registry import MetricsRegistry, fmt_count, merge_snapshots


def registry_from_engines(engines, queue=None) -> MetricsRegistry:
    """Fleet registry for the in-process CLI: fold every engine's
    ``metrics_snapshot()`` (the same tuples workers put on the wire) and
    the queue's admission counters."""
    reg = merge_snapshots(e.metrics_snapshot() for e in engines)
    if queue is not None:
        reg.inc("queue.submitted", queue.n_submitted)
        reg.inc("queue.rejected", queue.n_rejected)
        reg.inc("queue.requeued", queue.n_requeued)
    return reg


def observe_phase_durations(reg: MetricsRegistry, trace) -> None:
    """Fold a scheduler/controller span trace (``SpanRecord`` list) into
    per-phase duration histograms: ``phase.<kind>.duration`` flattens to
    ``.count`` / ``.sum`` / ``.le_<bound>`` entries in the snapshot."""
    for r in trace:
        reg.observe(f"phase.{r.phase}.duration", r.t1 - r.t0)


def format_summary(s: dict, reg: MetricsRegistry, *, bandwidth: float,
                   achieved=None, prefix_cache: bool = False,
                   lifecycle: Optional[str] = None) -> List[str]:
    """The shared tail of a CLI run report: throughput, latency, bw
    demand (+ achieved when an event clock ran), the prefix-cache
    counters, and the request-lifecycle digest.  ``s`` is
    ``ServingMetrics.summary()``; ``reg`` the fleet registry."""
    lines = [
        f"  throughput: {s['tok_per_s_virtual']:.1f} tok/s (virtual) "
        f"{s['tok_per_s_wall']:.1f} tok/s (wall)",
        f"  ttft p50={s['ttft_p50']*1e3:.3g}ms "
        f"p95={s['ttft_p95']*1e3:.3g}ms "
        f"tpot p50={s['tpot_p50']*1e6:.3g}us "
        f"deadline_misses={s['deadline_misses']}",
        f"  bw demand: mean={s['bw_demand_mean']/1e9:.1f} GB/s "
        f"std={s['bw_demand_std']/1e9:.2f} GB/s "
        f"(pipe {bandwidth/1e9:.0f} GB/s)",
    ]
    if achieved is not None:
        am, astd = achieved
        lines.append(f"  bw achieved: mean={am/1e9:.1f} GB/s "
                     f"std={astd/1e9:.2f} GB/s")
    if prefix_cache:
        lines.append(
            "  prefix cache: "
            f"hits={fmt_count(reg.get('prefix.hits'))} "
            f"cached_tokens={fmt_count(reg.get('prefix.cached_tokens'))} "
            f"cow={fmt_count(reg.get('pool.cow'))} "
            f"evicted={fmt_count(reg.get('pool.evicted'))}")
    if lifecycle:
        lines.append(f"  {lifecycle}")
    return lines

"""Observability: span tracing, metrics registry, request lifecycles.

The reference's ``obs`` package, copied: ``Tracer`` collects structured
events (span begin/end, instants, counters, flows) from every layer — the
contention timeline, engines, schedulers, the queue, the cluster
controller and the PD router — all stamped on the shared *virtual* clock,
so traces are deterministic and equal the reference's event for event.
``export.to_chrome`` renders them as Chrome-trace / Perfetto JSON.
``MetricsRegistry`` holds counters/gauges/histograms whose snapshots
workers piggyback on ``WorkerStatus``; ``LifecycleLog`` records
per-request hop timestamps (arrival→admit→prefill→[handoff]→decode→
retire).

Tracing records host events only (no device or CUDA-graph spans), is
strictly opt-in and zero-overhead when off: every hot call site is guarded
by ``if <owner>.tracer is not None`` on a plain attribute that defaults to
``None``, so the off path executes no observability code.
"""
from repro_torch.obs.export import (to_chrome, trace_bw_segments,
                                    validate_chrome, write_chrome)
from repro_torch.obs.lifecycle import LifecycleLog
from repro_torch.obs.registry import MetricsRegistry, merge_snapshots
from repro_torch.obs.summary import (format_summary, observe_phase_durations,
                                     registry_from_engines)
from repro_torch.obs.tracer import NullTracer, Tracer

__all__ = [
    "LifecycleLog", "MetricsRegistry", "NullTracer", "Tracer",
    "format_summary", "merge_snapshots", "observe_phase_durations",
    "registry_from_engines", "to_chrome", "trace_bw_segments",
    "validate_chrome", "write_chrome",
]

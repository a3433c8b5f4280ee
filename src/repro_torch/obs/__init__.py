"""Observability: the metrics registry and the shared CLI summary."""
from repro_torch.obs.registry import MetricsRegistry, merge_snapshots
from repro_torch.obs.summary import (format_summary, observe_phase_durations,
                                     registry_from_engines)

"""Metrics registry: counters, gauges, histograms with flat snapshots.

A ``MetricsRegistry`` is the aggregate side of observability — where the
tracer records *events*, the registry records *totals*: queue depth,
slots in use, pool free/cached blocks, prefix-cache hits, handoff
deferrals, per-phase duration histograms.  Snapshots are flat sorted
``((name, value), ...)`` tuples of floats, which makes them trivially
wire-safe: workers attach ``engine.metrics_snapshot()`` to every
``WorkerStatus`` and the controller folds them fleet-wide with
``merge_snapshots`` (values are summed — counters and block counts both
sum meaningfully across workers; the merged result feeds the unified CLI
summary, which is how the cluster CLI gained the prefix-cache counters
the in-process CLI always printed).

Histograms use fixed log-spaced bucket bounds so two runs observing the
same values snapshot identically; a histogram flattens into
``name.count`` / ``name.sum`` / ``name.le_<bound>`` entries.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

Snapshot = Tuple[Tuple[str, float], ...]

# default histogram bounds: log-spaced seconds, 1 µs .. 100 s (virtual)
_DEFAULT_BOUNDS = tuple(10.0 ** e for e in range(-6, 3))


class Histogram:
    """Fixed-bound cumulative histogram (observe-only, no quantiles)."""

    def __init__(self, bounds: Tuple[float, ...] = _DEFAULT_BOUNDS):
        self.bounds = tuple(sorted(bounds))
        self.counts = [0] * (len(self.bounds) + 1)  # last = +inf overflow
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def flatten(self, name: str) -> List[Tuple[str, float]]:
        out = [(f"{name}.count", float(self.n)),
               (f"{name}.sum", float(self.total))]
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out.append((f"{name}.le_{b:g}", float(cum)))
        return out


class MetricsRegistry:
    """Named counters (monotone), gauges (last value), histograms."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- write ---------------------------------------------------------------
    def inc(self, name: str, n: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + float(n)

    def set_gauge(self, name: str, v: float) -> None:
        self._gauges[name] = float(v)

    def observe(self, name: str, v: float,
                bounds: Tuple[float, ...] = _DEFAULT_BOUNDS) -> None:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds)
        h.observe(v)

    # -- read ----------------------------------------------------------------
    def get(self, name: str, default: float = 0.0) -> float:
        if name in self._counters:
            return self._counters[name]
        if name in self._gauges:
            return self._gauges[name]
        return default

    def histogram(self, name: str) -> Histogram:
        return self._histograms[name]

    def snapshot(self) -> Snapshot:
        """Flat, sorted, deterministic ((name, value), ...) view."""
        pairs: List[Tuple[str, float]] = []
        pairs += self._counters.items()
        pairs += self._gauges.items()
        for name, h in self._histograms.items():
            pairs += h.flatten(name)
        return tuple(sorted((str(k), float(v)) for k, v in pairs))

    def load_snapshot(self, snap: Snapshot) -> None:
        """Fold a flat snapshot into this registry (values add)."""
        for name, v in snap:
            self.inc(name, v)


def merge_snapshots(snaps: Iterable[Snapshot]) -> MetricsRegistry:
    """Fleet-wide aggregation: sum same-named values across workers."""
    reg = MetricsRegistry()
    for snap in snaps:
        reg.load_snapshot(snap)
    return reg


def snapshot_get(snap: Snapshot, name: str, default: float = 0.0) -> float:
    for k, v in snap:
        if k == name:
            return v
    return default


def fmt_count(v: float) -> str:
    """Render a snapshot value: integral floats print as ints."""
    return str(int(v)) if float(v).is_integer() and math.isfinite(v) \
        else f"{v:.6g}"

"""The event collector: spans, instants, counters, flows on virtual time.

A ``Tracer`` is a list of plain event dicts plus a clock binding.  Every
producer (timeline, engine, scheduler, queue, controller, PD router)
holds a ``tracer`` attribute that defaults to ``None`` and only emits
under an ``if self.tracer is not None`` guard — the off path runs no
observability code at all.  ``NullTracer`` exists for callers that want
an always-valid object (its methods are no-ops), but the hot paths use
the ``None`` guard, which is strictly cheaper.

Event shape (one dict per event, kept close to the Chrome trace format
so ``export.to_chrome`` is a projection, not a transformation):

  {"ph": "B"|"E"|"i"|"C"|"s"|"f", "group": str, "tid": int|str,
   "name": str, "t": float_virtual_seconds, "args": {...}}

Flow events ("s"/"f") additionally carry ``"id"`` — allocate one with
``flow_id()`` and use it for both ends (the PD handoff export→import
arrow).  Timestamps are whatever clock the tracer is bound to — in this
repo always the shared virtual clock, so identical runs produce
identical event lists (pinned byte-for-byte by ``tests/test_torch_obs.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.lifecycle import LifecycleLog


class Tracer:
    """Collects structured events in virtual-time order."""

    def __init__(self, clock: Optional[object] = None):
        self.events: List[Dict[str, Any]] = []
        self.clock = clock          # object with a ``.now`` attribute
        self.lifecycle = LifecycleLog()
        self._flow_seq = 0

    # -- clock ---------------------------------------------------------------
    @property
    def vnow(self) -> float:
        """Current virtual time of the bound clock (0.0 when unbound) —
        lets producers that do not own a clock (engines) stamp events."""
        c = self.clock
        return 0.0 if c is None else float(c.now)

    # -- emission ------------------------------------------------------------
    def begin(self, group: str, tid, name: str, t: float, **args) -> None:
        """Open a slice on track (group, tid)."""
        self.events.append({"ph": "B", "group": group, "tid": tid,
                            "name": name, "t": t, "args": args})

    def end(self, group: str, tid, name: str, t: float, **args) -> None:
        """Close the innermost open slice on track (group, tid)."""
        self.events.append({"ph": "E", "group": group, "tid": tid,
                            "name": name, "t": t, "args": args})

    def instant(self, group: str, tid, name: str, t: float, **args) -> None:
        """A zero-duration marker (admissions, holds, failovers, ...)."""
        self.events.append({"ph": "i", "group": group, "tid": tid,
                            "name": name, "t": t, "args": args})

    def counter(self, group: str, tid, name: str, t: float,
                **values) -> None:
        """One sample of a (multi-series) counter track; ``values`` maps
        series name -> number (the aggregate bw-demand curve)."""
        self.events.append({"ph": "C", "group": group, "tid": tid,
                            "name": name, "t": t, "args": values})

    def flow_id(self) -> int:
        """A fresh id linking a flow's start and finish events."""
        self._flow_seq += 1
        return self._flow_seq

    def flow_start(self, group: str, tid, name: str, t: float, fid: int,
                   **args) -> None:
        """Flow arrow tail (e.g. KV export on the source worker track)."""
        self.events.append({"ph": "s", "group": group, "tid": tid,
                            "name": name, "t": t, "id": fid, "args": args})

    def flow_end(self, group: str, tid, name: str, t: float, fid: int,
                 **args) -> None:
        """Flow arrow head (e.g. KV import on the destination track)."""
        self.events.append({"ph": "f", "group": group, "tid": tid,
                            "name": name, "t": t, "id": fid, "args": args})


class NullTracer:
    """API-compatible no-op tracer.  Hot paths should prefer the
    ``tracer is None`` guard (no call at all); this class is for code
    that wants an unconditionally valid tracer object."""

    events: List[Dict[str, Any]] = []   # shared, always empty
    clock = None
    vnow = 0.0

    def __init__(self):
        self.lifecycle = LifecycleLog()

    def begin(self, group, tid, name, t, **args):
        pass

    def end(self, group, tid, name, t, **args):
        pass

    def instant(self, group, tid, name, t, **args):
        pass

    def counter(self, group, tid, name, t, **values):
        pass

    def flow_id(self) -> int:
        return 0

    def flow_start(self, group, tid, name, t, fid, **args):
        pass

    def flow_end(self, group, tid, name, t, fid, **args):
        pass

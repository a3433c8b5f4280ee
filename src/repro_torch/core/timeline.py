"""Shared contention timeline: the max-min-fair fluid event clock.

One memory pipe, many in-flight *spans*.  A span is a unit of work with a
full-speed duration (FLOPs at the owner's compute rate) and a byte volume;
while in flight it demands ``byts / duration`` bytes/s.  At every event —
a span starting, a span finishing, a timer firing — bandwidth is
re-allocated max-min fair across whatever is in flight, and each span's
progress is integrated at ``min(1, alloc / demand)`` of full speed until
the next event.  Spans therefore *stretch* under contention exactly as in
the paper's fluid model (§4): the queueing effect of Fig. 3(b) falls out
of the allocation, not out of any per-consumer modelling.

The span lifecycle: ``start()`` puts a span in flight *now*; between
events it progresses at ``min(1, alloc / demand)`` of full speed; when its
remaining full-speed seconds hit zero the clock advances to that instant,
stamps ``t_end``, and fires ``on_complete(span, now)`` — which typically
issues the next span, which the next re-allocation picks up.  Time only
moves inside ``step()``; callbacks never see a half-advanced clock.

This module is the single timing substrate for every evaluation path
(each path once had its own loop; they are one clock now, which is
what makes simulated and live numbers directly comparable):

  * ``core.shaping_sim.simulate`` / ``simulate_tasks`` — the paper's
    Fig. 4/5/6 simulator — drive per-partition task chains over one
    timeline via ``run_chain`` (each task-completion callback starts the
    next task);
  * ``serving.scheduler.EventScheduler`` — the live in-process serving
    clock — issues each partition's prefill/decode op as an independent
    span, so a partition finishes its decode step and immediately starts
    the next while a neighbour is still mid-prefill;
  * ``serving.cluster.ClusterController`` — the multi-process cluster —
    puts each worker's ``OpIssued`` reply in flight as a span on ITS
    timeline, so virtual time is transport-invariant (a multiprocessing
    run reproduces the loopback run bit-for-bit).

The recorded observable is ``bw_samples``: piecewise-constant
(t_start, t_end, aggregate allocated bytes/s) segments between events,
resampled into fixed windows by ``bin_bw_samples`` for the mean/std
shaping metrics (the paper's Fig. 1/5 curves).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

# Epsilons shared with the pre-refactor loops in ``core.shaping_sim`` (the
# equivalence tests pin bit-comparable traces, so these are load-bearing).
_EPS_DONE = 1e-12   # remaining work below this completes the span
_EPS_TIME = 1e-15   # minimum event step / timer-due slack
_EPS_SPEED = 1e-12  # progress rates below this stall (infinite finish time)


def maxmin_fair(demands: np.ndarray, cap: float) -> np.ndarray:
    """Max-min fair allocation of ``cap`` among flows wanting ``demands``.

    Progressive filling: every unsatisfied flow receives an equal share of
    the remaining capacity; flows whose demand is met leave the active set
    and their leftover is redistributed, until either every demand is
    satisfied or the pipe is exhausted.  The result has the two defining
    properties (property-tested in ``tests/test_timeline.py``):

      * no flow receives more than it asked for, and when total demand
        exceeds ``cap`` the full capacity is handed out;
      * the *binding* flows (those not fully satisfied) all receive the
        same allocation, and it is >= every satisfied flow's demand — no
        starved flow while a greedier one gets more.

    This is the paper's §4 contention model: memory-bound phases are
    exactly the flows that end up binding, and the queueing of Fig. 3(b)
    falls out of the allocation with no per-consumer modelling.  Flows
    with zero demand are left at zero (pure-compute spans run at full
    speed regardless of the pipe)."""
    alloc = np.zeros_like(demands)
    active = demands > 0
    remaining = cap
    while active.any() and remaining > 1e-9:
        share = remaining / active.sum()
        sat = active & (demands - alloc <= share + 1e-18)
        if sat.any():
            grant = (demands - alloc)[sat]
            alloc[sat] += grant
            remaining -= grant.sum()
            active &= ~sat
        else:
            alloc[active] += share
            remaining = 0.0
    return alloc


def bin_bw_samples(bw_samples, t_end: float, window: float):
    """Resample (t_start, t_end, bytes/s) segments into fixed windows.

    Each segment contributes to a window proportionally to the time it
    overlaps it (a segment fully inside a window adds ``v * seg/window``),
    so the result is the time-weighted average bandwidth per window —
    the Fig. 1/5 observable.  Returns ``(edges, bw_per_window)``."""
    edges = np.arange(0.0, t_end + window, window)
    bw_win = np.zeros(max(len(edges) - 1, 1))
    for (a, bnd, v) in bw_samples:
        i0 = min(int(a / window), len(bw_win) - 1)
        i1 = min(int(bnd / window), len(bw_win) - 1)
        if i0 == i1:
            bw_win[i0] += v * (bnd - a) / window
        else:
            bw_win[i0] += v * ((i0 + 1) * window - a) / window
            for i in range(i0 + 1, i1):
                bw_win[i] += v
            bw_win[i1] += v * (bnd - i1 * window) / window
    return edges, bw_win


@dataclass
class Span:
    """One in-flight unit of work on the shared pipe.

    ``duration`` is the op's length at FULL compute speed (FLOPs at the
    owner's rate); ``byts`` the bytes it must move while running.  While
    in flight the span demands ``byts / duration`` bytes/s; if the
    allocator grants less, the span runs at ``alloc / demand`` of full
    speed and its wall (virtual) length stretches — ``t_end - t_start >=
    duration`` always, with equality only when never constrained.  A span
    is the unit both evaluation paths share: a CNN layer task in the
    simulator, a prefill/decode op in the live scheduler."""
    duration: float                 # seconds at full compute speed
    byts: float                     # bytes to move while running
    key: object = None              # caller tag (partition id, op kind, ...)
    on_complete: Optional[Callable[["Span", float], None]] = None
    t_start: float = 0.0
    t_end: float = 0.0              # filled at completion
    rem: float = 0.0                # remaining full-speed seconds
    alloc: float = 0.0              # bytes/s granted in the current segment
    bound: bool = False             # ever in the max-min binding set
                                    # (only maintained while tracing)

    @property
    def bytes_done(self) -> float:
        """Bytes moved so far (full volume once complete) — what a
        cancellation forfeits."""
        return self.byts * (1.0 - self.rem / max(self.duration, 1e-15))

    @property
    def demand(self) -> float:      # bytes/s wanted when compute-bound
        return self.byts / max(self.duration, 1e-15)


class ContentionTimeline:
    """Event-driven fluid clock over one bandwidth pipe.

    ``start()`` puts a span in flight at the current time; ``call_at()``
    schedules a callback (used for stagger offsets and policy release
    timers).  ``step()`` advances to the next event; ``run()`` drives the
    clock until idle, a deadline, or a caller predicate.  Completion
    callbacks run *after* the clock has advanced to the completion instant
    and may start new spans or timers — re-allocation picks them up at the
    next step.
    """

    def __init__(self, bandwidth: float):
        self.bandwidth = float(bandwidth)
        self.now = 0.0
        self.spans: List[Span] = []                  # in flight, start order
        self.bw_samples: List[Tuple[float, float, float]] = []
        self._timers: List[Tuple[float, int, Callable[[float], None]]] = []
        self._seq = 0
        self.n_completed = 0
        # cancellation cost accounting (failover observability): bytes the
        # pipe moved for spans that never completed — kept unconditionally,
        # the tracer additionally gets per-span ``cancelled`` events
        self.n_cancelled = 0
        self.cancelled_bytes = 0.0
        # observability is strictly opt-in: every emission site below is
        # guarded by ``if self.tracer is not None`` so the off path runs
        # no tracing code at all (pinned by tests/test_obs.py)
        self.tracer = None

    def attach_tracer(self, tracer) -> None:
        """Bind a tracer to this clock: span lifecycle events land on the
        'spans' track group and the tracer's ``vnow`` follows ``now``."""
        self.tracer = tracer
        tracer.clock = self

    @staticmethod
    def _track(key) -> Tuple[str, str]:
        """(track id, slice name) for a span key — the repo convention is
        ``(partition_or_worker_id, op_kind)`` tuples.  Each (owner, kind)
        pair gets its own track so differently-named spans never overlap
        on one track (keeps begin/end strictly stack-paired; same-kind
        overlap — e.g. two concurrent handoffs — pairs by name)."""
        if isinstance(key, tuple) and len(key) == 2:
            return f"{key[0]}.{key[1]}", str(key[1])
        return ("0" if key is None else str(key)), "span"

    # -- issue ---------------------------------------------------------------
    def start(self, duration: float, byts: float, *, key: object = None,
              on_complete: Optional[Callable] = None) -> Span:
        """Put a span in flight starting now."""
        sp = Span(duration=float(duration), byts=float(byts), key=key,
                  on_complete=on_complete, t_start=self.now,
                  rem=float(duration))
        self.spans.append(sp)
        if self.tracer is not None:
            tid, name = self._track(key)
            self.tracer.begin("spans", tid, name, self.now, bytes=sp.byts,
                              duration=sp.duration, demand=sp.demand)
        return sp

    def call_at(self, t: float, fn: Callable[[float], None]) -> None:
        """Schedule ``fn(now)`` at absolute time ``t`` (>= now)."""
        heapq.heappush(self._timers, (float(t), self._seq, fn))
        self._seq += 1

    def cancel(self, sp: Span) -> bool:
        """Take an in-flight span off the clock without completing it (its
        ``on_complete`` never fires).  Used by the cluster controller when
        a worker dies mid-op: the work it was doing will never commit, so
        it must stop contending for bandwidth.  Bandwidth it consumed in
        already-recorded segments stays recorded (it really was moving
        bytes until the failure).  The forfeited progress is accounted in
        ``n_cancelled`` / ``cancelled_bytes`` and, when tracing, emitted
        as a ``cancelled`` instant carrying bytes-completed — failover
        cost is measurable, not silently dropped.  Returns True when the
        span was in flight."""
        try:
            self.spans.remove(sp)
        except ValueError:
            return False
        self.n_cancelled += 1
        self.cancelled_bytes += sp.bytes_done
        if self.tracer is not None:
            tid, name = self._track(sp.key)
            self.tracer.end("spans", tid, name, self.now, cancelled=True,
                            bytes_done=sp.bytes_done)
            self.tracer.instant("spans", tid, "cancelled", self.now,
                                op=name, bytes=sp.byts,
                                bytes_done=sp.bytes_done)
        return True

    @property
    def idle(self) -> bool:
        return not self.spans and not self._timers

    # -- advance -------------------------------------------------------------
    def _fire_due(self) -> None:
        while self._timers and self._timers[0][0] <= self.now + _EPS_TIME:
            _, _, fn = heapq.heappop(self._timers)
            fn(self.now)

    def step(self) -> bool:
        """Advance to the next event; returns False when nothing is left.

        One step = one piecewise-constant segment of the fluid model:
        (1) fire timers due *now* (they may start spans); (2) allocate the
        pipe max-min fair over the in-flight demands; (3) find the nearest
        future event — the earliest span completion at current speeds or
        the earliest pending timer; (4) integrate every span's progress at
        its granted speed up to that instant, record the aggregate
        allocated bandwidth segment in ``bw_samples``, and deliver the
        completions.  Demands are re-evaluated from scratch every step, so
        anything a callback started is picked up by the next allocation."""
        self._fire_due()
        if self.idle:
            return False
        demands = np.array([sp.demand for sp in self.spans])
        alloc = maxmin_fair(demands, self.bandwidth)
        dt_candidates = []
        for sp, d, a in zip(self.spans, demands, alloc):
            speed = min(1.0, a / d) if d > 0 else 1.0
            sp.alloc = float(a)
            sp._speed = speed
            if speed > _EPS_SPEED:
                dt_candidates.append(sp.rem / speed)
            else:
                dt_candidates.append(np.inf)
        for (t_fire, _, _) in self._timers:
            dt_candidates.append(t_fire - self.now)
        dt = max(min(dt_candidates), _EPS_TIME)

        self.bw_samples.append((self.now, self.now + dt, float(alloc.sum())))
        if self.tracer is not None:
            # one counter sample per fluid segment: the aggregate demand
            # curve is the live Fig. 6 observable, allocated bw shows the
            # pipe clipping it, and ``bound`` counts the max-min binding
            # set (spans running below full speed)
            n_bound = 0
            for sp in self.spans:
                if sp._speed < 1.0 - _EPS_SPEED:
                    sp.bound = True
                    n_bound += 1
            self.tracer.counter("spans", 0, "bw", self.now,
                                demand=float(demands.sum()),
                                alloc=float(alloc.sum()),
                                inflight=len(self.spans), bound=n_bound)
        self.now += dt
        still, done = [], []
        for sp in self.spans:
            sp.rem -= dt * sp._speed
            (done if sp.rem <= _EPS_DONE else still).append(sp)
        self.spans = still
        for sp in done:
            sp.t_end = self.now
            self.n_completed += 1
            if self.tracer is not None:
                tid, name = self._track(sp.key)
                self.tracer.end(
                    "spans", tid, name, self.now, bytes=sp.byts,
                    stretch=(self.now - sp.t_start)
                    / max(sp.duration, _EPS_TIME), bound=sp.bound)
            if sp.on_complete is not None:
                sp.on_complete(sp, self.now)
        return True

    def run(self, *, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None,
            max_events: Optional[int] = None) -> float:
        """Drive until idle / ``until`` / ``stop()`` / ``max_events``."""
        n = 0
        while True:
            if until is not None and self.now >= until:
                break
            if stop is not None and stop():
                break
            if not self.step():
                break
            n += 1
            if max_events is not None and n >= max_events:
                break
        return self.now

    # -- chained task lists (the simulator's partition model) ---------------
    def run_chain(self, tasks, *, offset: float = 0.0, key: object = None,
                  on_task_done: Optional[Callable] = None) -> None:
        """Run ``tasks`` (objects with .dur/.byts) sequentially as spans,
        starting after ``offset`` seconds — the simulator's partition
        model: one partition = one chain, its stagger = the offset, each
        completion callback starting the next task so the chain is always
        exactly one span deep.  ``on_task_done(i, t)`` fires as each task
        completes (pass/tasklist bookkeeping for the wrappers in
        ``core.shaping_sim``)."""
        tasks = list(tasks)
        if not tasks:
            return

        def _start(i: int) -> None:
            def _done(_sp: Span, t: float) -> None:
                if on_task_done is not None:
                    on_task_done(i, t)
                if i + 1 < len(tasks):
                    _start(i + 1)
            self.start(tasks[i].dur, tasks[i].byts, key=key,
                       on_complete=_done)

        self.call_at(self.now + offset, lambda _t: _start(0))

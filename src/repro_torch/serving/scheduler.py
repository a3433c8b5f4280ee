"""Phase-staggered scheduling: P partition engines, one memory pipe,
two virtual clocks.

The serving transfer of the paper's core idea: prefill is compute-bound and
decode is bandwidth-bound (the conv-vs-BN fluctuation of §2), so *which
partitions prefill at the same instant* determines how spiky the aggregate
HBM demand is.  The scheduler decides which engines may start a prefill
wave; engines with active slots always take a decode step (continuous
batching never stalls admitted work).

Stagger policies (shared by both clocks):
  none    — every drained engine prefills immediately.  All partitions
            phase-align (the paper's synchronous baseline): demand swings
            between all-prefill and all-decode.
  uniform — prefills are serialized round-robin over partitions: the
            static analogue of the paper's uniform offsets (one grant per
            tick under lockstep; at most one prefill in flight under the
            event clock).
  demand  — model-driven stagger: successive prefill-wave starts are
            spaced at least ``max(prefill_duration, wave_time / P)`` apart
            on the virtual clock, both terms priced from each engine's
            ``CostModel`` (``repro_torch.profiling``): the analytic per-phase
            bytes/FLOPs estimates by default, on-device measured durations
            when a ``MeasuredCostModel`` is attached (``--cost-model
            measured``).  Spacing by the prefill duration means
            two partitions are never in the compute-bound phase at the
            same instant; spacing by ``wave_time / P`` spreads the wave
            starts across the whole wave period when prefill is short —
            the dynamic counterpart of the anti-correlated static offsets
            in ``core.schedule`` / ``serving.trace_sim``.

The two clocks:

``PhaseStaggeredScheduler`` (clock="lockstep") — one tick = every acting
engine performs one phase op; the virtual clock advances by the slowest op
in the tick (lockstep fleet, as on real partitioned hardware between sync
points).  Lockstep quantizes time — a long prefill op stretches that tick
for every decoding partition — so staggered policies under-report virtual
throughput.  It is kept as the regression oracle: simple, deterministic,
and the behaviour every pre-event-clock result was measured on.

``EventScheduler`` (clock="event") — each partition's op is an independent
in-flight span on the shared ``core.timeline.ContentionTimeline``: a
partition finishes its decode step and immediately starts the next while a
neighbour is still mid-prefill.  Bandwidth is re-allocated max-min fair at
every op boundary and op durations stretch under contention, so the
virtual clock has exactly the continuous-overlap semantics of the fluid
simulator (``core.shaping_sim`` / ``serving.trace_sim``) — the timing
ground truth the shaping claim is judged on, now measured live.  With one
partition and an uncontended pipe the two clocks agree exactly (pinned by
tests); with staggered fleets the event clock closes the lockstep
throughput under-report.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import hw
from repro_torch.core.timeline import ContentionTimeline, Span, maxmin_fair
from repro_torch.serving.engine import PendingOp
from repro_torch.serving.metrics import ServingMetrics, achieved_bw_stats
from repro_torch.serving.queue import RequestQueue

POLICIES = ("none", "uniform", "demand")
CLOCKS = ("lockstep", "event")


def _top_up_backlogs(engines: List, queue: RequestQueue) -> None:
    """Top every engine's backlog up to one wave (``slots`` requests):
    busy engines then refill finished slots continuously; drained ones
    have a full prefill wave ready when the policy grants it."""
    for eng in engines:
        need = eng.slots - len(eng.backlog)
        if need > 0 and len(queue):
            eng.assign(queue.pop(need))


def _demand_spacing(engine, n_engines: int) -> float:
    """The demand policy's wave-start spacing, priced from the engine's
    cost model (analytic by default, measured when one is attached):
    ``max(prefill_duration, wave_time / P)`` (shared by both clocks so
    they gate on the identical quantity).  ``prefill_cost_est`` prices the
    next wave as it would actually run — under a prefix cache a resident
    shared prefix shrinks the estimate to the divergent tail, so hits
    (which remove compute-bound phase time from the schedule) tighten the
    spacing instead of leaving the rule pacing against phantom prefills."""
    pre = engine.prefill_cost_est()
    gen_est = engine.backlog[0].max_new_tokens
    wave = pre.duration + gen_est * engine.decode_cost_est().duration
    return max(pre.duration, wave / max(n_engines, 1))


def _drain_completed(engines: List, queue: RequestQueue,
                     metrics: ServingMetrics) -> None:
    for e in engines:
        while e.completed:
            req = e.completed.pop(0)
            queue.mark_done(req)
            metrics.observe_request(req)


@dataclass
class TickRecord:
    t: float
    dt: float
    phases: Tuple[str, ...]   # per-engine: "prefill" | "decode" | "idle"
    demand: float             # aggregate unconstrained bytes/s


@dataclass
class PhaseStaggeredScheduler:
    engines: List
    queue: RequestQueue
    policy: str = "demand"
    bandwidth: float = hw.H100_HBM_BW
    metrics: ServingMetrics = field(default_factory=ServingMetrics)
    trace: List[TickRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self._now = 0.0
        self._rr = 0  # round-robin cursor for the uniform policy
        self._last_wave_start = -float("inf")  # demand-policy spacing state

    # -- dispatch: keep engine backlogs fed from the global queue -----------
    def _dispatch(self) -> None:
        _top_up_backlogs(self.engines, self.queue)

    # -- policy: which drained engines may start a prefill wave -------------
    def _grant_prefills(self) -> List:
        cand = [e for e in self.engines if e.wants_prefill]
        if not cand:
            return []
        if self.policy == "none":
            return cand
        if self.policy == "uniform":
            # one grant per tick, round-robin so waves spread out in time
            order = sorted(cand, key=lambda e:
                           (e.pid - self._rr) % len(self.engines))
            self._rr = (order[0].pid + 1) % len(self.engines)
            return order[:1]
        # demand: analytic wave-start spacing (one prefill in flight, wave
        # starts spread over the wave period)
        cand.sort(key=lambda e: e.backlog[0].arrival)  # FIFO urgency
        e = cand[0]
        spacing = _demand_spacing(e, len(self.engines))
        if self._now - self._last_wave_start >= spacing * (1 - 1e-9):
            self._last_wave_start = self._now
            return [e]
        return []

    # -- one lockstep tick ---------------------------------------------------
    def step(self) -> bool:
        """Run one tick; returns False when no engine had work."""
        self._dispatch()
        grants = set(id(e) for e in self._grant_prefills())
        ops = []  # (engine, phase)
        for e in self.engines:
            if id(e) in grants:
                ops.append((e, "prefill"))
            elif e.busy:
                ops.append((e, "decode"))
        if not ops:
            # forward progress: nothing is running, so spacing-blocked
            # prefill candidates may start (the fleet would otherwise stall)
            waiting = [e for e in self.engines if e.wants_prefill]
            if not waiting:
                return False
            e = min(waiting, key=lambda e: e.backlog[0].arrival)
            if self.policy == "demand":
                # spacing state belongs to the demand policy alone; other
                # policies must not be coupled to it through the fallback
                self._last_wave_start = self._now
            ops = [(e, "prefill")]

        costs, phases = [], []
        for e in self.engines:
            phase = next((ph for eng, ph in ops if eng is e), "idle")
            phases.append(phase)
            if phase == "prefill":
                costs.append(e.prefill_wave(self._now))
            elif phase == "decode":
                costs.append(e.decode_step(self._now))
        # virtual clock: the same fluid model as core.shaping_sim — when the
        # tick's aggregate demand exceeds the pipe, max-min fair allocation
        # stretches the over-demanding ops' durations
        demands = np.array([c.demand for c in costs])
        alloc = maxmin_fair(demands.copy(), self.bandwidth)
        slow = np.where(demands > 0, np.minimum(1.0, alloc
                                                / np.maximum(demands, 1e-15)),
                        1.0)
        dt = max(c.duration / max(s, 1e-15)
                 for c, s in zip(costs, slow))
        demand = float(demands.sum())
        self.trace.append(TickRecord(self._now, dt, tuple(phases), demand))
        self.metrics.observe_tick(self._now, dt, demand)
        self._now += dt
        self._harvest()
        return True

    def _harvest(self) -> None:
        _drain_completed(self.engines, self.queue, self.metrics)

    def run(self, max_ticks: Optional[int] = None) -> ServingMetrics:
        """Drive until the queue and every engine drain (or ``max_ticks``)."""
        t0 = time.perf_counter()
        ticks = 0
        while self.step():
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        self.metrics.wall_seconds = time.perf_counter() - t0
        self.metrics.virtual_seconds = self._now
        return self.metrics


# ---------------------------------------------------------------------------
# event clock: ops as independent in-flight spans on one contention timeline
# ---------------------------------------------------------------------------


@dataclass
class SpanRecord:
    """One committed op on the event clock (the per-span trace)."""
    t0: float
    t1: float                 # contention-stretched completion instant
    pid: int
    phase: str                # "prefill" | "decode" | "refill"
    demand: float             # unconstrained bytes/s while in flight


class EventScheduler:
    """Event-driven serving scheduler on the shared contention timeline.

    Each partition runs its own op chain: issue an op (device execution is
    eager), put its (duration, bytes) in flight as a timeline span, and on
    the span's completion event commit the op (stamp tokens, retire, refill)
    and immediately issue the next.  Partitions therefore overlap exactly
    as in the fluid model — no lockstep tick quantization.  The stagger
    policies gate *prefill starts* as op-completion callbacks:

      none    — drained engines prefill the moment they have backlog;
      uniform — at most one prefill span in flight, granted round-robin
                over waiting partitions as prefills complete;
      demand  — wave starts spaced ``max(prefill_dur, wave_time / P)``
                apart on the event clock (a release timer re-pumps the
                fleet when the spacing window opens), with at most one
                prefill in flight — the compute-bound phases of two
                partitions never overlap.

    Refill prefills discovered at op commit (a slot freed mid-wave) run as
    follow-on spans before the partition's next op, mirroring the lockstep
    clock's sequential refill billing.
    """

    def __init__(self, engines: List, queue: RequestQueue,
                 policy: str = "demand", bandwidth: float = hw.H100_HBM_BW,
                 metrics: Optional[ServingMetrics] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.engines = list(engines)
        self.queue = queue
        self.policy = policy
        self.bandwidth = float(bandwidth)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.timeline = ContentionTimeline(bandwidth)
        self.trace: List[SpanRecord] = []
        self._inflight: Dict[int, Span] = {}   # id(engine) -> span
        self._rr = 0                           # uniform round-robin cursor
        self._last_wave_start = -float("inf")  # demand-policy spacing state
        self._prefill_live = 0                 # prefill spans in flight
        self._spacing_timer = False            # demand release timer armed
        # opt-in observability: policy decisions (spacing holds/releases,
        # wave grants) as instants on the 'policy' track; every emission
        # site is guarded so the off path runs no tracing code
        self.tracer = None

    def attach_tracer(self, tracer) -> None:
        """Wire one tracer through the whole in-process stack: the
        timeline (span begin/end + the bw counter track), the queue
        (admission instants), every engine (request lifecycles), and this
        scheduler's policy decisions.  The tracer's clock becomes the
        shared contention timeline."""
        self.tracer = tracer
        self.timeline.attach_tracer(tracer)
        self.queue.tracer = tracer
        for e in self.engines:
            e.tracer = tracer

    # -- dispatch: keep engine backlogs fed from the global queue -----------
    def _dispatch(self) -> None:
        _top_up_backlogs(self.engines, self.queue)

    # -- policy gates --------------------------------------------------------
    def _demand_clear(self, e, now: float) -> bool:
        """Demand spacing on the event clock; arms a release timer when the
        window is still closed so the fleet re-pumps exactly on time."""
        spacing = _demand_spacing(e, len(self.engines))
        if now - self._last_wave_start >= spacing * (1 - 1e-9):
            return True
        if not self._spacing_timer:
            self._spacing_timer = True

            def _release(t: float) -> None:
                self._spacing_timer = False
                if self.tracer is not None:
                    self.tracer.instant("policy", 0, "spacing_release", t)
                self._pump(t)

            self.timeline.call_at(self._last_wave_start + spacing, _release)
            if self.tracer is not None:
                self.tracer.instant("policy", 0, "spacing_hold", now,
                                    pid=e.pid, spacing=spacing,
                                    open_at=self._last_wave_start + spacing)
        return False

    # -- op issue / completion ----------------------------------------------
    def _issue(self, e, kind: str, now: float) -> None:
        pend = e.issue_prefill() if kind == "prefill" else e.issue_decode()
        if kind == "prefill":
            self._prefill_live += 1
        sp = self.timeline.start(
            pend.cost.duration, pend.cost.byts, key=(e.pid, kind),
            on_complete=lambda sp, t, e=e, pend=pend:
                self._complete(e, pend, sp, t))
        self._inflight[id(e)] = sp

    def _complete(self, e, pend: PendingOp, sp: Span, t: float) -> None:
        del self._inflight[id(e)]
        if pend.kind == "prefill":
            self._prefill_live -= 1
        extra = e.commit_op(pend, t)
        self._record(sp.t_start, t, e.pid, pend.kind, pend.cost.demand)
        self._harvest()
        if extra is not None:
            # slot-refill prefills run sequentially after the op that freed
            # the slots, before this partition's next op (as under lockstep)
            sp2 = self.timeline.start(
                extra.duration, extra.byts, key=(e.pid, "refill"),
                on_complete=lambda sp2, t2, e=e, extra=extra:
                    self._refill_done(e, extra, sp2, t2))
            self._inflight[id(e)] = sp2
        self._pump(t)

    def _refill_done(self, e, extra, sp: Span, t: float) -> None:
        del self._inflight[id(e)]
        self._record(sp.t_start, t, e.pid, "refill", extra.demand)
        self._harvest()
        self._pump(t)

    def _record(self, t0: float, t1: float, pid: int, phase: str,
                demand: float) -> None:
        self.trace.append(SpanRecord(t0, t1, pid, phase, demand))
        self.metrics.observe_span(t0, t1 - t0, demand)

    def _harvest(self) -> None:
        _drain_completed(self.engines, self.queue, self.metrics)

    # -- the pump: start every op the policies currently allow --------------
    def _pump(self, now: float) -> None:
        self._dispatch()
        for e in self.engines:   # decode is never policy-gated
            if id(e) not in self._inflight and e.busy:
                self._issue(e, "decode", now)
        cand = [e for e in self.engines
                if id(e) not in self._inflight and e.wants_prefill]
        if not cand:
            return
        if self.policy == "uniform":
            cand.sort(key=lambda e: (e.pid - self._rr) % len(self.engines))
        else:
            cand.sort(key=lambda e: e.backlog[0].arrival)  # FIFO urgency
        for e in cand:
            if self.policy != "none" and self._prefill_live > 0:
                if self.tracer is not None:
                    self.tracer.instant("policy", 0, "stagger_hold", now,
                                        pid=e.pid,
                                        live_prefills=self._prefill_live)
                break  # serialized: retried when the live prefill commits
            if self.policy == "demand" and not self._demand_clear(e, now):
                break  # retried when the release timer fires
            if self.policy == "uniform":
                self._rr = (e.pid + 1) % len(self.engines)
            if self.policy == "demand":
                self._last_wave_start = now
            if self.tracer is not None:
                self.tracer.instant("policy", 0, "wave_grant", now,
                                    pid=e.pid, policy=self.policy)
            self._issue(e, "prefill", now)

    def run(self, max_spans: Optional[int] = None) -> ServingMetrics:
        """Drive until the queue and every engine drain (or ``max_spans``
        timeline events)."""
        t0 = time.perf_counter()
        self._pump(self.timeline.now)
        self.timeline.run(max_events=max_spans)
        self.metrics.wall_seconds = time.perf_counter() - t0
        self.metrics.virtual_seconds = self.timeline.now
        return self.metrics

    def achieved_bw_stats(self, *, window: Optional[float] = None,
                          trim: float = 0.0) -> Tuple[float, float]:
        """(mean, std) of the ALLOCATED aggregate bandwidth over fixed
        windows — the exact observable of ``core.shaping_sim`` (Fig. 5),
        measured on the live clock.  ``trim`` drops windows within that
        many seconds of both ends (warmup/cooldown exclusion); degenerate
        traces (empty, zero-length, or fully swallowed by the trim) report
        empty-trace stats (0, 0) — see ``metrics.achieved_bw_stats``."""
        return achieved_bw_stats(self.timeline.bw_samples, self.timeline.now,
                                 window=window, trim=trim)


def make_scheduler(engines: List, queue: RequestQueue, *,
                   policy: str = "demand", bandwidth: float = hw.H100_HBM_BW,
                   clock: str = "event"):
    """One entry point for both virtual clocks (the ``--clock`` axis).
    Defaults to the event clock, like the serve CLI; pass
    ``clock="lockstep"`` for the legacy tick-quantized regression oracle."""
    if clock not in CLOCKS:
        raise ValueError(f"clock must be one of {CLOCKS}")
    cls = PhaseStaggeredScheduler if clock == "lockstep" else EventScheduler
    return cls(engines, queue, policy=policy, bandwidth=bandwidth)

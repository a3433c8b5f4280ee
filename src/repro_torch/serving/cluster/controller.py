"""Cluster controller: the RequestQueue + routing policies + failure
handling over any transport.

The controller is the ``EventScheduler`` control flow lifted onto the
message protocol: it hosts the global ``RequestQueue``, mirrors every
worker through the ``WorkerStatus`` snapshots piggybacked on replies, and
drives the shared ``core.timeline.ContentionTimeline`` — each granted op
comes back as an ``OpIssued`` span (FLOPs-duration + bytes) that goes in
flight on the one contention clock, and the span's completion event sends
the ``CommitOp`` that stamps tokens / retires requests worker-side.  Virtual
time therefore has exactly the fluid-model semantics of the in-process
fleet; over the loopback transport the decision sequence (and the metrics)
is identical, which the equivalence tests pin.

Routing policies (the pluggable placement + prefill-grant rule):

  round_robin      — top each worker's backlog up to one wave in wid order
                     (the in-process dispatch order); every drained worker
                     prefills immediately.  The cluster's phase-aligned
                     baseline: loopback round_robin == EventScheduler
                     policy='none' exactly.
  shortest_backlog — join-shortest-backlog placement: each queued request
                     goes to the worker with the least outstanding work
                     (backlog + active slots); prefills ungated.
  shaping          — the demand-aware stagger router: placement as
                     round_robin, but successive prefill-wave starts
                     cluster-wide are spaced ``max(prefill_dur,
                     wave_time / P)`` apart on the virtual clock (the
                     ``PhaseCost`` spacing rule, priced worker-side), with
                     at most one prefill in flight — prefill bursts stay
                     staggered across the whole cluster.  Loopback shaping
                     == EventScheduler policy='demand' exactly.
  pd               — prefill/decode disaggregation
                     (``repro_torch.serving.pd.PdRouter``): the fleet splits
                     into a prefill pool and a decode pool, completed
                     prefills migrate between them as ``KvHandoff``
                     payloads priced on the shared contention clock, and
                     phases overlap by construction instead of by
                     stagger.  See ``docs/pd_disaggregation.md``.

Routers may additionally implement optional hooks the controller calls
with ``getattr`` fallbacks (so pre-existing custom routers keep working):
``decode_candidates(ctl)`` restricts which views get the otherwise
never-gated decode issue; ``unserved(ctl)`` counts requests the router
holds in limbo (e.g. a KV handoff on the wire) so ``run()`` does not
mistake them for a drained cluster; ``on_worker_died(ctl, view, now)``
observes failovers; ``on_worker_joined(ctl, view, now)`` /
``on_worker_left(ctl, view, now)`` observe elastic membership changes
(``join_worker`` / ``drain_worker``) so stateful routers — the PD pool
split — rebalance when the fleet grows or shrinks.

Failure handling: a worker that crashes (pipe EOF), hangs past the
transport's heartbeat timeout, or is ``kill()``-ed mid-run is marked dead
at the failing RPC; its in-flight span is cancelled off the clock and every
unfinished request it held is re-queued at the FRONT of the queue with its
original ``arrival`` and ``deadline`` intact (generated tokens and
first-token stamps reset — the request restarts, TTFT stays billed from
the original arrival).  Surviving workers drain the re-queued work; the
run completes with no lost requests as long as one worker lives.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.timeline import ContentionTimeline, Span
from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.cluster.transport import WorkerGone
from repro_torch.serving.metrics import ServingMetrics, achieved_bw_stats
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import SpanRecord


class ClusterError(RuntimeError):
    """A worker reported an engine error (not recoverable by failover)."""


class WorkerView:
    """The controller's mirror of one worker: identity from ``Hello``,
    predicates from the last ``WorkerStatus``, the in-flight span, and the
    canonical ``Request`` objects currently owned by the worker."""

    def __init__(self, hello: P.Hello):
        self.wid = hello.wid
        self.slots = hello.slots
        self.max_len = hello.max_len
        self.status = hello.status
        self.alive = True
        # elastic scale-down: a draining worker takes no NEW placements but
        # finishes everything it holds, then leaves via Shutdown -> Bye
        self.draining = False
        self.span: Optional[Span] = None
        self.outstanding: Dict[int, Request] = {}


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


class RoundRobinRouter:
    """Top-up placement in wid order, ungated prefills (phase-aligned)."""

    name = "round_robin"

    def place(self, ctl: "ClusterController", now: float) -> None:
        # the in-process dispatch rule (_top_up_backlogs): keep every
        # worker's backlog topped up to one wave, in wid order
        for v in ctl.views_placeable():
            need = v.slots - v.status.backlog_len
            if need > 0 and len(ctl.queue):
                ctl.assign(v, ctl.queue.pop(need), now)

    def grant(self, ctl: "ClusterController", cand: List[WorkerView],
              now: float) -> None:
        for v in sorted(cand, key=lambda v: v.status.head_arrival):
            if v.alive and v.span is None:
                ctl.issue(v, "prefill", now)


class ShortestBacklogRouter(RoundRobinRouter):
    """Join-shortest-backlog placement: each request goes to the worker
    with the least outstanding work (backlog + active slots), capped at one
    wave of backlog per worker; prefills stay ungated."""

    name = "shortest_backlog"

    def place(self, ctl: "ClusterController", now: float) -> None:
        views = ctl.views_placeable()
        if not views or not len(ctl.queue):
            return
        load = {v.wid: v.status.backlog_len + v.status.n_active
                for v in views}
        depth = {v.wid: v.status.backlog_len for v in views}
        plan: Dict[int, List[Request]] = {v.wid: [] for v in views}
        while len(ctl.queue):
            open_views = [v for v in views if depth[v.wid] < v.slots]
            if not open_views:
                break
            v = min(open_views, key=lambda v: (load[v.wid], v.wid))
            plan[v.wid].extend(ctl.queue.pop(1))
            load[v.wid] += 1
            depth[v.wid] += 1
        for v in views:
            if plan[v.wid]:
                ctl.assign(v, plan[v.wid], now)


class ShapingRouter(RoundRobinRouter):
    """Demand-aware stagger: cluster-wide prefill-wave starts spaced
    ``max(prefill_dur, wave_time / P)`` apart (the ``PhaseCost`` spacing
    rule, ingredients priced worker-side), at most one prefill in flight.
    A release timer on the shared clock re-pumps the cluster the instant
    the spacing window opens."""

    name = "shaping"

    def __init__(self):
        self.last_wave_start = -float("inf")
        self._timer_armed = False

    def grant(self, ctl: "ClusterController", cand: List[WorkerView],
              now: float) -> None:
        for v in sorted(cand, key=lambda v: v.status.head_arrival):
            if ctl.prefill_live > 0:
                break  # serialized: retried when the live prefill commits
            if not self._clear(ctl, v, now):
                break  # retried when the release timer fires
            if not (v.alive and v.span is None):
                continue
            self.last_wave_start = now
            ctl.issue(v, "prefill", now)

    def _clear(self, ctl: "ClusterController", v: WorkerView,
               now: float) -> bool:
        spacing = max(v.status.pre_dur,
                      v.status.wave_dur / max(ctl.n_alive, 1))
        if now - self.last_wave_start >= spacing * (1 - 1e-9):
            return True
        if not self._timer_armed:
            self._timer_armed = True

            def _release(t: float) -> None:
                self._timer_armed = False
                ctl.pump(t)

            ctl.timeline.call_at(self.last_wave_start + spacing, _release)
        return False


def _pd_router():
    # lazy: repro_torch.serving.pd imports the protocol module, which imports
    # the engine — resolving it here keeps the module graph acyclic
    from repro_torch.serving.pd.router import PdRouter
    return PdRouter()


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "shortest_backlog": ShortestBacklogRouter,
    "shaping": ShapingRouter,
    "pd": _pd_router,
}


def make_router(router):
    if isinstance(router, str):
        if router not in ROUTERS:
            raise ValueError(f"router must be one of {tuple(ROUTERS)}, "
                             f"got {router!r}")
        return ROUTERS[router]()
    return router


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class ClusterController:
    """Drive a worker fleet over a transport until the queue drains.

    Construction performs the handshake: every worker's ``Hello`` becomes a
    ``WorkerView``; workers that never come up are dead from the start.
    ``run()`` then pumps ops exactly like ``EventScheduler.run`` and closes
    the transport when the clock goes idle.
    """

    def __init__(self, transport, queue: RequestQueue, *,
                 router="shaping", bandwidth: float = hw.H100_HBM_BW,
                 metrics: Optional[ServingMetrics] = None,
                 startup_timeout: float = 120.0):
        self.transport = transport
        self.queue = queue
        self.router = make_router(router)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.timeline = ContentionTimeline(bandwidth)
        self.bandwidth = float(bandwidth)
        self.startup_timeout = float(startup_timeout)
        self.trace: List[SpanRecord] = []
        self.prefill_live = 0
        self.n_failovers = 0
        self.failed_workers: List[int] = []
        # elastic membership bookkeeping (join_worker / drain_worker)
        self.n_joins = 0
        self.n_departures = 0
        self.departed_workers: List[int] = []
        self._departed_status: List[P.WorkerStatus] = []
        # opt-in observability (repro_torch.obs): the controller records the
        # whole fleet's trace — worker engines keep tracer=None, so the
        # loopback and subprocess transports trace identically and no op
        # is double-counted.  Every site is guarded on `is not None`.
        self.tracer = None
        self._pumping = False
        self._repump = False
        self.views: Dict[int, WorkerView] = {}
        for wid in self.transport.workers():
            try:
                hello = self.transport.recv(wid, timeout=startup_timeout)
            except WorkerGone:
                continue  # never came up; no state to fail over
            if not isinstance(hello, P.Hello):
                raise ClusterError(f"worker {wid}: expected Hello, got "
                                   f"{type(hello).__name__}")
            self.views[hello.wid] = WorkerView(hello)
        if not self.views:
            raise ClusterError("no cluster worker completed the handshake")

    def attach_tracer(self, tracer) -> None:
        """Wire one tracer through the controller's clock and queue.  The
        timeline emits the span/counter events; the controller adds the
        protocol-level view (dispatch, handoffs, heartbeats, failovers)."""
        self.tracer = tracer
        self.timeline.attach_tracer(tracer)
        self.queue.tracer = tracer

    def fleet_registry(self):
        """Merge the freshest per-worker metrics snapshots (piggybacked on
        every ``WorkerStatus``) into one fleet-wide ``MetricsRegistry``.
        Only the LAST snapshot per worker counts — the snapshots are
        cumulative, so folding every reply would multiply-count."""
        from repro_torch.obs import merge_snapshots
        return merge_snapshots(
            [s.metrics for s in self._departed_status]
            + [v.status.metrics for v in self.views_in_order()])

    # -- mirrors -------------------------------------------------------------
    def views_in_order(self) -> List[WorkerView]:
        return [self.views[w] for w in sorted(self.views)]

    def views_alive(self) -> List[WorkerView]:
        return [v for v in self.views_in_order() if v.alive]

    def views_placeable(self) -> List[WorkerView]:
        """Alive views that accept NEW work (draining workers still decode
        and prefill their remaining backlog, but place nothing fresh)."""
        return [v for v in self.views_in_order()
                if v.alive and not v.draining]

    @property
    def n_alive(self) -> int:
        return sum(1 for v in self.views.values() if v.alive)

    # -- RPC: strict request/reply, death -> failover ------------------------
    def _rpc(self, v: WorkerView, msg, now: float):
        try:
            self.transport.send(v.wid, msg)
            reply = self.transport.recv(v.wid)
        except WorkerGone:
            self._worker_died(v, now)
            return None
        if isinstance(reply, P.WorkerError):
            raise ClusterError(
                f"worker {v.wid} failed: {reply.error}\n{reply.traceback}")
        v.status = reply.status
        return reply

    # -- dispatch / issue / commit ------------------------------------------
    def assign(self, v: WorkerView, reqs: List[Request], now: float) -> None:
        """Seat ``reqs`` in the worker's backlog.  The canonical Request
        objects stay controller-side (tracked for failover); wire copies
        cross the boundary."""
        for r in reqs:
            v.outstanding[r.rid] = r
        if self.tracer is not None:
            for r in reqs:
                self.tracer.instant("cluster", v.wid, "dispatch", now,
                                    rid=r.rid, wid=v.wid)
                self.tracer.lifecycle.event(r.rid, "dispatch", now,
                                            wid=v.wid)
        wire = tuple(P.WireRequest.from_request(r) for r in reqs)
        self._rpc(v, P.Assign(requests=wire), now)

    def issue(self, v: WorkerView, kind: str, now: float) -> None:
        rep = self._rpc(v, P.IssueOp(op=kind), now)
        if rep is None:
            return  # worker died at issue; failover already ran
        cost = rep.cost.to_cost()
        if kind == "prefill":
            self.prefill_live += 1
        sp = self.timeline.start(
            cost.duration, cost.byts, key=(v.wid, kind),
            on_complete=lambda sp, t, v=v, kind=kind, cost=cost:
                self._complete(v, kind, cost, sp, t))
        v.span = sp

    def _complete(self, v: WorkerView, kind: str, cost, sp: Span,
                  t: float) -> None:
        v.span = None
        if kind == "prefill":
            self.prefill_live -= 1
        rep = self._rpc(v, P.CommitOp(t_end=t), t)
        self._record(sp.t_start, t, v.wid, kind, cost.demand)
        if rep is None:
            return  # died at commit: its requests are back in the queue
        self._apply_retired(v, rep.retired)
        if rep.refill is not None:
            # slot-refill prefills run sequentially after the op that freed
            # the slots, before this worker's next op (engine semantics)
            rc = rep.refill.to_cost()
            sp2 = self.timeline.start(
                rc.duration, rc.byts, key=(v.wid, "refill"),
                on_complete=lambda sp2, t2, v=v, rc=rc:
                    self._refill_done(v, rc, sp2, t2))
            v.span = sp2
        self.pump(t)

    def _refill_done(self, v: WorkerView, rc, sp: Span, t: float) -> None:
        v.span = None
        self._record(sp.t_start, t, v.wid, "refill", rc.demand)
        self.pump(t)

    def _apply_retired(self, v: WorkerView,
                       retired: Tuple[P.RetiredRequest, ...]) -> None:
        for rr in retired:
            req = v.outstanding.pop(rr.rid)
            req.tokens = list(rr.tokens)
            req.t_first_token = rr.t_first_token
            req.t_done = rr.t_done
            self.queue.mark_done(req)
            self.metrics.observe_request(req)
            if self.tracer is not None:
                lc = self.tracer.lifecycle
                if req.t_first_token is not None:
                    lc.event(req.rid, "first_token", req.t_first_token,
                             wid=v.wid)
                lc.event(req.rid, "retire",
                         self.timeline.now if req.t_done is None
                         else req.t_done,
                         wid=v.wid, tokens=len(req.tokens))

    def _record(self, t0: float, t1: float, wid: int, phase: str,
                demand: float) -> None:
        self.trace.append(SpanRecord(t0, t1, wid, phase, demand))
        self.metrics.observe_span(t0, t1 - t0, demand)

    # -- failure handling ----------------------------------------------------
    def _worker_died(self, v: WorkerView, now: float) -> None:
        if not v.alive:
            return
        v.alive = False
        self.n_failovers += 1
        self.failed_workers.append(v.wid)
        if self.tracer is not None:
            self.tracer.instant("cluster", v.wid, "failover", now,
                                wid=v.wid,
                                n_outstanding=len(v.outstanding))
        if v.span is not None:
            # the op will never commit: take its span off the clock.  When
            # cancel() returns False the span already left the timeline
            # (its completion is being delivered this very step) — its
            # _complete callback still fires and does the prefill_live
            # bookkeeping itself, so adjusting it here too would
            # double-decrement and break the one-prefill-in-flight gate.
            if self.timeline.cancel(v.span) and v.span.key[1] == "prefill":
                self.prefill_live -= 1
            v.span = None
        # re-queue every unfinished request at the queue FRONT with its
        # original arrival/deadline (TTFT/deadline accounting preserved);
        # partial generation is discarded — the request restarts cleanly
        reqs = sorted(v.outstanding.values(),
                      key=lambda r: (r.arrival, r.rid))
        v.outstanding.clear()
        for r in reqs:
            r.tokens = []
            r.t_first_token = None
            r.t_done = None
        self.queue.requeue(reqs)
        on_died = getattr(self.router, "on_worker_died", None)
        if on_died is not None:
            on_died(self, v, now)
        self.pump(now)

    def heartbeat(self, t_wall: Optional[float] = None) -> Dict[int, bool]:
        """Ping every live worker; a silent worker is marked dead and its
        requests fail over.  Returns wid -> alive after the sweep."""
        t_wall = time.time() if t_wall is None else t_wall
        for v in self.views_alive():
            if self.tracer is not None:
                self.tracer.instant("cluster", v.wid, "heartbeat",
                                    self.timeline.now, wid=v.wid)
            self._rpc(v, P.Ping(t_wall=t_wall,
                                t_virtual=self.timeline.now),
                      self.timeline.now)
        return {wid: v.alive for wid, v in self.views.items()}

    # -- elastic membership --------------------------------------------------
    def join_worker(self, spec) -> WorkerView:
        """Elastic scale-up: bring one more worker into the running fleet.

        The transport spawns/attaches it, its ``Hello`` (the one message a
        worker may send unprompted) becomes a ``WorkerView``, the router's
        optional ``on_worker_joined`` hook assigns it a role, and a pump
        immediately offers it work.  A wid that previously failed may be
        replaced; a live wid may not."""
        now = self.timeline.now
        old = self.views.get(spec.wid)
        if old is not None and old.alive:
            raise ValueError(f"worker {spec.wid} is already in the fleet")
        self.transport.add_worker(spec)
        try:
            hello = self.transport.recv(spec.wid,
                                        timeout=self.startup_timeout)
        except WorkerGone as e:
            raise ClusterError(
                f"joining worker {spec.wid} never completed the "
                f"handshake") from e
        if not isinstance(hello, P.Hello):
            raise ClusterError(f"worker {spec.wid}: expected Hello, got "
                               f"{type(hello).__name__}")
        v = WorkerView(hello)
        self.views[v.wid] = v
        self.n_joins += 1
        if self.tracer is not None:
            self.tracer.instant("cluster", v.wid, "join", now, wid=v.wid)
        on_joined = getattr(self.router, "on_worker_joined", None)
        if on_joined is not None:
            on_joined(self, v, now)
        self.pump(now)
        return v

    def drain_worker(self, wid: int) -> None:
        """Elastic scale-down, drain-then-``Bye``: stop placing NEW work on
        the worker; everything it already holds (backlog included) finishes
        normally — grants and decode steps keep flowing — and the moment it
        holds nothing the controller runs the graceful Shutdown -> Bye
        exchange and retires it from the fleet.  No request is ever
        dropped.  Refuses to drain the last placeable worker (the queue
        could never drain)."""
        v = self.views.get(wid)
        if v is None or not v.alive:
            raise ValueError(f"worker {wid} is not alive")
        if v.draining:
            return
        if not [u for u in self.views_placeable() if u.wid != wid]:
            raise ValueError("cannot drain the last placeable worker")
        v.draining = True
        if self.tracer is not None:
            self.tracer.instant("cluster", wid, "drain", self.timeline.now,
                                wid=wid)
        self._finish_drains(self.timeline.now)

    def _finish_drains(self, now: float) -> None:
        for v in list(self.views.values()):
            if not (v.alive and v.draining):
                continue
            if v.span is not None or v.outstanding:
                continue  # still working; checked again after every pump
            try:
                self.transport.send(v.wid, P.Shutdown())
                bye = self.transport.recv(v.wid)
                if not isinstance(bye, P.Bye):
                    raise ClusterError(f"worker {v.wid}: expected Bye, got "
                                       f"{type(bye).__name__}")
            except WorkerGone:
                pass  # died holding nothing: there is nothing to fail over
            retire = getattr(self.transport, "retire", None)
            if retire is not None:
                retire(v.wid)
            v.alive = False
            self.n_departures += 1
            self.departed_workers.append(v.wid)
            self._departed_status.append(v.status)
            del self.views[v.wid]
            if self.tracer is not None:
                self.tracer.instant("cluster", v.wid, "leave", now,
                                    wid=v.wid)
            on_left = getattr(self.router, "on_worker_left", None)
            if on_left is not None:
                on_left(self, v, now)

    # -- the pump ------------------------------------------------------------
    def pump(self, now: float) -> None:
        """Start every op the router currently allows.  Re-entrant calls
        (a worker dying inside an RPC issued by the pump) latch a re-pump
        instead of recursing into a half-updated iteration."""
        if self._pumping:
            self._repump = True
            return
        self._pumping = True
        try:
            while True:
                self._repump = False
                self._pump_once(now)
                if not self._repump:
                    break
        finally:
            self._pumping = False

    def _pump_once(self, now: float) -> None:
        self.router.place(self, now)
        decode_candidates = getattr(self.router, "decode_candidates", None)
        pool = decode_candidates(self) if decode_candidates is not None \
            else self.views_in_order()
        for v in pool:  # decode is never policy-gated within its pool
            if v.alive and v.span is None and v.status.busy:
                self.issue(v, "decode", now)
        cand = [v for v in self.views_in_order()
                if v.alive and v.span is None and v.status.wants_prefill]
        if cand:
            self.router.grant(self, cand, now)
        self._finish_drains(now)

    # -- drive ---------------------------------------------------------------
    def _unserved(self) -> int:
        limbo = getattr(self.router, "unserved", None)
        return len(self.queue) + sum(len(v.outstanding)
                                     for v in self.views.values()) \
            + (limbo(self) if limbo is not None else 0)

    def run(self, max_events: Optional[int] = None) -> ServingMetrics:
        """Drive until the queue and every worker drain; failover stalls
        (a death leaving re-queued work with nothing in flight) re-pump
        until the cluster is truly quiescent."""
        t0 = time.perf_counter()
        try:
            self.pump(self.timeline.now)
            self.timeline.run(max_events=max_events)
            while (max_events is None and self.timeline.idle
                   and self._unserved() and self.n_alive > 0):
                self.pump(self.timeline.now)
                if self.timeline.idle:
                    break  # pump could not start anything: give up
                self.timeline.run()
            if max_events is None and self._unserved():
                raise ClusterError(
                    f"{self._unserved()} request(s) unserved with "
                    f"{self.n_alive} worker(s) alive "
                    f"(failed: {self.failed_workers})")
        finally:
            self.transport.close()
            self.metrics.wall_seconds = time.perf_counter() - t0
            self.metrics.virtual_seconds = self.timeline.now
        return self.metrics

    def achieved_bw_stats(self, *, window: Optional[float] = None,
                          trim: float = 0.0) -> Tuple[float, float]:
        """(mean, std) of the allocated aggregate bandwidth — the Fig. 5
        observable on the cluster's shared contention clock."""
        return achieved_bw_stats(self.timeline.bw_samples, self.timeline.now,
                                 window=window, trim=trim)

"""The PD router: phase-dedicated worker pools over the cluster protocol.

``PdRouter`` plugs into ``ClusterController`` as router mode ``"pd"`` and
partitions the fleet into a PREFILL pool and a DECODE pool:

  * admissions go to the least-loaded live prefill worker (backlog capped
    at one wave, so requests keep their place in the global queue until a
    prefill slot actually opens);
  * prefill grants are ungated within the pool — workers there never
    decode, so waves need no stagger — but are held back when the decode
    pool has no headroom (the phase-balance valve: prefill cannot outrun
    decode by more than the decode pool's free slots);
  * every completed prefill is exported off its worker (``ExportKv``,
    freeing the slot immediately) and its KV pages travel as a bytes-only
    span on the shared ``ContentionTimeline`` — the transfer competes for
    the same modeled link as compute traffic and shows up in the demand
    overlay as phase ``"handoff"``;
  * on arrival the payload is imported into the least-loaded decode
    worker (``ImportKv``); a full worker defers the import
    (``ok=False``), and deferred handoffs retry whenever capacity frees;
  * pool sizes rebalance from the same ``CostModel``-priced
    ``WorkerStatus`` demand signals the shaping router prices spacing
    from: the EMA of ``pre_dur / wave_dur`` is the prefill share of a
    request's service time, and idle workers migrate between pools until
    the split matches it (auto mode only — an explicit ``--pd-split``
    pins the split).  Prefix caching composes transparently: workers
    price ``pre_dur`` post-hit (``prefill_cost_est`` sees their own
    cache), so a hit-heavy load shrinks the observed prefill share and
    the rebalance shifts workers toward decode — the cache *removing*
    compute phases is exactly the signal the split follows.  Handoffs
    re-match on the decode side: ``import_kv`` reference-shares any
    prefix already resident on the recipient instead of double-storing
    it, and ``export_kv`` only drops the donor's references (shared
    blocks survive), so a handoff never double-frees shared state.

Failover: a dying worker's seated requests fail over through the
controller's normal requeue path.  A handoff in flight when its only
possible destination pool dies is re-queued losslessly in admission order
(rid order — the ``RequestQueue.requeue`` invariant) with its generation
progress reset; if one pool loses its last live worker the survivor pool
absorbs the other phase (degenerate co-located mode) until a rebalance
repairs the split.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.queue import Request

_EMA = 0.2  # prefill-share smoothing for auto rebalance


class PdRouter:
    """Prefill/decode disaggregation router (cluster mode ``"pd"``).

    ``split=(n_prefill, n_decode)`` pins the pools (must sum to the
    worker count); ``split=None`` starts at an even split and rebalances
    from demand.  ``handoff_rate`` is the modeled link rate for KV
    transfers in bytes/s (default: the controller's contention
    bandwidth — handoffs share the one link)."""

    name = "pd"

    def __init__(self, split: Optional[Tuple[int, int]] = None, *,
                 handoff_rate: Optional[float] = None,
                 rebalance: Optional[bool] = None):
        self.split = tuple(int(s) for s in split) if split else None
        self.handoff_rate = handoff_rate
        self.rebalance = (split is None) if rebalance is None else rebalance
        self.pool_of: Dict[int, str] = {}    # wid -> "prefill" | "decode"
        self.n_handoffs = 0
        self.n_deferrals = 0
        self.n_requeued = 0
        self._in_flight = 0                  # transfer spans on the clock
        self._deferred: List[Tuple[Request, P.KvHandoff]] = []
        self._share = 0.0                    # EMA prefill share (auto mode)
        self._flow_ids: Dict[int, int] = {}  # rid -> trace flow id

    # -- pools ---------------------------------------------------------------
    def _ensure_pools(self, ctl) -> None:
        if self.pool_of:
            return
        wids = [v.wid for v in ctl.views_in_order()]
        if self.split is not None:
            n_pre, n_dec = self.split
            if n_pre < 1 or n_dec < 1:
                raise ValueError(f"pd split needs >=1 worker per pool, "
                                 f"got {self.split}")
            if n_pre + n_dec != len(wids):
                raise ValueError(
                    f"pd split {n_pre}:{n_dec} does not cover the "
                    f"{len(wids)}-worker fleet")
        else:
            n_pre = max(len(wids) // 2, 1)
        for i, wid in enumerate(wids):
            self.pool_of[wid] = "prefill" if i < n_pre else "decode"

    def _pool_live(self, ctl, pool: str) -> List:
        return [v for v in ctl.views_alive()
                if self.pool_of.get(v.wid) == pool]

    def prefill_views(self, ctl) -> List:
        """Live views that prefill: the prefill pool, or — degenerate
        co-located fallback — everyone, once the pool has no survivors."""
        pre = self._pool_live(ctl, "prefill")
        return pre if pre else ctl.views_alive()

    def decode_views(self, ctl) -> List:
        dec = self._pool_live(ctl, "decode")
        return dec if dec else ctl.views_alive()

    # -- controller hooks ----------------------------------------------------
    def decode_candidates(self, ctl) -> List:
        return self.decode_views(ctl)

    def unserved(self, ctl) -> int:
        # handoffs in limbo: on the wire, or deferred awaiting capacity
        return self._in_flight + len(self._deferred)

    def on_worker_died(self, ctl, v, now: float) -> None:
        pass  # pool membership is sticky; live-view filters do the rest

    def on_worker_joined(self, ctl, v, now: float) -> None:
        """Elastic join: seat the newcomer in whichever pool sits further
        below its demand-EMA target — the same signal ``_rebalance``
        steers by — or simply the smaller live pool before any demand
        signal has accumulated."""
        if not self.pool_of:
            return  # pools not formed yet: _ensure_pools covers everyone
        self.pool_of.pop(v.wid, None)  # a replaced wid sheds its old role
        pre = self._pool_live(ctl, "prefill")
        dec = self._pool_live(ctl, "decode")
        if self._share > 0:
            n = len(pre) + len(dec) + 1
            target = min(max(int(round(n * self._share)), 1), n - 1)
            pool = "prefill" if len(pre) < target else "decode"
        else:
            pool = "prefill" if len(pre) < len(dec) else "decode"
        self.pool_of[v.wid] = pool

    def on_worker_left(self, ctl, v, now: float) -> None:
        """Elastic leave (drain-then-Bye): the departed wid leaves its
        pool; ``_rebalance`` repairs a collapsed phase on the next pump."""
        self.pool_of.pop(v.wid, None)

    # -- placement + migration ----------------------------------------------
    def place(self, ctl, now: float) -> None:
        self._ensure_pools(ctl)
        if self.rebalance:
            self._rebalance(ctl)
        self._retry_deferred(ctl, now)
        self._migrate(ctl, now)
        self._admit(ctl, now)

    def _admit(self, ctl, now: float) -> None:
        """Least-loaded placement onto the prefill pool, one wave deep.
        Draining workers take nothing new (elastic scale-down)."""
        views = [v for v in self.prefill_views(ctl) if not v.draining]
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

    def _migrate(self, ctl, now: float) -> None:
        """Export every completed prefill off span-free prefill workers and
        put its KV payload in flight on the contention clock."""
        dec = self._pool_live(ctl, "decode")
        if not dec:
            return  # degenerate co-located mode: survivors decode in place
        for v in list(self._pool_live(ctl, "prefill")):
            if v.span is not None or not v.status.busy:
                continue
            rids = tuple(v.status.active_rids)
            if not rids:
                continue
            rep = ctl._rpc(v, P.ExportKv(rids=rids), now)
            if rep is None:
                continue  # died at export: controller requeued its work
            for h in rep.handoffs:
                req = v.outstanding.pop(h.request.rid)
                self._start_transfer(ctl, v.wid, req, h, now)

    def _start_transfer(self, ctl, src_wid: int, req: Request,
                        h: P.KvHandoff, now: float) -> None:
        rate = float(self.handoff_rate or ctl.bandwidth)
        byts = max(float(h.kv_bytes), 0.0)
        dur = max(byts / rate, 1e-12)
        self._in_flight += 1
        self.n_handoffs += 1
        if ctl.tracer is not None:
            # the flow arrow: export on the source worker's handoff track,
            # terminated at delivery on the destination's decode track
            fid = ctl.tracer.flow_id()
            self._flow_ids[req.rid] = fid
            ctl.tracer.flow_start("spans", f"{src_wid}.handoff", "kv_handoff",
                                  now, fid, rid=req.rid, kv_bytes=byts)
            ctl.tracer.lifecycle.event(req.rid, "handoff_export", now,
                                       wid=src_wid, kv_bytes=byts)
        ctl.timeline.start(
            dur, byts, key=(src_wid, "handoff"),
            on_complete=lambda sp, t, req=req, h=h, wid=src_wid:
                self._transfer_done(ctl, wid, req, h, sp, t))

    def _transfer_done(self, ctl, src_wid: int, req: Request,
                       h: P.KvHandoff, sp, t: float) -> None:
        self._in_flight -= 1
        ctl._record(sp.t_start, t, src_wid, "handoff",
                    sp.byts / max(sp.duration, 1e-12))
        if not self._deliver(ctl, req, h, t):
            self.n_deferrals += 1
            self._deferred.append((req, h))
        ctl.pump(t)

    def _deliver(self, ctl, req: Request, h: P.KvHandoff,
                 now: float) -> bool:
        """Import into the least-loaded decode worker.  True when the
        request found a home (imported, or re-queued because no decode
        pool survives); False to keep it deferred."""
        dec = self._pool_live(ctl, "decode")
        if not dec:
            # the decode pool died under the transfer: restart the request
            # on the survivors, losslessly in admission (rid) order
            req.tokens = []
            req.t_first_token = None
            req.t_done = None
            self._flow_ids.pop(req.rid, None)  # flow dies with the pool
            ctl.queue.requeue([req])
            self.n_requeued += 1
            return True
        cands = [v for v in dec
                 if v.status.n_active < v.slots and not v.draining]
        for v in sorted(cands,
                        key=lambda v: (v.status.n_active, v.wid)):
            rep = ctl._rpc(v, P.ImportKv(handoff=h), now)
            if rep is None:
                continue  # died at import: engine state never mutated
            if rep.ok:
                v.outstanding[req.rid] = req
                if ctl.tracer is not None:
                    fid = self._flow_ids.pop(req.rid, None)
                    if fid is not None:
                        ctl.tracer.flow_end("spans", f"{v.wid}.decode",
                                            "kv_handoff", now, fid,
                                            rid=req.rid)
                    ctl.tracer.lifecycle.event(req.rid, "handoff_import",
                                               now, wid=v.wid)
                return True
        return False

    def _retry_deferred(self, ctl, now: float) -> None:
        if not self._deferred:
            return
        still: List[Tuple[Request, P.KvHandoff]] = []
        for req, h in self._deferred:
            if not self._deliver(ctl, req, h, now):
                still.append((req, h))
        self._deferred = still

    # -- prefill grants (the phase-balance valve) ----------------------------
    def grant(self, ctl, cand: List, now: float) -> None:
        pre_wids = {v.wid for v in self.prefill_views(ctl)}
        dec = self._pool_live(ctl, "decode")
        if not dec:
            # degenerate co-located mode: ungated, like round_robin
            for v in sorted(cand, key=lambda v: v.status.head_arrival):
                if v.alive and v.span is None:
                    ctl.issue(v, "prefill", now)
            return
        headroom = sum(max(v.slots - v.status.n_active, 0) for v in dec) \
            - self._in_flight - len(self._deferred)
        for v in sorted(cand, key=lambda v: v.status.head_arrival):
            if v.wid not in pre_wids:
                continue
            if not (v.alive and v.span is None):
                continue
            wave = min(v.slots, v.status.backlog_len)
            if wave <= 0:
                continue
            if headroom < 1:
                break  # decode pool saturated: hold the wave
            ctl.issue(v, "prefill", now)
            headroom -= wave

    # -- demand-driven rebalance (auto mode) ---------------------------------
    def _rebalance(self, ctl) -> None:
        views = ctl.views_alive()
        if len(views) < 2:
            return
        for v in views:
            if v.status.wave_dur > 0:
                share = v.status.pre_dur / v.status.wave_dur
                self._share = _EMA * share + (1 - _EMA) * self._share
        pre = self._pool_live(ctl, "prefill")
        dec = self._pool_live(ctl, "decode")
        # repair a collapsed pool first (failover left one phase empty)
        if not pre and len(dec) >= 2:
            mover = min(dec, key=lambda v: (v.status.n_active
                                            + v.status.backlog_len, v.wid))
            self.pool_of[mover.wid] = "prefill"
            return
        if not dec and len(pre) >= 2:
            mover = min(pre, key=lambda v: (v.status.n_active
                                            + v.status.backlog_len, v.wid))
            self.pool_of[mover.wid] = "decode"
            return
        if self._share <= 0 or not pre or not dec:
            return
        target = min(max(int(round(len(views) * self._share)), 1),
                     len(views) - 1)
        if len(pre) == target:
            return
        src_pool = pre if len(pre) > target else dec
        dst = "decode" if len(pre) > target else "prefill"
        idle = [v for v in src_pool
                if v.span is None and not v.status.busy
                and v.status.backlog_len == 0 and not v.outstanding]
        if len(src_pool) > 1 and idle:
            self.pool_of[idle[-1].wid] = dst  # move one idle worker per pump

"""Cluster message protocol: the queue/scheduler interactions as wire data.

The in-process fleet couples the scheduler to its engines through direct
method calls (``assign`` / ``issue_prefill`` / ``issue_decode`` /
``commit_op``) and through attribute reads (``busy`` / ``wants_prefill`` /
the backlog head the demand policy prices its spacing from).  This module
re-expresses every one of those interactions as a serializable dataclass so
the identical control flow can run across a process (later: host) boundary:

  controller -> worker            worker -> controller
  --------------------            --------------------
  Assign   (seat requests)        Hello        (worker came up)
  IssueOp  (prefill grant /       AssignAck    (requests seated in backlog)
            decode step)          OpIssued     (op span: FLOPs/bytes/duration)
  CommitOp (clock-chosen end)     OpCommitted  (retire records + refill span)
  Ping     (heartbeat)            Pong         (heartbeat ack)
  Shutdown                        Bye
                                  WorkerError  (engine raised; fatal)

Every worker reply carries a full ``WorkerStatus`` snapshot — the engine
predicates plus the analytic spacing ingredients (``pre_dur`` /
``wave_dur``) the shaping router prices its cluster-wide stagger rule from.
Worker engine state only changes inside message handlers and the protocol
is strict request/reply per worker, so the controller's mirror of each
worker is never stale: the loopback transport therefore reproduces the
in-process ``EventScheduler`` decision sequence (and metrics) exactly.

``encode`` / ``decode`` round-trip messages through plain dicts of
primitives (prompts become tuples of ints) — nothing crosses by object
reference, which both transports exploit: loopback round-trips to prove the
protocol is complete; the multiprocessing pipe pickles the encoded dicts.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.serving.engine import PhaseCost
from repro_torch.serving.queue import Request

OP_KINDS = ("prefill", "decode")


# ---------------------------------------------------------------------------
# payload records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WireRequest:
    """A queued request, flattened for the wire."""
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0
    deadline: Optional[float] = None
    # admission-time prefix-cache probe result (prompt tokens); the worker
    # engine overwrites it with the actual match when the request seats
    cached_len: int = 0

    @classmethod
    def from_request(cls, req: Request) -> "WireRequest":
        return cls(rid=req.rid,
                   prompt=tuple(int(t) for t in np.asarray(req.prompt)),
                   max_new_tokens=int(req.max_new_tokens),
                   arrival=float(req.arrival), deadline=req.deadline,
                   cached_len=int(getattr(req, "cached_len", 0)))

    def to_request(self) -> Request:
        return Request(rid=self.rid,
                       prompt=np.asarray(self.prompt, np.int32),
                       max_new_tokens=self.max_new_tokens,
                       arrival=self.arrival, deadline=self.deadline,
                       cached_len=self.cached_len)


@dataclass(frozen=True)
class RetiredRequest:
    """A request the worker finished: the stamps the controller folds back
    into its canonical ``Request`` (timestamps are controller virtual
    seconds — the worker stamped them from ``CommitOp.t_end``)."""
    rid: int
    tokens: Tuple[int, ...]
    t_first_token: Optional[float]
    t_done: float


@dataclass(frozen=True)
class WireCost:
    """A ``PhaseCost`` on the wire."""
    flops: float
    byts: float
    duration: float

    @classmethod
    def from_cost(cls, c: PhaseCost) -> "WireCost":
        return cls(flops=c.flops, byts=c.byts, duration=c.duration)

    def to_cost(self) -> PhaseCost:
        return PhaseCost(self.flops, self.byts, self.duration)


@dataclass(frozen=True)
class WorkerStatus:
    """Engine predicate snapshot, piggybacked on every worker reply.

    ``head_arrival`` is the backlog head's arrival (FIFO-urgency ordering
    of prefill grants); ``pre_dur`` / ``wave_dur`` are the engine's
    prefill-duration and wave-time estimates — exactly the quantities the
    in-process demand policy prices ``max(pre, wave / P)`` spacing from —
    computed worker-side by the worker's own ``CostModel`` so both sides of
    the boundary use the identical pricing.  They are 0.0 when the backlog
    is empty.  ``cost_source`` names that pricing source ("analytic" |
    "measured"): with a ``MeasuredCostModel`` the spacing ingredients are
    the worker's on-device timings, and the controller mirror stays
    consistent with them without ever re-pricing controller-side.
    ``active_rids`` lists the requests currently seated in slots — the PD
    router migrates exactly these off a prefill-pool worker.
    ``metrics`` is the engine's flat ``metrics_snapshot()`` — sorted
    (name, value) pairs of counters/gauges (prefix-cache hits, pool
    blocks, phase counts) the controller folds fleet-wide for the unified
    CLI summary; defaults to empty for wire back-compat."""
    busy: bool
    wants_prefill: bool
    backlog_len: int
    n_active: int
    head_arrival: float = 0.0
    pre_dur: float = 0.0
    wave_dur: float = 0.0
    cost_source: str = "analytic"
    active_rids: Tuple[int, ...] = ()
    metrics: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class PageArray:
    """One named device array of a handoff payload, flattened to raw
    bytes (row-major) + dtype/shape for exact reconstruction.  The dtype
    string is numpy's name for it (``float32``, ``int8``, ``bfloat16``,
    ``float8_e4m3fn``), the same string and bytes the reference writes, so
    a payload packed by either package unpacks in the other."""
    name: str
    dtype: str
    shape: Tuple[int, ...]
    data: bytes


# dtypes numpy has no native type for: they cross as same-width integers
# (bit for bit, as ``bridge.to_torch`` carries them), never via ml_dtypes
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def pack_array(name: str, arr) -> PageArray:
    """``arr``: a torch tensor (any device) or anything ``np.asarray``
    takes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if dtype in _BIT_VIEWS:
            t = t.view(getattr(torch, np.dtype(_BIT_VIEWS[dtype][0]).name))
        a = t.numpy()
    else:
        a = np.asarray(arr)
        dtype = str(a.dtype)
    return PageArray(name=name, dtype=dtype,
                     shape=tuple(int(s) for s in a.shape),
                     data=np.ascontiguousarray(a).tobytes())


def unpack_array(pa: PageArray) -> torch.Tensor:
    """A writable CPU tensor of the payload's dtype, shape and bits."""
    raw, view = _BIT_VIEWS[pa.dtype] if pa.dtype in _BIT_VIEWS \
        else (np.dtype(pa.dtype), None)
    a = np.frombuffer(pa.data, dtype=raw).reshape(pa.shape).copy()
    t = torch.from_numpy(a)  # copy above: frombuffer views are read-only
    return t if view is None else t.view(view)


@dataclass(frozen=True)
class KvHandoff:
    """A prefilled request's complete KV state, leaving a prefill worker.

    ``len`` is the slot's context length (cache write position, prefix
    included) at export; ``kv_bytes`` the modeled size of the transfer —
    the per-slot cache bytes a decode step streams, priced by the source
    worker's own cost model so the controller's handoff span competes on
    the contention timeline in the same units as compute traffic.
    ``pages`` carries the gathered device arrays (paged: the block rows of
    the slot's table, in table order; dense: the slot's cache rows); a
    ``SimulatedEngine`` ships an empty tuple.  ``tokens`` /
    ``t_first_token`` are the generation progress that must survive the
    move (the first-token stamp keeps TTFT billed where prefill ran)."""
    request: WireRequest
    tokens: Tuple[int, ...]
    t_first_token: Optional[float]
    len: int
    kv_bytes: float
    pages: Tuple[PageArray, ...]


# ---------------------------------------------------------------------------
# controller -> worker
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Assign:
    """Seat requests in the worker's backlog (the dispatch edge)."""
    requests: Tuple[WireRequest, ...]


@dataclass(frozen=True)
class IssueOp:
    """Start one phase op: ``op='prefill'`` is a stagger-policy grant,
    ``op='decode'`` the never-gated decode step."""
    op: str


@dataclass(frozen=True)
class CommitOp:
    """Commit the one outstanding issued op at the clock-chosen instant."""
    t_end: float


@dataclass(frozen=True)
class ExportKv:
    """Export the named active requests' KV state (PD handoff source
    side): each request leaves the engine, its slot and blocks are freed,
    and its state comes back as a ``KvHandoff`` payload."""
    rids: Tuple[int, ...]


@dataclass(frozen=True)
class ImportKv:
    """Seat a handed-off request in a free slot with its KV state
    restored (PD handoff destination side).  All-or-nothing: a worker
    without a free slot or enough pool blocks replies ``ok=False`` and
    mutates nothing (the controller defers and retries)."""
    handoff: KvHandoff


@dataclass(frozen=True)
class Ping:
    """Heartbeat.  ``t_virtual`` is the cross-host virtual-clock export:
    the controller's ``ContentionTimeline.now`` at send.  Every op a worker
    runs is priced worker-side but *placed* controller-side (the one fleet
    clock), so workers never advance virtual time themselves — the
    heartbeat stream is how a remote host observes fleet-virtual now
    between its own commits (``CommitOp.t_end`` carries it at every
    commit).  Defaults keep old pickles decodable."""
    t_wall: float = 0.0
    t_virtual: float = 0.0


@dataclass(frozen=True)
class Shutdown:
    pass


# ---------------------------------------------------------------------------
# worker -> controller
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hello:
    wid: int
    slots: int
    max_len: int
    status: WorkerStatus


@dataclass(frozen=True)
class AssignAck:
    status: WorkerStatus


@dataclass(frozen=True)
class OpIssued:
    """The issued op as a contention-timeline span: run ``duration``
    full-speed seconds moving ``byts`` bytes (same fields as ``PhaseCost``;
    the controller puts it in flight on the shared clock)."""
    op: str
    cost: WireCost
    status: WorkerStatus


@dataclass(frozen=True)
class OpCommitted:
    """Commit results: retired requests plus the sequential refill-prefill
    span (slots freed by the op re-seated from backlog), if any."""
    op: str
    retired: Tuple[RetiredRequest, ...]
    refill: Optional[WireCost]
    status: WorkerStatus


@dataclass(frozen=True)
class KvExported:
    """Reply to ``ExportKv``: one handoff per requested rid, in request
    order.  The slots are already free on the worker — it can start its
    next prefill wave while the payloads are still in flight."""
    handoffs: Tuple[KvHandoff, ...]
    status: WorkerStatus


@dataclass(frozen=True)
class KvImported:
    """Reply to ``ImportKv``.  ``ok=False`` is the ``PoolExhausted``
    deferral path (capacity, not failure — the controller retries);
    engine errors still surface as ``WorkerError``."""
    ok: bool
    reason: str
    status: WorkerStatus


@dataclass(frozen=True)
class Pong:
    """Heartbeat ack.  ``t_virtual`` echoes the worker's fleet-virtual
    clock (the max of every ``Ping.t_virtual`` / ``CommitOp.t_end`` it has
    seen) so the controller can assert clock export took."""
    t_wall: float
    status: WorkerStatus
    t_virtual: float = 0.0


@dataclass(frozen=True)
class Bye:
    n_prefills: int = 0
    n_refills: int = 0
    n_decode_steps: int = 0


@dataclass(frozen=True)
class WorkerError:
    """The engine raised inside a handler; the run is not recoverable by
    failover (the same op would raise on any worker)."""
    error: str
    traceback: str = ""


# ---------------------------------------------------------------------------
# codec: message <-> dict of primitives
# ---------------------------------------------------------------------------

_MESSAGES: Tuple[Type, ...] = (
    Assign, IssueOp, CommitOp, ExportKv, ImportKv, Ping, Shutdown,
    Hello, AssignAck, OpIssued, OpCommitted, KvExported, KvImported,
    Pong, Bye, WorkerError,
)
_KIND_OF: Dict[Type, str] = {cls: cls.__name__ for cls in _MESSAGES}
_BY_KIND: Dict[str, Type] = {v: k for k, v in _KIND_OF.items()}

# nested dataclass fields, per message type (tuples mean "tuple of")
_NESTED = {
    Assign: {"requests": (WireRequest,)},
    ImportKv: {"handoff": KvHandoff},
    Hello: {"status": WorkerStatus},
    AssignAck: {"status": WorkerStatus},
    OpIssued: {"cost": WireCost, "status": WorkerStatus},
    OpCommitted: {"retired": (RetiredRequest,), "refill": WireCost,
                  "status": WorkerStatus},
    KvExported: {"handoffs": (KvHandoff,), "status": WorkerStatus},
    KvImported: {"status": WorkerStatus},
    Pong: {"status": WorkerStatus},
}

# message-level plain-tuple fields that asdict flattens to lists
_TUPLE_FIELDS = {
    ExportKv: ("rids",),
}


def encode(msg) -> dict:
    """Flatten a message to a plain dict (pickle/JSON-friendly)."""
    d = asdict(msg)
    d["kind"] = _KIND_OF[type(msg)]
    return d


def decode(d: dict):
    """Rebuild the message object from its ``encode`` dict."""
    d = dict(d)
    cls = _BY_KIND[d.pop("kind")]
    for name, spec in _NESTED.get(cls, {}).items():
        val = d.get(name)
        if val is None:
            continue
        if isinstance(spec, tuple):
            d[name] = tuple(_build(spec[0], item) for item in val)
        else:
            d[name] = _build(spec, val)
    for name in _TUPLE_FIELDS.get(cls, ()):
        d[name] = tuple(d[name])
    return cls(**d)


def _build(cls, val):
    if isinstance(val, cls):  # already decoded (defensive)
        return val
    if cls is WireRequest:
        val = dict(val, prompt=tuple(val["prompt"]))
    if cls is RetiredRequest:
        val = dict(val, tokens=tuple(val["tokens"]))
    if cls is WorkerStatus:
        val = dict(val, active_rids=tuple(val.get("active_rids", ())),
                   metrics=tuple((str(k), float(v))
                                 for k, v in val.get("metrics", ())))
    if cls is PageArray:
        val = dict(val, shape=tuple(val["shape"]))
    if cls is KvHandoff:
        val = dict(val,
                   request=_build(WireRequest, val["request"]),
                   tokens=tuple(val["tokens"]),
                   pages=tuple(_build(PageArray, p)
                               for p in val["pages"]))
    return cls(**val)

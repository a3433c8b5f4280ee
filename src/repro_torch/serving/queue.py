"""Request queue with admission control, deadlines, and FIFO dispatch.

Extracted and hardened from the inline list in the old ``launch/serve.py``:
requests are first-class records carrying arrival time, a completion
deadline, and per-token timestamps (TTFT/TPOT are computed by
``repro_torch.serving.metrics`` from these).  Admission control rejects work the
system cannot serve — a bounded queue depth plus a deadline-feasibility
check against a caller-supplied service-time estimate.

Timestamps are *virtual* seconds on the scheduler's clock (derived from the
analytic phase costs), so queue/deadline behaviour is deterministic and
hardware-independent in tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0            # virtual s
    deadline: Optional[float] = None  # absolute virtual completion deadline
    # prefix-cache hit length (cache positions whose content was already
    # resident when the request was seated).  The queue's admission probe
    # fills in a submission-time estimate so deadline feasibility prices
    # the post-hit prefill; the engine overwrites it with the actual match
    # at seating.  0 = cold (the only value when caching is off).
    cached_len: int = 0
    # filled in by the engine:
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


class RequestQueue:
    """Bounded FIFO with admission control.

    ``service_estimate(req)`` — optional callable returning the estimated
    seconds to serve ``req`` end-to-end (queueing excluded); a request whose
    deadline cannot be met even if started immediately is rejected at
    submission (cheaper than accepting work that is guaranteed late).

    ``prefix_probe(req)`` — optional callable returning the prefix-cache
    hit length (cache positions already resident) the fleet would serve
    ``req`` with.  It runs BEFORE the feasibility check and its result is
    stored on ``req.cached_len``, so ``service_estimate`` prices the
    post-hit prefill — without it, a hit-eligible request whose COLD
    service time overshoots its deadline is wrongly rejected even though
    the cached run would meet it.
    """

    def __init__(self, max_depth: Optional[int] = None,
                 service_estimate: Optional[Callable[[Request], float]] = None,
                 prefix_probe: Optional[Callable[[Request], int]] = None):
        self.max_depth = max_depth
        self.service_estimate = service_estimate
        self.prefix_probe = prefix_probe
        self._fifo: List[Request] = []
        self._next_rid = 0
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_requeued = 0
        self.completed: List[Request] = []
        # opt-in observability (repro_torch.obs): admission decisions become
        # instants on the 'queue' track + request lifecycle records; every
        # site is guarded so the off path runs no tracing code
        self.tracer = None

    def __len__(self) -> int:
        return len(self._fifo)

    def submit(self, prompt, max_new_tokens: int, *, arrival: float = 0.0,
               deadline: Optional[float] = None) -> Optional[Request]:
        """Returns the admitted Request, or None when rejected."""
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt),
                      max_new_tokens=int(max_new_tokens), arrival=arrival,
                      deadline=deadline)
        if self.max_depth is not None and len(self._fifo) >= self.max_depth:
            self.n_rejected += 1
            if self.tracer is not None:
                self.tracer.instant("queue", 0, "reject", arrival,
                                    rid=req.rid, why="depth")
                self.tracer.lifecycle.event(req.rid, "reject", arrival,
                                            why="depth")
            return None
        if self.prefix_probe is not None:
            req.cached_len = int(self.prefix_probe(req))
        if (deadline is not None and self.service_estimate is not None
                and arrival + self.service_estimate(req) > deadline):
            self.n_rejected += 1
            if self.tracer is not None:
                self.tracer.instant("queue", 0, "reject", arrival,
                                    rid=req.rid, why="deadline")
                self.tracer.lifecycle.event(req.rid, "reject", arrival,
                                            why="deadline")
            return None
        self._next_rid += 1
        self.n_submitted += 1
        self._fifo.append(req)
        if self.tracer is not None:
            self.tracer.instant("queue", 0, "admit", arrival, rid=req.rid,
                                depth=len(self._fifo))
            self.tracer.lifecycle.event(req.rid, "submit", arrival,
                                        cached_len=req.cached_len)
        return req

    def pop(self, n: int = 1) -> List[Request]:
        """FIFO-dequeue up to ``n`` requests for slot refill / a prefill
        wave.  Preserves submission order (the ordering invariant the slot
        refill tests pin down)."""
        out, self._fifo = self._fifo[:n], self._fifo[n:]
        return out

    def requeue(self, requests: List[Request]) -> None:
        """Re-admit already-admitted requests (cluster failover: a dead
        worker's unfinished work must not lose its place).  The queue is
        re-sorted by rid — the admission order — so requeued requests slot
        back in FRONT of everything admitted after them, and sequential
        failovers cannot let a later worker's newer requests jump an
        earlier worker's older, already-requeued ones.  Bypasses admission
        control — the requests were admitted once and rejecting them now
        would lose them; the depth bound may transiently overshoot.
        Arrival and deadline are the caller's to preserve (TTFT stays
        billed from the original arrival)."""
        self._fifo[:0] = list(requests)
        self._fifo.sort(key=lambda r: r.rid)
        self.n_requeued += len(requests)
        if self.tracer is not None:
            t = self.tracer.vnow
            for req in requests:
                self.tracer.instant("queue", 0, "requeue", t, rid=req.rid)
                self.tracer.lifecycle.event(req.rid, "requeue", t)

    def mark_done(self, req: Request) -> None:
        self.completed.append(req)

    @property
    def drained(self) -> bool:
        return not self._fifo

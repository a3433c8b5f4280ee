"""Per-partition inference engine: paged KV pool, prefill / decode, in torch.

The port's counterpart of ``repro/serving/engine.py``.  An engine is one
traffic-shaping partition of the serving fleet.  It owns ``slots``
concurrent sequences backed by a paged KV-cache pool
(``repro_torch.serving.kv_pool``) and exposes two steppable phases to the
scheduler: ``prefill_wave()`` (compute-bound: the ragged prompt wave runs
through the model, each slot's prefix lands in its own freshly allocated
blocks and each request emits its first token) and ``decode_step()``
(bandwidth-bound: one token for every active slot).  Continuous batching
is per slot: a finished slot's blocks return to the pool and the next
backlog request prefills its own prompt into fresh blocks.

``EngineBase`` — the slot / backlog / pool state machine and the virtual-
clock issue/commit protocol — is the reference's code, copied unchanged, so
a torch fleet and a JAX fleet on the same load make the same scheduling
decisions and price every op identically.  ``PartitionEngine`` runs the
model through ``repro_torch.models.api`` on the api's device: on the card
every projection, prefill attention and paged decode step goes through the
port's CUDA kernels.  Phase costs come from the engine's ``CostModel``
(``repro_torch.profiling.cost_model``; analytic, priced at H100 data-sheet
rates by default).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hw
# PhaseCost + the analytic pricing functions live in profiling; re-exported
# here as in the reference (the scheduler and trace_sim import them here).
from repro_torch.profiling.cost_model import (  # noqa: F401
    AnalyticCostModel, CostModel, PhaseCost, decode_cost, prefill_cost,
    prefill_cost_ragged)
from repro_torch.profiling.timer import shape_key
from repro_torch.serving import kv_pool as KV
from repro_torch.serving.kv_pool import (KV_DTYPES, NULL_BLOCK, BlockPool,
                                         ChainAlloc, PoolExhausted,
                                         kv_dtype_supported)
from repro_torch.serving.prefill_graph import PrefillGraphs
from repro_torch.serving.queue import Request
from repro_torch.serving.step_graph import DecodeGraph

# model families whose per-sequence state does not live (only) in KV blocks:
# SSM/hybrid recurrent state is a per-slot array (not content-addressable by
# token prefix) and enc-dec has no paged cache at all, so block-level prefix
# sharing cannot represent a cached prefix for them
_NO_PREFIX_CACHE_FAMILIES = ("ssm", "hybrid", "encdec")

# families the bandwidth-reduction KV layouts (quantized pages, blockwise-
# sparse reads) cannot serve: SSM/hybrid recurrent state is not KV blocks
# (quantizing only the attention half would misprice the hybrid mix) and
# enc-dec has no paged cache at all
_NO_KV_QUANT_FAMILIES = ("ssm", "hybrid", "encdec")

# a KV handoff's page arrays (the reference's names) and the pool tensors
# they come from / go to
_HANDOFF_PAGES = (("k", "k_pages"), ("v", "v_pages"),
                  ("k_scales", "k_scales"), ("v_scales", "v_scales"))
# the per-slot SSM arrays of the SSM and hybrid families, under the same
# names in the dense cache, the pool dict and a handoff
_SSM_KEYS = ("ssm_state", "ssm_conv")
# every per-slot array of a dense cache
_CACHE_KEYS = ("k", "v") + _SSM_KEYS


@dataclass
class PendingOp:
    """An issued-but-uncommitted phase op.

    Device execution is eager (it happened at issue), but the virtual-time
    effects — first-token stamps, retirement, slot refill — wait for the
    clock to decide when the op actually ends.  The lockstep clock commits
    immediately at ``issue_time + cost.duration``; the event clock commits
    at the contention-stretched completion event."""
    kind: str                 # "prefill" | "decode"
    cost: PhaseCost
    stamp_first: List[Request] = field(default_factory=list)
    # requests whose first token was emitted by this op (stamped at commit)


# ---------------------------------------------------------------------------
# engine base: slot/backlog/pool state machine (model-execution agnostic)
# ---------------------------------------------------------------------------


class EngineBase:
    """Slot, backlog, and block-pool bookkeeping shared by the real and the
    simulated engine.

    Scheduler-facing surface:
      assign(requests)   — extend this partition's FIFO backlog
      wants_prefill      — drained of active work but has backlog
      busy               — at least one active slot
      issue_prefill()    -> PendingOp   (only when wants_prefill)
      issue_decode()     -> PendingOp   (only when busy)
      commit_op(op, t)   -> Optional[PhaseCost]  (refill cost, if any)
      prefill_wave(now)  -> PhaseCost   (issue+commit at now+duration)
      decode_step(now)   -> PhaseCost   (issue+commit at now+duration)

    ``issue_*`` runs the model and mutates slot state eagerly (the next op
    cannot be issued before the previous one commits, so ordering is safe);
    ``commit_op`` applies the time-dependent effects at the clock-chosen
    end instant and returns any refill-prefill cost triggered by requests
    that completed in the op.  The one-shot ``prefill_wave``/``decode_step``
    wrappers preserve the original lockstep semantics exactly.

    Per-slot state: ``slot_lens[i]`` is slot i's context length (cache
    write position, prefix tokens included) and ``slot_tables[i]`` its
    block chain.  Both are host-side source of truth; the device arrays the
    real engine feeds the model are rebuilt from them every step.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 pid: int = 0, peak_flops: float = hw.H100_PEAK_FLOPS,
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 wave_only: bool = False,
                 cost_model: Optional[CostModel] = None,
                 prefix_cache: bool = False, kv_dtype: str = "fp32",
                 sparse_threshold: float = 0.0):
        if prefix_cache and cfg.family in _NO_PREFIX_CACHE_FAMILIES:
            raise ValueError(
                f"prefix caching is not supported for the {cfg.family!r} "
                "family: its per-sequence state is not (only) KV blocks, so "
                "a shared block chain cannot stand in for a cached prefix")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}: expected one "
                             f"of {KV_DTYPES}")
        if not kv_dtype_supported(kv_dtype):
            raise ValueError(
                f"kv_dtype {kv_dtype!r} is not supported by this torch build "
                "(no float8_e4m3fn dtype); use 'int8' or 'fp32'")
        if not 0.0 <= sparse_threshold < 1.0:
            raise ValueError("sparse_threshold must be in [0, 1) — it is a "
                             "per-block attention-mass cutoff, and >= 1 "
                             f"would drop every block (got {sparse_threshold})")
        if (kv_dtype != "fp32" or sparse_threshold > 0.0) \
                and cfg.family in _NO_KV_QUANT_FAMILIES:
            raise ValueError(
                f"quantized / blockwise-sparse KV is not supported for the "
                f"{cfg.family!r} family: its per-sequence state is not "
                "(only) attention KV blocks, so packed pages or block "
                "skipping cannot represent its cache traffic")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.pid = pid
        self.peak_flops = peak_flops
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self.kv_dtype = kv_dtype
        self.sparse_threshold = float(sparse_threshold)
        # phase pricing: analytic by default (bit-for-bit the historical
        # behaviour for fp32/keep-all; quantized or sparse layouts reprice
        # the KV-traffic term); a MeasuredCostModel swaps in on-device
        # durations and its live timer (if any) is fed by _run_timed below
        self.cost_model = cost_model if cost_model is not None \
            else AnalyticCostModel(cfg, peak_flops, kv_dtype=kv_dtype,
                                   sparse_keep=1.0 - self.sparse_threshold)
        # shape buckets whose compile-tainted first sample was discarded
        self._timed_warm: set = set()
        # wave-only batching: freed slots wait for the engine to drain and
        # the next *policy-granted* prefill wave instead of refilling
        # immediately (the enc-dec behaviour, also the load shape of the
        # paper's Fig. 5 — every wave start passes through the stagger
        # policy, so phase shaping binds for the whole run, not just at
        # startup)
        self.wave_only = wave_only
        # default pool: every slot can hold a full max_len chain (+ null)
        n_blocks = pool_blocks or \
            1 + slots * int(math.ceil(max_len / block_size))
        self.pool = BlockPool(n_blocks, block_size,
                              prefix_cache=self.prefix_cache)
        self.table_width = self.pool.blocks_for(max_len)
        self.backlog: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.slot_lens: List[int] = [0] * slots
        self.slot_tables: List[List[int]] = [[] for _ in range(slots)]
        # leading reference-shared blocks per slot (prefix-cache hits): the
        # real engine masks exactly these entries out of its page scatters,
        # so shared content is written once by its original owner
        self.slot_shared: List[int] = [0] * slots
        self.assign_order: List[int] = []  # rids in service order (tests)
        self.slot_tokens: List[List[int]] = [[] for _ in range(slots)]
        self.n_prefills = 0
        self.n_refills = 0
        self.n_decode_steps = 0
        self.n_exports = 0
        self.n_imports = 0
        self.n_prefix_hits = 0     # seatings that reused cached content
        self.n_cached_tokens = 0   # cache positions served from the index
        self.completed: List[Request] = []
        self._prefix = (getattr(cfg, "n_meta_tokens", 0) or 0) + \
                       (getattr(cfg, "n_img_tokens", 0) or 0)
        # opt-in observability (repro_torch.obs): request lifecycle hops at
        # seat/first-token/retire/handoff.  Every emission site is guarded
        # by ``if self.tracer is not None`` so the off path (the default)
        # executes no tracing code on the hot issue/commit path — pinned
        # by the zero-allocation guard in tests/test_obs.py.  In cluster
        # mode worker engines keep tracer=None; the controller records
        # the same transitions from the protocol messages instead.
        self.tracer = None

    def metrics_snapshot(self):
        """Flat ((name, value), ...) metrics view — computed on demand
        from counters the engine maintains anyway (zero steady-state
        overhead).  Workers piggyback this on every ``WorkerStatus`` so
        the controller can aggregate fleet-wide; the in-process CLI folds
        the same tuples via ``repro_torch.obs.registry.merge_snapshots``."""
        return (
            ("engine.backlog", float(len(self.backlog))),
            ("engine.decode_steps", float(self.n_decode_steps)),
            ("engine.exports", float(self.n_exports)),
            ("engine.imports", float(self.n_imports)),
            ("engine.prefills", float(self.n_prefills)),
            ("engine.refills", float(self.n_refills)),
            ("engine.slots_in_use",
             float(sum(1 for r in self.active if r is not None))),
            ("pool.cached_blocks", float(self.pool.n_cached)),
            ("pool.cow", float(self.pool.n_cow)),
            ("pool.evicted", float(self.pool.n_evicted)),
            ("pool.free_blocks", float(self.pool.n_free)),
            ("prefix.cached_tokens", float(self.n_cached_tokens)),
            ("prefix.hits", float(self.n_prefix_hits)),
        )

    # -- scheduler predicates ------------------------------------------------
    @property
    def busy(self) -> bool:
        return any(r is not None for r in self.active)

    @property
    def wants_prefill(self) -> bool:
        return (not self.busy) and bool(self.backlog)

    @property
    def idle(self) -> bool:
        return not self.busy and not self.backlog

    def assign(self, requests: List[Request]) -> None:
        self.backlog.extend(requests)

    def _ctx_budget(self, req: Request) -> int:
        """Cache positions this request needs end-to-end."""
        return self._prefix + req.prompt_len + req.max_new_tokens

    # -- prefix caching ------------------------------------------------------
    def _prefix_key(self, req: Request) -> list:
        """Content key for the prefix index: one sentinel per meta/img
        position (their embeddings are request-independent in the current
        frontends, so every request shares them) followed by the prompt
        token ids."""
        return [("pfx", j) for j in range(self._prefix)] + \
            [int(t) for t in np.asarray(req.prompt).reshape(-1)]

    def peek_cached(self, req: Request) -> int:
        """Prompt tokens of ``req`` the prefix cache would serve right now
        (0 when caching is off).  Pure peek — admission-control probes and
        the demand policy's cost estimates price from this without
        touching pool state."""
        if not self.prefix_cache:
            return 0
        hit = self.pool.peek_cached_tokens(self._prefix_key(req))
        return max(hit - self._prefix, 0)

    def _alloc_blocks(self, req: Request) -> ChainAlloc:
        """Allocate ``req``'s full-budget block chain, reusing cached
        prefix blocks when caching is on (all-or-nothing either way)."""
        need = self._ctx_budget(req)
        if not self.prefix_cache:
            return ChainAlloc(self.pool.alloc_for_tokens(need))
        return self.pool.alloc_chain(self._prefix_key(req), need)

    def _seat_blocks(self, i: int, req: Request, ca: ChainAlloc) -> None:
        """Install an allocated chain into slot ``i``'s bookkeeping and
        stamp the request's actual hit length (prompt-token units)."""
        self.slot_tables[i] = ca.table
        self.slot_shared[i] = ca.shared_blocks
        req.cached_len = max(ca.cached_tokens - self._prefix, 0)
        if ca.cached_tokens:
            self.n_prefix_hits += 1
            self.n_cached_tokens += ca.cached_tokens

    def _register_prefix(self, i: int, req: Request) -> None:
        """Publish slot ``i``'s prompt-content blocks in the prefix index
        (generated tokens are never shared, so registration stops at the
        end of the prompt)."""
        if self.prefix_cache:
            self.pool.register_chain(self._prefix_key(req),
                                     self.slot_tables[i],
                                     self._prefix + req.prompt_len)

    # -- KV handoff (prefill/decode disaggregation) --------------------------
    def export_kv(self, rid: int):
        """Remove active request ``rid`` from this engine, returning
        ``(request, state)`` — the request object plus everything a peer
        engine needs to continue decoding it: ``state['len']`` is the
        slot's context length, ``state['kv_bytes']`` the modeled transfer
        size (the per-slot cache bytes one decode step streams, in this
        engine's cost-model dtype), ``state['pages']`` the device arrays
        gathered by ``_export_slot_state`` (empty for the simulated
        engine).  The slot and its blocks are freed immediately — the
        prefill-pool worker can start its next wave while the payload is
        still in flight."""
        from repro_torch.core.traffic import decode_kv_bytes

        for i, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                break
        else:
            raise KeyError(f"request {rid} is not active on engine "
                           f"{self.pid}")
        from repro_torch.profiling.cost_model import KV_PRICE_BYTES

        dtype_bytes = int(getattr(self.cost_model, "dtype_bytes", 2))
        state = {
            "len": int(self.slot_lens[i]),
            # a quantized pool ships packed pages, so the handoff payload is
            # priced at the pool's bytes-per-element, not the model dtype's
            "kv_bytes": float(decode_kv_bytes(
                self.cfg, self.slot_lens[i], dtype_bytes,
                kv_dtype_bytes=KV_PRICE_BYTES.get(self.kv_dtype))),
            "kv_dtype": self.kv_dtype,
            "pages": self._export_slot_state(i),
        }
        self.active[i] = None
        # a decref, not a destroy: blocks shared with other chains (or
        # published in the prefix index) survive the donor's departure
        self.pool.free(self.slot_tables[i])
        self.slot_tables[i] = []
        self.slot_shared[i] = 0
        self.slot_lens[i] = 0
        self.n_exports += 1
        if self.tracer is not None:
            self.tracer.lifecycle.event(req.rid, "handoff_export",
                                        self.tracer.vnow, pid=self.pid,
                                        kv_bytes=state["kv_bytes"])
        return req, state

    def import_kv(self, req: Request, state: dict) -> int:
        """Seat a handed-off request in a free slot and restore its KV
        state; returns the slot index.  All-or-nothing: every capacity
        check runs BEFORE any state mutates, so a ``PoolExhausted`` (no
        free slot, or not enough blocks for the request's full context
        budget) leaves the engine untouched and the caller free to defer
        the import to another worker or a later time."""
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free:
            raise PoolExhausted(
                f"engine {self.pid}: no free slot for imported request "
                f"{req.rid} ({self.slots} slots active)")
        need = self._ctx_budget(req)
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid} needs {need} cache positions > "
                f"per-slot budget max_len={self.max_len}")
        if int(state["len"]) > need:
            raise ValueError(
                f"request {req.rid} imports len={state['len']} beyond its "
                f"context budget {need}")
        if not self.pool.can_fit(need):
            raise PoolExhausted(
                f"engine {self.pid}: request {req.rid} needs "
                f"{self.pool.blocks_for(need)} blocks; pool has "
                f"{self.pool.n_free} of {self.pool.n_blocks}")
        i = free[0]
        # re-match the prompt against the recipient's own prefix index: a
        # shared system prompt already resident here is reference-shared
        # instead of re-stored, and the handoff scatter masks those blocks
        # out (their content is already authoritative on this engine)
        self._seat_blocks(i, req, self._alloc_blocks(req))
        self.active[i] = req
        self.slot_lens[i] = int(state["len"])
        self.assign_order.append(req.rid)
        self._import_slot_state(i, state.get("pages") or {}, req)
        self._register_prefix(i, req)
        self.n_imports += 1
        if self.tracer is not None:
            self.tracer.lifecycle.event(req.rid, "handoff_import",
                                        self.tracer.vnow, pid=self.pid)
        return i

    # -- cost estimates (used by the demand policy) --------------------------
    def prefill_cost_est(self) -> PhaseCost:
        n = min(self.slots, max(len(self.backlog), 1))
        plen = self.backlog[0].prompt_len if self.backlog else self.max_len // 2
        # price the NEXT wave as it would actually run: a resident shared
        # prefix makes it cheaper, and the demand policy must space from
        # the post-hit cost, not the cold one
        cached = self.peek_cached(self.backlog[0]) if self.backlog else 0
        return self.cost_model.prefill(n, plen, cached)

    def decode_cost_est(self) -> PhaseCost:
        ctxs = [max(l, 1) for r, l in zip(self.active, self.slot_lens)
                if r is not None]
        if not ctxs:
            plen = (self.backlog[0].prompt_len if self.backlog
                    else self.max_len // 2)
            ctxs = [max(self._prefix + plen, 1)] * self.slots
        return self.cost_model.decode(ctxs)

    # -- on-device timing: feed the cost model's live PhaseTimer -------------
    def _run_timed(self, phase: str, batch: int, tokens: int, fn):
        """Run a model-execution hook, wall-clocking it into the cost
        model's timer when one is attached.

        Both edges must block on the device (``_sync_device``): JAX
        dispatch is asynchronous, so work queued by a PREVIOUS op would
        otherwise bill into this measurement, and the return of ``fn``
        alone does not mean this op ran.  The first sample per shape
        bucket is discarded — the first execution of a jitted fn at a new
        shape includes XLA compilation (seconds against microseconds of
        steady-state run time), and an EMA never fully forgets a sample
        that large."""
        timer = self.cost_model.timer
        if timer is None:
            return fn()
        self._sync_device()
        t0 = time.perf_counter()
        out = fn()
        self._sync_device()
        dt = time.perf_counter() - t0
        key = shape_key(phase, batch, tokens)
        if key in self._timed_warm:
            timer.observe(key, dt)
        else:
            self._timed_warm.add(key)   # compile-tainted: discard
        return out

    # -- phase execution: issue (eager) / commit (clock-timed) ---------------
    def issue_prefill(self) -> PendingOp:
        assert self.wants_prefill, "issue_prefill() on a busy/idle engine"
        # validate the whole candidate wave BEFORE allocating anything, so
        # a contract violation cannot leak earlier members' blocks
        for req in self.backlog[:self.slots]:
            if self._ctx_budget(req) > self.max_len:
                raise ValueError(
                    f"request {req.rid} needs {self._ctx_budget(req)} cache "
                    f"positions > per-slot budget max_len={self.max_len}")
        wave: List[Request] = []
        for req in self.backlog[:self.slots]:
            if not self.pool.can_fit(self._ctx_budget(req)):
                break  # pool exhausted: the rest stays queued (FIFO)
            wave.append(req)
            self._seat_blocks(len(wave) - 1, req, self._alloc_blocks(req))
            self._register_prefix(len(wave) - 1, req)  # intra-wave sharing
        if not wave:
            raise PoolExhausted(
                f"request {self.backlog[0].rid} needs "
                f"{self.pool.blocks_for(self._ctx_budget(self.backlog[0]))} "
                f"blocks; pool has {self.pool.n_free} of {self.pool.n_blocks}")
        self.backlog = self.backlog[len(wave):]
        lens = [r.prompt_len for r in wave]
        cost = self.cost_model.prefill_ragged(
            lens, [r.cached_len for r in wave] if self.prefix_cache else None)
        first = self._run_timed("prefill", len(wave), max(lens),
                                lambda: self._run_prefill(wave))
        for i, req in enumerate(wave):
            self.active[i] = req
            self.slot_lens[i] = self._prefix + req.prompt_len
            self.assign_order.append(req.rid)
            if first is not None:  # prefill emits the first token
                req.tokens.append(int(first[i]))
                self.slot_tokens[i].append(int(first[i]))
        for i in range(len(wave), self.slots):
            self.active[i] = None
            self.slot_lens[i] = 0
        self.n_prefills += 1
        if self.tracer is not None:
            t = self.tracer.vnow
            for req in wave:
                self.tracer.lifecycle.event(req.rid, "prefill", t,
                                            pid=self.pid,
                                            cached_len=req.cached_len)
        return PendingOp("prefill", cost,
                         list(wave) if first is not None else [])

    def issue_decode(self) -> PendingOp:
        assert self.busy, "issue_decode() on an engine with no active slots"
        ctxs = [max(l, 1) for r, l in zip(self.active, self.slot_lens)
                if r is not None]
        cost = self.cost_model.decode(ctxs)
        toks = self._run_timed("decode", len(ctxs), sum(ctxs),
                               self._run_decode)
        firsts: List[Request] = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.slot_lens[i] += 1
            req.tokens.append(int(toks[i]))
            self.slot_tokens[i].append(int(toks[i]))
            if req.t_first_token is None:
                firsts.append(req)
        self.n_decode_steps += 1
        return PendingOp("decode", cost, firsts)

    def commit_op(self, pending: PendingOp,
                  t_end: float) -> Optional[PhaseCost]:
        """Apply the op's time-dependent effects at its end instant: stamp
        first tokens, retire completed requests, refill freed slots.
        Returns the combined cost of any refill prefills (the caller bills
        them into its tick or schedules them as a follow-on span)."""
        for req in pending.stamp_first:
            if req.t_first_token is None:
                req.t_first_token = t_end
                if self.tracer is not None:
                    self.tracer.lifecycle.event(req.rid, "first_token",
                                                t_end, pid=self.pid)
        return self._finish_done(t_end)

    # -- one-shot wrappers (lockstep clock + direct use in tests) ------------
    def prefill_wave(self, now: float) -> PhaseCost:
        pend = self.issue_prefill()
        return pend.cost.merge(self.commit_op(pend, now + pend.cost.duration))

    def decode_step(self, now: float) -> PhaseCost:
        pend = self.issue_decode()
        return pend.cost.merge(self.commit_op(pend, now + pend.cost.duration))

    def _retire(self, i: int, req: Request, t: float) -> None:
        req.t_done = t
        self.completed.append(req)
        self.active[i] = None
        self.pool.free(self.slot_tables[i])
        self.slot_tables[i] = []
        self.slot_shared[i] = 0
        self.slot_lens[i] = 0
        if self.tracer is not None:
            self.tracer.lifecycle.event(req.rid, "retire", t, pid=self.pid,
                                        tokens=len(req.tokens))

    def _finish_done(self, t_end: float) -> Optional[PhaseCost]:
        """Retire finished requests and refill their slots per-slot: the
        newcomer's OWN prompt is prefilled into freshly allocated blocks
        (FIFO, gated only by pool capacity).  Returns the combined cost of
        any refill prefills so the caller can bill them into its tick."""
        extra: Optional[PhaseCost] = None
        t_cursor = t_end
        for i, req in enumerate(self.active):
            if req is None or not req.done:
                continue
            self._retire(i, req, t_end)
            # chained refill: a newcomer whose prefill-emitted first token
            # already exhausts its budget retires immediately and frees the
            # slot for the next backlog request within the same tick
            while self.backlog and self._supports_slot_refill():
                nxt = self.backlog[0]
                if (self._ctx_budget(nxt) > self.max_len
                        or not self.pool.can_fit(self._ctx_budget(nxt))):
                    # exhausted now (retried on the next completion);
                    # over-budget requests surface as ValueError at the wave
                    break
                self.backlog.pop(0)
                self._seat_blocks(i, nxt, self._alloc_blocks(nxt))
                self._register_prefix(i, nxt)
                c = self.cost_model.prefill(1, nxt.prompt_len,
                                            nxt.cached_len)
                tok = self._run_timed("prefill", 1, nxt.prompt_len,
                                      lambda: self._refill_slot(i, nxt))
                self.active[i] = nxt
                self.slot_lens[i] = self._prefix + nxt.prompt_len
                self.assign_order.append(nxt.rid)
                self.n_refills += 1
                if self.tracer is not None:
                    self.tracer.lifecycle.event(nxt.rid, "prefill", t_cursor,
                                                pid=self.pid, refill=True,
                                                cached_len=nxt.cached_len)
                t_cursor += c.duration  # refills in a tick run sequentially
                extra = c if extra is None else extra.merge(c)
                if tok is not None:
                    nxt.tokens.append(int(tok))
                    self.slot_tokens[i].append(int(tok))
                    nxt.t_first_token = t_cursor
                    if self.tracer is not None:
                        self.tracer.lifecycle.event(nxt.rid, "first_token",
                                                    t_cursor, pid=self.pid)
                if not nxt.done:
                    break
                self._retire(i, nxt, t_cursor)
        return extra

    # -- model-execution hooks ----------------------------------------------
    def _supports_slot_refill(self) -> bool:
        return not self.wave_only

    def _sync_device(self) -> None:
        """Block until the engine's device state is materialized (the stop
        edge of a phase-op wall-clock measurement).  The base/simulated
        engine has no device; the real engine overrides this with
        ``torch.cuda.synchronize`` on its device."""

    def _run_prefill(self, wave: List[Request]):
        """Seat ``wave`` in slots [0, len(wave)); returns per-slot first
        tokens (len(wave),) or None."""
        raise NotImplementedError

    def _run_decode(self):
        """Returns per-slot next tokens (slots,)."""
        raise NotImplementedError

    def _refill_slot(self, i: int, req: Request):
        """Prefill ``req``'s own prompt into slot ``i`` (blocks already
        allocated).  Returns the request's first token, or None."""
        raise NotImplementedError

    def _export_slot_state(self, i: int) -> dict:
        """Gather slot ``i``'s device state as host numpy arrays (keyed by
        name).  The base engine has no device state — the simulated engine
        hands off an empty payload and migration is pure bookkeeping."""
        return {}

    def _import_slot_state(self, i: int, pages: dict,
                           req: Request) -> None:
        """Install an exported payload into slot ``i`` (tables already
        allocated, request already seated).  Base engine: nothing to do."""


# ---------------------------------------------------------------------------
# real engine (torch, via models.api)
# ---------------------------------------------------------------------------


class PartitionEngine(EngineBase):
    """Runs the actual model in PyTorch on ``api.device``.  ``params`` may
    be shared across engines in-process (they are read-only during
    serving); on hardware each partition holds its own replica — the
    paper's reuse-vs-shaping tradeoff.

    ``paged=True`` (the default) stores KV in the block pool and decodes
    through ``models.transformer.decode_step_paged``, whose pool update is
    in place (the reference donates the pool to its jitted step instead);
    the pool may be packed (``kv_dtype`` int8/fp8), decode may skip
    low-mass blocks (``sparse_threshold``) and prompts may share cached
    prefix blocks (``prefix_cache``).  ``paged=False`` keeps the dense
    ``(L, slots, max_len)`` slab with per-slot lengths and decodes through
    ``decode_step`` — same serving semantics, the equivalence oracle.  The
    SSM and hybrid families keep each slot's SSM state and conv window in
    per-slot arrays beside the pool (or in the slab), updated in place by
    every decode step, idle slots included, as in the reference.
    Enc-dec models keep the dense slab (``paged`` defaults to False and
    True raises) and wave-only batching, as in the reference: each wave
    encodes frame embeddings drawn from ``np.random.default_rng(seed +
    pid)``, one (slots, enc_seq, d) f32 draw a wave, into the slab's cross
    K/V; the wave's prefill emits no first token (every slot's first
    decode input is token 1), and every decode step writes and attends at
    one position for the whole wave, the number of steps since its
    prefill.  ``export_kv`` / ``import_kv`` move a
    slot's KV state between engines (PD disaggregation) as host tensors,
    the reference's ``KvHandoff`` payload (not for enc-dec, whose cache is
    the wave's: they raise, as the reference's do).

    Every decode step runs through the engine's ``DecodeGraph``
    (``serving/step_graph.py``), the counterpart of the reference's jitted
    step: on a card the first step runs eagerly on its static buffers, the
    second is captured as a CUDA graph and every later one replays it; on
    the CPU every step runs the same static-buffer path eagerly.
    Every prefill wave and slot refill runs through ``prefill_graphs``
    (``serving/prefill_graph.py``), the counterpart of the reference's
    ``prefill_fn`` / ``prefill_uniform_fn``: one cache of captured
    prefills by shape, which engines on one api share (the serve CLI
    builds one for its fleet; None makes the engine its own).  The pool
    or slab install stays outside the graph.  ``cuda_graph=False`` keeps
    the decode step and the prefills that rebuild their inputs and run
    eagerly every time: the equivalence gate and the profilers' A/B use
    it, nothing else.
    """

    def __init__(self, cfg: ModelConfig, api, params, *, slots: int,
                 max_len: int, pid: int = 0,
                 peak_flops: float = hw.H100_PEAK_FLOPS,
                 seed: int = 0, paged: Optional[bool] = None,
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 wave_only: bool = False,
                 cost_model: Optional[CostModel] = None,
                 prefix_cache: bool = False, kv_dtype: str = "fp32",
                 sparse_threshold: float = 0.0, cuda_graph: bool = True,
                 prefill_graphs: Optional[PrefillGraphs] = None):
        super().__init__(cfg, slots=slots, max_len=max_len, pid=pid,
                         peak_flops=peak_flops, block_size=block_size,
                         pool_blocks=pool_blocks, wave_only=wave_only,
                         cost_model=cost_model, prefix_cache=prefix_cache,
                         kv_dtype=kv_dtype, sparse_threshold=sparse_threshold)
        self.encdec = cfg.family == "encdec"
        self.paged = (not self.encdec) if paged is None else bool(paged)
        if self.paged and self.encdec:
            raise ValueError("paged KV is not supported for enc-dec models")
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix caching shares KV *blocks* and needs "
                             "the paged pool (paged=True); the dense "
                             "per-wave slab has no blocks to share")
        if (self.kv_dtype != "fp32" or self.sparse_threshold > 0.0) \
                and not self.paged:
            raise ValueError("kv quantization / blockwise-sparse attention "
                             "live in the paged block pool (paged=True); "
                             "the dense per-wave slab has neither packed "
                             "pages nor block granularity to skip")
        self.api = api
        self.params = params
        self.device = api.device
        self.cache = None          # dense mode: the (L, slots, max_len) slab
        self.pages = None          # paged mode: pool tensors (+ scales,
        #                            the per-slot SSM arrays)
        self._last_tok = None      # (slots, 1) int32 host array
        self.last_logits = None    # (slots, V) np, for equivalence tests
        self.cuda_graph = bool(cuda_graph)
        self.graph: Optional[DecodeGraph] = None   # built at the 1st decode
        if prefill_graphs is not None and \
                (not self.cuda_graph or prefill_graphs.api is not api):
            raise ValueError("prefill_graphs: a cache of this engine's api, "
                             "for an engine with cuda_graph=True")
        self.prefill_graphs = prefill_graphs if prefill_graphs is not None \
            else PrefillGraphs(api) if self.cuda_graph else None
        # enc-dec: the stub frontend's frames (the reference's draw) and
        # the decode position of the current wave
        self._rng = np.random.default_rng(seed + pid)
        self._wave_pos = 0

    # -- batch assembly ------------------------------------------------------
    def _make_batch(self, prompts: List[np.ndarray]) -> dict:
        stack = np.stack([np.asarray(p, np.int32) for p in prompts])
        return self.api.prefill_batch(torch.as_tensor(stack,
                                                      device=self.device))

    def _has_ssm(self) -> bool:
        return self.cfg.family in ("ssm", "hybrid")

    def _prefill(self, tokens: np.ndarray, max_len: int, lens=None):
        """One prefill of ``tokens`` (rows, width): through the prefill
        graphs, or eagerly on freshly built inputs."""
        if self.prefill_graphs is not None:
            return self.prefill_graphs(self.params, tokens, max_len,
                                       lens=lens)
        return self.api.prefill(
            self.params, self._make_batch(list(tokens)), max_len=max_len,
            lens=None if lens is None else torch.as_tensor(
                lens, device=self.device))

    # -- prefill paths -------------------------------------------------------
    def _wave_prefill_cache(self, wave: List[Request]):
        """Run the wave's prompts, returning (first_logits, dense cache)
        covering slots [0, len(wave)) with a per-slot ``len`` vector.

        Attention-only families run the ragged wave as ONE padded batch:
        causal masking keeps each slot's last-token logits and cache
        prefix exact.  SSM-bearing families run one batch per distinct
        prompt length instead, each padded to the full slot width with
        zero prompts, never within a row (their recurrent state
        integrates every input position), and each group's rows are
        copied into a cache of the wave's own before the next group runs
        (a prefill graph's outputs are rewritten by its next replay)."""
        if self._has_ssm():
            return self._group_prefill_cache(wave)
        lens = np.array([r.prompt_len for r in wave], np.int32)
        width = max(int(lens.max()), 1)
        padded = np.zeros((self.slots, width), np.int32)
        for i, r in enumerate(wave):
            padded[i, :r.prompt_len] = np.asarray(r.prompt, np.int32)
        lens_full = np.concatenate(
            [lens, np.ones(self.slots - len(wave), np.int32)])
        return self._prefill(padded, self.max_len, lens=lens_full)

    def _group_prefill_cache(self, wave: List[Request]):
        """The SSM families' wave: one uniform prefill per distinct prompt
        length (the reference's ``_wave_prefill_cache``, its SSM branch)."""
        cache = self.api.init_cache(self.slots, self.max_len)
        logits = None
        by_len: dict = {}
        for i, r in enumerate(wave):
            by_len.setdefault(r.prompt_len, []).append(i)
        for plen, idxs in by_len.items():
            tokens = np.zeros((self.slots, plen), np.int32)
            for j, i in enumerate(idxs):
                tokens[j] = np.asarray(wave[i].prompt, np.int32)
            lg, cg = self._prefill(tokens, self.max_len)
            rows = torch.as_tensor(idxs, dtype=torch.long, device=self.device)
            src = torch.arange(len(idxs), device=self.device)
            for key, t in cache.items():
                dim = 0 if key == "len" else 1
                t.index_copy_(dim, rows, cg[key].index_select(dim, src))
            if logits is None:
                logits = torch.empty((len(wave), lg.shape[-1]),
                                     dtype=lg.dtype, device=self.device)
            logits.index_copy_(0, rows, lg.index_select(0, src))
        return logits, cache

    def _ensure_pages(self) -> None:
        """Lazily initialise the paged pool tensors and the per-slot SSM
        arrays (first prefill, or first import on a decode engine)."""
        if self.pages is None:
            self.pages = KV.init_pages(self.cfg, self.pool.n_blocks,
                                       self.block_size, device=self.device,
                                       kv_dtype=self.kv_dtype)
            if self._has_ssm():
                st = self.api.init_cache(self.slots, 1)
                for key in _SSM_KEYS:
                    self.pages[key] = st[key]

    def _install_paged(self, cache, rows: List[int],
                       src_rows: Optional[List[int]] = None) -> None:
        """Move batch rows ``src_rows`` (default: ``rows`` themselves) of a
        dense cache into slots ``rows``: K/V prefixes into the block pool,
        SSM state into the per-slot arrays, one scatter per pool tensor
        regardless of how many slots are installed (an SSM-only cache has
        no K/V to scatter)."""
        self._ensure_pages()
        src = list(src_rows if src_rows is not None else rows)
        src_t = torch.as_tensor(src, dtype=torch.long, device=self.device)
        if "k" in cache:
            tables = np.zeros((len(rows), self.table_width), np.int32)
            for j, i in enumerate(rows):
                tables[j, :len(self.slot_tables[i])] = self.slot_tables[i]
                # leading reference-shared blocks (prefix-cache hits)
                # already hold this content: divert their rewrite to the
                # null block
                tables[j, :self.slot_shared[i]] = NULL_BLOCK
            # a packed pool quantizes on this append (write_prefix_pages)
            KV.write_prefix_pages(self.pages, cache["k"][:, src_t],
                                  cache["v"][:, src_t],
                                  torch.as_tensor(tables, device=self.device))
        if self._has_ssm():
            rows_t = torch.as_tensor(rows, dtype=torch.long,
                                     device=self.device)
            for key in _SSM_KEYS:
                self.pages[key].index_copy_(
                    1, rows_t, cache[key].index_select(1, src_t))

    def _encdec_prefill(self) -> None:
        """An enc-dec wave: the encoder and the cross K/V of one draw of
        frames for every slot, into the engine's slab; the prompts are not
        consumed (stub frontend), and no first token is emitted."""
        frames = self._rng.standard_normal(
            (self.slots, self.cfg.enc_seq, self.cfg.d_model),
            dtype=np.float32)
        if self.prefill_graphs is not None:
            _, cache = self.prefill_graphs.encode(self.params, frames,
                                                  self.max_len)
        else:
            _, cache = self.api.prefill(
                self.params, self.api.prefill_batch(torch.as_tensor(
                    frames, device=self.device)), max_len=self.max_len)
        self._install_dense(cache)
        self._wave_pos = 0
        self._last_tok = np.ones((self.slots, 1), np.int32)

    def _install_dense(self, cache) -> None:
        """Make ``cache`` the engine's slab: at the first wave a copy of
        its own (a prefill graph's output tensors are rewritten by its
        next replay, this engine's or another's), at every later one
        copied into that slab, which a captured decode step reads by
        address."""
        if self.cache is None:
            self.cache = {k: t.clone() for k, t in cache.items()}
        else:
            for key, t in cache.items():
                self.cache[key].copy_(t)

    def _run_prefill(self, wave: List[Request]):
        if self.encdec:
            self._encdec_prefill()
            return None
        # seat lens before installing storage (base sets them after
        # _run_prefill returns, so mirror the assignment here first)
        for i, req in enumerate(wave):
            self.slot_lens[i] = self._prefix + req.prompt_len
        logits, cache = self._wave_prefill_cache(wave)
        if self.paged:
            self._install_paged(cache, list(range(len(wave))))
            self.cache = None
        else:
            # one slab for the engine's life (a refill writes it in place)
            self._install_dense(cache)
        first = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        last = np.ones((self.slots, 1), np.int32)
        last[:first.shape[0], 0] = first.reshape(-1)[:self.slots]
        self._last_tok = last
        return first.reshape(-1)[:len(wave)]

    def _refill_slot(self, i: int, req: Request):
        prompt = np.asarray(req.prompt, np.int32)
        ml = self._prefix + req.prompt_len if self.paged else self.max_len
        lg, c1 = self._prefill(prompt[None], ml)
        self.slot_lens[i] = self._prefix + req.prompt_len
        if self.paged:
            self._install_paged(c1, [i], src_rows=[0])
        else:
            for key in _CACHE_KEYS:
                if key in c1:
                    self.cache[key][:, i] = c1[key][:, 0]
            self.cache["len"][i] = c1["len"][0]
        tok = int(torch.argmax(lg, dim=-1).reshape(-1)[0])
        last = self._last_tok.copy()
        last[i, 0] = tok
        self._last_tok = last
        return tok

    # -- KV handoff device-state movers --------------------------------------
    def _export_slot_state(self, i: int) -> dict:
        """Gather slot ``i``'s cache to host tensors, in table order (paged)
        or as the slot's dense rows, with its SSM state and conv window:
        copies, since the engine goes on writing these tensors in place
        (``.cpu()`` of a CPU tensor would be the tensor itself).  The last
        generated token is not shipped — it is ``req.tokens[-1]``
        and the importer rebuilds the ``_last_tok`` row from it."""
        if self.encdec:
            raise ValueError("KV handoff is not supported for enc-dec "
                             "models (wave-shared decoder cache)")
        out: dict = {}
        if self.paged:
            if self.pages is not None:
                tbl = torch.as_tensor(self.slot_tables[i], dtype=torch.long,
                                      device=self.device)
                # packed pages travel as-is, with their scales, so the
                # importer rebuilds the quantized layout exactly
                for name, key in _HANDOFF_PAGES:
                    if key in self.pages:
                        out[name] = self.pages[key][:, tbl].cpu()
                for key in _SSM_KEYS:
                    if key in self.pages:
                        out[key] = self.pages[key][:, i].to("cpu",
                                                             copy=True)
        elif self.cache is not None:
            for key in _CACHE_KEYS:
                if key in self.cache:
                    out[key] = self.cache[key][:, i].to("cpu", copy=True)
        return out

    def _import_slot_state(self, i: int, pages: dict,
                           req: Request) -> None:
        """Scatter a handoff payload into slot ``i`` IN PLACE: a captured
        decode graph reads the addresses of the pool tensors and of the
        dense slab, so they are written through, never rebound (the slab,
        when this engine has none yet, is allocated here once and kept for
        life, as ``_run_prefill`` does).  The slot then reaches the graph's
        next replay through its host-side lens, tables and ``_last_tok``,
        exactly as a refill does."""
        if self.encdec:
            raise ValueError("KV handoff is not supported for enc-dec "
                             "models (wave-shared decoder cache)")
        if not req.tokens:
            raise ValueError(f"request {req.rid} imported before prefill "
                             "(no generated tokens to resume from)")
        if self.paged:
            self._ensure_pages()
            if "k" in pages:
                n_blk = len(self.slot_tables[i])
                if pages["k"].shape[1] != n_blk:
                    raise ValueError(
                        f"handoff carries {pages['k'].shape[1]} blocks but "
                        f"slot {i} allocated {n_blk} (block_size mismatch "
                        "across the fleet?)")
                if ("k_scales" in pages) != ("k_scales" in self.pages):
                    raise ValueError(
                        "KV handoff layout mismatch: donor and receiver "
                        "must use the same kv_dtype (packed pages carry "
                        "per-block scales a float pool cannot hold, and "
                        "float pages cannot be scattered into a packed "
                        "pool without requantizing)")
                tbl = list(self.slot_tables[i])
                # blocks re-matched from this engine's own prefix index
                # already hold the donor's prefix content — mask them out
                # of the scatter (shared blocks are never written)
                tbl[:self.slot_shared[i]] = [NULL_BLOCK] * self.slot_shared[i]
                idx = torch.as_tensor(tbl, dtype=torch.long,
                                      device=self.device)
                for name, key in _HANDOFF_PAGES:
                    if name in pages:
                        dst = self.pages[key]
                        dst[:, idx] = pages[name].to(device=self.device,
                                                     dtype=dst.dtype)
            for key in _SSM_KEYS:
                if key in self.pages:
                    dst = self.pages[key]
                    dst[:, i] = pages[key].to(device=self.device,
                                              dtype=dst.dtype)
        else:
            if self.cache is None:
                self.cache = self.api.init_cache(self.slots, self.max_len)
            for key in _CACHE_KEYS:
                if key in self.cache and key in pages:
                    dst = self.cache[key]
                    dst[:, i] = pages[key].to(device=self.device,
                                              dtype=dst.dtype)
        last = (self._last_tok.copy() if self._last_tok is not None
                else np.ones((self.slots, 1), np.int32))
        last[i, 0] = int(req.tokens[-1])
        self._last_tok = last

    # -- decode --------------------------------------------------------------
    def _device_lens(self) -> np.ndarray:
        """Each slot's decode position: its length, 0 for an idle slot; for
        enc-dec the wave's one position, the steps since its prefill."""
        if self.encdec:
            return np.full((self.slots,), self._wave_pos, np.int32)
        return np.array([l if r is not None else 0
                         for r, l in zip(self.active, self.slot_lens)],
                        np.int32)

    def _host_tables(self) -> np.ndarray:
        tables = np.zeros((self.slots, self.table_width), np.int32)
        for i, tbl in enumerate(self.slot_tables):
            if self.active[i] is not None:
                tables[i, :len(tbl)] = tbl
        return tables

    def _run_timed(self, phase: str, batch: int, tokens: int, fn):
        # the decode steps that warm up and capture the graph cost what
        # later steps do not: keep them out of the timer, as the base keeps
        # out each bucket's first sample
        if phase == "decode" and self.cuda_graph and \
                not (self.graph is not None and self.graph.warm):
            return fn()
        if phase == "prefill" and self.prefill_graphs is not None:
            fn = self._unless_steady(batch, tokens, fn)
        return super()._run_timed(phase, batch, tokens, fn)

    def _unless_steady(self, batch: int, tokens: int, fn):
        """``fn``, marking its timer sample as a warm-up when its prefill
        was a shape's eager run or its capture: whether the prefill will
        replay is known only once its shape is, inside ``fn``; the base
        then discards the sample as it does a bucket's first."""
        def run():
            before = self.prefill_graphs.n_steady
            out = fn()
            if self.prefill_graphs.n_steady == before:
                self._timed_warm.discard(shape_key("prefill", batch, tokens))
            return out
        return run

    def _step_on(self, token, lens, tables=None):
        """The decode step on the graph's static buffers: (logits (slots,
        V) f32, greedy tokens (slots,) int32).  The pool or slab is
        updated in place."""
        if self.paged:
            pcache = dict(self.pages, tables=tables, lens=lens)
            logits, _ = self.api.decode_paged(
                self.params, token, pcache,
                sparse_threshold=self.sparse_threshold)
        else:
            logits, _ = self.api.decode(self.params, token,
                                        dict(self.cache, len=lens))
        logits = logits.reshape(self.slots, -1)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    def _run_decode(self):
        if not self.cuda_graph:
            return self._run_decode_eager()
        if self.graph is None:
            self.graph = DecodeGraph(
                self._step_on, slots=self.slots, device=self.device,
                table_width=self.table_width if self.paged else None)
        logits, toks = self.graph(
            self._last_tok, self._device_lens(),
            self._host_tables() if self.paged else None)
        self._wave_pos += 1
        self._last_tok = toks.reshape(self.slots, 1).cpu().numpy()
        self.last_logits = logits.cpu().numpy()
        return self._last_tok[:, 0]

    def _run_decode_eager(self):
        """The step without static buffers (``cuda_graph=False``): inputs
        rebuilt on the device and every op issued from Python, each step."""
        token = torch.as_tensor(self._last_tok, device=self.device)
        lens = torch.as_tensor(self._device_lens(), device=self.device)
        if self.paged:
            pcache = dict(self.pages)
            pcache["tables"] = torch.as_tensor(self._host_tables(),
                                               device=self.device)
            pcache["lens"] = lens
            logits, pcache = self.api.decode_paged(
                self.params, token, pcache,
                sparse_threshold=self.sparse_threshold)
            self.pages = {k: v for k, v in pcache.items()
                          if k not in ("tables", "lens")}
        else:
            cache = dict(self.cache)
            cache["len"] = lens
            logits, self.cache = self.api.decode(self.params, token, cache)
        self._wave_pos += 1
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        self._last_tok = toks.reshape(self.slots, 1).cpu().numpy()
        self.last_logits = logits.reshape(self.slots, -1).cpu().numpy()
        return self._last_tok[:, 0]

    def _supports_slot_refill(self) -> bool:
        return not self.encdec and not self.wave_only

    def _sync_device(self) -> None:
        """Wait for the issued op's device work (the stop edge of a
        phase-op wall-clock measurement)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class SimulatedEngine(EngineBase):
    """Same slot/backlog/pool/phase state machine, no model execution:
    tokens are synthetic.  Used by scheduler unit tests and the partitions
    x policy benchmark sweep, where only phase timing, pool accounting, and
    bandwidth demand matter."""

    def _run_prefill(self, wave):
        return np.arange(len(wave)) + 1

    def _run_decode(self):
        return np.full(self.slots, 1 + (self.n_decode_steps % 7))

    def _refill_slot(self, i, req):
        return 1 + (self.n_refills % 7)

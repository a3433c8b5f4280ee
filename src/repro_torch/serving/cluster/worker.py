"""Partition worker: one engine behind the cluster message protocol.

``WorkerRuntime`` is the protocol adapter — it owns exactly one
``EngineBase`` and maps each controller message onto the engine's
issue/commit surface, replying with a fresh ``WorkerStatus`` snapshot.
The SAME runtime class serves both transports: the loopback transport
calls ``handle`` in-process, ``worker_main`` runs it as a subprocess
recv/handle/send loop over a multiprocessing pipe.

``WorkerSpec`` is the picklable recipe a worker process builds its engine
from (the controller never ships live objects across the boundary).  A
real engine runs on the device its spec names: ``"cuda"`` (the default)
pins worker ``wid`` to card ``wid % torch.cuda.device_count()``, so the
workers of one host spread over its cards (and share the one card of a
one-card host); ``"cpu"`` only when named, as the tests do; ``"cuda"``
without a card raises.  The reference's worker also pins a JAX submesh
(``_partition_mesh``): a ``"cuda"`` worker asks ``runtime.elastic.
submesh_plan`` for the same grid; None (every host with fewer cards than
one model group, a one-card host included) keeps the placement above,
and a grid raises, since one process group a partition is not ported.
"""
from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.engine import EngineBase, PendingOp


class WorkerRuntime:
    """Protocol adapter around one engine (any ``EngineBase``).

    ``process_metrics``, when given, returns more ``(name, value)`` pairs
    for every status snapshot: a worker process adds its boot seconds, peak
    device memory and the kernel wrappers' launch counts (process-wide,
    so only a process that holds one engine reports them)."""

    def __init__(self, engine: EngineBase,
                 process_metrics: Optional[Callable[[], Tuple]] = None):
        self.engine = engine
        self.process_metrics = process_metrics
        self._pending: Optional[PendingOp] = None
        # fleet-virtual clock as last exported by the controller (every
        # CommitOp.t_end and Ping.t_virtual); the worker never advances it
        self.vnow = 0.0

    # -- status snapshot -----------------------------------------------------
    def status(self) -> P.WorkerStatus:
        e = self.engine
        pre_dur = wave_dur = 0.0
        head_arrival = 0.0
        if e.backlog:
            head = e.backlog[0]
            head_arrival = float(head.arrival)
            if e.wants_prefill:
                # the demand-spacing ingredients, priced engine-side by the
                # worker's own cost model (analytic by default; measured
                # on-device timings under --cost-model measured) — the same
                # estimators the in-process policy uses
                pre = e.prefill_cost_est()
                pre_dur = pre.duration
                wave_dur = pre.duration + head.max_new_tokens * \
                    e.decode_cost_est().duration
        return P.WorkerStatus(
            busy=e.busy, wants_prefill=e.wants_prefill,
            backlog_len=len(e.backlog),
            n_active=sum(1 for r in e.active if r is not None),
            head_arrival=head_arrival, pre_dur=pre_dur, wave_dur=wave_dur,
            cost_source=e.cost_model.kind,
            active_rids=tuple(r.rid for r in e.active if r is not None),
            # flat metrics snapshot, piggybacked on every reply so the
            # controller's fleet view is as fresh as its worker mirror
            metrics=e.metrics_snapshot() if self.process_metrics is None
            else tuple(sorted(e.metrics_snapshot() +
                              tuple(self.process_metrics()))))

    def hello(self) -> P.Hello:
        return P.Hello(wid=self.engine.pid, slots=self.engine.slots,
                       max_len=self.engine.max_len, status=self.status())

    # -- message dispatch ----------------------------------------------------
    def handle(self, msg):
        try:
            return self._handle(msg)
        except Exception as e:  # noqa: BLE001 — shipped to the controller
            return P.WorkerError(error=f"{type(e).__name__}: {e}",
                                 traceback=traceback.format_exc())

    def _handle(self, msg):
        if isinstance(msg, P.Assign):
            self.engine.assign([wr.to_request() for wr in msg.requests])
            return P.AssignAck(status=self.status())
        if isinstance(msg, P.IssueOp):
            assert self._pending is None, "issue before previous commit"
            if msg.op == "prefill":
                self._pending = self.engine.issue_prefill()
            elif msg.op == "decode":
                self._pending = self.engine.issue_decode()
            else:
                raise ValueError(f"unknown op {msg.op!r}")
            return P.OpIssued(op=msg.op,
                              cost=P.WireCost.from_cost(self._pending.cost),
                              status=self.status())
        if isinstance(msg, P.CommitOp):
            assert self._pending is not None, "commit with no issued op"
            self.vnow = max(self.vnow, msg.t_end)
            pend, self._pending = self._pending, None
            extra = self.engine.commit_op(pend, msg.t_end)
            retired = tuple(
                P.RetiredRequest(rid=r.rid, tokens=tuple(r.tokens),
                                 t_first_token=r.t_first_token,
                                 t_done=r.t_done)
                for r in self._drain_completed())
            refill = P.WireCost.from_cost(extra) if extra is not None else None
            return P.OpCommitted(op=pend.kind, retired=retired,
                                 refill=refill, status=self.status())
        if isinstance(msg, P.ExportKv):
            from repro_torch.serving.pd import handoff as H
            handoffs = tuple(H.export_handoff(self.engine, rid)
                             for rid in msg.rids)
            return P.KvExported(handoffs=handoffs, status=self.status())
        if isinstance(msg, P.ImportKv):
            from repro_torch.serving.kv_pool import PoolExhausted
            from repro_torch.serving.pd import handoff as H
            try:
                H.apply_handoff(self.engine, msg.handoff)
            except PoolExhausted as e:
                # capacity, not failure: all-or-nothing import left the
                # engine untouched; the controller defers and retries
                return P.KvImported(ok=False, reason=str(e),
                                    status=self.status())
            return P.KvImported(ok=True, reason="", status=self.status())
        if isinstance(msg, P.Ping):
            self.vnow = max(self.vnow, msg.t_virtual)
            return P.Pong(t_wall=msg.t_wall, status=self.status(),
                          t_virtual=self.vnow)
        if isinstance(msg, P.Shutdown):
            return P.Bye(n_prefills=self.engine.n_prefills,
                         n_refills=self.engine.n_refills,
                         n_decode_steps=self.engine.n_decode_steps)
        raise ValueError(f"unknown message {type(msg).__name__}")

    def _drain_completed(self):
        out, self.engine.completed = self.engine.completed, []
        return out


# ---------------------------------------------------------------------------
# engine construction from a picklable spec (subprocess + loopback share it)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkerSpec:
    """Everything a worker process needs to build its engine.

    ``cost_model`` picks the phase-pricing source ("analytic" |
    "measured"); ``profile`` is an optional path to a saved calibration
    profile — with ``cost_model="measured"`` an existing profile is loaded
    as a FROZEN replay model (deterministic across the fleet), a missing
    one means each worker calibrates live with its own ``PhaseTimer``.
    """
    wid: int
    arch: str
    smoke: bool
    slots: int
    max_len: int
    peak_flops: float
    engine: str = "sim"          # "sim" | "real"
    wave_only: bool = False
    block_size: int = 16
    paged: Optional[bool] = None
    partitions: int = 1          # the fleet's width (the submesh plan)
    seed: int = 0
    cost_model: str = "analytic"  # phase pricing: "analytic" | "measured"
    profile: Optional[str] = None  # saved calibration profile (replay)
    prefix_cache: bool = False   # per-worker KV-pool prefix index (COW)
    kv_dtype: str = "fp32"       # KV pool element layout: fp32 | int8 | fp8
    sparse_threshold: float = 0.0  # blockwise-sparse attention cutoff
    device: str = "cuda"         # real engines: "cuda" (card wid % count),
    #                              "cuda:N" or "cpu"


def worker_device(spec: WorkerSpec):
    """The ``torch.device`` a real worker runs on: ``"cuda"`` pins worker
    ``wid`` to card ``wid % torch.cuda.device_count()``; anything else is
    taken as named.  Raises when a card is asked for and there is none."""
    import torch

    from repro_torch.device import resolve

    dev = resolve(spec.device)
    if dev.type == "cuda":
        partition_submesh(spec, torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", spec.wid % torch.cuda.device_count())
    return dev


def partition_submesh(spec: WorkerSpec, n_local_devices: int) -> None:
    """The counterpart of the reference's ``_partition_mesh``: the
    (data, model) grid ``submesh_plan`` picks for a worker of
    ``spec.partitions`` on a host of ``n_local_devices`` cards.  None (a
    host smaller than one model group) keeps the one-card placement; a
    grid raises ``NotImplementedError`` naming it: pinning one would take
    one process group a partition, the multi-card item of ROADMAP.md."""
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.elastic import submesh_plan

    plan = submesh_plan(n_local_devices, spec.partitions,
                        data_axis=M.DATA_AXIS, model_axis=M.MODEL_AXIS)
    if plan is not None:
        raise NotImplementedError(
            f"worker {spec.wid}: submesh_plan gives a (data, model) = {plan} "
            f"grid for {spec.partitions} partitions on {n_local_devices} "
            "cards; one process group a partition is not ported")


def build_engine(spec: WorkerSpec) -> EngineBase:
    """Build the engine a spec describes (used by subprocess workers and by
    the loopback transport, so both paths serve identical engines)."""
    from repro_torch.configs import get_config
    from repro_torch.profiling import make_cost_model
    from repro_torch.serving.engine import SimulatedEngine

    cfg = get_config(spec.arch, smoke=spec.smoke)
    cost_model = make_cost_model(
        spec.cost_model, cfg, spec.peak_flops, profile=spec.profile,
        kv_dtype=spec.kv_dtype, sparse_keep=1.0 - spec.sparse_threshold)
    if spec.engine == "sim" and cost_model.timer is not None:
        # a live timer on a SimulatedEngine would fold the Python wall
        # time of synthetic token generation — not device time — into the
        # EMAs and silently wreck the spacing rule; measured pricing on
        # sim engines is replay-only
        raise ValueError(
            "cost_model='measured' on a simulated engine requires a "
            "calibration profile (the sim has no device to time); "
            "calibrate with the real in-process fleet first: "
            "python -m repro_torch.launch.serve --cost-model measured "
            "--profile PATH ...")
    kw = dict(slots=spec.slots, max_len=spec.max_len, pid=spec.wid,
              peak_flops=spec.peak_flops, wave_only=spec.wave_only,
              block_size=spec.block_size, cost_model=cost_model,
              prefix_cache=spec.prefix_cache, kv_dtype=spec.kv_dtype,
              sparse_threshold=spec.sparse_threshold)
    if spec.engine == "sim":
        return SimulatedEngine(cfg, **kw)
    if spec.engine != "real":
        raise ValueError(f"unknown engine kind {spec.engine!r}")
    import torch

    from repro_torch.models import api as mapi
    from repro_torch.serving.engine import PartitionEngine

    device = worker_device(spec)
    api = mapi.build(cfg, device)
    params = api.init(torch.Generator(device).manual_seed(spec.seed))
    # the engine makes its own PrefillGraphs: one cache per worker process
    return PartitionEngine(cfg, api, params, paged=spec.paged,
                           seed=spec.seed, **kw)


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``; 0.0 where it
    cannot be read): a spawned worker's interpreter start and imports come
    before ``worker_main`` runs."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def _process_metrics(device, boot: dict):
    """What a real worker process adds to its status snapshots: its boot
    seconds by part (``boot``: process start to ``worker_main``, the CUDA
    context, the engine build, and their sum, process start to ``Hello``),
    peak device memory, and the kernel wrappers' launch counts."""
    import torch

    from repro_torch.kernels.counts import snapshot
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode, paged_decode_quant, paged_decode_sparse)

    wrappers = {"conv2d": conv2d, "flash_attention": flash_attention,
                "flash_decode": flash_decode, "matmul": matmul,
                "paged_decode": paged_decode,
                "paged_decode_quant": paged_decode_quant,
                "paged_decode_sparse": paged_decode_sparse}

    def metrics():
        counts = snapshot(list(wrappers.values()))
        out = [(f"worker.{part}_seconds", s) for part, s in boot.items()]
        out += [(f"kernel.{name}.launches", float(n))
                for name, (n, _) in zip(wrappers, counts)]
        if device.type == "cuda":
            out.append(("worker.peak_memory_bytes",
                        float(torch.cuda.max_memory_allocated(device))))
        return tuple(out)
    return metrics


def worker_main(conn, spec: WorkerSpec) -> None:
    """Subprocess entry: build the engine, say Hello, then serve the
    request/reply loop until Shutdown (or the pipe closes).  A real
    worker on a card makes that card current before it builds anything."""
    t_main = time.perf_counter()
    start = _process_age()      # the interpreter, the spawn's imports
    process_metrics = None
    if spec.engine == "real":
        import torch

        device = worker_device(spec)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.synchronize(device)      # the context exists
        t0 = time.perf_counter()
        engine = build_engine(spec)
        if device.type == "cuda":
            torch.cuda.synchronize(device)      # the weights are drawn
        t1 = time.perf_counter()
        process_metrics = _process_metrics(device, {
            "start": start, "context": t0 - t_main, "build": t1 - t0,
            "boot": start + t1 - t_main})
    else:
        engine = build_engine(spec)
    rt = WorkerRuntime(engine, process_metrics)
    conn.send(P.encode(rt.hello()))
    while True:
        try:
            msg = P.decode(conn.recv())
        except (EOFError, OSError):
            break  # controller went away
        reply = rt.handle(msg)
        conn.send(P.encode(reply))
        if isinstance(reply, P.Bye):
            break
    conn.close()

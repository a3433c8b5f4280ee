"""Cluster dispatch: controller-routed multi-process partition workers.

The in-process fleet turned into a controller + N partition-worker cluster:

  * ``protocol``  — the queue/scheduler interactions (seat request, prefill
    grant, op-complete span, retire, heartbeat) as serializable
    dataclasses, one protocol for every transport;
  * ``transport`` — deterministic in-process loopback (tests + fluid
    validation) and a real ``multiprocessing`` pipe transport, one worker
    process per ``WorkerSpec``;
  * ``worker``    — ``WorkerRuntime`` adapts one ``PartitionEngine`` /
    ``SimulatedEngine`` to the protocol; real engines pin themselves to a
    card (``WorkerSpec.device``);
  * ``controller``— the ``RequestQueue`` + routing policies (round_robin /
    shortest_backlog / shaping / pd) + heartbeat-timeout failover,
    driving the shared ``core.timeline`` contention clock.  The ``pd``
    router (``repro_torch.serving.pd``) disaggregates the fleet into prefill
    and decode pools with KV-page handoff between them.

``make_cluster`` is the one-call assembly used by the CLI, the benchmarks,
and the tests.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import hw
from repro_torch.serving.cluster.controller import (ROUTERS, ClusterController,
                                                    ClusterError,
                                                    ShapingRouter,
                                                    ShortestBacklogRouter,
                                                    RoundRobinRouter,
                                                    WorkerView, make_router)
from repro_torch.serving.cluster.transport import (TRANSPORTS,
                                                   LoopbackTransport,
                                                   PipeTransport,
                                                   SocketTransport, WorkerGone,
                                                   make_transport)
from repro_torch.serving.cluster.worker import (WorkerRuntime, WorkerSpec,
                                                build_engine, worker_device,
                                                worker_main)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import RequestQueue


def make_worker_specs(arch: str, n_workers: int, *, smoke: bool = True,
                      slots: int = 4, max_len: int = 128,
                      peak_flops_total: float = hw.H100_PEAK_FLOPS,
                      engine: str = "sim", wave_only: bool = False,
                      block_size: int = 16, paged: Optional[bool] = None,
                      seed: int = 0, cost_model: str = "analytic",
                      profile: Optional[str] = None,
                      prefix_cache: bool = False, kv_dtype: str = "fp32",
                      sparse_threshold: float = 0.0,
                      device: str = "cuda") -> List[WorkerSpec]:
    """One spec per worker; the fleet splits ``peak_flops_total`` evenly
    (the paper's 1/P compute split).  ``device`` is where real engines run
    (``"cuda"``: worker w on card w % count; see ``WorkerSpec``).
    ``cost_model`` / ``profile`` pick each worker's phase-pricing source
    (see ``WorkerSpec``); ``prefix_cache``
    turns on each worker's KV-pool prefix index (per-worker caches — the
    pool is worker-local, so hits depend on the router landing shared
    prefixes on the same worker).  ``kv_dtype`` / ``sparse_threshold``
    pick each worker's KV pool layout (packed int8/fp8 pages, blockwise-
    sparse reads); both flow into the worker's cost model so shaping
    prices the reduced traffic."""
    return [WorkerSpec(wid=w, arch=arch, smoke=smoke, slots=slots,
                       max_len=max_len,
                       peak_flops=peak_flops_total / n_workers,
                       engine=engine, wave_only=wave_only,
                       block_size=block_size, paged=paged,
                       seed=seed,
                       cost_model=cost_model, profile=profile,
                       prefix_cache=prefix_cache, kv_dtype=kv_dtype,
                       sparse_threshold=sparse_threshold, device=device)
            for w in range(n_workers)]


def make_cluster(specs: List[WorkerSpec], queue: RequestQueue, *,
                 transport: str = "loopback", router="shaping",
                 bandwidth: float = hw.H100_HBM_BW,
                 metrics: Optional[ServingMetrics] = None,
                 heartbeat_timeout: float = 60.0) -> ClusterController:
    """Assemble transport + controller for a worker fleet."""
    tp = make_transport(transport, specs,
                        heartbeat_timeout=heartbeat_timeout)
    try:
        return ClusterController(tp, queue, router=router,
                                 bandwidth=bandwidth, metrics=metrics)
    except Exception:
        tp.close()  # don't leak worker processes on a failed handshake
        raise


__all__ = [
    "ClusterController", "ClusterError", "LoopbackTransport",
    "PipeTransport", "ROUTERS", "RoundRobinRouter", "ShapingRouter",
    "ShortestBacklogRouter", "ServingMetrics", "SocketTransport",
    "TRANSPORTS", "WorkerGone", "WorkerRuntime", "WorkerSpec", "WorkerView",
    "build_engine", "make_cluster", "make_router", "make_transport",
    "make_worker_specs", "worker_device", "worker_main",
]

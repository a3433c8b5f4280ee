"""Partition-asynchronous serving in torch: the paged ``PartitionEngine``
over the reference's copied host code (queue, scheduler with both virtual
clocks, metrics, KV block pool, fluid-simulator validation, open-loop
``loadgen``), its decode step captured once as a CUDA graph
(``DecodeGraph``) and its prefills captured once per shape
(``PrefillGraphs``).  ``cluster`` lifts the fleet out of the process: a
controller routes requests to N partition workers (loopback, pipe or TCP
transports) with heartbeat failover, and ``pd`` splits them into prefill
and decode pools with KV handoff between them — see
``repro_torch.serving.cluster``."""
from repro_torch.serving.cluster import (ClusterController, ClusterError,
                                         WorkerSpec, make_cluster,
                                         make_worker_specs)
from repro_torch.serving.engine import (EngineBase, PartitionEngine,
                                        PendingOp, PhaseCost, SimulatedEngine,
                                        decode_cost, prefill_cost,
                                        prefill_cost_ragged)
from repro_torch.serving.kv_pool import BlockPool, PoolExhausted
from repro_torch.serving.loadgen import (ARRIVALS, LengthMix, OfferedRequest,
                                         SloSpec, goodput_stats,
                                         make_arrivals, make_trace,
                                         schedule_arrivals, submit_trace)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.pd import PdRouter
from repro_torch.serving.prefill_graph import PrefillGraphs
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import (CLOCKS, POLICIES, EventScheduler,
                                           PhaseStaggeredScheduler,
                                           SpanRecord, TickRecord,
                                           make_scheduler)
from repro_torch.serving.step_graph import DecodeGraph
from repro_torch.serving.trace_sim import (serving_tasklists,
                                           serving_trace_report)

__all__ = [
    "ClusterController", "ClusterError", "WorkerSpec", "make_cluster",
    "make_worker_specs",
    "EngineBase", "PartitionEngine", "PendingOp", "PhaseCost",
    "SimulatedEngine", "decode_cost", "prefill_cost", "prefill_cost_ragged",
    "BlockPool", "PdRouter", "PoolExhausted", "ServingMetrics", "Request",
    "RequestQueue",
    "ARRIVALS", "LengthMix", "OfferedRequest", "SloSpec", "goodput_stats",
    "make_arrivals", "make_trace", "schedule_arrivals", "submit_trace",
    "CLOCKS", "POLICIES", "EventScheduler", "PhaseStaggeredScheduler",
    "SpanRecord", "TickRecord", "make_scheduler", "serving_tasklists",
    "serving_trace_report", "DecodeGraph", "PrefillGraphs",
]

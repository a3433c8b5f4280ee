"""Partition-asynchronous serving in torch: the paged ``PartitionEngine``
over the reference's copied host code (queue, scheduler with both virtual
clocks, metrics, KV block pool, fluid-simulator validation), its decode
step captured once as a CUDA graph (``DecodeGraph``) and its prefills
captured once per shape (``PrefillGraphs``)."""
from repro_torch.serving.engine import (EngineBase, PartitionEngine,
                                        PendingOp, PhaseCost, decode_cost,
                                        prefill_cost, prefill_cost_ragged)
from repro_torch.serving.kv_pool import BlockPool, PoolExhausted
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefill_graph import PrefillGraphs
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import (CLOCKS, POLICIES, EventScheduler,
                                           PhaseStaggeredScheduler,
                                           make_scheduler)
from repro_torch.serving.step_graph import DecodeGraph
from repro_torch.serving.trace_sim import (serving_tasklists,
                                           serving_trace_report)

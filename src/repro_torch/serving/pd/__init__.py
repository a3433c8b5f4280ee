"""Prefill/decode disaggregation: dedicated worker pools per phase.

The paper keeps one accelerator's partitions in different phases so their
memory-traffic peaks interleave; this package is that idea at fleet
scale.  Instead of staggering prefill waves across co-located workers
(the ``shaping`` router), whole workers are dedicated to one phase each:
a compute-bound prefill pool and a bandwidth-bound decode pool overlap by
construction.  The glue is a KV handoff — a finished prefill's block
pages move from the prefill worker's ``kv_pool`` into a decode worker's
pool over the same modeled link compute traffic uses (a bytes-only span
on the shared ``ContentionTimeline``).

  handoff — engine state <-> ``KvHandoff`` wire payload conversion
  router  — ``PdRouter``: pool partitioning, admission, migration,
            deferral, failover, demand-driven rebalancing

See ``docs/pd_disaggregation.md`` for the full lifecycle.
"""
from repro_torch.serving.pd.handoff import apply_handoff, export_handoff
from repro_torch.serving.pd.router import PdRouter

__all__ = ["PdRouter", "apply_handoff", "export_handoff"]

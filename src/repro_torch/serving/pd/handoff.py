"""KV handoff glue: engine slot state <-> ``KvHandoff`` wire payload.

``export_handoff`` runs on the prefill worker: it pulls the request out of
the engine (freeing its slot and blocks immediately, so the worker can
start the next wave while the payload is in flight) and flattens the
gathered device arrays into ``PageArray`` records.  ``apply_handoff``
runs on the decode worker: it rebuilds the request with its generation
progress (tokens + first-token stamp — TTFT stays billed where prefill
ran) and seats it via the engine's all-or-nothing ``import_kv``, letting
``PoolExhausted`` propagate so the worker runtime can turn it into a
``KvImported(ok=False)`` deferral rather than an error.

Both directions are engine-agnostic: a ``SimulatedEngine`` ships an empty
page tuple and migration is pure bookkeeping; a ``PartitionEngine`` ships
its real block contents (paged) or cache rows (dense), and the oracle
test pins that decoding after the move is bit-identical to never moving.
"""
from __future__ import annotations

from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.engine import EngineBase
from repro_torch.serving.queue import Request


def export_handoff(engine: EngineBase, rid: int) -> P.KvHandoff:
    """Extract active request ``rid`` from ``engine`` as a wire payload."""
    req, state = engine.export_kv(rid)
    return P.KvHandoff(
        request=P.WireRequest.from_request(req),
        tokens=tuple(int(t) for t in req.tokens),
        t_first_token=req.t_first_token,
        len=int(state["len"]),
        kv_bytes=float(state["kv_bytes"]),
        pages=tuple(P.pack_array(name, arr)
                    for name, arr in sorted(state["pages"].items())))


def handoff_request(h: P.KvHandoff) -> Request:
    """The canonical ``Request`` a handoff carries, progress restored."""
    req = h.request.to_request()
    req.tokens = list(h.tokens)
    req.t_first_token = h.t_first_token
    return req


def apply_handoff(engine: EngineBase, h: P.KvHandoff) -> int:
    """Seat a handed-off request in ``engine``; returns the slot index.
    Raises ``PoolExhausted`` (engine untouched) when the worker has no
    free slot or not enough blocks — the deferral path."""
    state = {
        "len": int(h.len),
        "kv_bytes": float(h.kv_bytes),
        "pages": {pa.name: P.unpack_array(pa) for pa in h.pages},
    }
    return engine.import_kv(handoff_request(h), state)

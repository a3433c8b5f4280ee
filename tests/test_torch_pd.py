"""The port's prefill/decode disaggregation (``repro_torch.serving.pd``)
and its KV handoff, against the JAX reference.

* Wire: ``KvHandoff`` and the PD messages round-trip through the codec;
  bf16 and fp8 pages cross bit for bit as torch tensors without
  ``ml_dtypes`` (checked in a fresh interpreter that never imports it),
  and a payload packed by either package unpacks in the other.
* Engine handoff semantics: ``export_kv`` frees the slot and its blocks at
  once; ``import_kv`` is all-or-nothing and rejects what no engine could
  serve; the import checks block count and layout.
* PD clusters: a PD loopback cluster keeps each pool to its phase (and
  equals the reference's PD loopback cluster), a PD ``mp`` cluster equals
  loopback, and killing the decode pool while handoffs are in flight
  requeues its requests and loses none.
* The migrated-decode oracle: a request prefilled on one port engine,
  wired and imported into another decodes tokens, logits and KV state
  bit-identical to the never-migrated engine — paged float, int8, fp8,
  dense and a prefix-cache hit (shared blocks masked out of the scatter),
  on graph engines (the static-buffer path, and with the card's
  prefill capture / replay lifecycle emulated) and on eager ones.
* Both directions across frameworks: a JAX engine's handoff, packed by
  the reference's codec, unpacks in the port's and decodes on a port
  engine with the JAX engine's never-migrated greedy tokens and its fp32
  logits within 2e-4; and the other way round.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import PdRouter as JPdRouter
from repro.serving import RequestQueue as JQueue
from repro.serving import make_cluster as jmake_cluster
from repro.serving import make_worker_specs as jmake_specs
from repro.serving.cluster import protocol as JP
from repro.serving.pd import apply_handoff as japply
from repro.serving.pd import export_handoff as jexport
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.serving import (PartitionEngine, PdRouter, PoolExhausted,
                                 RequestQueue, SimulatedEngine, make_cluster,
                                 make_worker_specs)
from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.pd import apply_handoff, export_handoff
from repro_torch.serving.pd.handoff import handoff_request
from test_torch_prefill_graph import Emulated

ARCH = "qwen2-7b"
PEAK, BW = 1e12, 2e11
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg():
    return get_config(ARCH, smoke=True)


def _load(queue, n, prompt_len=8, gen=4, deadline=None):
    rng = np.random.default_rng(0)
    return [queue.submit(rng.integers(1, 100, size=(prompt_len,))
                         .astype(np.int32), gen, deadline=deadline)
            for _ in range(n)]


def _sim(slots=2, max_len=32, pid=0, **kw):
    return SimulatedEngine(_cfg(), slots=slots, max_len=max_len, pid=pid,
                           peak_flops=PEAK, block_size=8, **kw)


def _specs(n, slots=2, max_len=64, make=None):
    return (make or make_worker_specs)(ARCH, n, slots=slots, max_len=max_len,
                                       peak_flops_total=PEAK)


def _status():
    return P.WorkerStatus(busy=True, wants_prefill=False, backlog_len=1,
                          n_active=2, head_arrival=0.5, pre_dur=1e-6,
                          wave_dur=5e-6, active_rids=(3, 7))


def _bits(t):
    return t.contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


def test_empty_page_handoff_round_trips():
    q = RequestQueue()
    reqs = _load(q, 1)
    eng = _sim()
    eng.assign(q.pop(1))
    eng.prefill_wave(0.0)
    h = export_handoff(eng, reqs[0].rid)
    assert h.pages == () and h.len > 0 and h.kv_bytes > 0
    for msg in (P.ImportKv(handoff=h),
                P.KvExported(handoffs=(h,), status=_status())):
        assert P.decode(P.encode(msg)) == msg


def test_pd_messages_round_trip():
    h = P.KvHandoff(
        request=P.WireRequest(rid=4, prompt=(9, 8, 7), max_new_tokens=6,
                              arrival=0.25, deadline=2.0),
        tokens=(11, 12), t_first_token=0.5, len=5, kv_bytes=4096.0,
        pages=(P.pack_array("k", torch.arange(12, dtype=torch.float32)
                            .reshape(3, 4)),))
    for msg in [P.ExportKv(rids=(3, 7)), P.ImportKv(handoff=h),
                P.KvExported(handoffs=(h, h), status=_status()),
                P.KvImported(ok=False, reason="pool", status=_status())]:
        d = P.encode(msg)
        assert isinstance(d, dict) and d["kind"] == type(msg).__name__
        assert P.decode(d) == msg
    st = P.decode(P.encode(P.Pong(t_wall=1.0, status=_status()))).status
    assert st.active_rids == (3, 7)


_NO_ML_DTYPES = """
import sys
import torch
from repro_torch.serving.cluster import protocol as P
g = torch.Generator().manual_seed(3)
arrs = {"k": torch.randn(2, 3, 8, 2, 16, generator=g).to(torch.bfloat16),
        "v": (torch.randn(2, 3, 8, 2, 16, generator=g) * 40).to(
            torch.float8_e4m3fn),
        "k_scales": torch.rand(2, 3, 2, generator=g),
        "q": torch.randint(-127, 128, (2, 3, 8), generator=g,
                           dtype=torch.int8)}
h = P.KvHandoff(request=P.WireRequest(rid=1, prompt=(1, 2), max_new_tokens=4),
                tokens=(5,), t_first_token=1e-6, len=3, kv_bytes=1.0,
                pages=tuple(P.pack_array(n, a)
                            for n, a in sorted(arrs.items())))
h2 = P.decode(P.encode(P.ImportKv(handoff=h))).handoff
assert h2 == h
for pa in h2.pages:
    back, want = P.unpack_array(pa), arrs[pa.name]
    assert back.dtype == want.dtype and back.shape == want.shape, pa.name
    w = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[want.element_size()]
    assert torch.equal(back.view(w), want.view(w)), pa.name
    back.view(w)[(0,) * back.ndim] = 0   # writable memory
assert [pa.dtype for pa in h2.pages] == ["bfloat16", "float32", "int8",
                                         "float8_e4m3fn"]
bad = [m for m in sys.modules if m.split(".")[0] in ("ml_dtypes", "jax",
                                                      "repro")]
assert not bad, bad
print("ok")
"""


def test_bf16_and_fp8_pages_round_trip_without_ml_dtypes():
    """In a fresh interpreter (this test process has jax, and so
    ml_dtypes, loaded): bf16, fp8, f32 and int8 pages round-trip bit for
    bit and ``ml_dtypes`` is never imported."""
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_pages_cross_between_the_packages_bit_for_bit():
    import ml_dtypes

    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    for np_dtype, t_dtype in ((ml_dtypes.bfloat16, torch.bfloat16),
                              (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
                              (np.float32, torch.float32)):
        a = f32.astype(np_dtype)
        # the reference packs, the port unpacks
        t = P.unpack_array(P.PageArray(**JP.pack_array("k", a).__dict__))
        assert t.dtype == t_dtype and tuple(t.shape) == a.shape
        assert _bits(t).numpy().tobytes() == a.tobytes()
        # the port packs, the reference unpacks
        pa = P.pack_array("k", t)
        assert pa == P.PageArray(**JP.pack_array("k", a).__dict__)
        back = JP.unpack_array(JP.PageArray(**pa.__dict__))
        assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# engine: export frees, import is all-or-nothing
# ---------------------------------------------------------------------------


def test_export_frees_slot_and_import_resumes_decode():
    q = RequestQueue()
    reqs = _load(q, 2, prompt_len=8, gen=4)
    src = _sim(pid=0)
    src.assign(q.pop(2))
    src.prefill_wave(0.0)
    live0 = src.pool.n_live
    req, state = src.export_kv(reqs[0].rid)
    assert req.rid == reqs[0].rid and len(req.tokens) == 1
    assert state["pages"] == {} and state["len"] == reqs[0].prompt_len
    assert state["kv_bytes"] > 0 and src.n_exports == 1
    assert src.active[0] is None and src.slot_lens[0] == 0
    assert src.slot_tables[0] == [] and src.pool.n_live < live0
    with pytest.raises(KeyError, match="not active"):
        src.export_kv(999)
    dst = _sim(pid=1)
    assert dst.import_kv(req, state) == 0 and dst.n_imports == 1
    assert dst.active[0] is req and dst.slot_lens[0] == state["len"]
    while dst.busy:
        dst.decode_step(0.0)
    done = {r.rid: r for r in dst.completed}
    assert len(done[req.rid].tokens) == req.max_new_tokens


def test_import_all_or_nothing_on_exhaustion():
    q = RequestQueue()
    reqs = _load(q, 3, prompt_len=8, gen=4)
    src = _sim(slots=3, max_len=32)
    src.assign(q.pop(3))
    src.prefill_wave(0.0)
    _, state = src.export_kv(reqs[0].rid)
    full = _sim(slots=2)
    full.import_kv(*src.export_kv(reqs[1].rid))
    full.import_kv(*src.export_kv(reqs[2].rid))
    with pytest.raises(PoolExhausted, match="no free slot"):
        full.import_kv(reqs[0], state)
    assert full.n_imports == 2
    tiny = _sim(slots=2, pool_blocks=1)
    free0 = tiny.pool.n_free
    with pytest.raises(PoolExhausted, match="blocks"):
        tiny.import_kv(reqs[0], state)
    assert tiny.n_imports == 0 and tiny.pool.n_free == free0
    assert tiny.active == [None, None] and tiny.assign_order == []
    with pytest.raises(ValueError, match="cache positions"):
        _sim(max_len=8).import_kv(reqs[0], state)
    with pytest.raises(ValueError, match="beyond its"):
        tiny.import_kv(reqs[0], dict(state, len=1000))


# ---------------------------------------------------------------------------
# PD clusters
# ---------------------------------------------------------------------------


def _pd_run(Q, make, specs, router, n=24, transport="loopback", **kw):
    q = Q()
    _load(q, n, gen=4)
    ctl = make(_specs(4, make=specs), q, transport=transport, router=router,
               bandwidth=BW, **kw)
    m = ctl.run()
    return ctl, q, m


def test_pd_loopback_pools_stay_phase_pure():
    ctl, q, _ = _pd_run(RequestQueue, make_cluster, make_worker_specs,
                        PdRouter(split=(2, 2)))
    assert len(q.completed) == 24
    assert all(len(r.tokens) == r.max_new_tokens for r in q.completed)
    assert all(r.t_first_token is not None for r in q.completed)
    eng = {w: ctl.transport.runtimes[w].engine for w in ctl.views}
    for w in (0, 1):
        assert eng[w].n_prefills > 0 and eng[w].n_exports > 0
        assert eng[w].n_decode_steps == 0
    for w in (2, 3):
        assert eng[w].n_decode_steps > 0 and eng[w].n_imports > 0
        assert eng[w].n_prefills == 0 and eng[w].n_refills == 0
    r = ctl.router
    assert r.n_handoffs == sum(eng[w].n_exports for w in (0, 1)) == 24
    spans = [s for s in ctl.trace if s.phase == "handoff"]
    assert len(spans) == r.n_handoffs
    assert all(s.demand > 0 and s.t1 > s.t0 for s in spans)
    assert {s.pid for s in spans} == {0, 1}


@pytest.mark.parametrize("split", [(2, 2), (1, 3), None],
                         ids=["2:2", "1:3", "auto"])
def test_pd_loopback_equals_reference(split):
    def stamps(q):
        return sorted((r.rid, tuple(r.tokens), r.t_first_token, r.t_done)
                      for r in q.completed)

    tc, tq, tm = _pd_run(RequestQueue, make_cluster, make_worker_specs,
                         PdRouter(split=split))
    jc, jq, jm = _pd_run(JQueue, jmake_cluster, jmake_specs,
                         JPdRouter(split=split))
    assert stamps(tq) == stamps(jq)
    assert tc.router.n_handoffs == jc.router.n_handoffs
    assert tc.router.n_deferrals == jc.router.n_deferrals
    assert [(s.t0, s.t1, s.pid, s.phase) for s in tc.trace] == \
        [(s.t0, s.t1, s.pid, s.phase) for s in jc.trace]


def test_pd_mp_matches_loopback():
    def run(transport, **kw):
        _, q, _ = _pd_run(RequestQueue, make_cluster, make_worker_specs,
                          PdRouter(split=(2, 2)), n=12, transport=transport,
                          **kw)
        assert len(q.completed) == 12
        return sorted((r.rid, r.t_first_token, r.t_done)
                      for r in q.completed)
    assert run("mp", heartbeat_timeout=120.0) == run("loopback")


def test_pd_split_must_cover_fleet():
    q = RequestQueue()
    _load(q, 4)
    ctl = make_cluster(_specs(3), q, transport="loopback",
                       router=PdRouter(split=(2, 2)), bandwidth=BW)
    with pytest.raises(ValueError, match="does not cover"):
        ctl.run()


def test_decode_pool_death_requeues_inflight_handoffs_in_order():
    q = RequestQueue()
    _load(q, 8, gen=4)
    requeues = []
    orig = q.requeue

    def spy(reqs):
        requeues.append([(r.rid, list(r.tokens), r.t_first_token)
                         for r in reqs])
        orig(reqs)
        assert [r.rid for r in q._fifo] == sorted(r.rid for r in q._fifo)

    q.requeue = spy
    router = PdRouter(split=(2, 1), handoff_rate=1.0)
    ctl = make_cluster(_specs(3), q, transport="loopback", router=router,
                       bandwidth=BW)
    ctl.timeline.call_at(1.0, lambda t: ctl.transport.kill(2))
    ctl.run()
    assert ctl.n_failovers == 1 and ctl.failed_workers == [2]
    assert router.n_requeued > 0
    assert router._in_flight == 0 and not router._deferred
    pd_calls = [c for c in requeues if len(c) == 1]
    assert len(pd_calls) >= router.n_requeued
    for call in pd_calls:
        _, tokens, t_first = call[0]
        assert tokens == [] and t_first is None
    assert len(q.completed) == 8
    assert all(len(r.tokens) == r.max_new_tokens for r in q.completed)
    eng = {w: ctl.transport.runtimes[w].engine for w in (0, 1)}
    assert sum(e.n_decode_steps for e in eng.values()) > 0


# ---------------------------------------------------------------------------
# the oracle: migrated decode is bit-identical to never migrating
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    jcfg = jget_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = _cfg().replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


LAYOUTS = {"paged": {}, "int8": dict(kv_dtype="int8"),
           "fp8": dict(kv_dtype="fp8"), "dense": dict(paged=False),
           "prefix": dict(prefix_cache=True)}
STATE_KEYS = ("k", "v", "k_pages", "v_pages", "k_scales", "v_scales")


def _engine(built, layout, graph="static", pid=0):
    _, (tcfg, tm, tp) = built
    kw = dict(LAYOUTS[layout])
    if graph == "eager":
        kw["cuda_graph"] = False
    elif graph == "emulated":
        kw["prefill_graphs"] = Emulated(tm)
    return PartitionEngine(tcfg, tm, tp, slots=2, max_len=48, pid=pid,
                           peak_flops=PEAK, block_size=8, **kw)


def _live_state(eng):
    """Each live slot's KV state (its blocks in table order, or its slab
    row), by rid."""
    out = {}
    for i, req in enumerate(eng.active):
        if req is None:
            continue
        if eng.paged:
            tbl = torch.as_tensor(eng.slot_tables[i], dtype=torch.long)
            out[req.rid] = {k: _bits(eng.pages[k][:, tbl]).clone()
                            for k in STATE_KEYS if k in eng.pages}
        else:
            out[req.rid] = {k: _bits(eng.cache[k][:, i]).clone()
                            for k in ("k", "v")}
    return out


def _by_rid(eng):
    return {r.rid: i for i, r in enumerate(eng.active) if r is not None}


def _prompts(lens=(8, 12), seed=7, vocab=256, head=0):
    """Random prompts; with ``head``, each starts with the same ``head``
    tokens (whole blocks a prefix cache shares)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(1, vocab, size=(head,)).astype(np.int32)
    return [np.concatenate([h, rng.integers(1, vocab, size=(n,))
                            .astype(np.int32)]) for n in lens]


@pytest.mark.parametrize("graph", ["static", "emulated", "eager"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_migrated_decode_is_bit_identical_to_oracle(built, layout, graph):
    """Prefill on engine A, export, full wire round trip, import into a
    fresh engine B; B's tokens, live logits and live KV state equal the
    never-migrated oracle C's bit for bit after every decode step."""
    qa, qo = RequestQueue(), RequestQueue()
    for p in _prompts(head=16 if layout == "prefix" else 0):
        qa.submit(p, 5)
        qo.submit(p, 5)
    src = _engine(built, layout, graph)
    oracle = _engine(built, layout, graph)
    src.assign(qa.pop(2))
    oracle.assign(qo.pop(2))
    src.prefill_wave(0.0)
    oracle.prefill_wave(0.0)

    dst = _engine(built, layout, graph, pid=1)
    for req in [r for r in list(src.active) if r is not None]:
        h = export_handoff(src, req.rid)
        names = {pa.name for pa in h.pages}
        assert names == ({"k", "v", "k_scales", "v_scales"}
                         if "kv_dtype" in LAYOUTS[layout] else {"k", "v"})
        h2 = P.decode(P.encode(P.ImportKv(handoff=h))).handoff
        assert h2 == h
        apply_handoff(dst, h2)
    assert src.n_exports == 2 and dst.n_imports == 2
    assert not src.busy and dst.busy
    if layout == "prefix":   # the second import shares the head's blocks
        assert sorted(dst.slot_shared) == sorted(oracle.slot_shared) == [0, 2]
    elif layout != "dense":
        assert src.pool.n_live == 0

    steps = 0
    while oracle.busy:
        assert dst.busy
        assert _by_rid(dst) == _by_rid(oracle)
        live = list(_by_rid(oracle).values())
        dst.decode_step(0.0)
        oracle.decode_step(0.0)
        for i in live:
            assert np.array_equal(dst.last_logits[i], oracle.last_logits[i])
        sd, so = _live_state(dst), _live_state(oracle)
        assert sd.keys() == so.keys()
        for rid in so:
            for k in so[rid]:
                assert torch.equal(sd[rid][k], so[rid][k]), (rid, k)
        steps += 1
    assert steps > 0 and not dst.busy
    for rm, ro in zip(sorted(dst.completed, key=lambda r: r.rid),
                      sorted(oracle.completed, key=lambda r: r.rid)):
        assert rm.rid == ro.rid and rm.tokens == ro.tokens
    if layout != "dense":
        assert dst.pool.n_live == 0
    if graph != "eager":
        assert dst.graph is not None and dst.graph.n_eager == steps


def test_import_writes_in_place_for_the_graph(built):
    """The import scatters into the pool (and the dense slab) without
    rebinding them: a captured step keeps reading the same storage."""
    for layout in ("paged", "dense"):
        q = RequestQueue()
        for p in _prompts():
            q.submit(p, 4)
        src = _engine(built, layout)
        src.assign(q.pop(2))
        src.prefill_wave(0.0)
        dst = _engine(built, layout, pid=1)
        apply_handoff(dst, export_handoff(src, src.assign_order[0]))
        state = dst.pages if layout == "paged" else dst.cache
        ptrs = {k: t.data_ptr() for k, t in state.items()}
        dst.decode_step(0.0)
        apply_handoff(dst, export_handoff(src, src.assign_order[1]))
        dst.decode_step(0.0)
        state = dst.pages if layout == "paged" else dst.cache
        assert {k: t.data_ptr() for k, t in state.items()} == ptrs


def test_import_skips_blocks_shared_through_the_prefix_cache(built):
    """A recipient that already holds the prompt's head shares those blocks
    and never writes them: garbage in the payload's head blocks does not
    land (the reference scatters them to the null block)."""
    q = RequestQueue()
    for p in _prompts(head=16):
        q.submit(p, 4)
    src = _engine(built, "prefix")
    src.assign(q.pop(2))
    src.prefill_wave(0.0)
    dst = _engine(built, "prefix", pid=1)
    first, second = src.assign_order
    apply_handoff(dst, export_handoff(src, first))
    head = torch.as_tensor(dst.slot_tables[0][:2], dtype=torch.long)
    before = {k: dst.pages[k][:, head].clone() for k in ("k_pages",
                                                        "v_pages")}
    req, state = src.export_kv(second)
    for k in ("k", "v"):
        state["pages"][k][:, :2] = 1e4
    slot = dst.import_kv(req, state)
    assert dst.slot_shared[slot] == 2
    assert dst.slot_tables[slot][:2] == dst.slot_tables[0][:2]
    for k, t in before.items():
        assert torch.equal(dst.pages[k][:, head], t)


def test_import_refuses_mismatched_payloads(built):
    q = RequestQueue()
    q.submit(_prompts()[1], 4)
    src = _engine(built, "int8")
    src.assign(q.pop(1))
    src.prefill_wave(0.0)
    h = export_handoff(src, src.assign_order[0])
    with pytest.raises(ValueError, match="layout mismatch"):
        apply_handoff(_engine(built, "paged", pid=1), h)
    req, state = handoff_request(h), {
        "len": h.len, "kv_bytes": h.kv_bytes,
        "pages": {pa.name: P.unpack_array(pa)[:, :1] for pa in h.pages}}
    with pytest.raises(ValueError, match="carries 1 blocks"):
        _engine(built, "int8", pid=1).import_kv(req, state)
    req.tokens = []
    with pytest.raises(ValueError, match="before prefill"):
        _engine(built, "int8", pid=1).import_kv(req, dict(state, pages={}))


def test_handoff_request_restores_progress(built):
    q = RequestQueue()
    q.submit(np.arange(1, 9, dtype=np.int32), 4)
    eng = _engine(built, "paged")
    eng.assign(q.pop(1))
    eng.prefill_wave(2.5e-6)
    h = export_handoff(eng, eng.assign_order[0])
    req = handoff_request(h)
    assert req.tokens == list(h.tokens) and len(req.tokens) == 1
    assert req.t_first_token == h.t_first_token is not None


# ---------------------------------------------------------------------------
# across frameworks, both directions
# ---------------------------------------------------------------------------


def _jengine(built, layout, pid=0):
    (jcfg, jm, jp), _ = built
    kw = dict(LAYOUTS[layout])
    paged = kw.pop("paged", True)
    return JEngine(jcfg, jm, jp, slots=2, max_len=48, pid=pid,
                   peak_flops=PEAK, paged=paged, block_size=8, **kw)


def _cross(built, layout, src_pkg):
    """Prefill on ``src_pkg``'s engine, migrate into the other package's
    engine through the source's codec and the destination's, and decode
    it beside a never-migrated engine of the source package."""
    make = {"jax": (_jengine, JQueue), "torch": (_engine, RequestQueue)}
    dst_pkg = "torch" if src_pkg == "jax" else "jax"
    (mk_src, Q_src), (mk_dst, _) = make[src_pkg], make[dst_pkg]
    qa, qo = Q_src(), Q_src()
    for p in _prompts():
        qa.submit(p, 5)
        qo.submit(p, 5)
    src, oracle = mk_src(built, layout), mk_src(built, layout)
    src.assign(qa.pop(2))
    oracle.assign(qo.pop(2))
    src.prefill_wave(0.0)
    oracle.prefill_wave(0.0)
    dst = mk_dst(built, layout, pid=1)
    for rid in [r.rid for r in src.active if r is not None]:
        if src_pkg == "jax":
            wire = JP.encode(JP.ImportKv(handoff=jexport(src, rid)))
            apply_handoff(dst, P.decode(wire).handoff)
        else:
            wire = P.encode(P.ImportKv(handoff=export_handoff(src, rid)))
            japply(dst, JP.decode(wire).handoff)
    steps = 0
    while oracle.busy:
        live = list(_by_rid(oracle).values())
        assert _by_rid(dst) == _by_rid(oracle)
        dst.decode_step(0.0)
        oracle.decode_step(0.0)
        for i in live:
            np.testing.assert_allclose(np.asarray(dst.last_logits[i]),
                                       np.asarray(oracle.last_logits[i]),
                                       **TOL)
        steps += 1
    assert steps > 0 and not dst.busy
    got = sorted((r.rid, list(r.tokens)) for r in dst.completed)
    want = sorted((r.rid, list(r.tokens)) for r in oracle.completed)
    assert got == want


@pytest.mark.parametrize("layout", ["paged", "int8", "dense"])
def test_handoff_from_jax_decodes_on_the_port(built, layout):
    _cross(built, layout, "jax")


@pytest.mark.parametrize("layout", ["paged", "int8", "dense"])
def test_handoff_from_the_port_decodes_on_jax(built, layout):
    _cross(built, layout, "torch")


# ---------------------------------------------------------------------------
# CLI validation (parse time, shared by cluster.py and serve.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--heartbeat-timeout", "0"],
    ["--heartbeat-timeout", "-3"],
    ["--pd-split", "2:2"],
    ["--router", "pd", "--pd-split", "nope"],
    ["--router", "pd", "--pd-split", "4"],
    ["--router", "pd", "--pd-split", "0:4"],
    ["--router", "pd", "--pd-split", "2:3"],
], ids=["hb-zero", "hb-neg", "split-sans-pd", "split-garbage",
        "split-one-int", "split-empty-pool", "split-mismatch"])
def test_cluster_cli_rejects_bad_flags(extra):
    from repro_torch.launch.cluster import main
    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--smoke", "--device", "cpu"] + extra)


def test_serve_cli_rejects_pd_without_cluster():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--router",
              "pd"])
    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cluster",
              "4", "--router", "pd", "--pd-split", "1:2"])


def test_serve_cli_runs_a_traced_pd_cluster(tmp_path, capsys):
    from repro_torch.launch.serve import main
    path = tmp_path / "pd.json"
    outs = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cluster",
                 "2", "--simulated", "--router", "pd", "--pd-split", "1:1",
                 "--transport", "loopback", "--requests", "6", "--batch",
                 "2", "--prompt-len", "8", "--gen", "4", "--trace",
                 str(path)])
    out = capsys.readouterr().out
    assert len(outs) == 6 and "split=1:1 handoffs=6" in out
    assert "handoff_export=6" in out and path.stat().st_size > 0

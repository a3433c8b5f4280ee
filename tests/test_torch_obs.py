"""The port's tracing (``repro_torch.obs``) against the JAX reference's.

* Equality: an ``EventScheduler`` fleet of each package with the same
  explicit ``peak_flops`` and ``bandwidth`` on the same load emits the
  same event list, and ``write_chrome`` writes byte-identical files — on
  ``SimulatedEngine`` fleets, on real fp32 smoke engines (the reference's
  weights carried over by ``params_from_jax``) and on a loopback cluster
  (shaping, and PD with its handoff flows).
* The reference's own gates, on the port: determinism, schema
  (``validate_chrome``, and that it catches corruption), the lifecycle
  log, the registry, cancellation accounting, and fidelity — the bw
  counter track integrated back out of the file equals
  ``metrics.bw_stats`` to 1e-9.
* Tracing changes nothing: a fleet run untraced is bit-identical to the
  traced one (stamps, summary, tokens, logits), graph engines included
  (the static-buffer path, and the card's eager / capture / replay
  lifecycle emulated); with every tracer at None the run executes no line
  of ``repro_torch/obs`` (tracemalloc sees no allocation there).
* The serve CLI's ``--trace PATH`` writes a file that
  ``tools/torch_trace_export.py --check`` accepts.
"""
import importlib.util
import json
import tracemalloc
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro import serving as jserving
from repro.serving.trace_sim import phase_balanced_bandwidth as jbw
from repro_torch import obs as tobs
from repro_torch import serving as tserving
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.timeline import ContentionTimeline
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.serving.trace_sim import phase_balanced_bandwidth
from test_torch_prefill_graph import Emulated

ROOT = Path(__file__).resolve().parents[1]
PEAK = 1e12
PKGS = {"jax": (jserving, jobs, jget_config),
        "torch": (tserving, tobs, get_config)}


def _cfg(pkg="torch"):
    return PKGS[pkg][2]("qwen2-7b", smoke=True)


def _bw(partitions=4):
    kw = dict(total_slots=partitions * 2, prompt_len=8, gen=4,
              peak_flops_total=PEAK)
    bw = phase_balanced_bandwidth(_cfg(), **kw)
    assert bw == jbw(_cfg("jax"), **kw)
    return bw


def _load(queue, n, prompt_len=8, gen=4):
    rng = np.random.default_rng(0)
    for _ in range(n):
        queue.submit(rng.integers(1, 100, size=(prompt_len,))
                     .astype(np.int32), gen)


def _sim_fleet(pkg, partitions):
    S = PKGS[pkg][0]
    return [S.SimulatedEngine(_cfg(pkg), slots=2, max_len=64, pid=p,
                              peak_flops=PEAK / partitions)
            for p in range(partitions)]


def _run(pkg, engines, policy="demand", n=10, traced=True, path=None):
    """One event-clock fleet run; returns (tracer or None, sched, m)."""
    S, O, _ = PKGS[pkg]
    q = S.RequestQueue()
    tracer = None
    if traced:
        tracer = O.Tracer()
        q.tracer = tracer  # before the load: admissions must be captured
    _load(q, n)
    sched = S.make_scheduler(engines, q, policy=policy,
                             bandwidth=_bw(len(engines)), clock="event")
    if traced:
        sched.attach_tracer(tracer)
    m = sched.run()
    if path is not None:
        O.write_chrome(tracer, str(path))
    return tracer, sched, m


def _traced_run(policy="demand", partitions=4, n=10, trace_path=None):
    return _run("torch", _sim_fleet("torch", partitions), policy, n,
                path=trace_path)


def _stamps(queue):
    return sorted((r.rid, tuple(r.tokens), r.t_first_token, r.t_done)
                  for r in queue.completed)


def _no_wall(m):
    return {k: v for k, v in m.summary().items() if "wall" not in k}


# ---------------------------------------------------------------------------
# equality with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["none", "demand"])
def test_sim_fleet_trace_equals_reference(tmp_path, policy):
    runs = {pkg: _run(pkg, _sim_fleet(pkg, 4), policy,
                      path=tmp_path / f"{pkg}.json") for pkg in PKGS}
    (tj, _, mj), (tt, _, mt) = runs["jax"], runs["torch"]
    assert tt.events == tj.events and len(tt.events) > 50
    assert tt.lifecycle.records == tj.lifecycle.records
    assert (tmp_path / "torch.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert _no_wall(mt) == _no_wall(mj)


@pytest.fixture(scope="module")
def built():
    jcfg = _cfg("jax").replace(dtype="float32")
    tcfg = _cfg().replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


def _real_fleet(built, pkg, partitions=2, **kw):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    if pkg == "jax":
        return [jserving.PartitionEngine(jcfg, jm, jp, slots=2, max_len=48,
                                         pid=p, peak_flops=PEAK / partitions,
                                         paged=True, block_size=8)
                for p in range(partitions)]
    return [tserving.PartitionEngine(tcfg, tm, tp, slots=2, max_len=48,
                                     pid=p, peak_flops=PEAK / partitions,
                                     block_size=8, **kw)
            for p in range(partitions)]


def test_real_fleet_trace_equals_reference(built, tmp_path):
    """fp32 smoke engines with the same weights: the same events (the
    virtual clock prices ops from shapes) and the same greedy tokens."""
    runs = {pkg: _run(pkg, _real_fleet(built, pkg), n=8,
                      path=tmp_path / f"{pkg}.json") for pkg in PKGS}
    (tj, sj, _), (tt, st, _) = runs["jax"], runs["torch"]
    assert tt.events == tj.events
    assert (tmp_path / "torch.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert _stamps(st.queue) == _stamps(sj.queue)


def _traced_cluster(pkg, router, workers=2, n=8, untraced=False):
    S, O, _ = PKGS[pkg]
    q = S.RequestQueue()
    tracer = None if untraced else O.Tracer()
    q.tracer = tracer
    _load(q, n)
    specs = S.make_worker_specs("qwen2-7b", workers, smoke=True, slots=2,
                                max_len=64, engine="sim",
                                peak_flops_total=PEAK)
    if router == "pd":
        router = S.PdRouter(split=None)
    ctl = S.make_cluster(specs, q, transport="loopback", router=router,
                         bandwidth=_bw(workers))
    if tracer is not None:
        ctl.attach_tracer(tracer)
    m = ctl.run()
    return tracer, ctl, m


@pytest.mark.parametrize("router", ["shaping", "pd"])
def test_cluster_trace_equals_reference(router):
    tj, cj, mj = _traced_cluster("jax", router)
    tt, ct, mt = _traced_cluster("torch", router)
    assert tt.events == tj.events
    assert json.dumps(tobs.to_chrome(tt.events), sort_keys=True) == \
        json.dumps(jobs.to_chrome(tj.events), sort_keys=True)
    assert _stamps(ct.queue) == _stamps(cj.queue)
    assert _no_wall(mt) == _no_wall(mj)


# ---------------------------------------------------------------------------
# the reference's gates on the port: determinism + schema
# ---------------------------------------------------------------------------


def test_identical_runs_export_byte_identical_traces(tmp_path):
    paths = [tmp_path / "a.json", tmp_path / "b.json"]
    for p in paths:
        _traced_run(trace_path=p)
    a, b = (p.read_bytes() for p in paths)
    assert a == b and len(a) > 0


def test_exported_trace_passes_schema_validation(tmp_path):
    path = tmp_path / "t.json"
    _traced_run(trace_path=path)
    doc = json.loads(path.read_text())
    assert tobs.validate_chrome(doc) == []
    evs = doc["traceEvents"]
    groups = {ev["args"]["name"] for ev in evs
              if ev["ph"] == "M" and ev["name"] == "process_name"}
    assert {"spans", "queue", "policy"} <= groups
    assert any(ev["ph"] == "C" and ev["name"] == "bw" for ev in evs)
    assert any(ev["ph"] == "B" and ev["name"] == "prefill" for ev in evs)
    assert any(ev["ph"] == "B" and ev["name"] == "decode" for ev in evs)


def test_validator_catches_corruption():
    tracer, _, _ = _traced_run(n=6)
    doc = tobs.to_chrome(tracer.events)
    assert tobs.validate_chrome(doc) == []
    evs = list(doc["traceEvents"])
    kill = next(i for i, e in enumerate(evs) if e["ph"] == "E")
    assert tobs.validate_chrome({"traceEvents": evs[:kill] + evs[kill + 1:]})
    evs2 = [dict(e) for e in doc["traceEvents"]]
    last = max(i for i, e in enumerate(evs2) if e["ph"] != "M")
    evs2[last]["ts"] = -1.0
    assert tobs.validate_chrome({"traceEvents": evs2})
    bad = {"traceEvents": [{"name": "bw", "ph": "C", "ts": 0.0, "pid": 1,
                            "tid": 0, "args": {"demand": "oops"}}]}
    assert tobs.validate_chrome(bad)
    bad = {"traceEvents": [{"name": "x", "ph": "f", "ts": 0.0, "pid": 1,
                            "tid": 0, "id": 7, "args": {}}]}
    assert tobs.validate_chrome(bad)


# ---------------------------------------------------------------------------
# tracing changes nothing, and costs nothing when off
# ---------------------------------------------------------------------------


def test_tracer_off_hot_path_allocates_nothing_in_obs():
    """With every ``tracer`` attribute at None (the default), a full
    serving run must not execute a single line of ``repro_torch/obs``."""
    q = tserving.RequestQueue()
    _load(q, 8)
    sched = tserving.make_scheduler(_sim_fleet("torch", 2), q,
                                    policy="demand", bandwidth=2e9,
                                    clock="event")
    assert sched.timeline.tracer is None and q.tracer is None
    assert all(e.tracer is None for e in sched.engines)
    tracemalloc.start()
    try:
        sched.run()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    obs_allocs = [s for s in snap.statistics("filename")
                  if "repro_torch/obs" in s.traceback[0].filename.replace(
                      "\\", "/")]
    assert obs_allocs == []
    assert len(q.completed) == 8


@pytest.mark.parametrize("policy", ["none", "demand"])
def test_untraced_sim_fleet_is_bit_identical(policy):
    _, s_on, m_on = _run("torch", _sim_fleet("torch", 4), policy)
    _, s_off, m_off = _run("torch", _sim_fleet("torch", 4), policy,
                           traced=False)
    assert _stamps(s_off.queue) == _stamps(s_on.queue)
    assert m_off.bw_stats(0.0) == m_on.bw_stats(0.0)
    assert _no_wall(m_off) == _no_wall(m_on)
    assert s_off.timeline.now == s_on.timeline.now


@pytest.mark.parametrize("mode", ["static", "emulated"])
def test_traced_graph_engines_equal_untraced_twin(built, mode):
    """Real fp32 engines that decode through their ``DecodeGraph`` and
    prefill through a shared cache of prefill graphs (the static-buffer
    path; or the card's eager / capture / replay lifecycle emulated):
    the traced fleet's tokens, logits and pools equal the untraced twin's
    bit for bit, and the tracer saw the replays' phases."""
    (_, _, _), (tcfg, tm, tp) = built

    def fleet():
        kw = {}
        if mode == "emulated":
            kw["prefill_graphs"] = Emulated(tm)
        return _real_fleet(built, "torch", **kw)

    on, off = fleet(), fleet()
    t_on, s_on, m_on = _run("torch", on, n=8)
    _, s_off, m_off = _run("torch", off, n=8, traced=False)
    assert _stamps(s_off.queue) == _stamps(s_on.queue)
    assert _no_wall(m_off) == _no_wall(m_on)
    for a, b in zip(on, off):
        assert a.slot_tokens == b.slot_tokens
        assert np.array_equal(a.last_logits, b.last_logits)
        for k in a.pages:
            assert a.pages[k].equal(b.pages[k])
        assert a.graph is not None and a.graph.n_eager > 0
    if mode == "emulated":
        assert on[0].prefill_graphs.n_replays > 0
    assert tobs.validate_chrome(tobs.to_chrome(t_on.events)) == []
    assert t_on.lifecycle.stage_counts()["retire"] == 8


# ---------------------------------------------------------------------------
# cancellation accounting, lifecycle, registry
# ---------------------------------------------------------------------------


def test_cancel_records_partial_progress_unconditionally():
    tl = ContentionTimeline(1e12)
    sp = tl.start(1.0, 1e9)
    tl.call_at(0.5, lambda t: tl.cancel(sp))
    tl.run()
    assert tl.n_cancelled == 1
    assert tl.cancelled_bytes == pytest.approx(0.5e9)
    assert tl.n_completed == 0


def test_cancel_emits_cancelled_event_with_bytes_done():
    tl = ContentionTimeline(1e12)
    tracer = tobs.Tracer()
    tl.attach_tracer(tracer)
    sp = tl.start(1.0, 1e9, key=(3, "prefill"))
    tl.call_at(0.5, lambda t: tl.cancel(sp))
    tl.run()
    cancels = [e for e in tracer.events
               if e["ph"] == "i" and e["name"] == "cancelled"]
    assert len(cancels) == 1
    assert cancels[0]["args"]["bytes_done"] == pytest.approx(0.5e9)
    ends = [e for e in tracer.events if e["ph"] == "E"]
    assert len(ends) == 1 and ends[0]["args"]["cancelled"] is True
    assert tobs.validate_chrome(tobs.to_chrome(tracer.events)) == []


def test_lifecycle_stages_are_ordered_and_complete():
    tracer, _, _ = _traced_run(n=10)
    lc = tracer.lifecycle
    assert len(lc.records) == 10
    for recs in lc.records.values():
        stages = [s for s, _, _ in recs]
        times = [t for _, t, _ in recs]
        assert stages[0] == "submit" and stages[-1] == "retire"
        assert stages.index("prefill") < stages.index("first_token")
        assert times == sorted(times)
    s = lc.summary()
    assert s["n_submit"] == s["n_retire"] == 10
    assert s["mean_submit_to_retire"] >= s["mean_submit_to_first_token"] > 0
    line = lc.format_exit_line()
    assert line.startswith("lifecycle: ") and "retire=10" in line


def test_null_tracer_is_a_silent_stand_in():
    nt = tobs.NullTracer()
    nt.begin("g", 0, "x", 0.0)
    nt.counter("g", 0, "bw", 0.0, demand=1.0)
    nt.flow_start("g", 0, "f", 0.0, nt.flow_id())
    assert nt.events == [] and nt.vnow == 0.0 and nt.flow_id() == 0
    t = tobs.Tracer()
    assert t.vnow == 0.0 and (t.flow_id(), t.flow_id()) == (1, 2)


def test_engine_metrics_snapshot_feeds_fleet_registry():
    _, sched, _ = _traced_run(n=8, partitions=2)
    reg = tobs.registry_from_engines(sched.engines, queue=sched.queue)
    assert reg.get("engine.prefills") >= 2
    assert reg.get("engine.decode_steps") > 0
    assert reg.get("queue.submitted") == 8


# ---------------------------------------------------------------------------
# counter-track fidelity
# ---------------------------------------------------------------------------


def _bw_from_trace(doc):
    segs = tobs.trace_bw_segments(doc)
    assert segs
    w = np.array([b - a for a, b, _ in segs])
    v = np.array([val for _, _, val in segs])
    mean = float(np.average(v, weights=w))
    return mean, float(np.sqrt(np.average((v - mean) ** 2, weights=w)))


@pytest.mark.parametrize("policy", ["none", "demand"])
def test_trace_bw_counter_reproduces_metrics_bw_stats(tmp_path, policy):
    path = tmp_path / f"{policy}.json"
    _, _, m = _traced_run(policy=policy, trace_path=path)
    mean, std = _bw_from_trace(json.loads(path.read_text()))
    m_mean, m_std = m.bw_stats(0.0)
    assert mean == pytest.approx(m_mean, rel=1e-9)
    assert std == pytest.approx(m_std, rel=1e-9)


# ---------------------------------------------------------------------------
# the cluster path
# ---------------------------------------------------------------------------


def test_cluster_trace_valid_and_fleet_registry_aggregates():
    tracer, ctl, m = _traced_cluster("torch", "shaping")
    doc = tobs.to_chrome(tracer.events)
    assert tobs.validate_chrome(doc) == []
    assert any(e["ph"] == "i" and e["name"] == "dispatch"
               for e in tracer.events)
    reg = ctl.fleet_registry()
    assert reg.get("engine.prefills") >= 2
    assert reg.get("pool.free_blocks") > 0
    counts = tracer.lifecycle.stage_counts()
    assert counts["dispatch"] == counts["retire"] == 8
    mean, std = _bw_from_trace(json.loads(json.dumps(doc)))
    assert (mean, std) == pytest.approx(m.bw_stats(0.0), rel=1e-9)
    _, ctl_off, m_off = _traced_cluster("torch", "shaping", untraced=True)
    assert _stamps(ctl_off.queue) == _stamps(ctl.queue)
    assert _no_wall(m_off) == _no_wall(m)


def test_pd_cluster_trace_pairs_handoff_flows():
    tracer, ctl, _ = _traced_cluster("torch", "pd", workers=2, n=6)
    starts = [e for e in tracer.events if e["ph"] == "s"]
    ends = [e for e in tracer.events if e["ph"] == "f"]
    assert len(starts) == ctl.router.n_handoffs > 0
    assert len(ends) == len(starts)
    assert {e["id"] for e in starts} == {e["id"] for e in ends}
    assert tobs.validate_chrome(tobs.to_chrome(tracer.events)) == []
    counts = tracer.lifecycle.stage_counts()
    assert counts["handoff_export"] == counts["handoff_import"] == \
        ctl.router.n_handoffs


# ---------------------------------------------------------------------------
# the CLI and the checker tool
# ---------------------------------------------------------------------------


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_export", ROOT / "tools" / "torch_trace_export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_cli_trace_passes_the_checker(tmp_path, capsys):
    path = tmp_path / "serve.json"
    serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                "--partitions", "2", "--stagger", "demand", "--requests",
                "6", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                "--no-sim", "--trace", str(path)])
    out = capsys.readouterr().out
    assert f"-> {path}" in out and "lifecycle: " in out
    tool = _tool()
    assert tool.main(["--check", str(path)]) == 0
    assert "OK" in capsys.readouterr().out
    assert tool.main([str(path)]) == 0
    assert "bw counter" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    doc = json.loads(path.read_text())
    doc["traceEvents"] = [e for e in doc["traceEvents"] if e["ph"] != "E"]
    bad.write_text(json.dumps(doc))
    assert tool.main(["--check", str(bad)]) == 1

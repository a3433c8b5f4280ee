"""The port's cluster (``repro_torch.serving.cluster``) against the
in-process fleet and against the JAX reference's cluster.

* Codec: every message round-trips through plain primitives.
* Loopback: the port's loopback cluster equals the port's
  ``EventScheduler`` exactly (round_robin == 'none', shaping == 'demand',
  and on the wave-only load), and equals the reference's loopback cluster
  on the same load (same stamps, summary without wall time, final clock).
* The other behaviours, as the reference pins them: shortest_backlog,
  failover on a virtual-clock kill (requeue with arrival and deadline
  kept, the prefill gate balanced, all workers dead raises, worker errors
  propagate), heartbeats, elastic join and drain.
* Real processes: ``mp`` and ``socket`` equal loopback on simulated
  engines, and a hard kill requeues and completes.
* Real engines: a loopback cluster of two fp32 smoke engines on the CPU
  gives the same tokens, stamps and summary as the port's
  ``EventScheduler`` fleet of the same engines; a worker asking for a card
  where there is none raises.
"""
import numpy as np
import pytest
import torch

from repro.serving import RequestQueue as JQueue
from repro.serving import make_cluster as jmake_cluster
from repro.serving import make_worker_specs as jmake_specs
from repro_torch.configs import get_config
from repro_torch.serving import (EventScheduler, PartitionEngine,
                                 RequestQueue, SimulatedEngine, make_cluster,
                                 make_worker_specs)
from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.cluster import (ClusterError, LoopbackTransport,
                                         WorkerRuntime, WorkerSpec,
                                         build_engine, make_router,
                                         make_transport, worker_device)

ARCH = "qwen2-7b"
PEAK, BW = 1e12, 2e11


def _cfg():
    return get_config(ARCH, smoke=True)


def _load(queue, n, prompt_len=8, gen=4, deadline=None):
    rng = np.random.default_rng(0)
    for _ in range(n):
        queue.submit(rng.integers(1, 100, size=(prompt_len,))
                     .astype(np.int32), gen, deadline=deadline)


def _fleet(partitions, slots=2, max_len=64, wave_only=False):
    return [SimulatedEngine(_cfg(), slots=slots, max_len=max_len, pid=p,
                            peak_flops=PEAK / partitions,
                            wave_only=wave_only)
            for p in range(partitions)]


def _specs(partitions, slots=2, max_len=64, wave_only=False, make=None):
    return (make or make_worker_specs)(
        ARCH, partitions, slots=slots, max_len=max_len, wave_only=wave_only,
        peak_flops_total=PEAK)


def _stamps(queue):
    return sorted((r.rid, tuple(r.tokens), r.t_first_token, r.t_done)
                  for r in queue.completed)


def _summary_no_wall(m):
    return {k: v for k, v in m.summary().items() if "wall" not in k}


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def _status():
    return P.WorkerStatus(busy=True, wants_prefill=False, backlog_len=3,
                          n_active=2, head_arrival=1.5, pre_dur=2e-6,
                          wave_dur=9e-6, active_rids=(3, 7),
                          metrics=(("engine.prefills", 2.0),))


MESSAGES = [
    P.Assign(requests=(P.WireRequest(rid=7, prompt=(1, 2, 3),
                                     max_new_tokens=4, arrival=0.5,
                                     deadline=9.0, cached_len=2),)),
    P.IssueOp(op="prefill"),
    P.CommitOp(t_end=1.25e-6),
    P.ExportKv(rids=(3, 7)),
    P.Ping(t_wall=123.0, t_virtual=4e-6),
    P.Shutdown(),
    P.Hello(wid=2, slots=4, max_len=64, status=_status()),
    P.AssignAck(status=_status()),
    P.OpIssued(op="decode",
               cost=P.WireCost(flops=1e9, byts=2e6, duration=3e-6),
               status=_status()),
    P.OpCommitted(op="prefill",
                  retired=(P.RetiredRequest(rid=7, tokens=(1, 1, 2, 3),
                                            t_first_token=1e-6,
                                            t_done=4e-6),),
                  refill=P.WireCost(flops=1e8, byts=1e5, duration=1e-7),
                  status=_status()),
    P.OpCommitted(op="decode", retired=(), refill=None, status=_status()),
    P.KvImported(ok=False, reason="pool", status=_status()),
    P.Pong(t_wall=123.0, status=_status(), t_virtual=4e-6),
    P.Bye(n_prefills=3, n_refills=1, n_decode_steps=20),
    P.WorkerError(error="ValueError: boom", traceback="tb"),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: type(m).__name__)
def test_protocol_messages_round_trip(msg):
    wire = P.encode(msg)
    assert wire["kind"] == type(msg).__name__
    assert P.decode(wire) == msg


def test_codec_is_the_references():
    """The port's encoding of each message is the reference's, key for
    key: a port controller can speak to a reference worker's bytes."""
    from repro.serving.cluster import protocol as JP

    for msg in MESSAGES:
        jmsg = JP.decode(P.encode(msg))
        assert type(jmsg).__name__ == type(msg).__name__
        assert JP.encode(jmsg) == P.encode(msg)


def test_wire_request_round_trips_request():
    from repro_torch.serving.queue import Request

    req = Request(rid=3, prompt=np.array([5, 6, 7], np.int32),
                  max_new_tokens=2, arrival=1.0, deadline=4.0)
    back = P.WireRequest.from_request(req).to_request()
    assert back.rid == req.rid and back.max_new_tokens == 2
    assert back.arrival == 1.0 and back.deadline == 4.0
    np.testing.assert_array_equal(back.prompt, req.prompt)


def test_worker_status_reports_spacing_ingredients():
    eng = _fleet(2)[0]
    q = RequestQueue()
    _load(q, 3)
    eng.assign(q.pop(3))
    st = WorkerRuntime(eng).status()
    assert st.wants_prefill and not st.busy and st.backlog_len == 3
    pre = eng.prefill_cost_est()
    wave = pre.duration + \
        eng.backlog[0].max_new_tokens * eng.decode_cost_est().duration
    assert st.pre_dur == pre.duration and st.wave_dur == wave
    extra = WorkerRuntime(eng, lambda: (("kernel.matmul.launches", 3.0),))
    names = [k for k, _ in extra.status().metrics]
    assert "kernel.matmul.launches" in names and names == sorted(names)


# ---------------------------------------------------------------------------
# loopback equivalence: cluster == in-process EventScheduler, exactly,
# and == the reference's loopback cluster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router,policy", [("round_robin", "none"),
                                           ("shaping", "demand")])
def test_loopback_cluster_matches_event_scheduler_exactly(router, policy):
    q_ref = RequestQueue()
    _load(q_ref, 21)
    ref = EventScheduler(_fleet(4), q_ref, policy=policy, bandwidth=BW)
    m_ref = ref.run()

    q_cl = RequestQueue()
    _load(q_cl, 21)
    ctl = make_cluster(_specs(4), q_cl, transport="loopback", router=router,
                       bandwidth=BW)
    m_cl = ctl.run()

    assert len(q_cl.completed) == len(q_ref.completed) == 21
    assert _stamps(q_cl) == _stamps(q_ref)
    assert _summary_no_wall(m_cl) == _summary_no_wall(m_ref)
    assert ctl.timeline.now == ref.timeline.now


def test_loopback_cluster_matches_event_scheduler_wave_only():
    q_ref = RequestQueue()
    _load(q_ref, 24, prompt_len=16, gen=6)
    ref = EventScheduler(_fleet(4, wave_only=True), q_ref, policy="demand",
                         bandwidth=BW)
    m_ref = ref.run()

    q_cl = RequestQueue()
    _load(q_cl, 24, prompt_len=16, gen=6)
    ctl = make_cluster(_specs(4, wave_only=True), q_cl,
                       transport="loopback", router="shaping", bandwidth=BW)
    m_cl = ctl.run()
    assert _stamps(q_cl) == _stamps(q_ref)
    assert _summary_no_wall(m_cl) == _summary_no_wall(m_ref)


@pytest.mark.parametrize("router", ["round_robin", "shortest_backlog",
                                    "shaping", "pd"])
@pytest.mark.parametrize("wave_only", [False, True],
                         ids=["refill", "wave_only"])
def test_loopback_cluster_equals_reference_cluster(router, wave_only):
    runs = []
    for Q, make, specs in ((JQueue, jmake_cluster, jmake_specs),
                           (RequestQueue, make_cluster, make_worker_specs)):
        q = Q()
        _load(q, 22, prompt_len=12, gen=5)
        ctl = make(_specs(4, wave_only=wave_only, make=specs), q,
                   transport="loopback", router=router, bandwidth=BW)
        m = ctl.run()
        runs.append((_stamps(q), _summary_no_wall(m), ctl.timeline.now,
                     [(s.t0, s.t1, s.pid, s.phase) for s in ctl.trace]))
    assert runs[1] == runs[0]
    assert len(runs[1][0]) == 22


def test_shortest_backlog_router_balances_and_completes():
    q = RequestQueue()
    _load(q, 26, gen=4)
    ctl = make_cluster(_specs(4), q, transport="loopback",
                       router="shortest_backlog", bandwidth=BW)
    ctl.run()
    assert len(q.completed) == 26
    served = [len(ctl.transport.runtimes[w].engine.assign_order)
              for w in sorted(ctl.views)]
    assert min(served) > 0


def test_make_router_validates():
    with pytest.raises(ValueError, match="router"):
        make_router("chaotic")
    with pytest.raises(ValueError, match="transport"):
        make_transport("carrier-pigeon", _specs(1))


# ---------------------------------------------------------------------------
# failure handling
# ---------------------------------------------------------------------------


def test_loopback_worker_kill_requeues_and_completes():
    q = RequestQueue()
    _load(q, 24, gen=5)
    ctl = make_cluster(_specs(3), q, transport="loopback",
                       router="round_robin", bandwidth=BW)
    kill_t = 2e-6
    ctl.timeline.call_at(kill_t, lambda t: ctl.transport.kill(1))
    ctl.run()
    assert ctl.n_failovers == 1 and ctl.failed_workers == [1]
    assert q.n_requeued > 0
    assert ctl.prefill_live == 0
    assert len(q.completed) == 24
    assert all(len(r.tokens) == r.max_new_tokens for r in q.completed)
    assert not ctl.views[1].outstanding
    assert all(s.t0 <= kill_t + 1e-12 for s in ctl.trace if s.pid == 1)


def test_requeued_requests_keep_arrival_and_deadline():
    q = RequestQueue()
    deadline = 1e6
    _load(q, 12, gen=4, deadline=deadline)
    ctl = make_cluster(_specs(2), q, transport="loopback",
                       router="round_robin", bandwidth=BW)
    ctl.timeline.call_at(2e-6, lambda t: ctl.transport.kill(0))
    ctl.run()
    assert ctl.n_failovers == 1 and q.n_requeued > 0
    assert len(q.completed) == 12
    assert all(r.arrival == 0.0 and r.deadline == deadline
               for r in q.completed)
    assert ctl.metrics.deadline_misses == 0


@pytest.mark.parametrize("kill_t", [1e-8, 1e-7, 1e-6, 5e-6])
def test_kill_during_shaping_keeps_prefill_gate_balanced(kill_t):
    q = RequestQueue()
    _load(q, 20, gen=5)
    ctl = make_cluster(_specs(2, wave_only=True), q, transport="loopback",
                       router="shaping", bandwidth=BW)
    ctl.timeline.call_at(kill_t, lambda t: ctl.transport.kill(1))
    ctl.run()
    assert len(q.completed) == 20
    assert ctl.prefill_live == 0
    prefills = sorted((s.t0, s.t1) for s in ctl.trace
                      if s.phase == "prefill" and s.t0 > kill_t)
    for (a0, a1), (b0, b1) in zip(prefills, prefills[1:]):
        assert b0 >= a1 - 1e-18


def test_all_workers_dead_raises():
    q = RequestQueue()
    _load(q, 8)
    ctl = make_cluster(_specs(1), q, transport="loopback",
                       router="round_robin", bandwidth=BW)
    ctl.timeline.call_at(1e-9, lambda t: ctl.transport.kill(0))
    with pytest.raises(ClusterError, match="unserved"):
        ctl.run()


def test_worker_error_propagates():
    q = RequestQueue()
    _load(q, 2, prompt_len=200)
    with pytest.raises(ClusterError, match="cache positions"):
        make_cluster(_specs(1, max_len=64), q, transport="loopback",
                     router="round_robin", bandwidth=BW).run()


def test_heartbeat_pings_and_detects_death():
    q = RequestQueue()
    ctl = make_cluster(_specs(3), q, transport="loopback",
                       router="round_robin", bandwidth=BW)
    assert ctl.heartbeat() == {0: True, 1: True, 2: True}
    ctl.transport.kill(1)
    assert ctl.heartbeat() == {0: True, 1: False, 2: True}
    assert ctl.failed_workers == [1]


def test_loopback_transport_is_strict_request_reply():
    tp = LoopbackTransport(_specs(1))
    assert isinstance(tp.recv(0), P.Hello)
    with pytest.raises(RuntimeError, match="request/reply"):
        tp.recv(0)


# ---------------------------------------------------------------------------
# elastic membership
# ---------------------------------------------------------------------------


def _elastic(mod_queue, make, specs_fn, join_t=3e-6, drain_t=6e-6):
    q = mod_queue()
    _load(q, 24, gen=5)
    specs = _specs(3, make=specs_fn)
    ctl = make(specs[:2], q, transport="loopback", router="round_robin",
               bandwidth=BW)
    ctl.timeline.call_at(join_t, lambda t: ctl.join_worker(specs[2]))
    ctl.timeline.call_at(drain_t, lambda t: ctl.drain_worker(0))
    m = ctl.run()
    return ctl, q, m


def test_elastic_join_and_drain_complete_and_equal_reference():
    ctl, q, m = _elastic(RequestQueue, make_cluster, make_worker_specs)
    assert ctl.n_joins == 1 and ctl.n_departures == 1
    assert ctl.departed_workers == [0]
    assert len(q.completed) == 24
    assert any(s.pid == 2 for s in ctl.trace)   # the joiner served work
    jctl, jq, jm = _elastic(JQueue, jmake_cluster, jmake_specs)
    assert _stamps(q) == _stamps(jq)
    assert _summary_no_wall(m) == _summary_no_wall(jm)


# ---------------------------------------------------------------------------
# the real process boundary (pipes and TCP sockets)
# ---------------------------------------------------------------------------

REMOTE_TRANSPORTS = ("mp", "socket")


@pytest.mark.parametrize("transport", REMOTE_TRANSPORTS)
def test_remote_cluster_matches_loopback(transport):
    runs = []
    for tp in ("loopback", transport):
        q = RequestQueue()
        _load(q, 16, gen=4)
        m = make_cluster(_specs(3), q, transport=tp, router="shaping",
                         bandwidth=BW, heartbeat_timeout=120.0).run()
        assert len(q.completed) == 16
        runs.append((_stamps(q), _summary_no_wall(m)))
    assert runs[1] == runs[0]


@pytest.mark.parametrize("transport", REMOTE_TRANSPORTS)
def test_remote_worker_hard_kill_requeues_and_completes(transport):
    q = RequestQueue()
    _load(q, 18, gen=5)
    ctl = make_cluster(_specs(3), q, transport=transport,
                       router="round_robin", bandwidth=BW,
                       heartbeat_timeout=120.0)
    ctl.timeline.call_at(2e-6, lambda t: ctl.transport.kill(2))
    ctl.run()
    assert ctl.n_failovers == 1 and ctl.failed_workers == [2]
    assert q.n_requeued > 0
    assert len(q.completed) == 18
    assert all(len(r.tokens) == r.max_new_tokens for r in q.completed)


# ---------------------------------------------------------------------------
# real engines
# ---------------------------------------------------------------------------


def _real_specs(n, **kw):
    return make_worker_specs(ARCH, n, slots=2, max_len=48, engine="real",
                             block_size=8, peak_flops_total=PEAK,
                             device="cpu", **kw)


@pytest.mark.parametrize("router,policy", [("round_robin", "none"),
                                           ("shaping", "demand")])
def test_real_engine_cluster_equals_event_scheduler(router, policy):
    """Two fp32 smoke engines as loopback workers (each built by
    ``build_engine`` from its spec, weights from the spec's seed) against
    the same two engines in the in-process fleet: same tokens, stamps,
    summary and clock."""
    specs = _real_specs(2)
    q_ref = RequestQueue()
    _load(q_ref, 9, prompt_len=8, gen=5)
    engines = [build_engine(s) for s in specs]
    assert all(isinstance(e, PartitionEngine) for e in engines)
    m_ref = EventScheduler(engines, q_ref, policy=policy,
                           bandwidth=BW).run()

    q_cl = RequestQueue()
    _load(q_cl, 9, prompt_len=8, gen=5)
    ctl = make_cluster(specs, q_cl, transport="loopback", router=router,
                       bandwidth=BW)
    m_cl = ctl.run()
    assert _stamps(q_cl) == _stamps(q_ref)
    assert _summary_no_wall(m_cl) == _summary_no_wall(m_ref)
    workers = [ctl.transport.runtimes[w].engine for w in sorted(ctl.views)]
    assert [e.slot_tokens for e in workers] == \
        [e.slot_tokens for e in engines]
    assert all(e.n_decode_steps > 0 for e in workers)


def test_worker_spec_pins_a_card_or_raises():
    spec = _real_specs(1)[0]
    assert worker_device(spec) == torch.device("cpu")
    cuda = WorkerSpec(**{**spec.__dict__, "device": "cuda", "wid": 3})
    if torch.cuda.is_available():
        assert worker_device(cuda) == torch.device(
            "cuda", 3 % torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            worker_device(cuda)
        with pytest.raises(RuntimeError, match="cuda"):
            build_engine(cuda)
    # simulated workers have no device to pin
    sim = WorkerSpec(**{**spec.__dict__, "engine": "sim", "device": "cuda"})
    assert isinstance(build_engine(sim), SimulatedEngine)


def test_real_worker_reports_its_boot_by_part():
    """``worker_main`` on a real CPU engine (run in a thread over a pipe):
    its Hello's status carries the boot seconds by part, which add up to
    the boot, the launch counts and no card memory; Shutdown ends it."""
    import multiprocessing
    import threading

    from repro_torch.serving.cluster.worker import worker_main

    here, there = multiprocessing.Pipe()
    t = threading.Thread(target=worker_main, args=(there, _real_specs(1)[0]))
    t.start()
    hello = P.decode(here.recv())
    m = dict(hello.status.metrics)
    parts = [m[f"worker.{p}_seconds"] for p in ("start", "context", "build")]
    assert all(s >= 0.0 for s in parts) and m["worker.build_seconds"] > 0.0
    assert m["worker.boot_seconds"] == pytest.approx(sum(parts), abs=1e-9)
    assert m["kernel.matmul.launches"] >= 0.0
    # those on the wgmma and stream routes, counted in the matmul's too
    assert 0.0 <= m["kernel.matmul_wgmma.launches"] <= \
        m["kernel.matmul.launches"]
    assert 0.0 <= m["kernel.matmul_stream.launches"] <= \
        m["kernel.matmul.launches"]
    assert "worker.peak_memory_bytes" not in m
    here.send(P.encode(P.Shutdown()))
    assert isinstance(P.decode(here.recv()), P.Bye)
    t.join(timeout=30)
    assert not t.is_alive()


def test_measured_cost_on_simulated_worker_needs_a_profile():
    spec = WorkerSpec(**{**_specs(1)[0].__dict__, "cost_model": "measured"})
    with pytest.raises(ValueError, match="calibration profile"):
        build_engine(spec)


def test_cluster_cli_defaults_to_the_card(capsys):
    from repro_torch.launch import cluster

    argv = ["--arch", ARCH, "--smoke", "--workers", "2", "--requests", "6",
            "--batch", "2", "--prompt-len", "8", "--gen", "4", "--simulated",
            "--transport", "loopback"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cluster.main(argv)
    cluster.main(argv + ["--device", "cpu", "--router", "pd"])
    out = capsys.readouterr().out
    assert "completed=6/6" in out and "router=pd" in out

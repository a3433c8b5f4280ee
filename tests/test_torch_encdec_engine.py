"""The enc-dec family through the port's serving path, held against the
JAX package's engine at whisper-base's smoke size in fp32.

* Lockstep: the port's ``PartitionEngine`` beside the reference's on the
  same weights, load and ``(seed, pid)`` (so both draw the same frames), a
  backlog of three waves through wave-only batching: the same occupancy,
  tokens and live logits within 2e-4 every step; with the decode step on
  the graph's static buffers, without graphs (``cuda_graph=False``) and
  with the card's prefill lifecycle emulated (eager, capture, replays).
* The graph engine equals ``cuda_graph=False`` bit for bit after every
  wave and step: tokens, live logits, the self K/V and the cross K/V;
  every wave of the fleet is one prefill-cache key whatever the prompts'
  width.
* The refusals the reference makes: the paged pool, the prefix cache,
  int8 / fp8 pages, sparse decode, and a KV handoff (export and import).
* The serve CLI serves whisper-base ``--smoke`` on the CPU; ``--cluster 2``
  gives the in-process fleet's tokens; PD fails as the reference's does.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro.serving import SimulatedEngine as JSim
from repro.serving.cluster import ClusterError as JClusterError
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.serving import EventScheduler, PrefillGraphs
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving import make_cluster, make_worker_specs
from repro_torch.serving.cluster import ClusterError, build_engine
from repro_torch.serving.step_graph import CapturedOp

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "whisper-base"
SLOTS, SEED, PID = 2, 5, 1
LENS = [5, 9, 7, 4, 6, 8]       # three waves of two, each of another width
GENS = [4, 3, 5, 2, 4, 3]
MAX_LEN = max(LENS) + 4 * max(GENS)


@functools.lru_cache(maxsize=None)
def _built():
    jcfg = jget_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, "cpu")
    return (jcfg, jm, jp), (tcfg, tm, params_from_jax(jp, "cpu"))


def _load(eng, q, lens=LENS, gens=GENS):
    rng = np.random.default_rng(7)
    for n, g in zip(lens, gens):
        q.submit(rng.integers(1, 256, size=(n,)).astype(np.int32), g)
    eng.assign(q.pop(len(lens)))


def _tengine(**kw):
    _, (tcfg, tm, tp) = _built()
    return TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN, pid=PID,
                   seed=SEED, peak_flops=hw.TPU_PEAK_FLOPS, **kw)


def _drive(eng):
    """Serve the engine's backlog, wave by wave; per step the occupancy
    and the live slots' logits."""
    steps = []
    while eng.busy or eng.wants_prefill:
        if eng.wants_prefill:
            eng.prefill_wave(0.0)
            continue
        occ = [r and r.rid for r in eng.active]
        eng.decode_step(0.0)
        steps.append((occ, {i: np.asarray(eng.last_logits[i]).copy()
                            for i, rid in enumerate(occ) if rid is not None}))
    return steps


@functools.lru_cache(maxsize=None)
def _reference_run():
    (jcfg, jm, jp), _ = _built()
    eng = JEngine(jcfg, jm, jp, slots=SLOTS, max_len=MAX_LEN, pid=PID,
                  seed=SEED, peak_flops=hw.TPU_PEAK_FLOPS)
    _load(eng, JQueue())
    steps = _drive(eng)
    return steps, eng.slot_tokens, eng.n_prefills


class _Replay:
    """A stand-in CUDA graph of an enc-dec wave: 'capturing' runs it once,
    each replay runs it again and writes the capture's cache in place."""

    def __init__(self, step):
        self.step = step
        self.out = step()

    def replay(self):
        for k, t in self.step()[1].items():
            self.out[1][k].copy_(t)


class _EmulatedOp(CapturedOp):
    def __init__(self, step, shapes, device, dtypes=None):
        super().__init__(step, shapes, device, dtypes)
        self.on_card = True

    def _record(self):
        g = _Replay(lambda: self._step(*self.buffers))
        return g, g.out


class Emulated(PrefillGraphs):
    """The card's prefill lifecycle on the CPU: eager, capture, replays."""

    op_type = _EmulatedOp


MODES = {"graph": {}, "eager": dict(cuda_graph=False), "emulated": None}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_reference(mode):
    steps, tokens, prefills = _reference_run()
    kw = MODES[mode]
    if kw is None:
        kw = dict(prefill_graphs=Emulated(_built()[1][1]))
    eng = _tengine(**kw)
    assert not eng.paged
    _load(eng, TQueue())
    got = _drive(eng)
    assert [occ for occ, _ in got] == [occ for occ, _ in steps]
    for k, ((_, a), (_, b)) in enumerate(zip(got, steps)):
        for i in b:
            np.testing.assert_allclose(a[i], b[i], **TOL,
                                       err_msg=f"step {k} slot {i}")
    assert eng.slot_tokens == tokens
    assert eng.n_prefills == prefills == 3 and eng.n_refills == 0
    if mode == "emulated":      # eager, captured, replayed: one key
        pg = eng.prefill_graphs
        assert len(pg.uses) == 1 and pg.n_captures == 1
        assert pg.n_eager == 1 and pg.n_replays == 2


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_graph_engine_equals_eager_bit_for_bit():
    """After every wave and step: tokens, live logits, the slab's self K/V
    and cross K/V; a wave emits no first token and starts every slot at
    token 1; the decode position is the wave's one counter."""
    pg = Emulated(_built()[1][1])
    engines = [_tengine(prefill_graphs=pg), _tengine(cuda_graph=False)]
    for eng in engines:
        _load(eng, TQueue())
    ge, ee = engines
    waves = 0
    while ee.busy or ee.wants_prefill:
        wave = ee.wants_prefill
        for eng in engines:
            if wave:
                assert eng.wants_prefill
                eng.prefill_wave(0.0)
                assert eng._wave_pos == 0
                assert (eng._last_tok == 1).all()
                assert all(not r.tokens for r in eng.active if r)
            else:
                eng.decode_step(0.0)
        waves += wave
        assert ge.slot_tokens == ee.slot_tokens
        assert ge._wave_pos == ee._wave_pos
        for key in ("k", "v", "xk", "xv"):
            assert torch.equal(_bits(ge.cache[key]), _bits(ee.cache[key])), \
                key
        if not wave:
            live = [i for i, r in enumerate(ee.active) if r is not None]
            assert np.array_equal(ge.last_logits[live], ee.last_logits[live])
    assert waves == 3 and not ge.busy and not ge.backlog
    assert ge.graph.n_eager == ge.n_decode_steps
    assert pg.uses == {pg.key(ge.params, SLOTS, ge.cfg.enc_seq, MAX_LEN,
                              False): 3}


def test_engines_on_one_seed_draw_the_same_frames():
    """The frames are the reference engine's draw: (seed, pid) fixes them,
    another pid draws others."""
    a, b = _tengine(cuda_graph=False), _tengine(cuda_graph=False)
    c = TEngine(*_built()[1], slots=SLOTS, max_len=MAX_LEN, pid=PID + 1,
                seed=SEED, cuda_graph=False)
    for eng in (a, b, c):
        _load(eng, TQueue(), LENS[:SLOTS], GENS[:SLOTS])
        eng.prefill_wave(0.0)
    assert torch.equal(a.cache["xk"], b.cache["xk"])
    assert not torch.equal(a.cache["xk"], c.cache["xk"])


REFUSED = {"paged": (dict(paged=True), ValueError,
                     "paged KV is not supported for enc-dec models"),
           "prefix cache": (dict(prefix_cache=True), ValueError,
                            "prefix caching is not supported for the "
                            "'encdec' family"),
           "int8": (dict(kv_dtype="int8"), ValueError,
                    "quantized / blockwise-sparse KV is not supported for "
                    "the 'encdec' family"),
           "fp8": (dict(kv_dtype="fp8"), ValueError,
                   "quantized / blockwise-sparse KV is not supported for the "
                   "'encdec' family"),
           "sparse": (dict(sparse_threshold=0.1), ValueError,
                      "quantized / blockwise-sparse KV is not supported for "
                      "the 'encdec' family")}


@pytest.mark.parametrize("lever", sorted(REFUSED))
def test_engine_refuses_what_the_reference_refuses(lever):
    kw, err, match = REFUSED[lever]
    (jcfg, jm, jp), _ = _built()
    with pytest.raises(err, match=match):
        if lever == "paged":
            JEngine(jcfg, jm, jp, slots=SLOTS, max_len=MAX_LEN, **kw)
        else:
            JSim(jcfg, slots=SLOTS, max_len=MAX_LEN, **kw)
    with pytest.raises(err, match=match):
        _tengine(**kw)


@pytest.mark.parametrize("side", ["export", "import"])
def test_kv_handoff_raises_as_the_reference(side):
    eng = _tengine()
    _load(eng, TQueue(), LENS[:SLOTS], GENS[:SLOTS])
    eng.prefill_wave(0.0)
    eng.decode_step(0.0)
    req = eng.active[0]
    match = "KV handoff is not supported for enc-dec models"
    with pytest.raises(ValueError, match=match):
        if side == "export":
            eng.export_kv(req.rid)
        else:
            eng._import_slot_state(0, {}, req)


def test_serve_cli_serves_whisper_on_cpu(capsys):
    outs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "6", "--batch", "2", "--partitions",
                       "2", "--stagger", "demand", "--prompt-len", "8",
                       "--gen", "4", "--no-sim"])
    out = capsys.readouterr().out
    assert "completed=6/6" in out and "dense=False" in out
    assert sum(len(o) for o in outs) == 6 * 4
    # two engines' waves of one shape: one prefill-cache key
    assert "prefill graphs: 1 shapes" in out


def _cluster_load(queue):
    rng = np.random.default_rng(0)
    for _ in range(6):
        queue.submit(rng.integers(1, 256, size=(8,)).astype(np.int32), 4)


@pytest.mark.parametrize("router,policy", [("round_robin", "none"),
                                           ("shaping", "demand")])
def test_cluster_equals_the_in_process_fleet(router, policy):
    """Two whisper smoke engines as loopback workers (built from their
    specs: weights from the spec's seed, frames from seed + worker id)
    against the same engines in the in-process fleet: the same tokens
    and stamps."""
    specs = make_worker_specs(ARCH, 2, slots=2, max_len=24, engine="real",
                              peak_flops_total=1e12, device="cpu")
    engines = [build_engine(s) for s in specs]
    assert all(not e.paged for e in engines)
    q_ref = TQueue()
    _cluster_load(q_ref)
    EventScheduler(engines, q_ref, policy=policy, bandwidth=2e11).run()
    q = TQueue()
    _cluster_load(q)
    ctl = make_cluster(specs, q, transport="loopback", router=router,
                       bandwidth=2e11)
    ctl.run()

    def stamps(queue):
        return sorted((r.rid, tuple(r.tokens), r.t_first_token, r.t_done)
                      for r in queue.completed)
    assert len(q.completed) == 6 and stamps(q) == stamps(q_ref)
    workers = [ctl.transport.runtimes[w].engine for w in sorted(ctl.views)]
    assert [e.slot_tokens for e in workers] == \
        [e.slot_tokens for e in engines]


def test_serve_cli_cluster_and_pd(capsys):
    """``--cluster 2`` completes the load with the in-process fleet's
    tokens; ``--router pd`` fails at the first handoff, as the reference's
    does."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "6", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--no-sim"]
    fleet = serve.main(argv + ["--partitions", "2", "--stagger", "demand"])
    outs = serve.main(argv + ["--cluster", "2", "--transport", "loopback"])
    assert "completed=6/6" in capsys.readouterr().out
    # the fleet's slot streams, cut into its requests' 4 tokens each
    want = [tuple(s[i:i + 4]) for s in fleet for i in range(0, len(s), 4)]
    assert len(outs) == 6 and sorted(map(tuple, outs)) == sorted(want)
    pd = ["--cluster", "2", "--transport", "loopback", "--router", "pd",
          "--pd-split", "1:1"]
    match = "KV handoff is not supported for enc-dec models"
    with pytest.raises(JClusterError, match=match):
        jserve.main([a for a in argv if a not in ("--device", "cpu")] + pd)
    with pytest.raises(ClusterError, match=match):
        serve.main(argv + pd)

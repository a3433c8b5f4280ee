"""The port's prefills through one shared cache of graphs
(``serving/prefill_graph.py``).

On a card a prefill wave or slot refill replays a graph captured at its
shape's second use; on the CPU every use runs the same static-buffer path
eagerly.  ``Emulated`` below gives the CPU the card's lifecycle (eager
run, capture, replays): its stand-in graph re-runs the step at each replay
and writes the capture's output tensors in place, as a replay does, so the
tests see an entry's outputs overwritten by the next use of its shape.

* Lockstep, bit for bit: an engine on the cache (static buffers, and
  emulated) and a ``cuda_graph=False`` engine on one ragged stream whose
  refills repeat a shape give the same occupancy, tokens, ``last_logits``
  and pool or slab after the wave and every step, in all six layouts and
  with a prefix-cache hit.
* Shape keys, the LRU bound and its eviction count; sharing: engines on
  one ``params`` use one entry, other params another; the dense slab keeps
  one address and is not an entry's output, so a later replay of its shape
  by another engine leaves it alone.
* A measured cost model's timer skips a shape's eager run and capture.
* Against the JAX reference: a cache engine over a stream with refills
  keeps the reference's tokens and its logits within 2e-4.
* The serve CLI hands one cache to its whole fleet and prints its counts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.profiling import MeasuredCostModel, PhaseTimer, \
    prefill_profile
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import PrefillGraphs
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving import prefill_graph
from repro_torch.serving.step_graph import CapturedOp

SLOTS, BS, MAX_LEN = 3, 4, 40
LENS = [9, 14, 6, 11, 11, 11, 7]   # a ragged wave of 3, then 4 refills
GENS = [6, 3, 9, 5, 4, 3, 6]       # of which three share one shape
HEAD = 8                           # prefix layout: two whole shared blocks
TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUTS = {
    "fp32": {}, "int8": dict(kv_dtype="int8"), "fp8": dict(kv_dtype="fp8"),
    "sparse": dict(sparse_threshold=0.1),
    "int8+sparse": dict(kv_dtype="int8", sparse_threshold=0.1),
    "dense": dict(paged=False), "prefix": dict(prefix_cache=True),
}
STATE_KEYS = ("k", "v", "k_pages", "v_pages", "k_scales", "v_scales")


class _Replay:
    """A stand-in CUDA graph: 'capturing' runs the step once, and each
    replay runs it again and writes the outputs of the capture in place."""

    def __init__(self, step):
        self.step = step
        self.out = step()

    def replay(self):
        logits, cache = self.step()
        self.out[0].copy_(logits)
        for k, t in cache.items():
            self.out[1][k].copy_(t)


class _EmulatedOp(CapturedOp):
    def __init__(self, step, shapes, device):
        super().__init__(step, shapes, device)
        self.on_card = True

    def _record(self):
        g = _Replay(lambda: self._step(*self.buffers))
        return g, g.out


class Emulated(PrefillGraphs):
    """The card's lifecycle on the CPU: eager run, capture, replays."""

    op_type = _EmulatedOp


@pytest.fixture(scope="module")
def built():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


def _prompts(layout, seed=7, lens=LENS):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 256, size=(HEAD,)).astype(np.int32)
    out = []
    for n in lens:
        p = rng.integers(1, 256, size=(n,)).astype(np.int32)
        out.append(np.concatenate([head, p]) if layout == "prefix" else p)
    return out


def _submit(engines, queues, prompts, gens):
    for eng, q in zip(engines, queues):
        for p, g in zip(prompts, gens):
            q.submit(p, g)
        eng.assign(q.pop(len(prompts)))


def _state(eng):
    return eng.cache if eng.pages is None else eng.pages


def _same_state(ga, eb, where):
    sa, sb = _state(ga), _state(eb)
    for key in STATE_KEYS:
        if key in sb:
            assert torch.equal(sa[key], sb[key]), (where, key)
    assert ga.slot_tokens == eb.slot_tokens, where


def _lockstep(ga, eb):
    """Drive the cache engine ``ga`` and the eager engine ``eb`` through
    one wave and its refills, bit for bit after the wave and every step
    (a step's commit runs its refills)."""
    ga.prefill_wave(0.0)
    eb.prefill_wave(0.0)
    _same_state(ga, eb, "wave")
    steps = 0
    while eb.busy:
        assert ga.busy
        ga.decode_step(0.0)
        eb.decode_step(0.0)
        assert [r and r.rid for r in ga.active] == \
            [r and r.rid for r in eb.active]
        np.testing.assert_array_equal(ga.last_logits, eb.last_logits)
        _same_state(ga, eb, f"step {steps}")
        steps += 1
    assert not ga.busy and ga.assign_order == eb.assign_order
    return steps


def _lifecycle(pg, emulated):
    """The cache's counts against its uses by shape: on the card's
    lifecycle one eager run a shape, a capture at its second use and a
    replay from then on; on the CPU every use eager."""
    uses = list(pg.uses.values())
    assert pg.n_evictions == 0 and len(pg) == len(uses)
    if emulated:
        assert pg.n_eager == len(uses)
        assert pg.n_captures == sum(u >= 2 for u in uses)
        assert pg.n_replays == sum(u - 1 for u in uses)
    else:
        assert pg.n_eager == sum(uses)
        assert pg.n_captures == pg.n_replays == 0


@pytest.mark.parametrize("mode", ["static", "emulated"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cache_engine_bitwise_equals_eager_prefill(built, layout, mode):
    _, (tcfg, tm, tp) = built
    kw = dict(LAYOUTS[layout], slots=SLOTS, max_len=MAX_LEN, block_size=BS)
    pg = Emulated(tm) if mode == "emulated" else None
    ga = TEngine(tcfg, tm, tp, prefill_graphs=pg, **kw)
    eb = TEngine(tcfg, tm, tp, cuda_graph=False, **kw)
    assert eb.prefill_graphs is None
    _submit((ga, eb), (TQueue(), TQueue()), _prompts(layout), GENS)
    steps = _lockstep(ga, eb)
    assert steps >= 8 and ga.n_refills == eb.n_refills == 4
    pg = ga.prefill_graphs
    # the wave and four refills over three shapes, one of them used thrice
    assert sum(pg.uses.values()) == 1 + 4
    assert sorted(pg.uses.values()) == [1, 1, 3]
    _lifecycle(pg, mode == "emulated")
    if layout == "prefix":
        assert ga.n_prefix_hits == eb.n_prefix_hits > 0


def test_shape_keys_and_lru_eviction(built, monkeypatch):
    _, (tcfg, tm, tp) = built
    monkeypatch.setattr(prefill_graph, "MAX_GRAPHS", 2)
    pg = Emulated(tm)
    rng = np.random.default_rng(3)

    def tokens(rows, width):
        return rng.integers(1, 256, size=(rows, width)).astype(np.int32)

    def use(tok, max_len, lens=None):
        got = pg(tp, tok, max_len, lens=lens)
        want = tm.prefill(tp, {"tokens": torch.as_tensor(tok)},
                          max_len=max_len,
                          lens=None if lens is None else torch.as_tensor(lens))
        assert torch.equal(got[0], want[0])
        for k in ("k", "v", "len"):
            assert torch.equal(got[1][k], want[1][k]), k
        return got

    a, b = tokens(1, 6), tokens(1, 6)
    use(a, 6)                                   # (1, 6, 6, uniform): eager
    use(b, 6, lens=np.array([4], np.int32))     # same tokens shape, ragged
    assert len(pg) == 2 and pg.n_eager == 2
    use(b, 6)                                   # capture + replay
    assert (pg.n_captures, pg.n_replays, pg.n_evictions) == (1, 1, 0)
    use(a, 8)                          # another max_len: a third shape ...
    assert len(pg) == 2 and pg.n_evictions == 1   # ... evicts the ragged
    use(b, 6, lens=np.array([5], np.int32))   # back: eager again, evicts a
    assert pg.n_eager == 4 and pg.n_evictions == 2 and len(pg) == 2
    # an evicted shape starts over: captured again at its next use, then
    # replayed; only that replay is a steady use
    use(b, 6, lens=np.array([3], np.int32))
    assert (pg.n_captures, pg.n_replays, pg.n_steady) == (2, 2, 0)
    use(a, 6, lens=np.array([6], np.int32))
    assert (pg.n_captures, pg.n_replays, pg.n_steady) == (2, 3, 1)
    ragged = pg._entries[pg.key(tp, 1, 6, 6, True)]
    assert ragged.last == "replay" and ragged.warm
    assert (ragged.n_eager, ragged.n_replays) == (1, 2)
    keys = list(pg.uses)
    assert len(keys) == 3 and all(k[0] == id(tp) for k in keys)
    assert pg.key(tp, 1, 6, 6, False) in pg.uses
    assert pg.uses[pg.key(tp, 1, 6, 6, True)] == 4
    assert pg.n_eager + pg.n_replays == sum(pg.uses.values())
    assert pg.n_evictions == pg.n_eager - len(pg)


def test_engines_on_one_params_share_an_entry(built):
    _, (tcfg, tm, tp) = built
    pg = Emulated(tm)
    other = {k: v for k, v in tp.items()}       # another params object
    kw = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BS, prefill_graphs=pg)
    engines = [TEngine(tcfg, tm, p, pid=i, **kw)
               for i, p in enumerate((tp, tp, other))]
    prompts = _prompts("fp32")[:SLOTS]
    _submit(engines, [TQueue() for _ in engines], prompts, GENS[:SLOTS])
    for eng in engines:
        eng.prefill_wave(0.0)
    assert all(e.prefill_graphs is pg for e in engines)
    # the first two engines: one entry, eager then captured and replayed;
    # the third's weights are another object, so another entry
    assert len(pg) == 2 and sorted(pg.uses.values()) == [1, 2]
    assert (pg.n_eager, pg.n_captures, pg.n_replays) == (2, 1, 1)
    assert engines[0].slot_tokens == engines[1].slot_tokens \
        == engines[2].slot_tokens
    own = TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN)
    assert isinstance(own.prefill_graphs, PrefillGraphs) \
        and own.prefill_graphs is not pg
    with pytest.raises(ValueError):             # another api's cache
        TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN,
                prefill_graphs=PrefillGraphs(tapi.build(tcfg, "cpu")))
    with pytest.raises(ValueError):             # the eager engine's prefill
        TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN,
                cuda_graph=False, prefill_graphs=pg)


def test_dense_slab_is_owned_not_a_graph_output(built):
    """The dense slab keeps one address over a wave and its refills, and
    shares no storage with an entry's outputs: when a second engine
    replays the first engine's wave shape, the first engine's slab holds
    still."""
    _, (tcfg, tm, tp) = built
    pg = Emulated(tm)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=False)
    ga, gb = (TEngine(tcfg, tm, tp, pid=i, prefill_graphs=pg, **kw)
              for i in range(2))
    eb = TEngine(tcfg, tm, tp, cuda_graph=False, **kw)
    _submit((ga, eb), (TQueue(), TQueue()), _prompts("dense"), GENS)
    ga.prefill_wave(0.0)
    eb.prefill_wave(0.0)
    slab = {k: ga.cache[k].data_ptr() for k in ("k", "v", "len")}

    def outputs():
        ptrs = set()
        for entry in pg._entries.values():
            logits, cache = entry.out
            ptrs |= {logits.data_ptr()} | {t.data_ptr()
                                           for t in cache.values()}
        return ptrs

    assert not set(slab.values()) & outputs()
    steps = 0
    while eb.busy:
        ga.decode_step(0.0)
        eb.decode_step(0.0)
        _same_state(ga, eb, f"step {steps}")
        steps += 1
        if steps == 1:
            # another engine replays this engine's wave shape
            _submit((gb,), (TQueue(),), _prompts("dense", seed=9)[:SLOTS],
                    GENS[:SLOTS])
            before = {k: ga.cache[k].clone() for k in ("k", "v", "len")}
            gb.prefill_wave(0.0)
            assert pg.n_replays >= 1
            for k, t in before.items():
                assert torch.equal(ga.cache[k], t), k
    assert ga.n_refills == 4 and pg.n_replays >= 3
    assert {k: ga.cache[k].data_ptr() for k in ("k", "v", "len")} == slab
    assert not set(slab.values()) & outputs()


@pytest.mark.parametrize("mode", ["static", "emulated"])
def test_timer_skips_a_shapes_eager_run_and_capture(built, mode):
    """Four 8-token requests through one slot: a wave, then three refills
    of one shape.  On the CPU's static path the timer sees what the
    reference's engine shows it (each bucket's first sample discarded);
    on the card's lifecycle it also skips the shape's eager run and its
    capture, so only the replayed refill is observed."""
    _, (tcfg, tm, tp) = built
    mm = MeasuredCostModel(tcfg, 1e12, timer=PhaseTimer())
    pg = Emulated(tm) if mode == "emulated" else None
    eng = TEngine(tcfg, tm, tp, slots=2, max_len=MAX_LEN, cost_model=mm,
                  prefill_graphs=pg)
    q = TQueue()
    rng = np.random.default_rng(0)
    q.submit(rng.integers(1, 100, size=(8,)).astype(np.int32), 30)
    for _ in range(4):
        q.submit(rng.integers(1, 100, size=(8,)).astype(np.int32), 2)
    eng.assign(q.pop(5))
    eng.prefill_wave(0.0)
    while eng.busy and eng.n_refills < 3:
        eng.decode_step(0.0)
    refills = mm._store.stats[("prefill", 1, 8)].count
    waves = mm._store.stats.get(("prefill", 2, 8))
    assert eng.n_refills == 3 and waves is None
    assert refills == (1 if mode == "emulated" else 2)
    if mode == "emulated":
        assert eng.prefill_graphs.n_replays == 2


@pytest.mark.parametrize("mode", ["static", "emulated"])
def test_cache_engine_matches_reference_with_refills(built, mode):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    et = TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN, block_size=BS,
                 peak_flops=hw.TPU_PEAK_FLOPS,
                 prefill_graphs=Emulated(tm) if mode == "emulated" else None)
    ej = JEngine(jcfg, jm, jp, slots=SLOTS, max_len=MAX_LEN, block_size=BS,
                 peak_flops=hw.TPU_PEAK_FLOPS)
    _submit((et, ej), (TQueue(), JQueue()), _prompts("fp32"), GENS)
    et.prefill_wave(0.0)
    ej.prefill_wave(0.0)
    while ej.busy:
        occupancy = [r and r.rid for r in ej.active]
        assert [r and r.rid for r in et.active] == occupancy
        et.decode_step(0.0)
        ej.decode_step(0.0)
        for i, rid in enumerate(occupancy):
            if rid is not None:
                np.testing.assert_allclose(et.last_logits[i],
                                           ej.last_logits[i], **TOL)
    assert not et.busy and et.slot_tokens == ej.slot_tokens
    assert et.n_refills == ej.n_refills == 4
    if mode == "emulated":
        assert et.prefill_graphs.n_replays == 2


def test_serve_shares_one_cache_across_its_fleet(capsys):
    engines = []
    serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                "--partitions", "2", "--stagger", "demand", "--requests",
                "8", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--no-sim"], engines_out=engines)
    pg = engines[0].prefill_graphs
    assert all(e.prefill_graphs is pg for e in engines)
    prefills = sum(e.n_prefills + e.n_refills for e in engines)
    # two engines' waves share one shape, every refill another
    assert sum(pg.uses.values()) == pg.n_eager == prefills == 6
    assert sorted(pg.uses.values()) == [2, 4]
    out = capsys.readouterr().out
    assert ("prefill graphs: 2 shapes, 6 eager runs, 0 captures, 0 "
            "replays, 0 evictions") in out


def test_fleet_ab_gives_every_fleet_the_same_tokens(built, monkeypatch):
    """``prefill_profile.fleet_ab`` on the CPU with the card's lifecycle
    emulated: the eager fleet and graph fleets of two bounds serve one
    mixed load to the same tokens, the small bound evicting."""
    _, (tcfg, tm, tp) = built
    monkeypatch.setattr(PrefillGraphs, "op_type", _EmulatedOp)
    monkeypatch.setattr(prefill_profile, "GEN", 3)
    monkeypatch.setattr(prefill_profile, "SLOTS", 2)
    lens = [5, 6, 7, 5, 6, 7, 8, 9, 5, 8, 9, 6]   # 2 x 2 in waves, 8 refills
    out = prefill_profile.fleet_ab(
        tcfg, tm, tp, {"mixed": (lens, {"eager": None, "graph": 2,
                                        "graph 8": 8})})
    rec = out["mixed"]
    assert all(len(r["wall_s"]) == 2 * prefill_profile.ROUNDS
               and r["tokens"] == len(lens) * 3
               for r in rec.values())
    small, large = rec["graph"]["prefills"], rec["graph 8"]["prefills"]
    assert small["uses"] == large["uses"] == 2 + 8
    assert small["evictions"] > 0 and small["held"] == 2
    assert large["evictions"] == 0 and large["replays"] > small["replays"]
    assert "eager" in rec and "prefills" not in rec["eager"]

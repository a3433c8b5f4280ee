"""The port's decode step on static buffers (``serving/step_graph.py``).

On a card every decode step after an engine's first replays one captured
CUDA graph; on the CPU the engine runs the same static-buffer step eagerly,
so these tests cover the buffer filling the card replays.

* Lockstep, bit for bit: a static-buffer engine and a ``cuda_graph=False``
  engine (the step that rebuilds its inputs every time) on one ragged
  stream with refills give the same occupancy, tokens, ``last_logits`` and
  pool after every step, in all six layouts (float, int8, fp8, sparse,
  int8 + sparse, dense) and with a prefix-cache hit; the dense slab keeps
  its address over a second wave.
* Against the JAX reference: the static-buffer dense engine over two waves
  keeps the reference's tokens and logits within 2e-4.
* The launch-count helper (``kernels/counts.py``) on stand-in wrappers,
  the profiler's kernel count by name (``decode_profile.port_kernels``),
  the serve CLI handing its engines to a caller, and ``BlockCount``'s
  persistent accumulator.
* A measured cost model fed by a static-buffer engine observes the steps
  the reference's engine observes.
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
from repro_torch.kernels import counts
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.profiling import decode_profile
from repro_torch.profiling import MeasuredCostModel, PhaseTimer
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving.step_graph import WRAPPERS, DecodeGraph

SLOTS, BS, MAX_LEN = 3, 4, 40
LENS = [9, 14, 6, 11, 7]          # a ragged wave of 3, then 2 refills
GENS = [6, 3, 9, 5, 6]
HEAD = 8                           # prefix layout: two whole shared blocks
TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUTS = {
    "fp32": {}, "int8": dict(kv_dtype="int8"), "fp8": dict(kv_dtype="fp8"),
    "sparse": dict(sparse_threshold=0.1),
    "int8+sparse": dict(kv_dtype="int8", sparse_threshold=0.1),
    "dense": dict(paged=False), "prefix": dict(prefix_cache=True),
}


@pytest.fixture(scope="module")
def built():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


def _prompts(layout, seed=7):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 256, size=(HEAD,)).astype(np.int32)
    out = []
    for n in LENS:
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


def _lockstep(ga, eb):
    """Drive the static-buffer engine ``ga`` and the eager engine ``eb``
    through one wave and its refills, bit for bit after every step."""
    ga.prefill_wave(0.0)
    eb.prefill_wave(0.0)
    steps = 0
    while eb.busy:
        assert ga.busy
        ga.decode_step(0.0)
        eb.decode_step(0.0)
        assert [r and r.rid for r in ga.active] == \
            [r and r.rid for r in eb.active]
        np.testing.assert_array_equal(ga.last_logits, eb.last_logits)
        sa, sb = _state(ga), _state(eb)
        for key in ("k", "v", "k_pages", "v_pages", "k_scales", "v_scales"):
            if key in sb:
                assert torch.equal(sa[key], sb[key]), key
        steps += 1
    assert not ga.busy
    assert ga.slot_tokens == eb.slot_tokens
    assert ga.assign_order == eb.assign_order
    return steps


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_static_buffer_step_bitwise_equals_eager(built, layout):
    _, (tcfg, tm, tp) = built
    kw = dict(LAYOUTS[layout])
    ga, eb = (TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN,
                      block_size=BS, cuda_graph=g, **kw)
              for g in (True, False))
    for w in (pa_ops.paged_decode_sparse, pa_ops.paged_decode_quant):
        w.dropped_blocks.reset()
    prompts = _prompts(layout)
    _submit((ga, eb), (TQueue(), TQueue()), prompts, GENS)
    steps = _lockstep(ga, eb)
    assert steps >= 8 and ga.n_refills == eb.n_refills == 2
    # every step ran on the graph's static buffers, eagerly (CPU: no graph)
    assert ga.graph.n_eager == ga.n_decode_steps == steps
    assert ga.graph.graph is None and ga.graph.n_replays == 0
    assert ga.graph.warm and eb.graph is None
    if layout == "prefix":
        assert ga.n_prefix_hits == eb.n_prefix_hits > 0
    if "sparse" in layout:
        w = pa_ops.paged_decode_quant if "int8" in layout \
            else pa_ops.paged_decode_sparse
        assert w.dropped_blocks.value > 0


def test_dense_slab_keeps_its_address_over_a_second_wave(built):
    _, (tcfg, tm, tp) = built
    ga, eb = (TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN,
                      paged=False, cuda_graph=g) for g in (True, False))
    qa, qb = TQueue(), TQueue()
    _submit((ga, eb), (qa, qb), _prompts("dense")[:SLOTS], GENS[:SLOTS])
    first = _lockstep(ga, eb)
    slab = {k: ga.cache[k].data_ptr() for k in ("k", "v")}
    _submit((ga, eb), (qa, qb), _prompts("dense", seed=8), GENS)
    second = _lockstep(ga, eb)
    assert first > 0 and second >= 8 and ga.n_prefills == 2
    assert {k: ga.cache[k].data_ptr() for k in ("k", "v")} == slab
    assert ga.graph.n_eager == first + second


def test_dense_static_buffer_engine_matches_reference_over_two_waves(built):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    et = TEngine(tcfg, tm, tp, slots=SLOTS, max_len=MAX_LEN, paged=False,
                 peak_flops=hw.TPU_PEAK_FLOPS)
    ej = JEngine(jcfg, jm, jp, slots=SLOTS, max_len=MAX_LEN, paged=False,
                 peak_flops=hw.TPU_PEAK_FLOPS)
    qt, qj = TQueue(), JQueue()
    for seed in (7, 8):
        _submit((et, ej), (qt, qj), _prompts("dense", seed), GENS)
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
        assert not et.busy
    assert et.slot_tokens == ej.slot_tokens
    assert et.n_prefills == ej.n_prefills == 2
    assert et.graph.n_eager == et.n_decode_steps == ej.n_decode_steps


def test_decode_graph_checks_its_inputs():
    g = DecodeGraph(lambda *bufs: bufs, slots=2, device=torch.device("cpu"),
                    table_width=3)
    with pytest.raises(ValueError):          # no tables for a paged step
        g(np.zeros((2, 1), np.int32), np.zeros(2, np.int32))
    tok, lens, tables = g(np.array([[5], [6]], np.int32),
                          np.array([3, 0], np.int32),
                          np.arange(6, dtype=np.int32).reshape(2, 3))
    assert tok.tolist() == [[5], [6]] and lens.tolist() == [3, 0]
    assert tables.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert g.n_eager == 1 and g.warm and g.graph is None


# ---------------------------------------------------------------------------
# the launch-count helper and the dropped-block accumulator
# ---------------------------------------------------------------------------


class _Wrapper:
    def __init__(self, launches, routes=None):
        self.launches = launches
        if routes is not None:
            self.routes = dict(routes)


def test_counts_snapshot_and_diff():
    mm = _Wrapper(10, {"mma": 7, "skinny": 3, "tiled": 0})
    pa = _Wrapper(4)
    ws = (mm, pa)
    before = counts.snapshot(ws)
    mm.launches += 5                    # one step: 5 matmuls, 2 paged
    mm.routes["mma"] += 5
    pa.launches += 2
    assert counts.diff(counts.snapshot(ws), before) == \
        ((5, {"mma": 5, "skinny": 0, "tiled": 0}), (2, {}))
    assert before == ((10, {"mma": 7, "skinny": 3, "tiled": 0}), (4, {}))
    assert counts.snapshot(ws)[0][1] is not mm.routes   # copies, not views


def test_counts_reject_mismatched_snapshots():
    with pytest.raises(ValueError):
        counts.diff(counts.snapshot([_Wrapper(1)]), ())


class _Row:
    """A stand-in for one row of a profiler's ``key_averages()``."""

    def __init__(self, key, count, on_card=True):
        self.key, self.count = key, count
        self.device_type = torch.autograd.DeviceType.CUDA if on_card \
            else torch.autograd.DeviceType.CPU


def test_port_kernels_counts_the_port_kernels_by_name():
    rows = [_Row("void (anonymous namespace)::mm_mma<16>(__nv_bfloat16 "
                 "const*)", 197),
            _Row("void (anonymous namespace)::mm_mma<64>(__nv_bfloat16 "
                 "const*)", 3),
            _Row("void split_reduce<__nv_bfloat16, true>(float const*)", 40),
            _Row("void decode::kernel<__nv_bfloat16, float>(decode::Args)",
                 28),
            _Row("void decode::combine<float>(float const*)", 28),
            _Row("void at::native::elementwise_kernel<128, 2>()", 500),
            _Row("aten::mm_mma_lookalike", 9, on_card=False),
            _Row("Memcpy DtoH (Device -> Pageable)", 2)]
    assert decode_profile.port_kernels(rows) == {
        "mm_mma": 200, "split_reduce": 40, "decode::kernel": 28,
        "decode::combine": 28}


def test_serve_hands_its_engines_to_the_caller(capsys):
    """``serve.main`` appends its fleet to ``engines_out``: each engine's
    graph counted every decode step as eager (CPU) and none as a replay."""
    engines = []
    outs = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                       "--partitions", "2", "--stagger", "demand",
                       "--requests", "4", "--batch", "2", "--prompt-len",
                       "8", "--gen", "3", "--no-sim"], engines_out=engines)
    assert sum(len(s) for s in outs) == 4 * 3
    assert [e.pid for e in engines] == [0, 1]
    for e in engines:
        assert e.graph.n_eager == e.n_decode_steps > 0
        assert e.graph.n_replays == 0 and e.graph.graph is None
    assert "0 replays" in capsys.readouterr().out


def test_decode_path_wrappers_are_counted():
    names = [w.__name__ for w in WRAPPERS]
    assert names == ["matmul", "flash_attention", "paged_decode",
                     "paged_decode_quant", "paged_decode_sparse",
                     "flash_decode"]
    snap = counts.snapshot(WRAPPERS)
    assert set(snap[0][1]) == {"mma", "skinny", "tiled", "wgmma", "stream"}


def test_block_count_accumulates_in_place():
    bc = pa_ops.BlockCount()
    assert bc.value == 0
    for n in (3, 0, 4):
        bc.add(torch.tensor(n))
    assert bc.value == 7
    acc = bc._sums[torch.device("cpu")]
    bc.reset()
    assert bc.value == 0 and bc._sums[torch.device("cpu")] is acc
    bc.add(torch.tensor(2))
    assert bc.value == 2 and bc._sums[torch.device("cpu")] is acc


def test_block_count_totals_of_a_sparse_step_are_unchanged():
    """The keep masks' dropped blocks, counted through the wrapper, equal
    the plain count of valid blocks the masks drop."""
    from repro_torch.kernels.paged_attention import ref as pa_ref

    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, D, bs, T = 3, 4, 2, 8, 4, 5
    q = torch.randn((B, Hq, D), generator=g)
    kp = torch.randn((1 + B * T, bs, Hkv, D), generator=g)
    vp = torch.randn((1 + B * T, bs, Hkv, D), generator=g)
    tables = torch.arange(1, 1 + B * T, dtype=torch.int32).reshape(B, T)
    cur = torch.tensor([17, 9, 3], dtype=torch.int32)
    w = pa_ops.paged_decode_sparse
    w.dropped_blocks.reset()
    total = 0
    for _ in range(3):
        keep = pa_ref.block_keep_mask(q, kp, tables, cur, threshold=0.3)
        valid = pa_ref.valid_blocks(cur, T, bs)
        total += int((valid[:, None, :] & ~keep).sum())
        w(q, kp, vp, tables, cur, keep=keep)
    assert w.dropped_blocks.value == total > 0


# ---------------------------------------------------------------------------
# the measured cost model fed by a static-buffer engine
# ---------------------------------------------------------------------------


def test_static_buffer_engine_feeds_the_timer_like_the_reference(built):
    """On the CPU every static-buffer step is a steady one, so the timer
    sees what the reference's engine shows it: each bucket's first sample
    discarded (``tests/test_cost_model.py``'s pattern), then every op."""
    _, (tcfg, tm, tp) = built
    mm = MeasuredCostModel(tcfg, 1e12, timer=PhaseTimer())
    eng = TEngine(tcfg, tm, tp, slots=2, max_len=MAX_LEN, cost_model=mm)
    q = TQueue()
    rng = np.random.default_rng(0)
    for _ in range(2):
        q.submit(rng.integers(1, 100, size=(8,)).astype(np.int32), 5)
    eng.assign(q.pop(2))
    eng.commit_op(eng.issue_prefill(), 1.0)
    assert mm.n_observations == 0
    obs = []
    for t in range(4):                  # ctx sums 16, 18, 20, 22
        eng.commit_op(eng.issue_decode(), 2.0 + t)
        obs.append(mm.n_observations)
    assert obs == [0, 0, 1, 2]
    assert eng.graph.warm and eng.graph.n_eager == 4

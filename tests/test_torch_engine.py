"""The port's serving engine against the JAX reference's, fp32 smoke.

* Lockstep: a JAX and a torch paged ``PartitionEngine`` on the same ragged
  request stream with mid-wave refills (the load of
  ``tests/test_paged_engine.py``) keep the same slot occupancy, emit the
  same greedy tokens and logits within 2e-4 at every decode step.
* Fleets: P = 2 engines of each package under ``EventScheduler`` with the
  same explicit ``peak_flops`` and ``bandwidth`` give identical tokens and
  an identical virtual-clock ``metrics.summary()`` (the clock, queue,
  scheduler and cost model are the reference's code, copied; only the
  wall-clock throughput may differ).
* The port's serve CLI completes every request on the CPU, with each
  bandwidth lever, with ``--dense``, with ``--cost-model measured``, with
  ``--trace`` and as a ``--cluster`` of simulated workers.
* ``get_config`` resolves every architecture id and alias of the
  reference's registry to the reference's config, field for field.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving import EventScheduler as JEventScheduler
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.serving import EventScheduler as TEventScheduler
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue

LENS = [8, 12, 10, 8, 12]  # ragged wave + enough backlog to force refills
PEAK, BW = 1e12, 2e11


@pytest.fixture(scope="module")
def built():
    # float32 so argmax never diverges on bf16 rounding
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


def _load(queue, lens, gen=4, vocab=256):
    rng = np.random.default_rng(7)
    for n in lens:
        queue.submit(rng.integers(1, vocab, size=(n,)).astype(np.int32), gen)


def test_lockstep_engines_match(built):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    qj, qt = JQueue(), TQueue()
    _load(qj, LENS)
    _load(qt, LENS)
    ej = JEngine(jcfg, jm, jp, slots=2, max_len=48, peak_flops=PEAK,
                 paged=True, block_size=8)
    et = TEngine(tcfg, tm, tp, slots=2, max_len=48, peak_flops=PEAK,
                 block_size=8)
    ej.assign(qj.pop(len(LENS)))
    et.assign(qt.pop(len(LENS)))
    ej.prefill_wave(0.0)
    et.prefill_wave(0.0)
    steps = 0
    while ej.busy:
        assert et.busy
        occupancy = [r.rid if r is not None else None for r in ej.active]
        assert [r.rid if r is not None else None
                for r in et.active] == occupancy
        ej.decode_step(0.0)
        et.decode_step(0.0)
        for i, rid in enumerate(occupancy):
            if rid is not None:
                np.testing.assert_allclose(et.last_logits[i],
                                           ej.last_logits[i],
                                           rtol=2e-4, atol=2e-4)
        steps += 1
    assert not et.busy
    assert steps > 0 and et.n_refills == ej.n_refills > 0
    assert et.slot_tokens == ej.slot_tokens
    assert et.assign_order == ej.assign_order
    assert et.slot_lens == ej.slot_lens
    assert et.pool.n_live == 0


def _fleet(cfg, api, params, engine_cls, queue_cls, sched_cls):
    q = queue_cls()
    _load(q, [8, 12, 10, 8, 12, 9, 11, 8], gen=5)
    engines = [engine_cls(cfg, api, params, slots=2, max_len=48, pid=p,
                          peak_flops=PEAK / 2, block_size=8)
               for p in range(2)]
    sched = sched_cls(engines, q, policy="demand", bandwidth=BW)
    m = sched.run()
    return engines, q, sched, m


def test_event_scheduled_fleets_match(built):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    ej, qj, sj, mj = _fleet(jcfg, jm, jp,
                            lambda *a, **k: JEngine(*a, paged=True, **k),
                            JQueue, JEventScheduler)
    et, qt, st, mt = _fleet(tcfg, tm, tp, TEngine, TQueue, TEventScheduler)
    assert [e.slot_tokens for e in et] == [e.slot_tokens for e in ej]
    assert sorted((r.rid, r.tokens) for r in qt.completed) == \
        sorted((r.rid, r.tokens) for r in qj.completed)
    sj_sum, st_sum = mj.summary(), mt.summary()
    for s in (sj_sum, st_sum):
        s.pop("tok_per_s_wall")
    assert st_sum == sj_sum
    assert [(r.t0, r.t1, r.pid, r.phase) for r in st.trace] == \
        [(r.t0, r.t1, r.pid, r.phase) for r in sj.trace]
    assert st_sum["requests_completed"] == 8


def test_serve_cli_completes_every_request_on_cpu(capsys):
    outs = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                       "--partitions", "2", "--stagger", "demand",
                       "--requests", "6", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4"])
    assert sum(len(s) for s in outs) == 6 * 4
    assert "completed=6/6" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--dense"], ["--kv-dtype", "int8"], ["--sparse-threshold", "0.1"],
    ["--prefix-cache"], ["--cost-model", "measured"],
])
def test_serve_cli_serves_formerly_refused_flags(flags, capsys):
    outs = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                       "--partitions", "2", "--stagger", "demand",
                       "--requests", "6", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4", "--no-sim", *flags])
    assert sum(len(s) for s in outs) == 6 * 4
    assert "completed=6/6" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--cluster", "2", "--simulated"],
                                   ["--trace", "t.json"]])
def test_serve_cli_refuses_unported_flags(flags, tmp_path, capsys):
    """No flag of the reference's CLI is refused any more: the two that
    waited longest (``--cluster`` with its ``--simulated`` workers, and
    ``--trace``) complete every request on the CPU."""
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    outs = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                       "--requests", "6", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4", "--no-sim", *flags])
    out = capsys.readouterr().out
    assert "completed=6/6" in out
    if flags[0] == "--cluster":
        assert "workers=2" in out and len(outs) == 6
        assert all(len(toks) == 4 for toks in outs)
    else:
        assert sum(len(s) for s in outs) == 6 * 4
        assert (tmp_path / "t.json").stat().st_size > 0
        assert "lifecycle: " in out


@pytest.mark.parametrize("name", jbase.ARCH_IDS + sorted(jbase._ALIASES))
def test_get_config_resolves_every_reference_name(name):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(name, smoke=smoke)) == \
            dataclasses.asdict(jget_config(name, smoke=smoke))


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="int4"), "unknown kv_dtype"),
    (dict(sparse_threshold=1.0), "sparse_threshold"),
    (dict(sparse_threshold=1.5), "sparse_threshold"),
    (dict(sparse_threshold=-0.1), "sparse_threshold"),
    (dict(paged=False, kv_dtype="int8"), "paged block pool"),
    (dict(paged=False, sparse_threshold=0.2), "paged block pool"),
    (dict(paged=False, prefix_cache=True), "paged pool"),
])
def test_engine_refuses_unported_layouts(built, kw, match):
    """The refusals that remain are the reference's loud ValueErrors
    (``tests/test_kv_quant.py:130-175``): unknown dtype, a threshold
    outside [0, 1), quantized, sparse or prefix-cached KV on the dense
    slab."""
    _, (tcfg, tm, tp) = built
    with pytest.raises(ValueError, match=match):
        TEngine(tcfg, tm, tp, slots=2, max_len=32, **kw)

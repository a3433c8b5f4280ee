"""The port's dense-slab engine and its prefix cache.

* Lockstep: a JAX and a torch ``PartitionEngine(paged=False)`` on the same
  ragged stream with refills keep the same occupancy and tokens, logits
  within 2e-4 every step, and the same dense slab.
* The port's own gate (``tests/test_paged_engine.py``): its paged engine
  and its dense engine serve the same stream with the same tokens and
  logits within 2e-4.
* Prefix caching (``tests/test_prefix_cache.py``): a request whose head is
  served from another request's blocks gives logits BIT-identical to a
  cold engine, and serving the donor's prompt again still matches its
  cold run bit for bit.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue

LENS = [8, 12, 10, 8, 12]   # ragged wave + backlog that forces refills
TOL = dict(rtol=2e-4, atol=2e-4)
HEAD, BS = 16, 8            # shared prompt head: two whole blocks


@pytest.fixture(scope="module")
def built():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return (jcfg, jm, jparams), (tcfg, tm, params_from_jax(jparams, "cpu"))


def _load(queue, vocab=256):
    rng = np.random.default_rng(7)
    for n in LENS:
        queue.submit(rng.integers(1, vocab, size=(n,)).astype(np.int32), 4)


def _pair(ea, eb, qa, qb, tol, compare_state=None):
    """Drive two engines in lockstep; live slots' logits within ``tol``."""
    _load(qa)
    _load(qb)
    ea.assign(qa.pop(len(LENS)))
    eb.assign(qb.pop(len(LENS)))
    ea.prefill_wave(0.0)
    eb.prefill_wave(0.0)
    steps = 0
    while eb.busy:
        assert ea.busy
        occupancy = [r.rid if r is not None else None for r in eb.active]
        assert [r.rid if r is not None else None
                for r in ea.active] == occupancy
        ea.decode_step(0.0)
        eb.decode_step(0.0)
        for i, rid in enumerate(occupancy):
            if rid is not None:
                np.testing.assert_allclose(ea.last_logits[i],
                                           eb.last_logits[i], **tol)
        if compare_state is not None:
            compare_state(ea, eb)
        steps += 1
    assert not ea.busy and steps > 0
    assert ea.n_refills == eb.n_refills > 0
    assert ea.slot_tokens == eb.slot_tokens
    assert ea.assign_order == eb.assign_order


def test_dense_engines_match_reference(built):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    et = TEngine(tcfg, tm, tp, slots=2, max_len=48, paged=False,
                 peak_flops=hw.TPU_PEAK_FLOPS)
    ej = JEngine(jcfg, jm, jp, slots=2, max_len=48, paged=False,
                 peak_flops=hw.TPU_PEAK_FLOPS)

    def slab(a, b):
        # rows of slots that are live, up to their lengths; the inactive
        # slots' rows at position 0 differ harmlessly in what they wrote
        for i, n in enumerate(a.slot_lens):
            if a.active[i] is not None:
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        a.cache[key][:, i, :n].numpy(),
                        np.asarray(b.cache[key])[:, i, :n], **TOL)

    _pair(et, ej, TQueue(), JQueue(), TOL, slab)
    assert et.pages is None and et.cache is not None


def test_paged_engine_matches_own_dense_oracle(built):
    _, (tcfg, tm, tp) = built
    ep = TEngine(tcfg, tm, tp, slots=2, max_len=48, block_size=8)
    ed = TEngine(tcfg, tm, tp, slots=2, max_len=48, paged=False)
    _pair(ep, ed, TQueue(), TQueue(), TOL)
    assert ep.pool.n_live == 0


def _prompts(tails, seed=9):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 256, size=(HEAD,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, 256, size=(t,))
                            .astype(np.int32)]) for t in tails]


def _drive_one(eng, prompt, gen=4):
    q = TQueue()
    q.submit(prompt, gen)
    eng.assign(q.pop(1))
    eng.prefill_wave(0.0)
    i = next(j for j, r in enumerate(eng.active) if r is not None)
    logits = []
    while eng.busy:
        eng.decode_step(0.0)
        logits.append(np.asarray(eng.last_logits[i]).copy())
    return logits, list(eng.completed[-1].tokens)


def test_prefix_hit_logits_bit_identical_to_cold(built):
    _, (tcfg, tm, tp) = built

    def engine(cache):
        return TEngine(tcfg, tm, tp, slots=2, max_len=48, block_size=BS,
                       prefix_cache=cache)

    prompts = _prompts([4, 4])
    warm = engine(True)
    _drive_one(warm, prompts[0])                  # cold fill registers head
    hit_logits, hit_tokens = _drive_one(warm, prompts[1])
    assert warm.n_prefix_hits == 1 and warm.n_cached_tokens == HEAD
    assert warm.pool.n_hits == 1
    ref_logits, ref_tokens = _drive_one(engine(False), prompts[1])
    assert hit_tokens == ref_tokens and len(hit_logits) == len(ref_logits) > 0
    for h, r in zip(hit_logits, ref_logits):
        np.testing.assert_array_equal(h, r)       # bitwise, not allclose
    again_logits, again_tokens = _drive_one(warm, prompts[0])
    ref2_logits, ref2_tokens = _drive_one(engine(False), prompts[0])
    assert again_tokens == ref2_tokens
    for h, r in zip(again_logits, ref2_logits):
        np.testing.assert_array_equal(h, r)

"""The port's serving engine with the bandwidth levers against the JAX
reference's, fp32 smoke, in lockstep.

A JAX and a torch paged ``PartitionEngine`` on the same weights and the
same ragged request stream (with mid-wave refills, the load of
``tests/test_kv_quant.py``) must keep the same slot occupancy and emit the
same greedy tokens, with every live slot's logits close at every decode
step, for an int8 pool, an fp8 pool, a blockwise-sparse float pool whose
threshold really drops blocks (the reference's own gate at 0.01 drops
none), and int8 + sparse.  The pools are compared after every step, the
garbage rows past each slot's length included and null block 0 excepted
(the inactive slots' duplicate writes land there in either order): float
pools within 2e-4, packed pools within one quantization step with the
scales within 2e-4.
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
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import api as tapi
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving import kv_pool as TKV

LENS = [22, 13, 18, 9]   # ragged wave + backlog that forces refills
BS = 4
TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's quantization budget (tests/test_kv_quant.py)
QTOL = dict(rtol=5e-2, atol=5e-2)
THRESHOLD = 0.1


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


def _pools_close(tp, jp, kind):
    for p in ("k_pages", "v_pages"):
        t = tp[p][:, 1:]
        j = np.asarray(jp[p])[:, 1:]
        if kind == "fp32":
            np.testing.assert_allclose(t.numpy(), j, **TOL)
            continue
        s = p[0] + "_scales"
        ts, js = tp[s][:, 1:], np.asarray(jp[s])[:, 1:]
        np.testing.assert_allclose(ts.numpy(), js, **TOL)
        a = TKV.dequantize_kv(t, ts).numpy()
        b = np.asarray(JKV.dequantize_kv(j, js))
        step = js[..., None, :, None]
        lim = (1.01 * step + 1e-6 if kind == "int8"
               else 0.126 * np.maximum(np.abs(a), np.abs(b))
               + step * 2.0 ** -9)
        assert bool((np.abs(a - b) <= lim).all()), p


def _lockstep(built, **kw):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    qj, qt = JQueue(), TQueue()
    _load(qj)
    _load(qt)
    common = dict(slots=2, max_len=48, block_size=BS, **kw)
    ej = JEngine(jcfg, jm, jp, peak_flops=hw.TPU_PEAK_FLOPS, paged=True,
                 **common)
    et = TEngine(tcfg, tm, tp, peak_flops=hw.TPU_PEAK_FLOPS, **common)
    ej.assign(qj.pop(len(LENS)))
    et.assign(qt.pop(len(LENS)))
    ej.prefill_wave(0.0)
    et.prefill_wave(0.0)
    kind = kw.get("kv_dtype", "fp32")
    tol = TOL if kind == "fp32" else QTOL
    _pools_close(et.pages, ej.pages, kind)
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
                                           ej.last_logits[i], **tol)
        _pools_close(et.pages, ej.pages, kind)
        steps += 1
    assert not et.busy and steps > 0
    assert et.n_refills == ej.n_refills > 0
    assert et.slot_tokens == ej.slot_tokens
    assert et.assign_order == ej.assign_order
    assert et.pool.n_live == 0
    return et


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_packed_pool_engines_match(built, kind):
    et = _lockstep(built, kv_dtype=kind)
    assert et.pages["k_pages"].dtype == {"int8": torch.int8,
                                         "fp8": torch.float8_e4m3fn}[kind]
    assert "k_scales" in et.pages


def test_sparse_engines_match_and_drop_blocks(built):
    before = pa_ops.paged_decode_sparse.dropped_blocks.value
    et = _lockstep(built, sparse_threshold=THRESHOLD)
    assert et.sparse_threshold == THRESHOLD
    assert pa_ops.paged_decode_sparse.dropped_blocks.value > before


def test_int8_plus_sparse_engines_match(built):
    before = pa_ops.paged_decode_quant.dropped_blocks.value
    et = _lockstep(built, kv_dtype="int8", sparse_threshold=THRESHOLD)
    assert et.kv_dtype == "int8" and et.sparse_threshold == THRESHOLD
    assert pa_ops.paged_decode_quant.dropped_blocks.value > before

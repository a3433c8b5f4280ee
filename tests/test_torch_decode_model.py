"""qwen2-7b SMOKE in fp32: the port's quantized, sparse and dense-slab
decode steps against the JAX reference, 8 greedy steps each.

The reference draws the weights and runs the ragged prefill; its pool
(packed or float) and its dense cache cross to the port bit for bit
(``repro_torch.bridge``, fp8 through a uint8 view), so both packages step
from the same state on the same tokens.

* float pool + sparse threshold: logits within 2e-4, identical argmax,
  pools within 2e-4 (garbage rows included, null block 0 excepted: the
  inactive slots' duplicate writes land there in either order), and the
  keep masks drop blocks;
* packed int8/fp8 pools (with and without sparsity): logits within the
  reference's quantization budget 5e-2 and identical argmax; the
  requantized pools within one quantum of each other (a row that differs
  by f32 rounding may round to the neighbouring code) and the scales
  within 2e-4;
* dense slab (``decode_step``): logits and the slab within 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax, to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import api as tapi
from repro_torch.serving import kv_pool as TKV

TOL = dict(rtol=2e-4, atol=2e-4)
QTOL = dict(rtol=5e-2, atol=5e-2)
LENS = [22, 9, 17, 3]
WIDTH, MAX_LEN, BS = 22, 36, 4
THRESHOLD = 0.1
STEPS = 8


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    rng = np.random.default_rng(11)
    toks = np.zeros((len(LENS), WIDTH), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, 256, size=n)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        max_len=MAX_LEN, lens=jnp.asarray(LENS))
    return jcfg, jm, jparams, tcfg, tm, params_from_jax(jparams, "cpu"), \
        jl, jc


def _tables():
    T = MAX_LEN // BS
    n = 1 + len(LENS) * T
    ids = np.random.default_rng(12).permutation(np.arange(1, n))
    return ids.reshape(len(LENS), T).astype(np.int32), n


def _tree_to_torch(d):
    return {k: to_torch(v, "cpu") for k, v in d.items()}


def _quantum_close(tq, ts, jq, js, kind):
    """Packed pools within one quantization step of each other: int8 codes
    one apart, fp8 one e4m3 spacing (1/8 relative, or the subnormal step)."""
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    a = TKV.dequantize_kv(tq, ts).numpy()
    b = np.asarray(JKV.dequantize_kv(jq, js))
    step = np.asarray(js)[..., None, :, None]
    if kind == "int8":
        lim = 1.01 * step + 1e-6
    else:
        lim = 0.126 * np.maximum(np.abs(a), np.abs(b)) + step * 2.0 ** -9
    assert bool((np.abs(a - b) <= lim).all())
    codes_t = tq.contiguous().view(torch.uint8).numpy()
    return float((codes_t != np.asarray(jq).view(np.uint8)).mean())


def _drive(models, kind, threshold):
    jcfg, jm, jp, tcfg, tm, tp, jl, jc = models
    tables, n_blocks = _tables()
    jpc = JKV.write_prefix_pages(
        JKV.init_pages(jcfg, n_blocks, BS, kv_dtype=kind),
        jc["k"], jc["v"], jnp.asarray(tables))
    tpc = _tree_to_torch(jpc)                        # the same start state
    jpc.update(tables=jnp.asarray(tables), lens=jnp.asarray(LENS, jnp.int32))
    tpc.update(tables=torch.from_numpy(tables),
               lens=torch.tensor(LENS, dtype=torch.int32))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    counter = (pa_ops.paged_decode_quant if kind != "fp32"
               else pa_ops.paged_decode_sparse).dropped_blocks
    dropped = counter.value
    tol = TOL if kind == "fp32" else QTOL
    for step in range(STEPS):
        ttok = torch.from_numpy(np.array(jtok))
        jl, jpc = jm.decode_paged(jp, jtok, jpc, sparse_threshold=threshold)
        tl, tpc = tm.decode_paged(tp, ttok, tpc, sparse_threshold=threshold)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"decode step {step}")
        jtok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(
            torch.argmax(tl[:, 0], -1)[:, None].numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpc["lens"].numpy(), np.asarray(jpc["lens"]))
    if threshold:
        assert counter.value > dropped       # the gate really drops blocks
    return jpc, tpc


def test_sparse_float_pool_eight_steps(models):
    jpc, tpc = _drive(models, "fp32", THRESHOLD)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tpc[key][:, 1:].numpy(),
                                   np.asarray(jpc[key])[:, 1:], **TOL)


@pytest.mark.parametrize("threshold", [0.0, THRESHOLD])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_packed_pool_eight_steps(models, kind, threshold):
    jpc, tpc = _drive(models, kind, threshold)
    assert tpc["k_pages"].dtype == {"int8": torch.int8,
                                    "fp8": torch.float8_e4m3fn}[kind]
    for p, s in (("k_pages", "k_scales"), ("v_pages", "v_scales")):
        frac = _quantum_close(tpc[p][:, 1:], tpc[s][:, 1:],
                              jpc[p][:, 1:], jpc[s][:, 1:], kind)
        assert frac < 1e-2                 # codes off by one stay rare


def test_dense_slab_eight_steps(models):
    jcfg, jm, jp, tcfg, tm, tp, jl, jc = models
    tc = _tree_to_torch(jc)
    jcache = dict(jc)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for step in range(STEPS):
        ttok = torch.from_numpy(np.array(jtok))
        jl2, jcache = jm.decode(jp, jtok, jcache)
        tl2, tc = tm.decode(tp, ttok, tc)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL,
                                   err_msg=f"decode step {step}")
        jtok = jnp.argmax(jl2[:, 0], -1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(
            torch.argmax(tl2[:, 0], -1)[:, None].numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jcache["len"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jcache[key]),
                                   **TOL)

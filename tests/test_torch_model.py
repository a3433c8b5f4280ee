"""qwen2-7b SMOKE in fp32: the port's model against the JAX reference.

The reference draws the weights; ``params_from_jax`` carries them over.
Both packages then run a ragged ``prefill(lens=)``, install the prefixes
into a paged pool with ``write_prefix_pages`` and take 8 greedy
``decode_step_paged`` steps: logits within 2e-4, identical argmax, every
step.  Also: ``init_lm`` gives the reference's key / shape / dtype tree,
and ``write_prefix_pages`` raises rather than truncate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.serving import kv_pool as TKV

TOL = dict(rtol=2e-4, atol=2e-4)
LENS = [12, 7, 10, 3]
WIDTH, MAX_LEN, BS = 12, 32, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, device="cpu")
    return jcfg, jm, jparams, tcfg, tm, params_from_jax(jparams, "cpu")


def _tree(p, leaf):
    return {k: _tree(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_matches_reference_tree(dtype):
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype=dtype)
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype=dtype)
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = tapi.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    spec_j = _tree(jp, lambda a: (tuple(a.shape), str(a.dtype)))
    spec_t = _tree(tp, lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")))
    assert spec_t == spec_j
    # same distributions: zero biases, unit norms, ~N(0, 1/d_in) weights
    blk = tp["blocks"]
    assert torch.count_nonzero(blk["attn"]["bq"]) == 0
    assert torch.all(blk["ln1"] == 1) and torch.all(tp["ln_f"] == 1)
    wq = blk["attn"]["wq"].float()
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.1
    assert abs(float(tp["embed"].float().std()) / 0.02 - 1) < 0.1


def test_bf16_crosses_bit_exact():
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 7)).astype(jnp.bfloat16)
    t = params_from_jax({"x": x}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


def _prompts():
    rng = np.random.default_rng(11)
    toks = np.zeros((len(LENS), WIDTH), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, 256, size=n)
    return toks


def _tables():
    """Per-slot chains of MAX_LEN / BS blocks in a shuffled pool."""
    T = MAX_LEN // BS
    ids = np.random.default_rng(12).permutation(np.arange(1, 1 + len(LENS) * T))
    return ids.reshape(len(LENS), T).astype(np.int32), 1 + len(LENS) * T


def test_ragged_prefill_logits_and_cache(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    toks = _prompts()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN,
                        lens=jnp.asarray(LENS))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN, lens=torch.tensor(LENS))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)


def test_eight_paged_decode_steps_match(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    toks = _prompts()
    tables, n_blocks = _tables()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN,
                        lens=jnp.asarray(LENS))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN, lens=torch.tensor(LENS))
    jpc = JKV.write_prefix_pages(JKV.init_pages(jcfg, n_blocks, BS),
                                 jc["k"], jc["v"], jnp.asarray(tables))
    tpc = TKV.write_prefix_pages(
        TKV.init_pages(tcfg, n_blocks, BS, device="cpu"), tc["k"], tc["v"],
        torch.from_numpy(tables))
    jpc.update(tables=jnp.asarray(tables), lens=jnp.asarray(LENS, jnp.int32))
    tpc.update(tables=torch.from_numpy(tables),
               lens=torch.tensor(LENS, dtype=torch.int32))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for step in range(8):
        jl, jpc = jm.decode_paged(jp, jtok, jpc)
        tl, tpc = tm.decode_paged(tp, ttok, tpc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        jtok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl[:, 0], -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpc["lens"].numpy(), np.asarray(jpc["lens"]))
    # the in-place pool equals the reference's returned pool (null block 0
    # excluded: duplicate null-table writes land there in either order)
    np.testing.assert_allclose(tpc["k_pages"][:, 1:].numpy(),
                               np.asarray(jpc["k_pages"])[:, 1:], **TOL)


def test_init_cache_matches_reference(models):
    jcfg, jm, _, tcfg, tm, _ = models
    jc, tc = jm.init_cache(3, 20), tm.init_cache(3, 20)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).replace("torch.", "") == str(jc[key].dtype)
        assert torch.count_nonzero(tc[key]) == 0


def test_write_prefix_pages_raises_on_overflow(models):
    _, _, _, tcfg, _, _ = models
    pages = TKV.init_pages(tcfg, 5, 4, device="cpu")
    L, Hkv, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    k = torch.zeros((L, 1, 9, Hkv, D))          # 9 tokens > 2 blocks x 4
    with pytest.raises(ValueError, match="never"):
        TKV.write_prefix_pages(pages, k, k, torch.tensor([[1, 2]]))
    assert torch.count_nonzero(pages["k_pages"]) == 0     # nothing written

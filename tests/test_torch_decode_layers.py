"""The port's quantized, sparse and dense-slab decode layers against the
JAX package's, fp32 smoke widths.

* ``attention_decode_paged`` with packed int8/fp8 pools, with a
  blockwise-sparse float pool, and with both: the same output as the
  reference (2e-4 on float pools, the packed pools' pages being the same
  bytes on both sides), the packed pool untouched (the row comes back for
  the caller's requantization) and the float pool's new row written in
  place; the keep mask taken from the pool BEFORE the row is persisted.
* ``attention_decode_slice`` (dense slab): output within 2e-4 and the row
  written in place at each slot's own position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.paged_attention import ref as jpa_ref
from repro.models import layers as JL
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax, to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def attn_params(cfgs):
    jcfg, _ = cfgs
    p = JL.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    for name in ("bq", "bk", "bv"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape, np.float32)
                              * 0.1)
    return p, params_from_jax(p, device="cpu")


def _t(x):
    return to_torch(x, "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _pool(tcfg, seed, B=3, bs=4, T=6):
    """A float pool whose (block, head) key tiles carry distinct offsets,
    shuffled tables, ragged positions and one inactive (null) slot."""
    rng = np.random.default_rng(seed)
    Hkv, D = tcfg.n_kv_heads, tcfg.head_dim
    N = 1 + B * T
    kp = (rng.standard_normal((N, bs, Hkv, D), np.float32)
          + 2 * rng.standard_normal((N, 1, Hkv, D), np.float32))
    vp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    ids = rng.permutation(np.arange(1, N)).reshape(B, T).astype(np.int32)
    cur = np.asarray([21, 13, 0][:B], np.int32)
    tables = ids.copy()
    tables[B - 1] = 0                      # the last slot is inactive
    x = rng.standard_normal((B, 1, tcfg.d_model), np.float32)
    return kp, vp, tables, cur, x


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("threshold", [0.0, 0.15])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_attention_decode_paged_quant(cfgs, attn_params, kind, threshold,
                                      window):
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    kp, vp, tables, cur, x = _pool(tcfg, 5)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    vq, vs = JKV.quantize_kv(jnp.asarray(vp), kind)
    tkq, tvq, tks, tvs = _t(kq), _t(vq), _t(ks), _t(vs)
    before = [t.clone() for t in (tkq, tvq, tks, tvs)]
    dropped = pa_ops.paged_decode_quant.dropped_blocks.value
    t_out, (tk, tv) = TL.attention_decode_paged(
        tp, tcfg, _t(x), tkq, tvq, _t(tables), _t(cur), window=window,
        k_scales=tks, v_scales=tvs, sparse_threshold=threshold)
    j_out, (jk, jv) = JL.attention_decode_paged(
        jp, jcfg, x, kq, vq, jnp.asarray(tables), jnp.asarray(cur),
        window=window, k_scales=ks, v_scales=vs, sparse_threshold=threshold)
    _close(t_out[:2], j_out[:2])         # active slots (inactive: ignored)
    _close(tk, jk)
    _close(tv, jv)
    for a, b in zip((tkq, tvq, tks, tvs), before):   # caller requantizes
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.float32
                           else a, b.view(torch.uint8)
                           if b.dtype != torch.float32 else b)
    if threshold:
        assert pa_ops.paged_decode_quant.dropped_blocks.value > dropped


@pytest.mark.parametrize("window", [None, 10])
def test_attention_decode_paged_sparse(cfgs, attn_params, window):
    """Float pool + sparse: the mask comes from the pool as the step found
    it, the row is then persisted in place, the output matches."""
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    kp, vp, tables, cur, x = _pool(tcfg, 6)
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    dropped = pa_ops.paged_decode_sparse.dropped_blocks.value
    t_out, (tk, tv) = TL.attention_decode_paged(
        tp, tcfg, _t(x), tkp, tvp, _t(tables), _t(cur), window=window,
        sparse_threshold=0.15)
    j_out, (jk, jv) = JL.attention_decode_paged(
        jp, jcfg, x, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(cur), window=window, sparse_threshold=0.15)
    _close(t_out[:2], j_out[:2])
    assert pa_ops.paged_decode_sparse.dropped_blocks.value > dropped
    bs = kp.shape[1]
    for b in range(2):
        blk, off = tables[b, cur[b] // bs], cur[b] % bs
        _close(tkp[blk, off], jk[b, 0])
        _close(tvp[blk, off], jv[b, 0])


def test_keep_mask_reads_the_pool_before_the_row(cfgs, attn_params):
    """The reference's mask is ``block_keep_mask`` over the pool as the
    step found it.  With K projections scaled up, the new row moves its
    block's mean key enough that a mask computed after the row's write
    differs: the port's layer must still give the reference's output."""
    jcfg, tcfg = cfgs
    jp = dict(attn_params[0])
    jp["wk"], jp["bk"] = jp["wk"] * 50, jp["bk"] * 50
    tp = params_from_jax(jp, device="cpu")
    kp, vp, tables, cur, x = _pool(tcfg, 7)
    q, k, _ = JL.attention_qkv(jp, jcfg, jnp.asarray(x),
                               jnp.asarray(cur)[:, None])
    bs = kp.shape[1]
    written = kp.copy()
    for b in range(len(cur)):
        written[tables[b, cur[b] // bs], cur[b] % bs] = np.asarray(k[b, 0])
    masks = [jpa_ref.block_keep_mask(q[:, 0], jnp.asarray(pool),
                                     jnp.asarray(tables), jnp.asarray(cur),
                                     threshold=0.15)[:2]
             for pool in (kp, written)]
    assert not np.array_equal(np.asarray(masks[0]), np.asarray(masks[1]))
    t_out, _ = TL.attention_decode_paged(
        tp, tcfg, _t(x), _t(kp.copy()), _t(vp.copy()), _t(tables), _t(cur),
        sparse_threshold=0.15)
    j_out, _ = JL.attention_decode_paged(
        jp, jcfg, x, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(cur), sparse_threshold=0.15)
    _close(t_out[:2], j_out[:2])


@pytest.mark.parametrize("window", [None, 5])
def test_attention_decode_slice_writes_then_attends(cfgs, attn_params,
                                                    window):
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    rng = np.random.default_rng(8)
    B, S = 3, 19
    Hkv, D = tcfg.n_kv_heads, tcfg.head_dim
    kc = rng.standard_normal((B, S, Hkv, D), np.float32)
    vc = rng.standard_normal((B, S, Hkv, D), np.float32)
    cur = np.asarray([0, 7, 18], np.int32)
    x = rng.standard_normal((B, 1, tcfg.d_model), np.float32)
    tkc, tvc = _t(kc.copy()), _t(vc.copy())
    t_out, (tk, tv) = TL.attention_decode_slice(tp, tcfg, _t(x), tkc, tvc,
                                                _t(cur), window=window)
    j_out, (jk, jv) = JL.attention_decode_slice(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(cur), window=window)
    _close(t_out, j_out)
    _close(tk, jk)
    jkc = JL._cache_write(jnp.asarray(kc), jk, jnp.asarray(cur))
    jvc = JL._cache_write(jnp.asarray(vc), jv, jnp.asarray(cur))
    _close(tkc, jkc)
    _close(tvc, jvc)

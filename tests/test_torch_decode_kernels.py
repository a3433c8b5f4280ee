"""The port's plain versions of the decode kernels this slice adds, against
the JAX package's, on the same numpy-made inputs.

* ``paged_decode_attention_quant`` (int8 and fp8 pages) and
  ``paged_decode_attention_sparse`` against the JAX ``ref.py`` and the
  Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs
  them), fp32 at the reference's 2e-4 and bf16 at 3e-2.  The port's quant
  version rounds dequantized rows and softmax weights to q's dtype, as the
  reference's model path does; in fp32 that is the JAX ref's arithmetic.
* ``block_keep_mask`` EXACTLY equal to the reference's (selection is
  discontinuous), with a window and with packed pages + ``k_scales``; the
  inputs are checked to sit away from the threshold and to drop blocks.
* The ``k_row``/``v_row`` and ``keep`` operands the model path adds,
  against the reference's model-path math (the row placed in the gathered
  view, the mask applied as ``head_keep``).
* ``flash_decode``'s plain version against the JAX ref and the Pallas
  kernel with a scalar ``cur_pos``, and against the reference's
  ``layers.decode_attention`` with a (B,) vector.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.flash_decode import ref as jfd_ref
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention import ref as jpa_ref
from repro.models import layers as JL
from repro.serving import kv_pool as JKV
from repro_torch.bridge import to_torch
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _t(x, dtype="float32"):
    """numpy or jax array -> CPU tensor (bit-exact, fp8 included)."""
    return to_torch(x, "cpu", getattr(torch, dtype) if dtype else None)


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), **TOL[dtype])


def _pool(seed, B, T, N, bs, Hkv, D, lens):
    """numpy pool + per-slot block tables covering ``lens`` tokens each.
    Each (block, kv head) of K carries its own offset, so block mean keys
    (and the keep mask's estimated masses) differ from block to block."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((N, bs, Hkv, D), np.float32) \
        + rng.standard_normal((N, 1, Hkv, D), np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        for t in range((n + bs - 1) // bs):
            tables[b, t] = free.pop()
    return kp, vp, tables


SHAPES = [  # B, Hq, Hkv, D, bs, window, lens
    (3, 4, 2, 32, 16, 0, [9, 40, 63]),       # GQA, ragged
    (2, 8, 2, 64, 16, 48, [64, 30]),         # sliding window
    (1, 8, 1, 32, 8, 0, [29]),               # MQA
]


# ---------------------------------------------------------------------------
# quantized pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("B,Hq,Hkv,D,bs,window,lens", SHAPES)
def test_quant_plain_vs_jax_ref_and_pallas(B, Hq, Hkv, D, bs, window, lens,
                                           kind):
    T = 4
    N = 1 + T * B
    kp, vp, tables = _pool(0, B, T, N, bs, Hkv, D, lens)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    vq, vs = JKV.quantize_kv(jnp.asarray(vp), kind)
    q = np.random.default_rng(1).standard_normal((B, Hq, D), np.float32)
    cur = np.asarray([n - 1 for n in lens], np.int32)
    out = pa_ref.paged_decode_attention_quant(
        _t(q), _t(kq, None), _t(vq, None), _t(ks), _t(vs),
        _t(tables, None), _t(cur, None), window=window)
    jref = jpa_ref.paged_decode_attention_quant(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tables),
        jnp.asarray(cur), window=window)
    _close(out, jref, "float32")
    jker = jpa_ops.paged_decode_quant(jnp.asarray(q), kq, vq, ks, vs,
                                      jnp.asarray(tables), jnp.asarray(cur),
                                      window=window, interpret=True)
    _close(out, jker, "float32")
    # and the wrapper routes the CPU tensor to this plain version
    wrapped = pa_ops.paged_decode_quant(
        _t(q), _t(kq, None), _t(vq, None), _t(ks), _t(vs),
        _t(tables, None), _t(cur, None), window=window)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quant_plain_bf16_vs_jax_ref(kind):
    B, Hq, Hkv, D, bs, T = 3, 4, 2, 32, 16, 4
    lens = [9, 40, 63]
    kp, vp, tables = _pool(2, B, T, 1 + T * B, bs, Hkv, D, lens)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    vq, vs = JKV.quantize_kv(jnp.asarray(vp), kind)
    q = np.random.default_rng(3).standard_normal((B, Hq, D), np.float32)
    cur = np.asarray([n - 1 for n in lens], np.int32)
    out = pa_ref.paged_decode_attention_quant(
        _t(q, "bfloat16"), _t(kq, None), _t(vq, None), _t(ks), _t(vs),
        _t(tables, None), _t(cur, None))
    assert out.dtype == torch.bfloat16
    jref = jpa_ref.paged_decode_attention_quant(
        jnp.asarray(q).astype(jnp.bfloat16), kq, vq, ks, vs,
        jnp.asarray(tables), jnp.asarray(cur))
    _close(out, jref, "bfloat16")


def _model_path_quant(q, kq, vq, ks, vs, tables, cur, k_row, v_row, window,
                      keep):
    """The reference model path's math (``repro/models/layers.py:383-399``)
    on one layer: dequantized gather rounded to q's dtype, the exact row
    placed at ``cur``, ``keep`` as a per-position head mask."""
    B = q.shape[0]
    T = tables.shape[1]
    _, bs, Hkv, D = kq.shape
    kg = (kq[tables].astype(jnp.float32)
          * ks[tables][:, :, None, :, None]).astype(q.dtype)
    vg = (vq[tables].astype(jnp.float32)
          * vs[tables][:, :, None, :, None]).astype(q.dtype)
    kd = JL._cache_write(kg.reshape(B, T * bs, Hkv, D), k_row[:, None], cur)
    vd = JL._cache_write(vg.reshape(B, T * bs, Hkv, D), v_row[:, None], cur)
    head_keep = None if keep is None else jnp.repeat(keep, bs, axis=-1)
    return JL.decode_attention(q[:, None], kd, vd, cur, window=window,
                               head_keep=head_keep)[:, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quant_rows_and_keep_vs_model_path(kind, sparse, dtype):
    B, Hq, Hkv, D, bs, T, window = 3, 4, 2, 32, 8, 6, 0
    lens = [9, 40, 47]
    kp, vp, tables = _pool(4, B, T, 1 + T * B, bs, Hkv, D, lens)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    vq, vs = JKV.quantize_kv(jnp.asarray(vp), kind)
    rng = np.random.default_rng(5)
    q, k_row, v_row = (rng.standard_normal(s, np.float32) for s in
                       ((B, Hq, D), (B, Hkv, D), (B, Hkv, D)))
    cur = np.asarray([n - 1 for n in lens], np.int32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k_row, v_row))
    keep = None
    if sparse:
        keep = jpa_ref.block_keep_mask(jq, kq, jnp.asarray(tables),
                                       jnp.asarray(cur), threshold=0.2,
                                       k_scales=ks)
        assert int(keep.sum()) < int(jpa_ref.block_keep_mask(
            jq, kq, jnp.asarray(tables), jnp.asarray(cur), threshold=0.0,
            k_scales=ks).sum())                         # blocks are dropped
    want = _model_path_quant(jq, kq, vq, ks, vs, jnp.asarray(tables),
                             jnp.asarray(cur), jk, jv, window, keep)
    got = pa_ops.paged_decode_quant(
        _t(q, dtype), _t(kq, None), _t(vq, None), _t(ks), _t(vs),
        _t(tables, None), _t(cur, None), window=window,
        k_row=_t(k_row, dtype), v_row=_t(v_row, dtype),
        keep=None if keep is None else _t(keep, None))
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# blockwise-sparse float pages and the keep mask
# ---------------------------------------------------------------------------


def _assert_mask_margin(q, kp, tables, cur, threshold, window, k_scales):
    """The estimated block masses sit away from ``threshold`` (so f32
    summation order cannot flip a block) and some valid block is dropped
    (the reference's own gate at 0.01 drops nothing)."""
    dense = jpa_ref.block_keep_mask(q, kp, tables, cur, threshold=0.0,
                                    window=window, k_scales=k_scales)
    hi = jpa_ref.block_keep_mask(q, kp, tables, cur, threshold=threshold
                                 * 1.02, window=window, k_scales=k_scales)
    lo = jpa_ref.block_keep_mask(q, kp, tables, cur, threshold=threshold
                                 * 0.98, window=window, k_scales=k_scales)
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(lo))
    assert int(hi.sum()) < int(dense.sum())


@pytest.mark.parametrize("threshold", [0.1, 0.25])
@pytest.mark.parametrize("B,Hq,Hkv,D,bs,window,lens", SHAPES)
def test_block_keep_mask_exactly_equal(B, Hq, Hkv, D, bs, window, lens,
                                       threshold):
    T = 4
    kp, vp, tables = _pool(6, B, T, 1 + T * B, bs, Hkv, D, lens)
    q = np.random.default_rng(7).standard_normal((B, Hq, D), np.float32) * 2
    cur = np.asarray([n - 1 for n in lens], np.int32)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(tables),
            jnp.asarray(cur))
    _assert_mask_margin(*args, threshold, window, None)
    want = jpa_ref.block_keep_mask(*args, threshold=threshold, window=window)
    got = pa_ref.block_keep_mask(_t(q), _t(kp), _t(tables, None),
                                 _t(cur, None), threshold=threshold,
                                 window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_block_keep_mask_with_scales_exactly_equal(kind):
    B, Hq, Hkv, D, bs, T, window = 3, 4, 2, 32, 8, 6, 24
    lens = [9, 40, 47]
    kp, _, tables = _pool(8, B, T, 1 + T * B, bs, Hkv, D, lens)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    q = np.random.default_rng(9).standard_normal((B, Hq, D), np.float32) * 2
    cur = np.asarray([n - 1 for n in lens], np.int32)
    args = (jnp.asarray(q), kq, jnp.asarray(tables), jnp.asarray(cur))
    _assert_mask_margin(*args, 0.15, window, ks)
    want = jpa_ref.block_keep_mask(*args, threshold=0.15, window=window,
                                   k_scales=ks)
    got = pa_ref.block_keep_mask(_t(q), _t(kq, None), _t(tables, None),
                                 _t(cur, None), threshold=0.15,
                                 window=window, k_scales=_t(ks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,D,bs,window,lens", SHAPES)
def test_sparse_plain_vs_jax_ref_and_pallas(B, Hq, Hkv, D, bs, window, lens,
                                            dtype):
    T = 4
    kp, vp, tables = _pool(10, B, T, 1 + T * B, bs, Hkv, D, lens)
    q = np.random.default_rng(11).standard_normal((B, Hq, D), np.float32) * 2
    cur = np.asarray([n - 1 for n in lens], np.int32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, kp, vp))
    jt, jc = jnp.asarray(tables), jnp.asarray(cur)
    keep = jpa_ref.block_keep_mask(jq, jk, jt, jc, threshold=0.2,
                                   window=window)
    jref = jpa_ref.paged_decode_attention_sparse(jq, jk, jv, jt, jc,
                                                 threshold=0.2, window=window)
    jker = jpa_ops.paged_decode_sparse(jq, jk, jv, jt, jc, threshold=0.2,
                                       window=window, interpret=True)
    tq, tk, tv = _t(q, dtype), _t(kp, dtype), _t(vp, dtype)
    # the plain version with the reference's mask, and the wrapper that
    # computes its own (identical) mask
    out = pa_ref.paged_decode_attention_sparse(
        tq, tk, tv, _t(tables, None), _t(cur, None), window=window,
        keep=_t(keep, None))
    _close(out, jref, dtype)
    _close(out, jker, dtype)
    before = pa_ops.paged_decode_sparse.dropped_blocks.value
    wrapped = pa_ops.paged_decode_sparse(tq, tk, tv, _t(tables, None),
                                         _t(cur, None), threshold=0.2,
                                         window=window)
    _close(wrapped, jref, dtype)
    assert pa_ops.paged_decode_sparse.launches == 0   # CPU: no kernel
    dense = jpa_ref.block_keep_mask(jq, jk, jt, jc, threshold=0.0,
                                    window=window)
    dropped = int(dense.sum()) - int(keep.sum())
    assert pa_ops.paged_decode_sparse.dropped_blocks.value - before \
        == dropped


def test_sparse_threshold_zero_is_dense_plain():
    B, Hq, Hkv, D, bs, T = 2, 8, 2, 64, 16, 4
    lens = [21, 55]
    kp, vp, tables = _pool(12, B, T, 1 + T * B, bs, Hkv, D, lens)
    q = np.random.default_rng(13).standard_normal((B, Hq, D), np.float32)
    cur = np.asarray([n - 1 for n in lens], np.int32)
    args = (_t(q), _t(kp), _t(vp), _t(tables, None), _t(cur, None))
    torch.testing.assert_close(
        pa_ref.paged_decode_attention_sparse(*args, threshold=0.0),
        pa_ref.paged_decode_attention(*args), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash decode (dense slab)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,cur,window", [
    (2, 128, 4, 2, 32, 77, 0),
    (1, 256, 8, 1, 64, 200, 64),        # MQA, sliding window
    (3, 64, 8, 8, 32, 63, 0),           # MHA, full cache
])
def test_flash_decode_plain_scalar_vs_jax(B, S, Hq, Hkv, D, cur, window,
                                          dtype):
    rng = np.random.default_rng(S + cur)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jcur = jnp.asarray(cur, jnp.int32)
    out = fd_ops.flash_decode(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              torch.tensor(cur, dtype=torch.int32),
                              window=window)
    assert fd_ops.flash_decode.launches == 0          # CPU: no kernel
    _close(out, jfd_ref.decode_attention(jq, jk, jv, jcur, window=window),
           dtype)
    _close(out, jfd_ops.flash_decode(jq, jk, jv, jcur, window=window,
                                     bk=64, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 9])
def test_flash_decode_plain_vector_vs_model_decode(window, dtype):
    """Per-slot positions, the form the dense decode step passes, held
    against the reference's ``layers.decode_attention``; S is ragged."""
    B, S, Hq, Hkv, D = 4, 37, 4, 2, 16
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    cur = np.asarray([0, 5, 36, 20], np.int32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = JL.decode_attention(jq[:, None], jk, jv, jnp.asarray(cur),
                               window=window or None)[:, 0]
    out = fd_ref.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  _t(cur, None), window=window)
    _close(out, want, dtype)


def test_jax_ref_and_pallas_agree_on_the_scalar_form():
    """The JAX flash-decode oracle and kernel take a scalar only; the
    port's vector form with equal entries equals its scalar form."""
    B, S, Hq, Hkv, D = 2, 64, 4, 2, 32
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal(s, np.float32) for s in
               ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    scalar = fd_ref.decode_attention(_t(q), _t(k), _t(v),
                                     torch.tensor(40, dtype=torch.int32))
    vector = fd_ref.decode_attention(_t(q), _t(k), _t(v),
                                     torch.full((B,), 40, dtype=torch.int32))
    torch.testing.assert_close(scalar, vector, rtol=0, atol=0)
    want = jax.jit(jfd_ref.decode_attention)(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.asarray(40, jnp.int32))
    _close(scalar, want, "float32")

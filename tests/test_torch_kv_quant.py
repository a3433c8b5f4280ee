"""The port's packed KV layouts against the JAX package, bit for bit.

``quantize_kv``, ``dequantize_kv``, ``init_pages`` and the quantize-on-
append branch of ``write_prefix_pages`` (``repro_torch.serving.kv_pool``)
take the same numpy-made rows as the reference's and must give the same
packed bytes and the same f32 scales: int8 rounds half to even and clips
to +-127 on both sides, fp8 is e4m3 (qmax 448).  A float8_e4m3fn pool
crosses ``repro_torch.bridge`` through a uint8 view, so a JAX fp8 pool can
be held against the port's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving import kv_pool as JKV
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.serving import kv_pool as TKV

KINDS = ["int8", "fp8"]


def _bytes(x) -> np.ndarray:
    """Packed values as raw bytes (int8 and fp8 alike)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _rows(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32) * scale
    x[0, :, 0] = 0.0                       # an all-zero (block, head) tile
    x[1, 2, 1, 3] = 1e3                    # a block dominated by one outlier
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(3, 8, 2, 16), (2, 5, 4, 16, 8)])
def test_quantize_kv_bit_for_bit(kind, shape):
    x = _rows(0, shape)
    jq, js = JKV.quantize_kv(jnp.asarray(x), kind)
    tq, ts = TKV.quantize_kv(torch.from_numpy(x), kind)
    assert str(tq.dtype).endswith({"int8": "int8", "fp8": "e4m3fn"}[kind])
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TKV.dequantize_kv(tq, ts).numpy(),
        np.asarray(JKV.dequantize_kv(jq, js)))


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_from_bf16_rows(kind):
    x = _rows(1, (4, 8, 2, 16))
    jq, js = JKV.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16), kind)
    tq, ts = TKV.quantize_kv(torch.from_numpy(x).to(torch.bfloat16), kind)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq_t = TKV.dequantize_kv(tq, ts, torch.bfloat16).float().numpy()
    deq_j = np.asarray(JKV.dequantize_kv(jq, js, jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(deq_t, deq_j)


def test_int8_rounds_half_to_even_and_bounds_error():
    # scale = 127 / 127 = 1: the halves sit exactly on rounding ties
    x = np.zeros((1, 4, 1, 8), np.float32)
    x[0, 0, 0, :] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0, 3.5]
    tq, ts = TKV.quantize_kv(torch.from_numpy(x), "int8")
    assert float(ts[0, 0]) == 1.0
    assert tq[0, 0, 0].tolist() == [0, 2, 2, 0, -2, -2, 127, 4]
    y = _rows(2, (3, 8, 2, 16))
    q, s = TKV.quantize_kv(torch.from_numpy(y), "int8")
    err = (TKV.dequantize_kv(q, s) - torch.from_numpy(y)).abs()
    assert bool((err <= s[:, None, :, None] / 2 + 1e-6).all())


@pytest.mark.parametrize("kind", ["fp32", "int8", "fp8"])
def test_init_pages_matches_reference(kind):
    jcfg = jget_config("qwen2-7b", smoke=True)
    tcfg = get_config("qwen2-7b", smoke=True)
    jp = JKV.init_pages(jcfg, 7, 8, kv_dtype=kind)
    tp = TKV.init_pages(tcfg, 7, 8, device="cpu", kv_dtype=kind)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape
        assert str(tp[key].dtype).replace("torch.", "") == str(jp[key].dtype)
        assert not bool(tp[key].float().any())


@pytest.mark.parametrize("kind", KINDS)
def test_write_prefix_pages_quantizes_on_append(kind):
    """Ragged prefixes into a packed pool: the same bytes and scales as the
    reference, null-padded entries (and a prefix-cache hit's diverted
    leading blocks) landing in null block 0, which is excepted."""
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    L, B, S, bs = tcfg.n_layers, 3, 13, 4
    Hkv, D = tcfg.n_kv_heads, tcfg.head_dim
    rng = np.random.default_rng(3)
    k = rng.standard_normal((L, B, S, Hkv, D), np.float32)
    v = rng.standard_normal((L, B, S, Hkv, D), np.float32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 7, 8, 9]], np.int32)
    jp = JKV.write_prefix_pages(JKV.init_pages(jcfg, 10, bs, kv_dtype=kind),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(tables))
    tp = TKV.init_pages(tcfg, 10, bs, device="cpu", kv_dtype=kind)
    out = TKV.write_prefix_pages(tp, torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(tables))
    assert out is tp                      # in place
    for key in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(_bytes(tp[key])[:, 1:],
                                      _bytes(jp[key])[:, 1:])
    for key in ("k_scales", "v_scales"):
        np.testing.assert_array_equal(tp[key][:, 1:].numpy(),
                                      np.asarray(jp[key])[:, 1:])
        assert bool((tp[key][:, 1:] > 0).all())


def test_fp8_pool_crosses_the_bridge_bit_exact():
    x = _rows(4, (3, 8, 2, 16))
    jq, js = JKV.quantize_kv(jnp.asarray(x), "fp8")
    t = to_torch(jq, "cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes(t), _bytes(jq))
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(jq.astype(jnp.float32)))

"""Every ported ``models/layers.py`` function against its JAX counterpart.

Inputs and parameters are made with numpy (or drawn by the reference and
carried over with ``repro_torch.bridge.params_from_jax``) and fed to both
packages; fp32, tolerance 2e-4 (the reference's own).  On the CPU the
port's layers run the kernels' plain PyTorch versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def attn_params(cfgs):
    """Reference attention params with random (not zero) qkv biases so the
    bias path is exercised."""
    jcfg, _ = cfgs
    p = JL.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    for name in ("bq", "bk", "bv"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape, np.float32)
                              * 0.1)
    return p, params_from_jax(p, device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32)
    _close(TL.rms_norm(_t(x), _t(w), 1e-5), JL.rms_norm(x, w, 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_split_half(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    pos = np.asarray([[0, 1, 2, 3, 10, 50, 99]] * 2, np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), theta),
           JL.apply_rope(x, jnp.asarray(pos), theta))


def test_attention_qkv_with_bias(cfgs, attn_params):
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, tcfg.d_model), np.float32)
    pos = np.arange(9, dtype=np.int32)[None, :]
    for a, b in zip(TL.attention_qkv(tp, tcfg, _t(x), _t(pos)),
                    JL.attention_qkv(jp, jcfg, x, jnp.asarray(pos))):
        _close(a, b)


@pytest.mark.parametrize("S,window", [(12, None), (40, None), (40, 8)])
def test_attention_block(cfgs, attn_params, S, window):
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model), np.float32)
    t_out, (tk, tv) = TL.attention_block(tp, tcfg, _t(x), window=window)
    j_out, (jk, jv) = JL.attention_block(jp, jcfg, x, window=window)
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_per_slot_positions(window):
    rng = np.random.default_rng(6)
    B, S, Hq, Hkv, D = 3, 20, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D), np.float32)
    kc = rng.standard_normal((B, S, Hkv, D), np.float32)
    vc = rng.standard_normal((B, S, Hkv, D), np.float32)
    cur = np.asarray([0, 7, 19], np.int32)
    _close(TL.decode_attention(_t(q), _t(kc), _t(vc), _t(cur), window=window),
           JL.decode_attention(q, kc, vc, jnp.asarray(cur), window=window))


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode_paged_appends_then_attends(cfgs, attn_params,
                                                     window):
    """Same output as the reference, and the new row lands in the pool
    where the reference's caller persists it (block tables[b, cur // bs],
    offset cur % bs) — before attention, so a kernel reading the pool
    sees it."""
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    rng = np.random.default_rng(7)
    B, bs, T = 3, 4, 4
    Hkv, D = tcfg.n_kv_heads, tcfg.head_dim
    N = 1 + B * T
    kp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    tables = np.zeros((B, T), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :1] = [7]
    cur = np.asarray([9, 2, 0], np.int32)          # slot 2: inactive (null)
    x = rng.standard_normal((B, 1, tcfg.d_model), np.float32)
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    t_out, (tk, tv) = TL.attention_decode_paged(
        tp, tcfg, _t(x), tkp, tvp, _t(tables), _t(cur), window=window)
    j_out, (jk, jv) = JL.attention_decode_paged(
        jp, jcfg, x, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(cur), window=window)
    _close(t_out[:2], j_out[:2])        # active slots (inactive: ignored)
    _close(tk, jk)
    for b in range(2):
        blk, off = tables[b, cur[b] // bs], cur[b] % bs
        _close(tkp[blk, off], jk[b, 0])
        _close(tvp[blk, off], jv[b, 0])


def test_mlp_block_swiglu():
    rng = np.random.default_rng(8)
    p = {k: rng.standard_normal(s, np.float32) / np.sqrt(s[0]) for k, s in
         (("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32)))}
    x = rng.standard_normal((2, 5, 32), np.float32)
    _close(TL.mlp_block(params_from_jax(p, device="cpu"), _t(x), "silu"),
           JL.mlp_block(p, x, "silu"))

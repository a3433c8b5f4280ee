"""The SSM and hybrid families in the port (mamba2-130m, hymba-1.5b), held
against the JAX package at the smoke sizes on the reference's weights.

* Each config module equals the reference's (published and smoke), and
  ``get_config`` serves both archs.
* ``init_lm``'s tree has the reference's keys, shapes and dtypes (the SSM's
  float32 leaves in a bf16 tree; hymba's meta tokens), and the bridge
  carries such a tree bit for bit.
* ``prefill`` (the meta tokens before the text), then 8 greedy steps of
  ``decode_step`` (dense slab) and of ``decode_step_paged`` (hymba's K/V
  in a pool; mamba2 has no pages): logits within 2e-4 in fp32, the same
  greedy tokens every step, the caches' SSM arrays and K/V within 2e-4;
  the SSM arrays updated in place.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax
from repro_torch.configs import PORTED_ARCH_IDS, get_config
from repro_torch.models import api as tapi
from repro_torch.serving import kv_pool as TKV

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["mamba2_130m", "hymba_1p5b"]
B, WIDTH, EXTRA, BS = 3, 11, 16, 8


def _cfgs(arch, dtype="float32"):
    return (jget_config(arch, smoke=True).replace(dtype=dtype),
            get_config(arch, smoke=True).replace(dtype=dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert arch in PORTED_ARCH_IDS
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jget_config(arch, smoke=smoke))
    alias = {"mamba2_130m": "mamba2-130m", "hymba_1p5b": "hymba-1.5b"}[arch]
    assert get_config(alias) == get_config(arch)


def _tree(p, leaf):
    return {k: _tree(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in p.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_tree(arch):
    jcfg = jget_config(arch, smoke=True)
    jp = jax.eval_shape(japi.build(jcfg).init, jax.random.PRNGKey(0))
    tp = tapi.build(get_config(arch, smoke=True), "cpu").init(
        torch.Generator().manual_seed(0))
    assert _tree(tp, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == \
        _tree(jp, lambda a: (tuple(a.shape), str(a.dtype)))
    ssm = tp["blocks"]["ssm"]
    assert {k for k, v in ssm.items() if v.dtype == torch.float32} == \
        {"dt_bias", "A_log", "D"}
    assert ("meta" in tp) == (arch == "hymba_1p5b")
    assert ("attn" in tp["blocks"]) == ("mlp" in tp["blocks"]) == \
        (arch == "hymba_1p5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_mixed_tree_bit_for_bit(arch):
    """bf16 weights and the SSM's float32 leaves cross as they are."""
    jcfg, _ = _cfgs(arch, "bfloat16")
    jp = jax.jit(japi.build(jcfg).init)(jax.random.PRNGKey(3))
    tp = params_from_jax(jp, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, a in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert str(t.dtype)[6:] == str(a.dtype)
        want = np.asarray(a)
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        np.testing.assert_array_equal(
            got, want.view(np.int16) if want.dtype.name == "bfloat16"
            else want)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _prefilled(arch):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg, "cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(jp, "cpu")
    toks = np.random.default_rng(11).integers(1, 256, size=(B, WIDTH)) \
        .astype(np.int32)
    max_len = (jcfg.n_meta_tokens or 0) + WIDTH + EXTRA
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=max_len)
    return jcfg, jm, jp, tm, tp, (jl, jc), (tl, tc), max_len


def _close_cache(tc, jc, where):
    for key in ("k", "v", "ssm_state", "ssm_conv", "k_pages", "v_pages"):
        assert (key in tc) == (key in jc), key
        if key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL, err_msg=f"{key} {where}")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, paged):
    jcfg, jm, jp, tm, tp, (jl, jc), (tl, tc), max_len = _prefilled(arch)
    n_meta = jcfg.n_meta_tokens or 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert int(tc["len"][0]) == n_meta + WIDTH
    _close_cache(tc, jc, "after prefill")
    if paged:
        T = -(-max_len // BS)
        tables = np.random.default_rng(12).permutation(
            np.arange(1, 1 + B * T)).reshape(B, T).astype(np.int32)
        jpc = JKV.init_pages(jcfg, 1 + B * T, BS)
        tpc = TKV.init_pages(jcfg, 1 + B * T, BS, device="cpu")
        assert (jpc == {}) == (tpc == {}) == (arch == "mamba2_130m")
        if "k" in jc:
            jpc = JKV.write_prefix_pages(jpc, jc["k"], jc["v"],
                                         jnp.asarray(tables))
            tpc = TKV.write_prefix_pages(tpc, tc["k"], tc["v"],
                                         torch.from_numpy(tables))
        lens = np.full((B,), n_meta + WIDTH, np.int32)
        for key in ("ssm_state", "ssm_conv"):
            jpc[key], tpc[key] = jc[key], tc[key]
        jpc.update(tables=jnp.asarray(tables), lens=jnp.asarray(lens))
        tpc.update(tables=torch.from_numpy(tables),
                   lens=torch.from_numpy(lens))
        jc, tc = jpc, tpc
    state = tc["ssm_state"]
    jstep = jax.jit(jm.decode_paged if paged else jm.decode)
    tstep = tm.decode_paged if paged else tm.decode
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1)[:, None]
    for step in range(8):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = tstep(tp, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        _close_cache(tc, jc, f"after decode step {step}")
        assert tc["ssm_state"] is state      # updated in place
        jtok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl[:, 0], -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

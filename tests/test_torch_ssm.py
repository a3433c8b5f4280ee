"""The Mamba-2 SSD block of the port (``repro_torch.models.ssm``) against
the JAX package's, on the same weights (``bridge.params_from_jax``) and
seeded numpy inputs.

* ``ssm_block``: output, final state and conv tail within 2e-4 in fp32 at
  chunks 4, 8 and 32 and at a prime length, where the chunk falls to 1;
  from a given initial state too; within 3e-2 in bf16.
* ``ssm_decode``: token by token from a prefilled cache, output, state and
  conv window within 2e-4 (fp32) and 3e-2 (bf16).
* The port's chunked SSD against its own token-by-token decode, as the
  reference's ``tests/test_models.py`` holds its own (state at 2e-3).
* A sequence shorter than the conv tail raises at prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as JSSM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import ssm as TSSM

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(arch="mamba2_130m", **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _params(jcfg, dtype):
    jp = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    return jp, params_from_jax(jp, "cpu")


def _x(cfg, B, S, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _jit(fn, cfg):
    """The reference's ``fn(p, cfg, *args)`` jitted with ``cfg`` bound
    (one compile, not one per primitive)."""
    return jax.jit(lambda p, *args, **kw: fn(p, cfg, *args, **kw))


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **tol,
                               err_msg=what)


@pytest.mark.parametrize("chunk,S,Q", [(4, 64, 4), (8, 64, 8), (32, 64, 32),
                                       (16, 17, 1)],
                         ids=["chunk4", "chunk8", "chunk32", "prime17"])
@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
def test_ssm_block_matches_reference_fp32(arch, chunk, S, Q):
    jcfg, tcfg = _cfgs(arch, ssm_chunk=chunk, dtype="float32")
    assert TSSM.chunk_len(tcfg, S) == Q
    jp, tp = _params(jcfg, "float32")
    jx, tx = _x(jcfg, 2, S, "float32")
    jy, jc = _jit(JSSM.ssm_block, jcfg)(jp, jx)
    ty, tc = TSSM.ssm_block(tp, tcfg, tx)
    tol = TOL["float32"]
    _close(ty, jy, tol, "out")
    _close(tc["state"], jc["state"], tol, "state")
    _close(tc["conv"], jc["conv"], tol, "conv")


def test_ssm_block_from_an_initial_state_matches_reference():
    jcfg, tcfg = _cfgs(ssm_chunk=8, dtype="float32")
    jp, tp = _params(jcfg, "float32")
    jx, tx = _x(jcfg, 2, 24, "float32")
    s0 = np.random.default_rng(5).standard_normal(
        (2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state)).astype(
        np.float32)
    jy, jc = _jit(JSSM.ssm_block, jcfg)(jp, jx,
                                        initial_state=jnp.asarray(s0))
    ty, tc = TSSM.ssm_block(tp, tcfg, tx,
                            initial_state=torch.from_numpy(s0))
    _close(ty, jy, TOL["float32"], "out")
    _close(tc["state"], jc["state"], TOL["float32"], "state")


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
def test_ssm_block_matches_reference_bf16(arch):
    jcfg, tcfg = _cfgs(arch, ssm_chunk=8, dtype="bfloat16")
    jp, tp = _params(jcfg, "bfloat16")
    assert tp["dt_bias"].dtype == tp["A_log"].dtype == tp["D"].dtype == \
        torch.float32 and tp["in_proj"].dtype == torch.bfloat16
    jx, tx = _x(jcfg, 2, 32, "bfloat16")
    jy, jc = _jit(JSSM.ssm_block, jcfg)(jp, jx)
    ty, tc = TSSM.ssm_block(tp, tcfg, tx)
    assert ty.dtype == tc["state"].dtype == tc["conv"].dtype == \
        torch.bfloat16
    tol = TOL["bfloat16"]
    _close(ty, jy, tol, "out")
    _close(tc["state"], jc["state"], tol, "state")
    _close(tc["conv"], jc["conv"], tol, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
def test_ssm_decode_matches_reference_token_by_token(arch, dtype):
    jcfg, tcfg = _cfgs(arch, ssm_chunk=8, dtype=dtype)
    jp, tp = _params(jcfg, dtype)
    jx, tx = _x(jcfg, 3, 16, dtype)
    _, jc = _jit(JSSM.ssm_block, jcfg)(jp, jx[:, :8])
    _, tc = TSSM.ssm_block(tp, tcfg, tx[:, :8])
    tol = TOL[dtype]
    jdecode = _jit(JSSM.ssm_decode, jcfg)
    for t in range(8, 16):
        jy, jc = jdecode(jp, jx[:, t:t + 1], jc)
        ty, tc = TSSM.ssm_decode(tp, tcfg, tx[:, t:t + 1], tc)
        assert ty.shape == (3, 1, jcfg.d_model)
        assert tc["state"].dtype == tc["conv"].dtype == getattr(torch, dtype)
        _close(ty, jy, tol, f"out at {t}")
        _close(tc["state"], jc["state"], tol, f"state at {t}")
        _close(tc["conv"], jc["conv"], tol, f"conv at {t}")


def _sequential(cfg, p, x):
    cache = TSSM.init_ssm_cache(cfg, x.shape[0], x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = TSSM.ssm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_ssd_matches_its_own_sequential_decode(chunk):
    """The reference's ``test_ssd_chunked_matches_sequential`` on the port:
    the chunked SSD and S single-token steps from a zero cache agree
    (output 2e-4, state 2e-3), and so do the conv windows (exactly: both
    are the last raw pre-conv rows)."""
    _, cfg = _cfgs(ssm_chunk=chunk, dtype="float32")
    p = TSSM.init_ssm(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu", 1)
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y_chunk, cache = TSSM.ssm_block(p, cfg, x)
    y_seq, cache_s = _sequential(cfg, p, x)
    np.testing.assert_allclose(y_chunk.numpy(), y_seq.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(cache["state"].numpy(),
                               cache_s["state"].numpy(), rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(cache["conv"], cache_s["conv"])


@pytest.mark.parametrize("S", [1, 2])
def test_a_prompt_shorter_than_the_conv_tail_raises(S):
    """The reference keeps a tail of S < ssm_conv - 1 rows and its first
    decode step then fails on the shape; the port refuses at prefill."""
    jcfg, tcfg = _cfgs(dtype="float32")
    _, tp = _params(jcfg, "float32")
    _, tx = _x(jcfg, 1, S, "float32")
    with pytest.raises(ValueError, match=r"ssm_conv - 1 = 3"):
        TSSM.ssm_block(tp, tcfg, tx)
    _, tc = TSSM.ssm_block(tp, tcfg, _x(jcfg, 1, 3, "float32")[1])
    assert tc["conv"].shape == (1, 3, TSSM.ssm_dims(tcfg)[1])

"""The enc-dec family in the port (``models/encdec.py``) and flash
attention's bidirectional mode, held against the JAX package on the same
inputs and weights at the smoke size (whisper-base's SMOKE: 2 + 2 layers,
d 64, 32 frames), with the reference's tolerances: 2e-4 in fp32, 3e-2 in
bf16.

* ``flash_attention(causal=False)``: the plain version against the JAX
  ``ref.attention`` and the Pallas kernel in interpret mode (the reference
  test's MQA shape, a cross shape with Sq != Skv), a ragged Skv against
  the JAX ``naive_attention``, a one-sided window; ``causal=True`` callers
  get what they got before.
* ``layer_norm`` (population variance), the tanh-GELU MLP, ``sinusoids``.
* ``init_encdec``'s tree; ``encode``; ``init_encdec_cache``; prefill and 8
  decode steps; ``forward_encdec``; the port's decode against its own
  teacher forcing (``tests/test_attention_semantics.py``'s check).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import api as japi
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import api as tapi
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = ["float32", "bfloat16"]
STEPS = 8


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


def _close(t_out, j_out, dtype, **kw):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               **(kw or TOL[dtype]))


def _qkv(seed, B, Sq, Skv, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s, np.float32), dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


# ---------------------------------------------------------------------------
# flash attention, bidirectional
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,bq,bk", [
    (2, 128, 128, 4, 1, 32, 64, 64),    # tests/test_kernels.py: MQA bidir.
    (2, 8, 32, 4, 4, 16, 8, 32),        # cross, G = 1: rows over frames
])
def test_bidirectional_plain_vs_pallas(B, Sq, Skv, Hq, Hkv, D, bq, bk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(Sq + Skv, B, Sq, Skv, Hq, Hkv, D,
                                        dtype)
    out = fa_ref.attention(tq, tk, tv, causal=False)
    _close(out, jfa_ops.flash_attention(jq, jk, jv, causal=False, bq=bq,
                                        bk=bk, interpret=True), dtype)
    _close(out, jfa_ref.attention(jq, jk, jv, causal=False), dtype)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(fa_ops.flash_attention(tq, tk, tv, causal=False), out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv,window", [
    (37, 100, 0),       # ragged Skv, not a tile multiple
    (100, 100, 0),
    (23, 100, 0),
    (70, 90, 16),       # a one-sided window: keys past the query stay
])
def test_bidirectional_ragged_vs_naive(Sq, Skv, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(Skv + window, 2, Sq, Skv, 4, 2, 16,
                                        dtype)
    out = fa_ref.attention(tq, tk, tv, causal=False, window=window)
    _close(out, JL.naive_attention(jq, jk, jv, causal=False,
                                   window=window or None), dtype)
    _close(out, jfa_ref.attention(jq, jk, jv, causal=False, window=window),
           dtype)


@pytest.mark.parametrize("window", [0, 8])
def test_causal_callers_are_unchanged(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 2, 40, 40, 4, 2, 16, "float32")
    default = fa_ref.attention(tq, tk, tv, window=window)
    assert torch.equal(default, fa_ref.attention(tq, tk, tv, causal=True,
                                                 window=window))
    assert torch.equal(default, fa_ops.flash_attention(tq, tk, tv,
                                                       window=window))
    _close(default, jfa_ref.attention(jq, jk, jv, causal=True,
                                      window=window), "float32")
    bidir = fa_ref.attention(tq, tk, tv, causal=False, window=window)
    assert not torch.allclose(bidir, default)
    # the last query sees every key either way
    assert torch.equal(bidir[:, -1], default[:, -1]) or window


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3 + 2
    w = rng.standard_normal((64,), np.float32)
    b = rng.standard_normal((64,), np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    out = L.layer_norm(tx, tw, tb, 1e-5)
    assert out.dtype == tx.dtype
    _close(out, JL.layer_norm(jx, jw, jb, 1e-5), dtype)
    # the population variance: torch's own layer_norm agrees, an unbiased
    # variance would not at 64 features
    if dtype == "float32":
        _close(out, F.layer_norm(tx, (64,), tw, tb, 1e-5), dtype)
        unbiased = (tx - tx.mean(-1, keepdim=True)) * torch.rsqrt(
            tx.var(-1, keepdim=True) + 1e-5) * tw + tb
        assert not torch.allclose(out, unbiased, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64), np.float32)
    w1 = rng.standard_normal((64, 128), np.float32) / 8
    w2 = rng.standard_normal((128, 64), np.float32) / 11
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, dtype) for a in (x, w1, w2))
    out = L.mlp_block({"w1": t1, "w2": t2}, tx, "gelu")
    _close(out, JL.mlp_block({"w1": j1, "w2": j2}, jx, "gelu"), dtype)
    if dtype == "float32":   # the tanh approximation, not the exact erf
        erf = F.gelu(tx @ t1) @ t2
        assert not torch.allclose(out, erf, rtol=1e-6, atol=1e-6)
    init = L.init_mlp(torch.Generator().manual_seed(0), 64, 128, "gelu",
                      torch.float32, "cpu", 3)
    assert {k: tuple(t.shape) for k, t in init.items()} == \
        {"w1": (3, 64, 128), "w2": (3, 128, 64)}


def test_sinusoids_are_the_reference_table():
    for length, ch in ((32, 64), (1500, 512)):
        got = ED.sinusoids(length, ch)
        assert got.dtype == np.float32
        assert np.array_equal(got, JED.sinusoids(length, ch))


# ---------------------------------------------------------------------------
# the model, on the reference's weights
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _built(dtype):
    jcfg = jget_config("whisper-base", smoke=True).replace(dtype=dtype)
    tcfg = get_config("whisper-base", smoke=True).replace(dtype=dtype)
    jm = japi.build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # the reference's phases jitted, as its engine and serve CLI run them
    jm = dataclasses.replace(
        jm, decode=jax.jit(jm.decode), forward=jax.jit(jm.forward),
        prefill=jax.jit(jm.prefill, static_argnames=("max_len",)))
    tm = tapi.build(tcfg, "cpu")
    return (jcfg, jm, jp), (tcfg, tm, params_from_jax(jp, "cpu"))


def _batch(cfg, B=2, S=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.enc_seq, cfg.d_model), np.float32),
            rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))


def _tree(p, leaf):
    return {k: _tree(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in p.items()}


def test_config_and_init_tree_match_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("whisper-base", smoke=smoke)) \
            == dataclasses.asdict(jget_config("whisper-base", smoke=smoke))
    jcfg = jget_config("whisper-base", smoke=True)
    jp = jax.eval_shape(japi.build(jcfg).init, jax.random.PRNGKey(0))
    tm = tapi.build(get_config("whisper-base", smoke=True), "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    assert _tree(tp, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == \
        _tree(jp, lambda a: (tuple(a.shape), str(a.dtype)))
    assert tp["pos_dec"].shape[0] == jcfg.max_seq
    assert tm.decode_paged is None and tm.init_cache(2, 16) is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    (jcfg, _, jp), (tcfg, _, tp) = _built(dtype)
    frames, _ = _batch(tcfg)
    jf, tf = _pair(frames, dtype)
    _close(ED.encode(tp, tcfg, tf),
           jax.jit(JED.encode, static_argnums=1)(jp, jcfg, jf), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_cache_and_decode_steps_match_reference(dtype):
    """``api.prefill`` (the encoder and each layer's cross K/V) and 8 decode
    steps on the same tokens, the caches compared after the prefill and
    after the last step."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _built(dtype)
    frames, tokens = _batch(tcfg)
    max_len = STEPS + 4
    jf, tf = _pair(frames, "float32")
    none, jc = jm.prefill(jp, {"enc_embeds": jf}, max_len=max_len)
    tnone, tc = tm.prefill(tp, tm.prefill_batch(tf), max_len=max_len)
    assert none is None and tnone is None
    assert set(tc) == set(jc) | {"xpos"}
    assert tc["xpos"].dtype == torch.int32 and int(tc["xpos"]) == \
        tcfg.enc_seq - 1 and tc["len"].shape == ()
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key], dtype)
    for t in range(STEPS):
        tok = tokens[:, t:t + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc)
        assert tuple(tl.shape) == (2, 1, tcfg.vocab) and \
            tl.dtype == torch.float32
        _close(tl, jl, dtype)
    assert int(tc["len"]) == int(jc["len"]) == STEPS
    for key in ("k", "v"):
        _close(tc[key], jc[key], dtype)


def test_decode_at_a_vector_position_equals_the_scalar():
    """The serving engine's static buffer: a (B,) position of one value
    gives the scalar's step bit for bit."""
    _, (tcfg, tm, tp) = _built("float32")
    frames, tokens = _batch(tcfg)
    outs = []
    for vector in (False, True):
        _, c = tm.prefill(tp, {"enc_embeds": torch.from_numpy(frames)},
                          max_len=STEPS)
        for t in range(3):
            if vector:
                c = dict(c, len=torch.full((2,), t, dtype=torch.int32))
            lg, c = tm.decode(tp, torch.from_numpy(tokens[:, t:t + 1]), c)
        outs.append((lg, c["k"].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    """The teacher-forced oracle: causal self attention at Sq = Skv = 8 and
    bidirectional cross attention at Sq = 8, Skv = 32."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _built(dtype)
    frames, tokens = _batch(tcfg, seed=3)
    jl, _ = jm.forward(jp, {"enc_embeds": jnp.asarray(frames),
                            "tokens": jnp.asarray(tokens)})
    tl, aux = ED.forward_encdec(tp, tcfg, {
        "enc_embeds": torch.from_numpy(frames),
        "tokens": torch.from_numpy(tokens)})
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    _close(tl, jl, dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.08)])
def test_decode_matches_teacher_forcing(dtype, tol):
    """The port's own decode against its own ``forward_encdec`` (the
    reference's ``test_whisper_decode_matches_teacher_forcing``, whose
    tolerance, 0.08, is for bf16), on weights the port draws itself."""
    cfg = get_config("whisper-base", smoke=True).replace(dtype=dtype)
    m = tapi.build(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    frames, tokens = _batch(cfg, seed=4)
    batch = {"enc_embeds": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)}
    logits_tf, _ = ED.forward_encdec(params, cfg, batch)
    _, cache = m.prefill(params, batch, max_len=STEPS + 4)
    outs = []
    for t in range(STEPS):
        lg, cache = m.decode(params, batch["tokens"][:, t:t + 1], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               logits_tf.numpy(), rtol=tol, atol=tol)

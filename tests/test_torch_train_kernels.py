"""The training path's kernel Functions, held against JAX's gradients.

On a CPU tensor the port's ``MatMul`` and ``FlashAttention`` autograd
Functions run their kernels' plain versions (the forward, the log-sum-exp
and the backward products), so these tests hold the Functions' structure
and arithmetic on the same inputs against ``jax.vjp`` of the reference's
``@`` and of its XLA chunked ``layers.flash_attention`` (what the
reference's training step differentiates): causal, a one-sided window,
bidirectional and cross attention with Sq != Skv, in fp32 at 2e-4 and bf16
at 3e-2, each against the RMS of the JAX output:
|port - jax| <= tol * (rms(jax) + |jax|).  The plain log-sum-exp is held
against a float64 one, and no-grad calls keep the serving path (no
Function, no log-sum-exp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import ops as mm_ops

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def close(got, want, tol, what=""):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    lim = tol * (rms + np.abs(want))
    assert np.isfinite(got).all(), what
    assert (err <= lim).all(), (
        f"{what}: max err {err.max():.3g}, worst {(err / lim).max():.3g} x "
        f"the limit (rms {rms:.3g})")


def pair(x, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


def leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(16, 64, 48), (37, 72, 8), (1, 128, 130)])
def test_matmul_function_gradients(dtype, M, K, N):
    rng = np.random.default_rng(M * 7 + K)
    (ja, ta), (jb, tb), (jg, tg) = (
        pair(rng.standard_normal(s, np.float32), dtype)
        for s in ((M, K), (K, N), (M, N)))
    out, vjp = jax.vjp(lambda a, b: a @ b, ja, jb)
    jda, jdb = vjp(jg)
    a, b = leaves(ta, tb)
    c = mm_ops.matmul(a, b)
    assert type(c.grad_fn).__name__ == "MatMulBackward"
    assert c.dtype == ta.dtype
    da, db = torch.autograd.grad(c, (a, b), tg)
    tol = TOL[dtype]
    close(c.detach(), out, tol, "C")
    close(da, jda, tol, "dA")
    close(db, jdb, tol, "dB")
    assert da.dtype == db.dtype == ta.dtype


def test_matmul_one_operand_needs_grad():
    """Only the operand that requires grad gets a product (the frozen one
    gets None), and the CPU path counts no launch."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((5, 6), np.float32))
    b = torch.from_numpy(rng.standard_normal((6, 4), np.float32))
    before = mm_ops.matmul.launches
    (bl,) = leaves(b)
    c = mm_ops.matmul(a, bl)
    (db,) = torch.autograd.grad(c.sum(), (bl,))
    torch.testing.assert_close(db, a.t() @ torch.ones(5, 4))
    assert mm_ops.matmul.launches == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, causal, window)
FA_CASES = {
    "causal": (2, 24, 24, 4, 2, 16, True, 0),
    "window": (1, 40, 40, 6, 2, 16, True, 9),
    "bidirectional": (2, 20, 20, 4, 4, 8, False, 0),
    "cross": (2, 12, 30, 4, 1, 16, False, 0),
    "causal_ragged": (1, 33, 33, 8, 1, 32, True, 0),
}


def _qkv_grad(seed, B, Sq, Skv, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    return [pair(rng.standard_normal(s, np.float32), dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_function_gradients(dtype, case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = FA_CASES[case]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _qkv_grad(
        sorted(FA_CASES).index(case), B, Sq, Skv, Hq, Hkv, D, dtype)

    def f(q, k, v):
        return JL.flash_attention(q, k, v, causal=causal,
                                  window=window or None, q_chunk=8,
                                  kv_chunk=8)

    out, vjp = jax.vjp(f, jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    q, k, v = leaves(tq, tk, tv)
    o = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), tdo)
    tol = TOL[dtype]
    close(o.detach(), out, tol, "O")
    for name, got, want in (("dQ", dq, jdq), ("dK", dk, jdk),
                            ("dV", dv, jdv)):
        close(got, want, tol, name)
        assert got.dtype == tq.dtype


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_plain_lse_against_float64(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = FA_CASES[case]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, Hq, D))
    k = rng.standard_normal((B, Skv, Hkv, D))
    G = Hq // Hkv
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, D), k) \
        / np.sqrt(D)
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= i >= j
    if window:
        ok &= i - j < window
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1)))    # (B, Hkv, G, Sq)
    want = want.transpose(0, 3, 1, 2).reshape(B, Sq, Hq)
    tq, tk = (torch.from_numpy(x.astype(np.float32)) for x in (q, k))
    o, lse = fa_ops.flash_attention_lse(tq, tk, tk, causal=causal,
                                        window=window)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, Sq, Hq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o, fa_ref.attention(tq, tk, tk, causal=causal,
                                                   window=window))


def test_no_grad_keeps_the_serving_path():
    """Under no_grad (serving) or without an input that requires grad the
    wrapper returns the plain attention itself, with no autograd node."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 8), np.float32))
    want = fa_ref.attention(q, k, k)
    out = fa_ops.flash_attention(q, k, k)
    assert out.grad_fn is None
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    (ql,) = leaves(q)
    with torch.no_grad():
        out = fa_ops.flash_attention(ql, k, k)
    assert out.grad_fn is None
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention_backward.launches)
    o = fa_ops.flash_attention(ql, k, k)
    torch.autograd.grad(o.sum(), (ql,))
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_backward.launches) == before


def test_backward_rejects_before_build():
    """The CUDA backward checks shapes before it loads anything."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q = torch.zeros((1, 4, 2, 12), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 12), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="D % 8"):
        fa.flash_attention_bwd_cuda(q, k, k, lse, q)
    q32, k32 = q.float(), k.float()
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q32, k32, k32, lse[:, :3], q32)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q32, k32, k32, lse, q32)

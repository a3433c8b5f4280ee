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



def test_backward_launches_in_order_with_declared_arguments(monkeypatch):
    """The backward's three launches run in the order Delta, dK / dV, dQ,
    each with as many arguments as its C entry point declares, the Delta
    scratch written by the first and read by the other two; with ``lib`` a
    given library (an A/B's other build) takes the calls."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    monkeypatch.setattr(_build, "check_inputs", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    (dq, dk, dv), launches = fa.flash_attention_bwd_launches(
        q, k, k, torch.zeros((1, 8, 4)), q, window=3, lib=Lib())
    assert list(launches) == list(fa.BWD_KERNELS) and not calls
    for run in launches.values():
        run()
    assert [n for n, _ in calls] == list(fa.BWD_SIGNATURES)
    for name, args in calls:
        assert len(args) == len(fa.BWD_SIGNATURES[name])
        assert args[-10:-1] == (1, 8, 8, 4, 2, 16, 3, 1, 1)
    delta = calls[0][1][5]
    assert calls[1][1][5] == calls[2][1][5] == delta
    assert calls[1][1][6:8] == (dk.data_ptr(), dv.data_ptr())
    assert calls[2][1][6] == dq.data_ptr()

# ---------------------------------------------------------------------------
# the bf16 tensor-core backward's rounding points
# ---------------------------------------------------------------------------


def _hi_lo(x):
    """x as the kernels feed it to a product: hi = x rounded to bf16 plus lo
    = the rest rounded to bf16 (two A fragments, one f32 sum)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _one_bf16(x):
    return x.bfloat16().float()


def _ordered_sum(parts):
    """f32 sum of ``parts`` (a sequence of tensors), added one by one in
    order: an accumulator's walk."""
    acc = torch.zeros_like(parts[0])
    for x in parts:
        acc = acc + x
    return acc


def _emulated_bf16_backward(q, k, v, do, lse, *, causal=True, delta=None,
                            rounding=_hi_lo):
    """The bf16 backward kernels' arithmetic (``flash_attention_bwd.cu``,
    the ``*_wgmma`` kernels) in plain torch on bf16 inputs, in their walks'
    order: S and dP in f32 from the bf16 operands, P = exp(scale S - LSE)
    (masked entries 0), dS = P o (dP - Delta); P taken through ``rounding``
    before dV = P^T dO, dS before dK = scale dS^T Q and dQ = scale dS K.
    The sums run as the kernels' accumulators do, in f32 over 64-key and
    64-row tiles: Delta (or ``delta`` (B, Hkv, G, Sq) given) and dQ of a
    64-row tile over its 64-key tiles in key order (the rows kernels'
    walk); dK and dV of a 64-key tile over the group's (head, 64-row tile)
    pairs, head by head and rows ascending (``fa_bwd_dkdv_wgmma``): one sum
    where D > 64 (a warpgroup sums dV, the other dK), else two, the even
    and the odd pairs', added at the end.  Each output rounded once to
    bf16."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, T = Hq // Hkv, 64
    scale = 1.0 / np.sqrt(D)
    qf, dof = (t.float().reshape(B, Sq, Hkv, G, D) for t in (q, do))
    kf, vf = k.float(), v.float()
    lse = lse.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)   # (B, Hkv, G, Sq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    ok = qi >= kj if causal else torch.ones(Sq, Skv, dtype=torch.bool)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros(()))
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    n_k, n_q = -(-Skv // T), -(-Sq // T)

    def keys_of(r0):        # the key tiles a row tile sees, in key order
        last = min(Skv, r0 + T) if causal else Skv
        return [slice(k0, min(k0 + T, Skv)) for k0 in range(0, last, T)]

    if delta is None:
        delta = torch.zeros(B, Hkv, G, Sq)
        for r0 in range(0, Sq, T):
            rs = slice(r0, min(r0 + T, Sq))
            delta[..., rs] = _ordered_sum(
                [(p[..., rs, ks] * dp[..., rs, ks]).sum(-1)
                 for ks in keys_of(r0)])
    ds = p * (dp - delta[..., None])
    del dp
    p_r, ds_r = rounding(p), rounding(ds)
    del p, ds
    dq = torch.zeros_like(qf)
    for r0 in range(0, Sq, T):
        rs = slice(r0, min(r0 + T, Sq))
        dq[:, rs] = _ordered_sum(
            [torch.einsum("bhgqk,bkhd->bqhgd", ds_r[..., rs, ks], kf[:, ks])
             for ks in keys_of(r0)]) * scale
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for t in range(n_k):
        ks = slice(t * T, min(t * T + T, Skv))
        first = t if causal else 0       # the first row tile seeing the keys
        pairs = [(g, slice(r * T, min(r * T + T, Sq))) for g in range(G)
                 for r in range(first, n_q)]
        for out, w, x in ((dv, p_r, dof), (dk, ds_r, qf)):
            parts = [torch.einsum("bqk,bqd->bkd", w[:, :, g, rs, ks]
                                  .reshape(B * Hkv, -1, ks.stop - ks.start),
                                  x[:, rs, :, g].permute(0, 2, 1, 3)
                                  .reshape(B * Hkv, -1, D))
                     for g, rs in pairs]
            if D > 64:
                acc = _ordered_sum(parts)
            else:
                acc = _ordered_sum(parts[0::2]) + _ordered_sum(parts[1::2])
            out[:, ks] = acc.reshape(B, Hkv, -1, D).permute(0, 2, 1, 3)
    dk *= scale
    return (dq.reshape(B, Sq, Hq, D).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def _rounding_inputs():
    """q (1, 4096, 2, 128) against k / v (1, 4096, 1, 128), causal, bf16:
    4096 rows, where Delta from the bf16 output missed; the log-sum-exp and
    the plain backward in f32 on the same bf16 values."""
    rng = np.random.default_rng(26)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .bfloat16() for s in ((1, 4096, 2, 128), (1, 4096, 1, 128),
                                         (1, 4096, 1, 128),
                                         (1, 4096, 2, 128)))
    o, lse = fa_ref.attention_lse(*(t.float() for t in (q, k, v)))
    want = fa_ref.attention_backward(*(t.float() for t in (q, k, v, do)))
    return (q, k, v, do), o, lse, want


def _worst(got, want):
    """Largest |got - want| / (3e-2 (rms(want) + |want|))."""
    w = want.float()
    rms = float(w.pow(2).mean().sqrt())
    return float(((got.float() - w).abs() / (3e-2 * (rms + w.abs()))).max())


def test_bf16_backward_rounding_points_at_4096_rows():
    """The tensor-core kernels feed P and dS to their products as two bf16
    parts each (hi + lo) and keep Delta = rowsum(P o dP) in f32: emulated in
    plain torch in the kernels' walks' order (64 x 64 tiles, the dK / dV
    split, f32 sums in a fixed order), dQ, dK and dV stay within 3e-2 x
    (rms + |want|) of the f32 plain backward at 4096 causal rows.  Two simpler layouts, emulated the
    same way, do not, and this shape is one where each shows: P and dS
    rounded once to bf16 (an early key's dV takes O(1) weights of the first
    rows, each off by up to 2^-9, against an RMS set by the many small
    ones), and FA2's Delta = rowsum(dO o O) from the bf16 output (ROADMAP,
    parity hazards)."""
    (q, k, v, do), o, lse, want = _rounding_inputs()
    got = _emulated_bf16_backward(q, k, v, do, lse)
    for name, a, b in zip(("dQ", "dK", "dV"), got, want):
        assert a.dtype == torch.bfloat16
        assert torch.isfinite(a.float()).all(), name
        assert _worst(a, b) <= 1, (name, _worst(a, b))
    once = _emulated_bf16_backward(q, k, v, do, lse, rounding=_one_bf16)
    assert max(_worst(a, b) for a, b in zip(once, want)) > 1
    o16 = o.bfloat16().float()
    fa2 = (do.float() * o16).sum(-1)                         # (B, Sq, Hq)
    fa2 = fa2.reshape(1, 4096, 1, 2).permute(0, 2, 3, 1)
    got_fa2 = _emulated_bf16_backward(q, k, v, do, lse, delta=fa2)
    assert max(_worst(a, b) for a, b in zip(got_fa2, want)) > 1

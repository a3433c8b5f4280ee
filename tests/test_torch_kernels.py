"""The port's plain kernel versions against the JAX package's kernels.

Each plain PyTorch version (``repro_torch.kernels.<name>.ref``) is what a
kernel wrapper runs on a CPU tensor and what ``chip_smoke.py`` holds the
CUDA kernel against on the card.  Here it is held against the JAX
reference's ``ref.py`` and against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it), on the same inputs made with numpy.
Shapes the Pallas kernels refuse (Sq / Skv / M / N that are not tile
multiples) are compared with the JAX ``ref.py`` only.  Tolerances are the
reference's own: 2e-4 in fp32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.matmul import ops as jmm_ops
from repro.kernels.matmul import ref as jmm_ref
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention import ref as jpa_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.kernels.paged_attention import ref as pa_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounding is
    round-to-nearest-even on both sides, so the bits agree)."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return j, t


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (64, 128, 64, 64, 128, 64),
    (128, 256, 128, 64, 128, 64),
    (8, 128, 256, 8, 128, 128),       # decode-like skinny M
])
def test_matmul_plain_vs_pallas(M, K, N, bm, bk, bn, dtype):
    rng = np.random.default_rng(M + N)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32) / np.sqrt(K)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    out = mm_ref.matmul(ta, tb)
    assert out.dtype == getattr(torch, dtype) and out.shape == (M, N)
    _close(out, jmm_ops.matmul(ja, jb, bm=bm, bk=bk, bn=bn), dtype)
    _close(out, jmm_ref.matmul(ja, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(37, 100, 70), (4, 96, 40), (1, 33, 513)])
def test_matmul_plain_ragged_vs_ref(M, K, N, dtype):
    rng = np.random.default_rng(M * K)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32) / np.sqrt(K)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    _close(mm_ref.matmul(ta, tb), jmm_ref.matmul(ja, jb), dtype)


# ---------------------------------------------------------------------------
# flash attention (causal + window + GQA)
# ---------------------------------------------------------------------------


def _qkv(rng, B, Sq, Skv, Hq, Hkv, D):
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Skv, Hkv, D), np.float32),
            rng.standard_normal((B, Skv, Hkv, D), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (1, 32, 7, 1, 128, 0),      # G = 7 at qwen2-7b's head width
    (2, 32, 14, 2, 16, 0),      # G = 7, smoke head width
    (1, 64, 7, 1, 16, 24),      # G = 7 under a sliding window
    (2, 32, 4, 2, 16, 8),       # G = 2, window shorter than a tile
])
def test_flash_attention_plain_vs_pallas(B, S, Hq, Hkv, D, window, dtype):
    rng = np.random.default_rng(S + D + window)
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    out = fa_ref.attention(tq, tk, tv, window=window)
    _close(out, jfa_ops.flash_attention(jq, jk, jv, causal=True,
                                        window=window, bq=8, bk=16), dtype)
    _close(out, jfa_ref.attention(jq, jk, jv, causal=True, window=window),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,window", [
    (2, 45, 7, 1, 16, 0),       # Sq = Skv not a tile multiple
    (1, 19, 14, 2, 128, 5),     # odd length, window, D = 128
])
def test_flash_attention_plain_ragged_vs_ref(B, Sq, Hq, Hkv, D, window,
                                             dtype):
    rng = np.random.default_rng(Sq)
    q, k, v = _qkv(rng, B, Sq, Sq, Hq, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    _close(fa_ref.attention(tq, tk, tv, window=window),
           jfa_ref.attention(jq, jk, jv, causal=True, window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,bq,bk", [
    (1, 16, 8, 1, 16, 0, 8, 16),       # G = 8
    (1, 16, 32, 2, 16, 0, 8, 8),       # G = 16, the wrapper's limit
    (1, 9, 7, 1, 16, 0, 9, 9),         # Sq * G = 63: one row short of a tile
    (1, 10, 7, 1, 16, 0, 5, 10),       # Sq * G = 70: six rows into a second
    (1, 65, 7, 1, 16, 0, 13, 13),      # Sq = Skv = 65: one key past a tile
    (1, 32, 7, 1, 80, 0, 8, 16),       # D = 80, zero-padded in the kernel
    (1, 130, 2, 1, 16, 100, 13, 26),   # window 100 over three key tiles
])
def test_flash_attention_plain_tile_edges(B, S, Hq, Hkv, D, window, bq, bk,
                                          dtype):
    """The tensor-core kernel's edges: 64 flattened rows q_pos * G + g and
    64 keys a tile; the Pallas kernel runs with blocks that divide S."""
    rng = np.random.default_rng(S * Hq + D + window)
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    out = fa_ref.attention(tq, tk, tv, window=window)
    _close(out, jfa_ops.flash_attention(jq, jk, jv, causal=True,
                                        window=window, bq=bq, bk=bk), dtype)
    _close(out, jfa_ref.attention(jq, jk, jv, causal=True, window=window),
           dtype)


@pytest.mark.parametrize("dtype,message", [
    (torch.bfloat16, "D % 8"),          # shape check, before any build
    (torch.float32, "CUDA device"),     # f32 takes D = 12; not a CPU tensor
])
def test_flash_attention_cuda_rejects_before_build(dtype, message):
    q = torch.zeros((1, 4, 2, 12), dtype=dtype)
    k = torch.zeros((1, 4, 1, 12), dtype=dtype)
    with pytest.raises(ValueError, match=message):
        fa_kernel.flash_attention_cuda(q, k, k)


# ---------------------------------------------------------------------------
# paged decode (ragged cur_pos, null-padded tables)
# ---------------------------------------------------------------------------


def _pool(rng, lens, T, bs, Hkv, D):
    """Random pool + per-slot tables covering ``lens`` tokens each, the
    rest of every row null-padded (block 0)."""
    B = len(lens)
    N = 1 + B * T
    kp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        for t in range(-(-n // bs)):
            tables[b, t] = free.pop()
    return kp, vp, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D,bs,window", [
    (7, 1, 128, 16, 0),         # G = 7, qwen2-7b head width
    (14, 2, 16, 8, 0),          # G = 7, smoke head width
    (14, 2, 16, 8, 12),         # sliding window
    (4, 2, 128, 16, 20),
])
def test_paged_decode_plain_vs_pallas(Hq, Hkv, D, bs, window, dtype):
    rng = np.random.default_rng(Hq * D + window)
    T = 4
    lens = [1, 3 * bs + 2, bs, 2 * bs + 5]       # ragged, null-padded tails
    kp, vp, tables = _pool(rng, lens, T, bs, Hkv, D)
    q = rng.standard_normal((len(lens), Hq, D), np.float32)
    cur = np.asarray([n - 1 for n in lens], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    out = pa_ref.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(cur),
        window=window)
    _close(out, jpa_ops.paged_decode(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(cur), window=window), dtype)
    _close(out, jpa_ref.paged_decode_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(cur), window=window),
        dtype)


def test_paged_decode_inactive_slot_reads_null_block_finite():
    """An inactive slot (cur_pos 0, all-null table) attends to null block 0
    only: finite, and equal to the reference's output for it."""
    rng = np.random.default_rng(5)
    kp, vp, tables = _pool(rng, [9, 0], 3, 4, 2, 16)
    q = rng.standard_normal((2, 14, 16), np.float32)
    cur = np.asarray([8, 0], np.int32)
    out = pa_ref.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(cur))
    assert torch.isfinite(out).all()
    ref = jpa_ref.paged_decode_attention(q, kp, vp, tables, cur)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])

"""Flash attention's bf16 forward on the warpgroup tensor cores
(``kernels/csrc/flash_attention.cu``: ``fa_wgmma_kernel``), held on the
CPU.  The kernel runs only on a card
(``tests/test_torch_fa_fwd_wgmma_card.py``, ``chip_smoke.py``); what it is
built from is modelled here in numpy, with the boxes, swizzle and
descriptors of ``tests/_torch_wgmma_model.py`` (shared with the backward's
model, ``tests/test_torch_fa_bwd_wgmma.py``):

* Q (two warpgroups of 64 rows, K-major), K (K-major) and V (MN-major: the
  transpose bit) read back through the kernel's descriptors, K and V in
  tiles of 128 keys at D > 64 (BN-row TMA boxes) and 64 at D <= 64;
* the launch itself: each grid index decoded as the kernel decodes it
  (the longest causal walks first), the walk of BN-key tiles from a
  multiple of BN, a warpgroup skipping the tiles none of its rows sees,
  the masks (-1e30 for a masked key, -inf past Skv), the online softmax
  in exp2 form and P rounded once to bf16 before O += P V: unrounded, the
  emulated launch is a float64 attention; rounded, it is within the bf16
  tolerance of it and of the JAX package's Pallas kernel in interpret
  mode; its LSE is ``ref.attention_lse``'s; every output row is written
  exactly once;
* the causal grid's balance over 132 SMs;
* ``fwd_route`` (the serving wave, the training shapes, f32), the C
  source's thresholds, the forced routes' refusals, and the count by
  route.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_wgmma_model import (BOX, H100_SMS, box, dc_of, kmajor,
                                makespan, mnmajor, place, rs, tile, tile_any,
                                tile_full)
from repro.kernels.flash_attention import ops as jfa_ops
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TOL = 3e-2                   # bf16, the reference's tolerance


def to_bf16(x):
    """x rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def bn_of(D):
    """Keys a K / V tile: 128 at D > 64, 64 at D <= 64."""
    return 128 if D > 64 else 64


def kv_tile(t, DC, BN, h, k0, b):
    """A K or V tile as the producer loads it: DC column boxes of BN rows
    (BN lines of 128 bytes each), box c at c BN 128 bytes: a BN-row box is
    BN / 64 boxes of 64 rows stacked (the swizzle repeats every 8 lines)."""
    cb = BN * 128
    img = np.full(DC * cb // 2, np.nan)
    for c in range(DC):
        for w in range(BN // 64):
            place(img, c * cb + w * BOX, box(t, 64 * c, h, k0 + 64 * w, b))
    assert not np.isnan(img).any()
    return img


def emulate_forward(q, k, v, causal, window, round_p=True):
    """``fa_wgmma_kernel`` as launched; returns (out, lse, rows written).
    ``round_p``: P rounded to bf16 before O += P V, as the kernel does."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    DC, BN, scale_log2 = dc_of(D), bn_of(D), LOG2E / math.sqrt(D)
    cb = BN * 128
    n_qt, per = -(-Sq // 128), Hq * B
    out, lse = np.full(q.shape, np.nan), np.full((B, Sq, Hq), np.nan)
    written = np.zeros((B, Sq, Hq), np.int64)
    for x in range(n_qt * per):
        qt = n_qt - 1 - x // per
        hq, b = x % Hq, x // Hq % B
        h, q0 = hq // (Hq // Hkv), qt * 128
        q_last = min(q0 + 128, Sq) - 1
        k_lo = (max(0, q0 - window + 1) if window > 0 else 0) // BN * BN
        k_hi = min(Skv, q_last + 1) if causal else Skv
        n_t = -(-(k_hi - k_lo) // BN) if k_hi > k_lo else 0
        q_img = tile(q, DC, hq, q0, b, halves=2)
        for wg in range(2):
            r0 = q0 + 64 * wg
            rows = np.arange(r0, r0 + 64)
            m, l = np.full(64, NEG), np.zeros(64)
            acc = np.zeros((64, 64 * DC))
            for t in range(n_t):
                k0 = k_lo + BN * t
                if not tile_any(r0, k0, Sq, Skv, window, causal, BN):
                    continue
                k_img, v_img = (kv_tile(t_, DC, BN, h, k0, b)
                                for t_ in (k, v))
                s = sum(kmajor(q_img, wg * DC * BOX + c * BOX + kk * 32)
                        @ kmajor(k_img, c * cb + kk * 32, BN).T
                        for c in range(DC) for kk in range(4)) * scale_log2
                if not tile_full(r0, k0, Sq, Skv, window, causal, BN):
                    qi, kj = rows[:, None], np.arange(k0, k0 + BN)[None]
                    masked = np.zeros((64, BN), bool)
                    if causal:
                        masked |= kj > qi
                    if window > 0:
                        masked |= qi - kj >= window
                    s = np.where(kj >= Skv, -np.inf, np.where(masked, NEG, s))
                mx = np.maximum(m, s.max(axis=1))
                corr = np.exp2(m - mx)
                p = np.exp2(s - mx[:, None])
                l = l * corr + p.sum(axis=1)
                acc = acc * corr[:, None] + rs(to_bf16(p) if round_p else p,
                                              v_img, DC, cb)
                m = mx
            for r in range(64):
                if r0 + r >= Sq:
                    continue
                written[b, r0 + r, hq] += 1
                out[b, r0 + r, hq] = acc[r, :D] / max(l[r], 1e-30)
                lse[b, r0 + r, hq] = m[r] * LN2 + math.log(max(l[r], 1e-30))
    return out, lse, written


def attention64(q, k, v, causal, window):
    """(out, LSE) in float64, row by row, from the softmax's definition."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qi, kj = np.arange(Sq)[:, None], np.arange(Skv)[None]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qi >= kj
    if window > 0:
        ok &= qi - kj < window
    out, lse = np.zeros_like(q), np.zeros((B, Sq, Hq))
    for b in range(B):
        for hq in range(Hq):
            s = np.where(ok, q[b, :, hq] @ k[b, :, hq // G].T / math.sqrt(D),
                         -np.inf)
            mx = s.max(axis=1, keepdims=True)
            e = np.exp(s - mx)
            lse[b, :, hq] = (mx + np.log(e.sum(1, keepdims=True)))[:, 0]
            out[b, :, hq] = e / e.sum(1, keepdims=True) @ v[b, :, hq // G]
    return out, lse


def bf16_inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [to_bf16(rng.standard_normal(s)) for s in
            ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def within_bf16(got, want):
    return bool((np.abs(got - want) <= TOL + TOL * np.abs(want)).all())


# ---------------------------------------------------------------------------
# the descriptors read what TMA wrote
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [16, 64, 72, 128])
def test_descriptors_read_q_k_v(D):
    """Every 16-deep slice of S = Q K^T (a warpgroup's 64 rows of Q and BN
    keys, both K-major, slice (c, kk) at c BOX + 32 kk of Q and c BN 128 +
    32 kk of K) and of O += P V (16 keys of V a slice, 2048 bytes on,
    MN-major over 64 DC columns whose atoms are BN 128 bytes apart) is the
    slice of the operand it multiplies: distinct values, so any misplaced
    byte shows; columns past D read zeros."""
    rng = np.random.default_rng(D)
    S, H, DC, BN = 300, 3, dc_of(D), bn_of(D)
    t = rng.permutation(2 * S * H * D).reshape(2, S, H, D) + 1.0
    b, h, r0 = 1, 2, 70
    pad = np.zeros((128, 64 * DC))                   # rows x padded columns
    pad[:, :D] = t[b, r0:r0 + 128, h]
    q_img = tile(t, DC, h, r0, b, halves=2)
    kv_img = kv_tile(t, DC, BN, h, r0, b)
    for c in range(DC):
        for kk in range(4):
            cols = slice(64 * c + 16 * kk, 64 * c + 16 * kk + 16)
            for wg in range(2):
                np.testing.assert_array_equal(
                    kmajor(q_img, wg * DC * BOX + c * BOX + kk * 32),
                    pad[64 * wg:64 * wg + 64, cols])
            np.testing.assert_array_equal(
                kmajor(kv_img, c * BN * 128 + kk * 32, BN), pad[:BN, cols])
    for kk in range(BN // 16):
        np.testing.assert_array_equal(
            mnmajor(kv_img, kk * 2048, 64 * DC, BN * 128),
            pad[16 * kk:16 * kk + 16].T)


# ---------------------------------------------------------------------------
# the launch, emulated
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, causal, window): every query row sees a key
SHAPES = [
    (2, 65, 100, 4, 2, 16, True, 0),      # ragged tiles, Sq < Skv, G = 2
    (1, 130, 33, 2, 2, 128, False, 0),    # Sq > Skv, bidirectional, G = 1
    (1, 200, 200, 14, 2, 72, True, 16),   # window, G = 7, D off 64
    (1, 33, 130, 8, 1, 64, True, 0),      # G = 8, a key tile no row sees
    (1, 300, 300, 2, 1, 64, True, 70),    # window across tiles, 3 CTAs
    (1, 1, 65, 2, 2, 128, False, 0),      # one query row
    (1, 150, 150, 3, 1, 128, True, 0),    # a warpgroup past Sq
]


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_launch_equals_the_float64_attention(shape):
    """With P unrounded the launch (grid decode, walk, skips, masks, exp2
    online softmax, every operand through its descriptor) is the float64
    attention within 1e-9, its LSE too; with P rounded once to bf16, as
    the kernel does, the output is within the bf16 tolerance and the LSE
    (which sums the unrounded weights) still within 1e-9; every row is
    written exactly once; the LSE is ``ref.attention_lse``'s."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape
    q, k, v = bf16_inputs(sum(shape[:6]), B, Sq, Skv, Hq, Hkv, D)
    want, want_lse = attention64(q, k, v, causal, window)
    exact, exact_lse, seen = emulate_forward(q, k, v, causal, window,
                                             round_p=False)
    assert (seen == 1).all()
    np.testing.assert_allclose(exact, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(exact_lse, want_lse, rtol=1e-9, atol=1e-9)
    got, got_lse, seen = emulate_forward(q, k, v, causal, window)
    assert (seen == 1).all()
    assert within_bf16(got, want)
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-9, atol=1e-9)
    _, ref_lse = fa_ref.attention_lse(
        *(torch.from_numpy(t).float() for t in (q, k, v)), causal=causal,
        window=window)
    np.testing.assert_allclose(ref_lse.numpy(), got_lse, rtol=1e-5,
                               atol=1e-5)


# (B, Sq, Skv, Hq, Hkv, D, causal, window, bq, bk): the Pallas kernel takes
# Sq % bq == Skv % bk == 0
PALLAS = [(1, 128, 128, 4, 2, 64, True, 0, 128, 64),
          (1, 64, 192, 2, 1, 32, False, 0, 64, 64),
          (1, 128, 128, 6, 2, 16, True, 48, 64, 64)]


@pytest.mark.parametrize("shape", PALLAS,
                         ids=["causal G=2", "bidirectional G=2",
                              "window G=3"])
def test_emulated_launch_equals_the_pallas_kernel(shape):
    """The emulated bf16 launch against the JAX package's
    ``flash_attention_pallas`` in interpret mode on the same bf16 inputs
    (it also rounds P to bf16 before P V), within the bf16 tolerance."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, bq, bk = shape
    q, k, v = bf16_inputs(Sq * Hq + D, B, Sq, Skv, Hq, Hkv, D)
    got, _, seen = emulate_forward(q, k, v, causal, window)
    assert (seen == 1).all()
    jq, jk, jv = (jnp.asarray(t, jnp.float32).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = np.asarray(jfa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk,
        interpret=True), np.float32)
    assert within_bf16(to_bf16(got), want)


# ---------------------------------------------------------------------------
# the causal balance of the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,Hq", [("qwen2-7b", 28), ("qwen3-moe", 32),
                                     ("internvl2", 48)])
def test_causal_grid_runs_the_longest_walks_first(name, Hq):
    """At 4096 causal rows (D = 128: tiles of 128 keys) a CTA of query tile
    qt runs 2 qt + 2 (64-row, 128-key) blocks, its warpgroups' visible
    tiles; longest first, one CTA an SM, the grid ends within 2 % of an
    even split over 132 SMs, and shortest first 1.07x later or more."""
    n = 4096 // 128
    jobs = [2 * qt + 2 for qt in range(n - 1, -1, -1) for _ in range(Hq)]
    assert all(sum(tile_any(r0, k0, 4096, 4096, 0, True, 128)
                   for r0 in (128 * qt, 128 * qt + 64)
                   for k0 in range(0, 128 * qt + 128, 128)) == 2 * qt + 2
               for qt in range(n))
    even = sum(jobs) / H100_SMS
    assert makespan(jobs) <= 1.02 * even
    assert makespan(sorted(jobs)) >= 1.07 * even


# ---------------------------------------------------------------------------
# the route and its count
# ---------------------------------------------------------------------------


def _zeros(B, S, H, D, dtype=torch.bfloat16):
    return torch.zeros((B, S, H, D), dtype=dtype)


@pytest.mark.parametrize("q,k,route", [
    (_zeros(4, 32, 28, 128), _zeros(4, 32, 4, 128), "mma"),     # serving wave
    (_zeros(1, 32, 28, 128), _zeros(1, 32, 4, 128), "mma"),     # a refill
    (_zeros(1, 4096, 28, 128), _zeros(1, 4096, 4, 128), "wgmma"),   # train
    (_zeros(1, 4096, 48, 128), _zeros(1, 4096, 8, 128), "wgmma"),
    (_zeros(1, 4096, 8, 64), _zeros(1, 1500, 8, 64), "wgmma"),  # cross
    (_zeros(4, 1500, 8, 64), _zeros(4, 1500, 8, 64), "wgmma"),  # encoder
    (_zeros(4, 288, 48, 128), _zeros(4, 288, 8, 128), "wgmma"),  # internvl2
    (_zeros(4, 160, 25, 64), _zeros(4, 160, 5, 64), "mma"),     # hymba
    (_zeros(1, 256, 2, 72), _zeros(1, 256, 2, 72), "wgmma"),    # threshold
    (_zeros(1, 255, 2, 128), _zeros(1, 255, 2, 128), "mma"),
    (_zeros(1, 768, 2, 64), _zeros(1, 768, 2, 64), "wgmma"),
    (_zeros(1, 767, 2, 16), _zeros(1, 767, 2, 16), "mma"),
    (_zeros(1, 4096, 2, 64, torch.float32),
     _zeros(1, 4096, 2, 64, torch.float32), "cuda_cores"),
], ids=["serving wave", "refill", "qwen2-7b train", "internvl2 train",
        "whisper cross", "whisper encoder", "internvl2 prompt", "hymba wave",
        "D=72 Sq=256", "D=128 Sq=255", "D=64 Sq=768", "D=16 Sq=767",
        "f32"])
def test_fwd_route(q, k, route):
    assert fa.fwd_route(q, k) == route


def test_threshold_is_the_sources():
    """``WGMMA_MIN_SQ`` and ``WGMMA_MIN_SQ_D64`` are the C source's
    ``FA_WGMMA_MIN_SQ`` and ``FA_WGMMA_MIN_SQ_D64``, the rows from which
    ``fa_launch`` takes the wgmma kernel."""
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    for name, want in (("FA_WGMMA_MIN_SQ", fa.WGMMA_MIN_SQ),
                       ("FA_WGMMA_MIN_SQ_D64", fa.WGMMA_MIN_SQ_D64)):
        (n,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert int(n) == want


def test_forced_routes_refuse_before_build():
    """A forced route takes bf16 only, and no name but ``wgmma`` / ``mma``;
    both refusals come before anything is built."""
    q = _zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="route 'wgmma' takes bf16"):
        fa.flash_attention_cuda(q.float(), q.float(), q.float(),
                                route="wgmma")
    with pytest.raises(ValueError, match="no forced route"):
        fa.flash_attention_cuda(q, q, q, route="tma")


def test_wrapper_counts_calls_by_route(monkeypatch):
    """The serving call and the training forward (with LSE) each add one to
    ``launches`` and one to their route's count."""
    monkeypatch.setattr(fa_ops, "_device", lambda q: "cuda")
    monkeypatch.setattr(fa_ops, "flash_attention_cuda",
                        lambda q, k, v, **kw: q)
    w = fa_ops.flash_attention
    assert set(w.routes) == set(fa.FWD_ROUTES)
    before = (w.launches, dict(w.routes))
    wave, long_q = _zeros(4, 32, 4, 16), _zeros(1, 256, 4, 128)
    w(wave, wave, wave)
    fa_ops.flash_attention_lse(long_q, long_q, long_q)
    w(long_q, long_q, long_q)
    w(wave.float(), wave.float(), wave.float())
    assert w.launches == before[0] + 4
    assert w.routes == {"wgmma": before[1]["wgmma"] + 2,
                        "mma": before[1]["mma"] + 1,
                        "cuda_cores": before[1]["cuda_cores"] + 1}

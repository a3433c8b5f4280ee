"""Flash attention's bf16 backward on the warpgroup tensor cores
(``kernels/csrc/flash_attention_bwd.cu``: ``fa_bwd_delta_wgmma``,
``fa_bwd_dkdv_wgmma``, ``fa_bwd_dq_wgmma``), held on the CPU.  The kernels
run only on a card (``tests/test_torch_fa_bwd_wgmma_card.py``,
``chip_smoke.py --only train``); what they are built from is modelled
here in numpy:

* the TMA boxes (64 columns x 1 head x 64 rows x 1 batch of the (D, H, S,
  B) view of a (B, S, H, D) tensor, zeros past S and D) placed by the
  128-byte swizzle, and every shared-memory descriptor the kernels use
  read back through the same swizzle: K-major A and B of S = Q K^T, dP =
  dO V^T and their transposes, and B read MN-major (the transpose bit) from
  the same tiles for dV += P^T dO, dK += dS^T Q and dQ += dS K;
* the three launches themselves: each grid index decoded as the kernels
  decode it, the walks (128-row query tiles over 64-key tiles; 64-key
  tiles over the group's (head, 64-row query tile) pairs), the masks and
  skipped tiles, the two warpgroups' split, every operand read through
  its descriptor: the emulated backward equals a float64 one, and every
  output row is written exactly once;
* the causal balance of the dK / dV grid (longest walks first, one CTA an
  SM) against an even split, beside the layout of 128 keys a CTA;
* the wrapper's route and its count by route.

The model of boxes, swizzle and descriptors is
``tests/_torch_wgmma_model.py``, shared with the forward's
(``tests/test_torch_fa_fwd_wgmma.py``).  The bf16 rounding points in the
walk's order are held in ``tests/test_torch_train_kernels.py``
(``_emulated_bf16_backward``).
"""
import math

import numpy as np
import pytest
import torch

from _torch_wgmma_model import (BOX, H100_SMS, box, dc_of, kmajor, makespan,
                                mnmajor, rs, ss, tile, tile_any, visible)
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref


def emulate_rows(q, k, v, do, lse, delta, causal, window, dq_out):
    """``fa_bwd_delta_wgmma`` (dq_out None: fills ``delta``) or
    ``fa_bwd_dq_wgmma`` (fills ``dq_out``); returns the rows written."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    DC, scale = dc_of(D), 1 / math.sqrt(D)
    n_qt, per = -(-Sq // 128), Hq * B
    written = np.zeros((B, Sq, Hq), np.int64)
    for x in range(n_qt * per):
        qt = n_qt - 1 - x // per
        hq, b = x % Hq, x // Hq % B
        h, q0 = hq // (Hq // Hkv), qt * 128
        q_last = min(q0 + 128, Sq) - 1
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(Skv, q_last + 1) if causal else Skv
        n_t = -(-(k_hi - k_lo) // 64) if k_hi > k_lo else 0
        q_img, do_img = (tile(t, DC, hq, q0, b, halves=2) for t in (q, do))
        for wg in range(2):
            r0 = q0 + 64 * wg
            rows = np.arange(r0, r0 + 64)
            lr = np.where(rows < Sq, lse[b, np.minimum(rows, Sq - 1), hq], 0)
            dl = np.where(rows < Sq, delta[b, np.minimum(rows, Sq - 1), hq],
                          0)
            acc = np.zeros((64, 64 * DC)) if dq_out is not None else \
                np.zeros(64)
            for t in range(n_t):
                k0 = k_lo + 64 * t
                if not tile_any(r0, k0, Sq, Skv, window, causal):
                    continue
                k_img, v_img = (tile(t_, DC, h, k0, b) for t_ in (k, v))
                s = ss(q_img, wg * DC * BOX, k_img, 0, DC)
                dp = ss(do_img, wg * DC * BOX, v_img, 0, DC)
                ok = visible(rows[:, None], np.arange(k0, k0 + 64)[None],
                             Sq, Skv, window, causal)
                p = np.where(ok, np.exp(s * scale - lr[:, None]), 0.0)
                if dq_out is None:
                    acc += (p * dp).sum(axis=1)
                else:
                    acc += rs(p * (dp - dl[:, None]), k_img, DC)
            for r in range(64):
                if r0 + r >= Sq:
                    continue
                written[b, r0 + r, hq] += 1
                if dq_out is None:
                    delta[b, r0 + r, hq] = acc[r]
                else:
                    dq_out[b, r0 + r, hq] = acc[r, :D] * scale
    return written


def emulate_dkdv(q, k, v, do, lse, delta, causal, window, dk, dv):
    """``fa_bwd_dkdv_wgmma``: D > 64 splits each pair's products over the
    warpgroups (one sums dV, the other dK), D <= 64 the pairs (i % 2), whose
    two sums are added at the end; returns the rows written."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, DC, scale = Hq // Hkv, dc_of(D), 1 / math.sqrt(D)
    written = np.zeros((B, Skv, Hkv), np.int64)
    per = Hkv * B
    for x in range(-(-Skv // 64) * per):
        h, b, k0 = x % Hkv, x // Hkv % B, (x // per) * 64
        k_last = min(k0 + 64, Skv) - 1
        q_lo = k0 if causal else 0
        q_hi = min(Sq, k_last + window) if window > 0 else Sq
        n_q = -(-(q_hi - q_lo) // 64) if q_hi > q_lo else 0
        k_img, v_img = (tile(t, DC, h, k0, b) for t in (k, v))
        keys = np.arange(k0, k0 + 64)
        acc_k = [np.zeros((64, 64 * DC)) for _ in range(2)]
        acc_v = [np.zeros((64, 64 * DC)) for _ in range(2)]
        for i in range(G * n_q):
            hq, q0 = h * G + i // n_q, q_lo + (i % n_q) * 64
            rows = np.arange(q0, q0 + 64)
            inside = rows < Sq
            lr = np.where(inside, lse[b, np.minimum(rows, Sq - 1), hq], 0)
            dl = np.where(inside, delta[b, np.minimum(rows, Sq - 1), hq], 0)
            q_img, do_img = (tile(t, DC, hq, q0, b) for t in (q, do))
            st = ss(k_img, 0, q_img, 0, DC)               # S^T, keys x rows
            dpt = ss(v_img, 0, do_img, 0, DC)
            ok = visible(rows[None], keys[:, None], Sq, Skv, window, causal)
            pt = np.where(ok, np.exp(st * scale - lr[None]), 0.0)
            dst = pt * (dpt - dl[None])
            w = 0 if DC == 2 else i % 2
            acc_v[w] += rs(pt, do_img, DC)
            acc_k[w] += rs(dst, q_img, DC)
        for r in range(64):
            if k0 + r >= Skv:
                continue
            written[b, k0 + r, h] += 1
            dk[b, k0 + r, h] = (acc_k[0][r, :D] + acc_k[1][r, :D]) * scale
            dv[b, k0 + r, h] = acc_v[0][r, :D] + acc_v[1][r, :D]
    return written


def backward64(q, k, v, do, causal, window):
    """(dQ, dK, dV, LSE, Delta) in float64, row by row, straight from the
    softmax's definition."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, 1 / math.sqrt(D)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    lse, delta = np.zeros((B, Sq, Hq)), np.zeros((B, Sq, Hq))
    ok = visible(np.arange(Sq)[:, None], np.arange(Skv)[None], Sq, Skv,
                 window, causal)
    for b in range(B):
        for hq in range(Hq):
            h = hq // G
            s = np.where(ok, q[b, :, hq] @ k[b, :, h].T * scale, -np.inf)
            m = s.max(axis=1, keepdims=True)
            lse[b, :, hq] = (m + np.log(np.exp(s - m).sum(1, keepdims=True))
                             )[:, 0]
            p = np.exp(s - lse[b, :, hq][:, None])
            dp = do[b, :, hq] @ v[b, :, h].T
            delta[b, :, hq] = (p * dp).sum(1)
            ds = p * (dp - delta[b, :, hq][:, None])
            dq[b, :, hq] = ds @ k[b, :, h] * scale
            dk[b, :, h] += ds.T @ q[b, :, hq] * scale
            dv[b, :, h] += p.T @ do[b, :, hq]
    return dq, dk, dv, lse, delta


# ---------------------------------------------------------------------------
# the descriptors read what TMA wrote
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_descriptors_read_what_tma_wrote(D):
    """Every 16-deep slice each product reads, through its descriptor, is
    the slice of the operand it multiplies (distinct values: any misplaced
    byte shows): Q / dO as A of S = Q K^T and dP = dO V^T (two warpgroups
    of 64 rows), K / V as B (K-major); K / V as A and Q / dO as B of S^T
    and dP^T; dO, Q and K as B read MN-major for dV, dK and dQ."""
    rng = np.random.default_rng(D)
    S, H, DC = 200, 3, dc_of(D)
    t = rng.permutation(2 * S * H * D).reshape(2, S, H, D) + 1.0
    b, h, r0 = 1, 2, 70
    pad = np.zeros((64 * 2, 64 * DC))                # rows x padded columns
    rows = min(128, S - r0)
    pad[:rows, :D] = t[b, r0:r0 + rows, h]
    two = tile(t, DC, h, r0, b, halves=2)             # the rows kernels' Q
    one = tile(t, DC, h, r0, b)                       # a 64-row tile
    for c in range(DC):
        for kk in range(4):
            cols = slice(64 * c + 16 * kk, 64 * c + 16 * kk + 16)
            for wg in range(2):
                np.testing.assert_array_equal(
                    kmajor(two, wg * DC * BOX + c * BOX + kk * 32),
                    pad[64 * wg:64 * wg + 64, cols])
            np.testing.assert_array_equal(kmajor(one, c * BOX + kk * 32),
                                          pad[:64, cols])
    for kk in range(4):                 # B MN-major: 16 lines x 64 DC
        np.testing.assert_array_equal(mnmajor(one, kk * 2048, 64 * DC),
                                      pad[16 * kk:16 * kk + 16].T)


def test_boxes_fill_zeros_past_the_edges():
    """A box past S or D reads zeros; the batch and head coordinates pick
    their own rows."""
    t = np.arange(2 * 70 * 3 * 72, dtype=float).reshape(2, 70, 3, 72) + 1
    got = box(t, 64, 1, 40, 1)
    assert (got[:30, :8] == t[1, 40:70, 1, 64:72]).all()
    assert (got[30:] == 0).all() and (got[:, 8:] == 0).all()
    assert (box(t, 0, 0, 70, 0) == 0).all()


# ---------------------------------------------------------------------------
# the launches, emulated
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, causal, window): every query row sees a key (a
# row that sees none is 0 in the kernels and uniform in the plain version)
SHAPES = [
    (2, 65, 100, 4, 2, 16, True, 0),      # ragged tiles, Sq < Skv
    (1, 130, 33, 2, 2, 128, False, 0),    # Sq > Skv, bidirectional, G = 1
    (2, 100, 100, 14, 2, 80, True, 16),   # window, G = 7, D off 64
    (1, 33, 130, 8, 1, 64, True, 0),      # G = 8, a key tile no row sees
    (1, 200, 200, 2, 1, 64, True, 70),    # window across tiles
    (1, 1, 65, 2, 2, 128, False, 0),      # one query row
    (1, 150, 150, 3, 1, 128, True, 0),    # three 128-row CTAs' worth
]


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_launches_equal_the_float64_backward(shape):
    """The three kernels as launched (grid decode, walks, skips, masks,
    the warpgroups' split, every operand through its descriptor) give
    Delta, dQ, dK and dV of a float64 backward, each output row written
    exactly once; rows that see no key of a tile skip it."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape
    rng = np.random.default_rng(sum(shape[:6]))
    q, do = (rng.standard_normal((B, Sq, Hq, D)) for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, Hkv, D)) for _ in range(2))
    dq64, dk64, dv64, lse, delta64 = backward64(q, k, v, do, causal, window)
    delta = np.full((B, Sq, Hq), np.nan)
    seen = emulate_rows(q, k, v, do, lse, delta, causal, window, None)
    assert (seen == 1).all()
    np.testing.assert_allclose(delta, delta64, rtol=1e-9, atol=1e-9)
    dq = np.full_like(q, np.nan)
    assert (emulate_rows(q, k, v, do, lse, delta, causal, window, dq)
            == 1).all()
    dk, dv = np.full_like(k, np.nan), np.full_like(v, np.nan)
    assert (emulate_dkdv(q, k, v, do, lse, delta, causal, window, dk, dv)
            == 1).all()
    for got, want in ((dq, dq64), (dk, dk64), (dv, dv64)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_float64_backward_is_the_plain_versions():
    """The float64 reference above is the port's plain backward (autograd
    through ``ref.attention``, f32) within f32's 2e-4."""
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((1, 70, 4, 32)) for _ in range(2))
    k, v = (rng.standard_normal((1, 90, 2, 32)) for _ in range(2))
    want = backward64(q, k, v, do, True, 20)[:3]
    got = fa_ref.attention_backward(*(torch.from_numpy(t).float()
                                      for t in (q, k, v, do)), window=20)
    for a, b in zip(got, want):
        err = np.abs(a.numpy() - b)
        rms = np.sqrt(np.mean(b ** 2))
        assert (err <= 2e-4 * (rms + np.abs(b))).all()


# ---------------------------------------------------------------------------
# the causal balance of the dK / dV grid
# ---------------------------------------------------------------------------


def dkdv_walks(Sq, G, Hkv, keys):
    """Pairs (64-row query tiles of the G heads) each CTA's warpgroups
    process, causal, in launch order (key tile 0, the longest, first), for
    ``keys`` keys a CTA: 64 (the two warpgroups on the same keys, a pair's
    products split between them, one pair at a time) or 128 (a warpgroup
    each, every pair its own: its time that of the first's walk)."""
    n = Sq // keys
    return [G * (Sq // 64 - t * keys // 64) for t in range(n)
            for _ in range(Hkv)]


@pytest.mark.parametrize("name,G,Hkv,wide_ratio", [
    ("qwen2-7b", 7, 4, 1.9), ("qwen3-moe", 8, 4, 1.9),
    ("internvl2", 6, 8, 0.0)])
def test_dkdv_grid_balances_causal_walks(name, G, Hkv, wide_ratio):
    """At 4096 causal rows the dK / dV grid of 64-key CTAs, longest walk
    first, ends within 2 % of an even split of its work over 132 SMs, and
    in the reverse order 1.2x later or more.  With 128 keys a CTA (two
    warpgroups on their own 64 keys each, the CTA's time its walk's) and
    4 kv heads there are 128 CTAs for 132 SMs: the longest walk alone is
    ~2x the even split (internvl2's 8 kv heads make 256, balanced)."""
    jobs = dkdv_walks(4096, G, Hkv, 64)
    even = sum(jobs) / H100_SMS
    assert makespan(jobs) <= 1.02 * even
    assert makespan(sorted(jobs)) >= 1.2 * even
    wide = dkdv_walks(4096, G, Hkv, 128)
    assert makespan(wide) >= wide_ratio * sum(wide) / H100_SMS


# ---------------------------------------------------------------------------
# the route and its count
# ---------------------------------------------------------------------------


def test_route_by_dtype_and_its_count(monkeypatch):
    """bf16 takes ``wgmma``, f32 the CUDA cores; the wrapper adds one to
    its call's route, to ``launches`` and to each of the three kernels."""
    q16 = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    assert fa.bwd_route(q16) == "wgmma"
    assert fa.bwd_route(q16.float()) == "cuda_cores"
    assert set(fa_ops.flash_attention_backward.routes) == set(fa.BWD_ROUTES)
    monkeypatch.setattr(fa_ops, "_device", lambda q: "cuda")
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_cuda",
                        lambda q, k, v, lse, do, **kw: (q, k, v))
    w = fa_ops.flash_attention_backward
    before = (w.launches, dict(w.routes), dict(w.kernels))
    for q in (q16, q16, q16.float()):
        w(q, q, q, None, q)
    assert w.launches == before[0] + 3
    assert w.routes == {"wgmma": before[1]["wgmma"] + 2,
                        "cuda_cores": before[1]["cuda_cores"] + 1}
    assert all(w.kernels[n] == before[2][n] + 3 for n in fa.BWD_KERNELS)

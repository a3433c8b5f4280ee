"""A numpy model of what the conv2d kernel's warpgroup route reads
(``conv_wgmma<T, BN>`` in ``kernels/csrc/conv2d.cu``), held against the
JAX package's ``ref.conv2d`` on the CPU.

The kernel runs only on a card.  What it reads is modelled here:

* TMA's im2col walk: a load starts at one output pixel's window corner
  (w, h) of image n and takes 128 pixels, stepping the corner by the
  stride along a row of the bounding box [0, Wp - kw] x [0, Hp - kh],
  then to the next row and the next image, zeros past the last image;
  each pixel is read at its corner plus the tap (i, j), one 128-byte line
  of channels (64 bf16 or 32 f32).  The walk equals the conv's gather at
  strides 1 and 2, windows 1x1 to 7x7, boxes that cross output rows and
  images, and rows past M.
* the 128-byte swizzle TMA writes and the slices the descriptors read
  back: A K-major (a warpgroup's 64 lines, 32 bytes a k16 slice), B the
  (R, K) weights MN-major in 64-column atoms of a step's depth rows (64
  lines in bf16, 32 in f32, hi then lo).
* the f32 route's register fragments: each thread's rows g, g + 8 and
  depth 2 t4 (+1), 2 t4 + 8 (+1) read from the swizzled f32 tile at the
  kernel's addresses, split into bf16 hi and lo.
* a whole launch: tiles, steps, split-R partials added in split order,
  three bf16 passes in f32, rounded once, against ``ref.conv2d`` at the
  reference's tolerances (2e-4 fp32, 3e-2 bf16).

The card's half of it, which reads boxes back from TMA, is
``tests/test_torch_conv2d_wgmma_card.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_wgmma_model import (LINE, PIXELS, im2col, kmajor, mnmajor,
                                place_lines, walk)
from repro.kernels.conv2d import ref as jconv_ref
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d import plan as P

H100_SMS = 132


def frag_f32(img, warp_row, lane, kk):
    """f32 A, k16 slice kk: the thread's four (row, depth) pairs as the
    kernel reads them (frag_f32 in conv2d.cu), as (rows, cols, values)."""
    gq, t4 = lane >> 2, lane & 3
    rows, cols, vals = [], [], []
    for q in range(4):
        r = gq + 8 * (q & 1)
        byte = 64 * kk + 32 * (q >> 1) + 8 * t4
        addr = (warp_row + r) * LINE + (((byte >> 4) ^ (r & 7)) << 4) + (
            byte & 15)
        for e in range(2):
            rows.append(r)
            cols.append(16 * kk + 8 * (q >> 1) + 2 * t4 + e)
            vals.append(img[(addr + 4 * e) // 4])
    return rows, cols, vals


def f32_slots(kk):
    """(128, 16) f32 slots of the tile that the two warpgroups' fragments
    of slice kk read, by (row, depth): each (row, depth) pair once."""
    out = np.full((PIXELS, 16), -1)
    for wg, warp, lane in itertools.product(range(2), range(4), range(32)):
        base = wg * 64 + warp * 16
        for r, c, slot in zip(*frag_f32(np.arange(PIXELS * 32), base, lane,
                                        kk)):
            assert out[base + r, c - 16 * kk] == -1
            out[base + r, c - 16 * kk] = slot
    return out


F32_SLOTS = [f32_slots(kk) for kk in range(2)]


def a_slices_f32(img, kk):
    """The 128 x 16 f32 A slice kk as the fragments hold it."""
    return img[F32_SLOTS[kk]]


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)


def b_stage(Bmat, n0, r, bn, bk):
    """A stage's B: bn / 64 atoms of 64 columns x bk depth rows of the
    (R, K) bf16 weights from (r, n0), zeros past K, as a bf16-slot
    image."""
    R, K = Bmat.shape
    atoms = []
    for q in range(bn // 64):
        box = np.zeros((bk, 64))
        c0 = n0 + 64 * q
        if c0 < K:
            box[:, :min(64, K - c0)] = Bmat[r:r + bk, c0:min(K, c0 + 64)]
        atoms.append(place_lines(box, 2))
    return np.concatenate(atoms)


def emulate(xp, w, s, p):
    """conv_wgmma's output: per tile and split, per depth step the boxes
    as TMA places them and the products as the descriptors and fragments
    read them, f32 sums (three bf16 passes on f32 inputs), the splits
    added in order, rounded once to the input dtype."""
    is_bf16 = xp.dtype == torch.bfloat16
    xs = xp.float().numpy().astype(np.float64)
    N, Hp, Wp, C = xs.shape
    kh, kw, _, K = w.shape
    M, _, R, Ho, Wo = P.gemm_dims(xp.shape, w.shape, s)
    bk = P.WG_BK[is_bf16]
    W = w.float().numpy().astype(np.float64).reshape(R, K)
    Wh = bf16(W)
    Wl = bf16(W - Wh)                  # the weights' split, once a launch
    esize = 2 if is_bf16 else 4
    out = np.zeros((M, K))
    for m0, n0 in itertools.product(range(0, M, PIXELS), range(0, K, p.bn)):
        total = np.zeros((PIXELS, p.bn), np.float32)
        for lo, hi in p.ranges(R):
            acc = np.zeros((PIXELS, p.bn), np.float32)
            for r in range(lo, hi, bk):
                tap, c = divmod(r, C)
                i, j = divmod(tap, kw)
                a_img = place_lines(im2col(xs, kh, kw, s, m0, c, i, j, bk), esize)
                if is_bf16:
                    b_img = b_stage(W, n0, r, p.bn, bk)
                    for wg, kk in itertools.product(range(2), range(bk // 16)):
                        a = kmajor(a_img, wg * 64 * LINE + kk * 32)
                        b = mnmajor(b_img, kk * 2048, p.bn, lbo=bk * LINE)
                        acc[64 * wg:64 * wg + 64] += (a @ b.T).astype(
                            np.float32)
                else:
                    bh_img = b_stage(Wh, n0, r, p.bn, bk)
                    bl_img = b_stage(Wl, n0, r, p.bn, bk)
                    for kk in range(bk // 16):
                        a = a_slices_f32(a_img, kk)
                        ah = bf16(a)
                        al = bf16(a - ah)
                        bh = mnmajor(bh_img, kk * 2048, p.bn, lbo=bk * LINE)
                        bl = mnmajor(bl_img, kk * 2048, p.bn, lbo=bk * LINE)
                        for ta, tb in ((al, bh), (ah, bl), (ah, bh)):
                            acc += (ta @ tb.T).astype(np.float32)
            total = acc if p.splits == 1 else total + acc
        rows, cols = min(PIXELS, M - m0), min(p.bn, K - n0)
        out[m0:m0 + rows, n0:n0 + cols] = total[:rows, :cols]
    y = torch.from_numpy(out.astype(np.float32)).reshape(
        xp.shape[0], Ho, Wo, K)
    return y.to(xp.dtype)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

WALKS = [  # N, Hp, Wp, k, stride: rows and images crossed within 128
    (2, 9, 9, 1, 1), (2, 9, 11, 3, 1), (1, 13, 13, 5, 2), (2, 12, 12, 7, 1),
    (1, 14, 14, 1, 2), (3, 8, 8, 3, 2), (1, 30, 30, 7, 2), (2, 6, 6, 5, 1),
]


@pytest.mark.parametrize("N,Hp,Wp,k,s", WALKS)
def test_walk_is_the_convs_gather(N, Hp, Wp, k, s):
    Ho, Wo = (Hp - k) // s + 1, (Wp - k) // s + 1
    M = N * Ho * Wo
    for m0 in sorted({0, 1, Wo - 1, Wo, M // 2, M - 1} | set(
            range(0, M, PIXELS))):
        for p, (n, h, w) in enumerate(walk(N, Hp, Wp, k, k, s, m0)):
            m = m0 + p
            if m >= M:
                assert n >= N                       # zeros past M
                continue
            want = (m // (Ho * Wo), (m % (Ho * Wo)) // Wo * s,
                    (m % Wo) * s)
            assert (n, h, w) == want, (m0, p)
            assert h + k <= Hp and w + k <= Wp      # the window inside


def test_walks_cross_rows_and_images():
    """The shapes above put a 128-pixel box across output rows and images
    and past M, at both strides."""
    crossed = set()
    for N, Hp, Wp, k, s in WALKS:
        px = walk(N, Hp, Wp, k, k, s, 0)
        ns = {n for n, _, _ in px}
        crossed |= {("rows", s)} if len({(n, h) for n, h, _ in px}) > 1 \
            else set()
        crossed |= {("images", s)} if len(ns & set(range(N))) > 1 else set()
        crossed |= {("past M", s)} if max(ns) >= N else set()
    assert crossed == {(c, s) for c in ("rows", "images", "past M")
                       for s in (1, 2)}


@pytest.mark.parametrize("is_bf16", (True, False))
def test_boxes_are_the_gathered_rows(is_bf16):
    """A box, by tap and channel line, equals the rows of the conv's A
    matrix (the mma route's gather) at depth [r, r + line)."""
    rng = np.random.default_rng(3)
    N, Hp, Wp, C, k, s = 2, 11, 10, 128, 3, 2
    xp = rng.standard_normal((N, Hp, Wp, C))
    Ho, Wo = (Hp - k) // s + 1, (Wp - k) // s + 1
    M = N * Ho * Wo
    m = np.arange(M)
    n, rem = m // (Ho * Wo), m % (Ho * Wo)
    ho, wo = rem // Wo, rem % Wo
    bk = P.WG_BK[is_bf16]
    for r in range(0, k * k * C, bk):
        tap, c = divmod(r, C)
        i, j = divmod(tap, k)
        A = xp[n, ho * s + i, wo * s + j, c:c + bk]
        for m0 in range(0, M, PIXELS):
            box = im2col(xp, k, k, s, m0, c, i, j, bk)
            rows = min(PIXELS, M - m0)
            np.testing.assert_array_equal(box[:rows], A[m0:m0 + rows])
            assert not box[rows:].any()


# ---------------------------------------------------------------------------
# the swizzle, the descriptors and the f32 fragments
# ---------------------------------------------------------------------------


def test_kmajor_slices_of_a_bf16_box():
    box = np.arange(PIXELS * 64, dtype=np.float64).reshape(PIXELS, 64)
    img = place_lines(box, 2)
    assert not np.isnan(img).any()
    for wg, kk in itertools.product(range(2), range(4)):
        np.testing.assert_array_equal(
            kmajor(img, wg * 64 * LINE + kk * 32),
            box[64 * wg:64 * wg + 64, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("bk,bn", [(64, 128), (64, 256), (32, 128),
                                   (32, 256)])
def test_mnmajor_slices_of_the_weights(bk, bn):
    """B read in place: the (R, K) row-major weights, a stage's bn / 64
    atoms of 64 columns x bk lines, each k16 slice the (bn, 16) transpose
    of depth rows [r + 16 kk, + 16), zeros past K."""
    rng = np.random.default_rng(bk + bn)
    R, K = 4 * bk, bn + 72
    Bmat = rng.standard_normal((R, K))
    for n0, r in itertools.product(range(0, K, bn), range(0, R, bk)):
        img = b_stage(Bmat, n0, r, bn, bk)
        want = np.zeros((bk, bn))
        cols = min(bn, K - n0)
        want[:, :cols] = Bmat[r:r + bk, n0:n0 + cols]
        for kk in range(bk // 16):
            np.testing.assert_array_equal(
                mnmajor(img, kk * 2048, bn, lbo=bk * LINE),
                want[16 * kk:16 * kk + 16].T)


def test_f32_fragments_read_every_element_once():
    """The f32 tile (128 pixels x 32 channels, 128-byte swizzle) read at
    frag_f32's addresses: each warpgroup's fragments hold its 64 rows of
    the k16 slice, every element once, at wgmma's register-A positions;
    and each thread's reads of a slice hit 16-byte chunks of distinct
    banks across the warp's eight rows."""
    box = np.arange(PIXELS * 32, dtype=np.float64).reshape(PIXELS, 32)
    img = place_lines(box, 4)
    for kk in range(2):
        np.testing.assert_array_equal(a_slices_f32(img, kk),
                                      box[:, 16 * kk:16 * kk + 16])
    for kk, q in itertools.product(range(2), range(4)):
        chunks = set()
        for lane in range(32):
            gq, t4 = lane >> 2, lane & 3
            r = gq + 8 * (q & 1)
            byte = 64 * kk + 32 * (q >> 1) + 8 * t4
            chunks.add((r, ((byte >> 4) ^ (r & 7))))
        assert len({c for _, c in chunks}) == 8     # all eight bank groups


def test_f32_split_is_exact_to_two_to_the_minus_16():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(10_000) * 10.0 ** rng.integers(-3, 3, 10_000)
    hi = bf16(v)
    lo = bf16(v - hi)
    assert (np.abs(v - hi - lo) <= 2.0 ** -16 * np.abs(v)).all()


# ---------------------------------------------------------------------------
# a whole launch against the JAX reference
# ---------------------------------------------------------------------------

EMU = [  # N, H, C, K, k, stride, splits: batch 1-2, channels 64-128
    (2, 9, 64, 72, 3, 1, None),      # a box over two images, Cout ragged
    (1, 12, 128, 136, 1, 2, None),   # stride 2, 1x1, two column tiles
    (2, 7, 64, 264, 5, 1, 2),        # 256 columns a CTA, split R
    (1, 13, 128, 64, 7, 2, 3),       # 7x7 at stride 2, three splits
    (2, 6, 64, 128, 3, 2, None),     # rows past M in one tile
]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H,C,K,k,s,splits", EMU)
def test_emulated_launch_vs_jax(N, H, C, K, k, s, splits, dtype):
    rng = np.random.default_rng(N * H + C + K + k)
    x = rng.standard_normal((N, H, H, C), np.float32)
    w = (rng.standard_normal((k, k, C, K), np.float32)
         * np.sqrt(2.0 / (k * k * C))).astype(np.float32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    xp = conv_ops.pad_same(tx, k, k, s)
    M, K_, R, _, _ = P.gemm_dims(xp.shape, tw.shape, s)
    is_bf16 = dtype == "bfloat16"
    assert P.tma_legal(C, K, k, k, s, 0, 0, bf16=is_bf16)
    p = P.plan(M, K_, R, bf16=is_bf16, is_aligned=True, tma=True,
               n_sm=H100_SMS, route="wgmma", splits=splits)
    assert (p.route, p.splits) == ("wgmma", splits or p.splits)
    got = emulate(xp, tw, s, p)
    want = np.asarray(jconv_ref.conv2d(
        jnp.asarray(x).astype(getattr(jnp, dtype)),
        jnp.asarray(w).astype(getattr(jnp, dtype)), stride=s), np.float32)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])

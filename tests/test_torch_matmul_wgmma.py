"""The warpgroup tensor-core route of the port's matmul (``wgmma``,
``kernels/csrc/matmul_wgmma.cu``), held on the CPU.  The kernel runs only
on a card (``tests/test_torch_matmul_wgmma_card.py``, ``chip_smoke.py
--only matmul`` / ``--only train``); what surrounds it is held here:

* the plan's route for every training product of the ten configs as
  ``MatMul`` issues it (forward; dA = dC B^T and dB = A^T dC with the
  transposes as views; a tied table as its ``.T`` view): ``wgmma`` where
  M >= 256 and TMA can read both operands in place, else ``mm_mma``
  (staged where a row is off 16 bytes); serving's decode shapes keep
  ``mm_mma``, and so do a refill's but its products of a column tile an
  SM; the waves of 65-255 rows take the ``stream`` route where K and N are
  wide (``tests/test_torch_matmul_stream.py``), those of 256 rows and more
  move;
* TMA legality (``plan.tma_operand``) of row-major operands, ``.t()``
  views, offset views, sliced lines and odd N / K;
* a numpy model of the kernel's coordinates: the band walk over tiles,
  each stage's TMA boxes placed by the 128-byte swizzle, the shared-memory
  descriptors of each 16-deep K slice read back through the same swizzle,
  the K split.  Every (m, n, k) term is covered exactly once for both
  layouts of each operand, and the emulated launch equals the plain
  product;
* ``MatMul``'s gradients with the views on the CPU against ``jax.grad`` of
  the JAX package's ``ref.matmul`` (2e-4 fp32, 3e-2 bf16), the backward's
  operands being views of the saved tensors (no copy).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import ref as jmm_ref
from repro_torch.configs import get_config
from repro_torch.kernels.matmul import matmul as mm_k
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import plan as P
from repro_torch.profiling.train_counts import (_chunk, _prefix,
                                                block_products,
                                                encdec_products)

H100_SMS = 132
SEQ, LOSS_CHUNK = 4096, 256          # a training microbatch, a loss chunk
ARCHS = ("qwen2-7b", "qwen1.5-4b", "mistral-nemo-12b", "qwen1.5-110b",
         "qwen3-moe-30b-a3b", "dbrx-132b", "internvl2-26b", "mamba2-130m",
         "hymba-1.5b", "whisper-base")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.fixture
def n_sm(monkeypatch):
    """``plan_for`` on meta tensors: the card's SM count stands in."""
    monkeypatch.setattr(mm_k, "_n_sm", lambda index: H100_SMS)


def _meta(shape, stride=None):
    if stride is None:
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return torch.empty_strided(shape, stride, dtype=torch.bfloat16,
                               device="meta")


def _legal(t) -> bool:
    """TMA reads ``t`` in place: contiguous along one dimension, its
    lines a multiple of 16 bytes apart (the base is a fresh allocation)."""
    s0, s1 = t.stride()
    return (s1 == 1 and s0 % 8 == 0) or (s0 == 1 and s1 % 8 == 0)


def _issued(M, K, N, tied=False):
    """(kind, a, b) of the three products ``MatMul`` issues for ``x (M, K)
    @ w (K, N)``: the forward, dA = dC w^T and dB = x^T dC, as meta
    tensors with their real strides; ``tied``: w is a (N, K) table's .T
    view."""
    x, dc = _meta((M, K)), _meta((M, N))
    w = _meta((N, K)).T if tied else _meta((K, N))
    return [("forward", x, w), ("dA", dc, w.t()), ("dB", x.t(), dc)]


def _training_products(arch):
    """(tag, M, K, N, tied) of each distinct training product of ``arch``
    at a 4096-position microbatch: its blocks' (whisper: the encoder's
    1500 rows and the decoder's 4096) and its LM head over a loss chunk
    (whisper's over the whole sequence)."""
    cfg = get_config(arch)
    out = []
    if cfg.family == "encdec":
        enc, dec = encdec_products(cfg)
        out += [("encoder", cfg.enc_seq, K, N, False) for K, N in set(enc)]
        out += [("decoder", SEQ, K, N, False) for K, N in set(dec)]
        out.append(("head", SEQ, cfg.d_model, cfg.vocab, True))
    else:
        out += [("block", SEQ, K, N, False)
                for K, N in set(block_products(cfg))]
        rows = _chunk(SEQ - _prefix(cfg), LOSS_CHUNK)
        out.append(("head", rows, cfg.d_model, cfg.vocab,
                    bool(cfg.tie_embeddings)))
    return sorted(out)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_training_products_take_their_route(arch, n_sm):
    seen = set()
    for tag, M, K, N, tied in _training_products(arch):
        for kind, a, b in _issued(M, K, N, tied):
            p = mm_k.plan_for(a, b)
            legal = _legal(a) and _legal(b)
            want = "wgmma" if legal and a.shape[0] >= P.WG_MIN_M else "mma"
            assert p.route == want, (arch, tag, kind, M, K, N, p)
            if want == "mma":
                # the copies mm_mma reads: staged where a row is off 16 B
                Ma, Ka = a.shape
                assert p.staged == (Ka % 8 != 0, b.shape[1] % 8 != 0)
                assert any(p.staged), (arch, tag, kind)
            else:
                assert p.staged == (False, False) and p.bm == P.WG_BM
                assert p.bn in P.WG_BNS
            seen.add(p.route)
    cfg = get_config(arch)
    misaligned = any(d % 8 for d in (cfg.d_model, cfg.vocab)) or any(
        K % 8 or N % 8 for _, _, K, N, _ in _training_products(arch))
    assert "wgmma" in seen and (("mma" in seen) == misaligned)


def test_qwen2_7b_training_products_all_take_wgmma(n_sm):
    """qwen2-7b's eight products (q, k, v, o, w1, w3, w2, the head) x
    forward / dA / dB, the backward's operands as views: all on wgmma,
    with the plan's widths and splits."""
    cfg = get_config("qwen2-7b")
    d, hd = cfg.d_model, cfg.head_dim
    projs = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
             (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
             (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    shapes = [(SEQ, K, N) for K, N in projs] + [(LOSS_CHUNK, d, cfg.vocab)]
    plans = {}
    for M, K, N in shapes:
        for kind, a, b in _issued(M, K, N):
            p = mm_k.plan_for(a, b)
            assert p.route == "wgmma", (M, K, N, kind)
            plans[(kind, a.shape[0], a.shape[1], b.shape[1])] = (p.bn,
                                                                 p.splits)
    # 256 columns a CTA wherever the tiles fill the card; the narrow
    # k / v projections (512 columns) and dB's 512 take 128; the head's
    # dA (28 tiles of 256 x 152,064 K rows) splits K four ways
    assert plans[("forward", SEQ, d, 512)] == (128, 1)
    assert plans[("dB", d, SEQ, 512)] == (128, 1)
    assert plans[("forward", SEQ, d, cfg.d_ff)] == (256, 1)
    assert plans[("dA", LOSS_CHUNK, cfg.vocab, d)] == (256, 4)
    assert plans[("forward", LOSS_CHUNK, d, cfg.vocab)] == (256, 1)
    assert plans[("dB", d, LOSS_CHUNK, cfg.vocab)] == (256, 1)


def _serving_shapes(cfg):
    shapes = [(K, N, False) for K, N in set(block_products(cfg))]
    shapes.append((cfg.d_model, cfg.vocab, bool(cfg.tie_embeddings)))
    return shapes


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("M", (1, 4, 16, 32, 64))
def test_serving_shapes_keep_mm_mma(arch, M, n_sm):
    """Decode (M = 4 slots, up to 16) stays on ``mm_mma`` whatever the
    operands' layout (the tied head's view is copied first, as ``_head``
    used to copy it), and so do refills (32, 64) but their products of
    K >= 1024 and a column tile an SM, which take ``stream``."""
    cfg = get_config(arch)
    for K, N, tied in _serving_shapes(cfg):
        a = _meta((M, K))
        b = _meta((N, K)).T if tied else _meta((K, N))
        p = mm_k.plan_for(a, b)
        legal = K % 8 == 0 and (tied or N % 8 == 0)
        if M > 16 and legal and K >= 1024 and -(-N // 128) >= H100_SMS:
            assert p.route == "stream", (K, N, tied, p)
            continue
        assert p.route == "mma" and p.bm == P.mma_bm(M)
        assert p.staged == (K % 8 != 0, N % 8 != 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("M", (65, 96, 128, 160, 255))
def test_serving_waves_take_the_stream_route(arch, M, n_sm):
    """Prefill waves of 65-128 rows (qwen2-7b's 4 x 32) take ``stream``
    where TMA reads both operands in place (the tied head as the table's
    .T view), K >= 1024 and N holds 16 column tiles; the short and narrow
    ones keep ``mm_mma`` below 128 rows, the misaligned ones staged on it.
    At 128 rows (one full row tile) weights of 2^27 elements and more take
    ``wgmma``, and so do the narrow legal products but where wgmma would
    split K more ways than mma (qwen1.5-110b's k / v); from 129 rows every
    legal product takes ``wgmma``."""
    cfg = get_config(arch)
    for K, N, tied in _serving_shapes(cfg):
        a = _meta((M, K))
        b = _meta((N, K)).T if tied else _meta((K, N))
        p = mm_k.plan_for(a, b)
        legal = K % 8 == 0 and (tied or N % 8 == 0)
        big = M == 128 and K * N >= 1 << 27
        if legal and (M >= 129 or big):
            assert p.route == "wgmma" and p.bn in P.WG_BNS, (K, N, p)
        elif legal and K >= 1024 and -(-N // 128) >= 16:
            assert p.route == "stream" and p.ctas >= 1, (K, N, tied, p)
        elif legal and M == 128 and (arch, K, N) != ("qwen1.5-110b", 8192,
                                                      1024):
            assert p.route == "wgmma" and p.bm == P.WG_BM, (K, N, p)
        else:
            assert p.route == "mma" and p.bm == P.mma_bm(M), (K, N, p)
            assert p.staged == (K % 8 != 0, N % 8 != 0)


@pytest.mark.parametrize("arch,rows", [("internvl2-26b", 4 * 288),
                                       ("hymba-1.5b", 4 * 160),
                                       ("whisper-base", 4 * 1500)])
def test_waves_past_256_rows_move_to_wgmma(arch, rows, n_sm):
    """Serving waves of 256 rows and more take ``wgmma`` where the
    operands are aligned (hymba's in_proj, N = 3257, stays staged)."""
    cfg = get_config(arch)
    prods = (set(encdec_products(cfg)[0]) if cfg.family == "encdec"
             else set(block_products(cfg)))
    for K, N in prods:
        p = mm_k.plan_for(_meta((rows, K)), _meta((K, N)))
        aligned = K % 8 == 0 and N % 8 == 0
        assert p.route == ("wgmma" if aligned else "mma"), (K, N)


# ---------------------------------------------------------------------------
# TMA legality
# ---------------------------------------------------------------------------


def _cpu(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("R,C", [(256, 64), (300, 72), (4096, 3584),
                                 (17, 8)])
def test_row_major_and_transposed_views_are_legal(R, C):
    x = _cpu((R, C))
    assert P.tma_operand(tuple(x.shape), x.stride(), 4096) == (False, C)
    t = x.t()                        # (C, R), stride (1, C)
    assert P.tma_operand(tuple(t.shape), t.stride(), 4096) == (True, C)
    # a column slice keeps the line stride: still legal where it is 16 B
    s = x[:, :C - 8]
    assert P.tma_operand(tuple(s.shape), s.stride(), 4096) == (False, C)


@pytest.mark.parametrize("R,C", [(256, 65), (300, 7), (64, 3257),
                                 (512, 51865)])
def test_odd_lines_are_not_legal(R, C):
    x = _cpu((R, C))
    assert P.tma_operand(tuple(x.shape), x.stride(), 4096) is None
    t = x.t()
    assert P.tma_operand(tuple(t.shape), t.stride(), 4096) is None


@pytest.mark.parametrize("off", (2, 6, 8, 14))
def test_offset_views_are_not_legal(off):
    """A view off a 16-byte boundary (a[:, 1:], a flat offset) is refused
    whatever its strides; 16 bytes on is legal again."""
    x = _cpu((64, 72))
    v = x[:, off // 2:]
    assert P.tma_operand(tuple(v.shape), v.stride(), 4096 + off) is None
    assert P.tma_operand(tuple(v.shape), v.stride(), 4096 + 16) == (False,
                                                                   72)


def test_other_layouts_are_not_legal():
    x = _cpu((64, 72))
    every_other = x[::2]             # lines 288 bytes apart: still legal
    assert P.tma_operand(tuple(every_other.shape), every_other.stride(),
                         4096) == (False, 144)
    for v in (x[:, ::2], x[:1].expand(64, 72),
              _cpu((64, 4, 72))[:, :, 0]):
        assert P.tma_operand(tuple(v.shape), v.stride(), 4096) is None, \
            v.stride()


@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_plan_for_reads_the_layout(a_t, b_t, n_sm):
    """Every layout of aligned operands takes wgmma at M >= 256; one
    misaligned operand sends the launch to mm_mma, which reads copies."""
    M, K, N = 512, 264, 136
    a = _meta((K, M)).t() if a_t else _meta((M, K))
    b = _meta((N, K)).t() if b_t else _meta((K, N))
    assert mm_k.plan_for(a, b).route == "wgmma"
    odd = _meta((N, K + 1)).t()[:K] if b_t else _meta((K, N + 1))[:, :N]
    p = mm_k.plan_for(a, odd)
    assert p.route == "mma" and p.staged == (False, False)
    assert mm_k.plan_for(a, b, route="mma").route == "mma"
    with pytest.raises(ValueError, match="wgmma route reads"):
        mm_k.plan_for(a, odd, route="wgmma")


# ---------------------------------------------------------------------------
# the kernel's coordinates, modelled
# ---------------------------------------------------------------------------

LINE = 128                   # bytes a swizzle line (64 bf16)
ATOM = 64 * LINE             # 64 lines
STAGES, BK = 4, P.WG_BK


def swizzle(addr):
    """The 128-byte swizzle TMA writes and wgmma reads: the 16-byte chunk
    within a line XOR the line within 8 (addresses from a 1024-aligned
    base)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def band_walk(m_tiles, n_tiles, band=16):
    """(row tile, column tile) of each CTA index, as ``mm_wgmma`` maps
    blockIdx.x: bands of ``band`` row tiles, rows fastest in a band."""
    out = []
    per = band * n_tiles
    for i in range(m_tiles * n_tiles):
        first = (i // per) * band
        in_band = min(band, m_tiles - first)
        local = i % per
        out.append((first + local % in_band, local // in_band))
    return out


def tma_stage(mem, mn_major, rows, k0, r0, R, K, boxes):
    """One operand's part of a stage as a byte-addressed image (uint16
    slots): the TMA boxes the producer issues for rows [r0, r0 + rows)
    (M rows of A or N columns of B) and K rows [k0, k0 + 64), elements
    past the operand zero.  ``mem[line, inner]`` is the operand as it lies
    in memory: (rows, K) K-major, (K, rows) MN-major."""
    img = np.full(rows * BK, np.nan)
    if not mn_major:                 # one box {64 k, rows lines}
        line, i = np.meshgrid(np.arange(rows), np.arange(BK), indexing="ij")
        r, k = r0 + line, k0 + i
        at = swizzle(line * LINE + 2 * i)
    else:                            # boxes {64 rows, 64 k lines}, ATOM apart
        j, line, i = np.meshgrid(np.arange(boxes), np.arange(BK),
                                 np.arange(64), indexing="ij")
        r, k = r0 + 64 * j + i, k0 + line
        at = j * ATOM + swizzle(line * LINE + 2 * i)
    inside = (r < R) & (k < K)
    rc, kc = np.minimum(r, R - 1), np.minimum(k, K - 1)
    vals = mem[kc, rc] if mn_major else mem[rc, kc]
    img[at // 2] = np.where(inside, vals, 0.0)
    assert not np.isnan(img).any()   # the boxes fill the stage
    return img


def desc_read(img, start, lbo, mn_major, rows):
    """The (rows, 16) slice a wgmma reads through a descriptor at byte
    ``start`` (LBO ``lbo``, SBO 1024) in the canonical 128-byte swizzled
    layout, K-major or MN-major."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    if mn_major:
        addr = (start + (r // 64) * lbo + (k // 8) * 1024 + (k % 8) * LINE
                + (r % 64) * 2)
    else:
        addr = start + (r // 8) * 1024 + (r % 8) * LINE + 2 * k
    return img[swizzle(addr) // 2]


def emulate(a, b, a_mn, b_mn, p):
    """``mm_wgmma``'s launch on numpy operands a (M, K), b (K, N), each
    stored as its layout says, by plan ``p``; returns (C, coverage) where
    coverage[m, n, k] counts the products of term (m, n, k) that reach C
    (the epilogue's masks included)."""
    M, K = a.shape
    N = b.shape[1]
    a_mem = a.T.copy() if a_mn else a        # what TMA's lines are
    b_mem = b.copy() if b_mn else b.T.copy()
    m_tiles, n_tiles = -(-M // P.WG_BM), -(-N // p.bn)
    out = np.zeros((p.splits, M, N))
    cover = np.zeros((M, N, K), np.int32)
    for mt, nt in band_walk(m_tiles, n_tiles):
        m0, n0 = mt * P.WG_BM, nt * p.bn
        for z in range(p.splits):
            lo, hi = z * p.rows, min(K, (z + 1) * p.rows)
            acc = np.zeros((P.WG_BM, p.bn))
            for t in range(-(-(hi - lo) // BK)):
                k0 = lo + t * BK
                ia = tma_stage(a_mem, a_mn, P.WG_BM, k0, m0, M, K, 2)
                ib = tma_stage(b_mem, b_mn, p.bn, k0, n0, N, K, p.bn // 64)
                for wg in range(2):
                    for kk in range(BK // 16):
                        sa = (wg * ATOM + kk * 2048 if a_mn
                              else wg * ATOM + kk * 32)
                        sb = kk * 2048 if b_mn else kk * 32
                        ta = desc_read(ia, sa, ATOM, a_mn, 64)
                        tb = desc_read(ib, sb, ATOM, b_mn, p.bn)
                        acc[64 * wg:64 * wg + 64] += ta @ tb.T
                        ks = [k for k in range(k0 + 16 * kk,
                                               k0 + 16 * kk + 16) if k < K]
                        if ks:
                            rs = slice(m0 + 64 * wg, min(M, m0 + 64 * wg
                                                         + 64))
                            cover[rs, n0:min(N, n0 + p.bn),
                                  ks[0]:ks[-1] + 1] += 1
            rm, cn = min(P.WG_BM, M - m0), min(p.bn, N - n0)
            out[z, m0:m0 + rm, n0:n0 + cn] = acc[:rm, :cn]
    return out.sum(axis=0), cover


def test_band_walk_is_a_bijection():
    for m_tiles, n_tiles in ((1, 1), (2, 594), (32, 14), (148, 14),
                             (17, 3), (40, 1)):
        tiles = band_walk(m_tiles, n_tiles)
        assert sorted(tiles) == [(m, n) for m in range(m_tiles)
                                 for n in range(n_tiles)]


@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("bn", P.WG_BNS)
def test_descriptors_read_what_tma_wrote(a_mn, b_mn, bn):
    """Every element of a stage, read back through the descriptors of the
    four 16-deep K slices and both warpgroups, is the element TMA put
    there (distinct values: any misplaced byte shows)."""
    rng = np.random.default_rng(bn + 2 * a_mn + b_mn)
    M, N, K = P.WG_BM, bn, BK
    a, b = rng.permutation(M * K).reshape(M, K) + 1.0, \
        rng.permutation(K * N).reshape(K, N) + 1e6
    ia = tma_stage(a.T.copy() if a_mn else a, a_mn, M, 0, 0, M, K, 2)
    ib = tma_stage(b.copy() if b_mn else b.T.copy(), b_mn, bn, 0, 0, N, K,
                   bn // 64)
    for kk in range(BK // 16):
        for wg in range(2):
            sa = wg * ATOM + (kk * 2048 if a_mn else kk * 32)
            np.testing.assert_array_equal(
                desc_read(ia, sa, ATOM, a_mn, 64),
                a[64 * wg:64 * wg + 64, 16 * kk:16 * kk + 16])
        np.testing.assert_array_equal(
            desc_read(ib, kk * 2048 if b_mn else kk * 32, ATOM, b_mn, bn),
            b[16 * kk:16 * kk + 16].T)


@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("M,K,N,bn,splits", [
    (129, 72, 136, 128, 1),     # a ragged second row tile, N past a tile
    (256, 200, 64, 256, 1),     # K past three steps, N under a tile
    (130, 520, 200, 128, 3),    # split K: 3 ranges of whole steps
    (40, 64, 264, 256, 1),      # M under a tile; two column tiles
    (300, 8, 300, 128, 1),      # K under a step; three tiles each way
    (257, 300, 72, 256, 2),     # two ranges, the second ragged
])
def test_emulated_launch_covers_each_term_once(a_mn, b_mn, M, K, N, bn,
                                               splits):
    """The plan's split (rows whole K steps), the band walk, the boxes and
    the descriptors together: every (m, n, k) term reaches C exactly once,
    and C equals the product (f64, exact for these small integers)."""
    p = dataclasses.replace(
        P.plan(M, N, K, bf16=True, is_aligned=(True, True), n_sm=H100_SMS,
               tma=True, route="wgmma", splits=splits), bn=bn)
    assert p.splits == splits
    assert p.splits == 1 or p.rows % BK == 0
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-3, 4, (M, K)).astype(np.float64)
    b = rng.integers(-3, 4, (K, N)).astype(np.float64)
    c, cover = emulate(a, b, a_mn, b_mn, p)
    assert (cover == 1).all()
    np.testing.assert_array_equal(c, a @ b)


def test_split_and_width_rules():
    """Splits where the tiles leave SMs idle (within the workspace's byte
    limit and MIN_STEPS K steps a range); 128 columns only where that
    fills more SMs."""
    def wg(M, N, K):
        return P.plan(M, N, K, bf16=True, is_aligned=(True, True),
                      n_sm=H100_SMS, tma=True)
    p = wg(256, 3584, 152064)                # the head's dA: 28 tiles
    assert (p.route, p.bn, p.splits) == ("wgmma", 256, 4)
    assert p.rows % BK == 0 and p.rows * (p.splits - 1) < 152064
    p = wg(4096, 512, 3584)                  # 64 tiles of 256 -> 128 of 128
    assert (p.bn, p.splits) == (128, 1)
    p = wg(4096, 18944, 3584)                # 2368 tiles
    assert (p.bn, p.splits) == (256, 1)
    p = wg(256, 64, 2048)                    # 2 tiles; K // (2 M) = 4
    assert (p.bn, p.splits) == (256, 4)
    assert P.workspace_shape(p, 256, 64) == (4, 256, 64)
    assert wg(255, 3584, 3584).route == "wgmma"   # from WG_MIN_M: a
    assert wg(255, 512, 3584).route == "wgmma"    # wave's, wide or not


# ---------------------------------------------------------------------------
# MatMul's gradients with the views
# ---------------------------------------------------------------------------


def _pair(x, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


def _close(got, want, tol, what):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    err = np.abs(got - want)
    lim = tol * (np.sqrt(np.mean(want ** 2)) + np.abs(want))
    assert np.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: max err {err.max():.3g}, worst {(err / lim).max():.3g} x "
        "the limit")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("M,K,N", [(40, 24, 56), (9, 72, 130)])
def test_matmul_gradients_with_views_vs_jax(dtype, tied, M, K, N):
    """x @ w and x @ E.T (a tied table): the loss sum(C * G) and its
    gradients against ``jax.grad`` of the JAX package's ``ref.matmul``."""
    rng = np.random.default_rng(M + 3 * N + tied)
    x, g = (rng.standard_normal(s, np.float32) for s in ((M, K), (M, N)))
    w = rng.standard_normal((N, K) if tied else (K, N), np.float32)
    (jx, tx), (jw, tw), (jg, tg) = (_pair(v, dtype) for v in (x, w, g))

    def loss(xa, wa):
        c = jmm_ref.matmul(xa, wa.T if tied else wa)
        return jnp.sum(c.astype(jnp.float32) * jg.astype(jnp.float32))
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jx, jw)

    xl, wl = (t.detach().clone().requires_grad_(True) for t in (tx, tw))
    c = mm_ops.matmul(xl, wl.T if tied else wl)
    assert type(c.grad_fn).__name__ == "MatMulBackward"
    (c.float() * tg.float()).sum().backward()
    tol = TOL[dtype]
    _close(xl.grad, jdx, tol, "dx")
    _close(wl.grad, jdw, tol, "dw")
    assert xl.grad.dtype == wl.grad.dtype == tx.dtype


def test_backward_products_read_views(monkeypatch):
    """``MatMul.backward`` issues dC B^T and A^T dC on views of the saved
    operands: the plain version (the CPU route) receives them unchanged,
    sharing the saved tensors' storage, transposed strides."""
    seen = []
    real = mm_ops.ref.matmul

    def record(a, b):
        seen.append((a.data_ptr(), a.stride(), b.data_ptr(), b.stride()))
        return real(a, b)
    monkeypatch.setattr(mm_ops.ref, "matmul", record)
    x = torch.randn(6, 8, requires_grad=True)
    w = torch.randn(8, 5, requires_grad=True)
    mm_ops.matmul(x, w).sum().backward()
    fwd, da, db = seen
    assert fwd == (x.data_ptr(), (8, 1), w.data_ptr(), (5, 1))
    assert da[2:] == (w.data_ptr(), (1, 5))      # w.t(), no copy
    assert db[:2] == (x.data_ptr(), (1, 8))      # x.t(), no copy

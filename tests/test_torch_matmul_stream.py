"""The stream route of the port's matmul (``stream``, ``mm_stream`` in
``kernels/csrc/matmul_wgmma.cu``), held on the CPU.  The kernel runs only
on a card (``tests/test_torch_matmul_stream_card.py``, ``chip_smoke.py``
phase 1 and ``--only matmul``); what surrounds it is held here:

* the partition in numpy: the flattened (tile, K step) units, tiles
  column-major and each tile's K steps in order, cut into ``Plan.shares``
  (stream-K): every unit covered once, each share within one K step of
  the others, the CTA that holds a unit (the kernel's ``sk_owner``), the
  one workspace slot a CTA (its first tile's partial) and the fixed
  order in which the first CTA of a shared tile sums the partials;
* each stage's TMA boxes placed by the 128-byte swizzle and read back
  through the kernel's descriptors (``tests/_torch_wgmma_model.py``'s
  ``swizzle`` / ``kmajor`` / ``mnmajor``), both layouts of each operand,
  and a row-major A's box cut to its rows where M fits one row tile;
* an emulated launch that walks the shares in the kernel's order, writes
  and counts the partials and lets each shared tile's first CTA wait for
  them and sum in share order: the same bits whatever order the CTAs run
  in, every term
  reaching C once, and within 2e-4 (f32) / 3e-2 (bf16) of the JAX
  package's ``ref.matmul`` and ``matmul_pallas(interpret=True)``;
* the route of every serving shape of the ten configs: decode (M <= 16)
  keeps ``mma``; 17-128 rows take ``stream`` where TMA reads both
  operands in place, K holds STREAM_MIN_K and N enough column tiles
  (STREAM_MIN_TILES for a wave's 65 rows and more, one an SM for a
  refill's fewer), else ``mma`` (staged where a row is off 16 bytes); a
  wave of 128 rows takes ``wgmma`` for weights of WG_WAVE_KN elements and
  more and for the products ``stream`` does not take (``mma`` where
  wgmma would split K more ways); 129 rows and more ``wgmma``; and the
  plan's refusals.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_wgmma_model import BOX, kmajor, mnmajor, place
from repro.kernels.matmul import ref as jmm_ref
from repro.kernels.matmul.matmul import matmul_pallas
from repro_torch.configs import get_config
from repro_torch.kernels.matmul import matmul as mm_k
from repro_torch.kernels.matmul import plan as P
from repro_torch.profiling.train_counts import block_products, encdec_products

H100_SMS = 132
ARCHS = ("qwen2-7b", "qwen1.5-4b", "mistral-nemo-12b", "qwen1.5-110b",
         "qwen3-moe-30b-a3b", "dbrx-132b", "internvl2-26b", "mamba2-130m",
         "hymba-1.5b", "whisper-base")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BK = P.WG_BK


def _plan(M, N, K, **kw):
    """The stream route's plan of (M, K) @ (K, N) (forced: the partition
    holds at any shape)."""
    return P.plan(M, N, K, bf16=True, is_aligned=(True, True),
                  n_sm=H100_SMS, tma=True, route="stream", **kw)


def _owner(u, units, ctas):
    """``sk_owner``: the largest c with c U / G <= u."""
    return ((u + 1) * ctas + units - 1) // units - 1


def _tiles(M, N):
    return -(-M // P.WG_BM), -(-N // P.STREAM_BN)


def _segments(p, M, N, K):
    """Each CTA's (tile, first K step, end K step) segments, in the order
    the kernel walks them."""
    steps = -(-K // BK)
    out = []
    for lo, hi in p.shares():
        seg, u = [], lo
        while u < hi:
            tile, ks = divmod(u, steps)
            ke = min(steps, ks + hi - u)
            seg.append((tile, ks, ke))
            u += ke - ks
        out.append(seg)
    return out


# the four products of a prefill wave at qwen2-7b's widths, a refill's
# rows, two row tiles, the narrow edges
SHAPES = [(128, 3584, 3584), (128, 512, 3584), (128, 18944, 3584),
          (128, 3584, 18944), (32, 3584, 3584), (64, 18944, 3584),
          (255, 512, 3584), (17, 136, 40), (129, 520, 1000), (40, 264, 72)]


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,N,K", SHAPES)
@pytest.mark.parametrize("ctas", [None, 1, 7, 10_000])
def test_shares_cover_every_unit_once_and_balance(M, N, K, ctas):
    p = _plan(M, N, K, ctas=ctas)
    mt, nt = _tiles(M, N)
    steps = -(-K // BK)
    assert p.route == "stream" and p.units == mt * nt * steps
    assert 1 <= p.ctas <= min(H100_SMS, p.units)
    shares = p.shares()
    assert shares[0][0] == 0 and shares[-1][1] == p.units
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    covered = np.zeros(p.units, np.int32)
    for seg in _segments(p, M, N, K):
        for tile, ks, ke in seg:
            covered[tile * steps + ks:tile * steps + ke] += 1
    assert (covered == 1).all()
    # the owner of every unit is the CTA whose share holds it
    for c, (lo, hi) in enumerate(shares):
        for u in {lo, hi - 1, (lo + hi) // 2}:
            assert _owner(u, p.units, p.ctas) == c


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_each_cta_fills_at_most_one_slot_and_lo_sums_in_share_order(M, N, K):
    """A shared tile's contributors are consecutive CTAs lo .. hi (from
    ``sk_owner`` of its first and last unit); lo's share ends with the
    tile's first K steps, so the tile is lo's last segment (lo sums it);
    each of lo + 1 .. hi holds it as its first segment and writes its
    partial to its own slot, so a CTA fills one slot at most; no CTA
    waits (as lo) before it has written (as another's contributor)."""
    p = _plan(M, N, K)
    steps = -(-K // BK)
    writes = {}
    for c, seg in enumerate(_segments(p, M, N, K)):
        for i, (tile, ks, ke) in enumerate(seg):
            whole = ks == 0 and ke == steps
            lo = _owner(tile * steps, p.units, p.ctas)
            hi = _owner(tile * steps + steps - 1, p.units, p.ctas)
            assert whole == (lo == hi)
            assert lo <= c <= hi
            if whole:
                continue
            if c == lo:
                assert ks == 0 and i == len(seg) - 1
            else:
                assert i == 0 and c not in writes, (c, tile)
                writes[c] = tile
    assert all(c < p.ctas for c in writes)


def test_ctas_follow_the_units():
    """One CTA an SM where every share keeps STREAM_MIN_STEPS K steps,
    fewer where it would not; forced CTAs are cut to the units and the
    SMs (the shares wait on each other: all resident at once)."""
    assert _plan(128, 18944, 3584).ctas == H100_SMS
    p = _plan(128, 1024, 3584)                  # 8 tiles x 56 steps
    assert p.ctas == p.units // P.STREAM_MIN_STEPS == 56
    assert _plan(17, 136, 40).ctas == 1         # 2 units
    assert _plan(17, 136, 40, ctas=10_000).ctas == 2
    assert _plan(128, 3584, 3584, ctas=7).ctas == 7
    assert _plan(128, 3584, 3584, ctas=10_000).ctas == H100_SMS
    with pytest.raises(ValueError, match="splits no K"):
        _plan(128, 3584, 3584, splits=3)


@pytest.mark.parametrize("M", [17, 64, 65, 128, 255])
def test_workspace_holds_a_slot_a_cta(M):
    """A slot is the f32 fragments of the warps with rows below M (16 rows
    a warp, 8 warps at most), 64 a thread."""
    p = _plan(M, 3584, 3584)
    warps = -(-min(M, 128) // 16)
    assert P.stream_slot(M) == 64 * 32 * warps
    assert P.workspace_shape(p, M, 3584) == (p.ctas, P.stream_slot(M))


# ---------------------------------------------------------------------------
# boxes and descriptors
# ---------------------------------------------------------------------------


def _stage(mem, mn_major, rows, k0, r0, R, K):
    """One operand's part of a stage as the producer loads it: K-major, a
    box of 64 K x ``rows`` lines (placed 64 lines a BOX); MN-major, rows /
    64 boxes of 64 elements x 64 K lines, BOX apart.  ``mem[line,
    inner]`` is the operand as it lies in memory; zeros past it."""
    img = np.full(rows * BK, np.nan)
    for j in range(rows // 64):
        box = np.zeros((64, 64))
        if mn_major:              # lines are K rows, inner the M / N index
            lines, inner = np.arange(k0, k0 + 64), np.arange(r0 + 64 * j,
                                                             r0 + 64 * j + 64)
            ok = (lines[:, None] < K) & (inner[None, :] < R)
        else:                     # lines are M / N rows, inner K
            lines, inner = np.arange(r0 + 64 * j, r0 + 64 * j + 64), \
                np.arange(k0, k0 + 64)
            ok = (lines[:, None] < R) & (inner[None, :] < K)
        lc = np.minimum(lines, mem.shape[0] - 1)
        ic = np.minimum(inner, mem.shape[1] - 1)
        box[:] = np.where(ok, mem[lc][:, ic], 0.0)
        place(img, j * BOX, box)
    assert not np.isnan(img).any()
    return img


@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_descriptors_read_what_tma_wrote(a_mn, b_mn):
    """Every element of a stage, read back through the kernel's
    descriptors (A: warpgroup wg at wg ATOM, slice kk at 32 kk K-major or
    2048 kk MN-major; B likewise, LBO one BOX), is the element TMA put
    there (distinct values: a misplaced byte shows)."""
    rng = np.random.default_rng(2 * a_mn + b_mn)
    M, N, K = P.WG_BM, P.STREAM_BN, BK
    bn = N
    a = rng.permutation(M * K).reshape(M, K) + 1.0
    b = rng.permutation(K * N).reshape(K, N) + 1e6
    ia = _stage(a.T if a_mn else a, a_mn, M, 0, 0, M, K)
    ib = _stage(b if b_mn else b.T, b_mn, bn, 0, 0, N, K)
    for kk in range(BK // 16):
        for wg in range(2):
            got = (mnmajor(ia, wg * BOX + kk * 2048, 64) if a_mn
                   else kmajor(ia, wg * BOX + kk * 32))
            np.testing.assert_array_equal(
                got, a[64 * wg:64 * wg + 64, 16 * kk:16 * kk + 16])
        got = (mnmajor(ib, kk * 2048, bn) if b_mn
               else kmajor(ib, kk * 32, bn))
        np.testing.assert_array_equal(got, b[16 * kk:16 * kk + 16].T)


def test_edge_boxes_fill_zeros():
    """Rows, columns and K rows past the operands come back as zeros
    through the descriptors (TMA's fill): the kernel masks only its
    stores."""
    rng = np.random.default_rng(3)
    M, N, K = 17, 70, 40
    a = rng.standard_normal((M, K))
    b = rng.standard_normal((K, N))
    ia = _stage(a, False, P.WG_BM, 0, 0, M, K)
    ib = _stage(b, True, 128, 0, 0, N, K)
    a_read = np.vstack([np.hstack([kmajor(ia, wg * BOX + kk * 32)
                                   for kk in range(BK // 16)])
                        for wg in range(2)])            # (128 rows, 64 k)
    np.testing.assert_array_equal(a_read,
                                  np.pad(a, ((0, 128 - M), (0, BK - K))))
    b_read = np.hstack([mnmajor(ib, kk * 2048, 128)
                        for kk in range(BK // 16)])     # (128 cols, 64 k)
    np.testing.assert_array_equal(b_read,
                                  np.pad(b, ((0, BK - K), (0, 128 - N))).T)


@pytest.mark.parametrize("M", [17, 32, 63, 64, 100, 128])
def test_a_narrow_box_holds_the_rows_below_m(M):
    """Where M fits one row tile, a row-major A's box holds ceil(M / 8) x
    8 rows (the swizzle's period: whole 1024-byte groups), so a stage's
    A bytes are that x 128: the rows below M read back through the
    descriptors as A, those up to the box's end as TMA's zeros, and the
    lines past the box are whatever the stage held before (NaN here).
    Each row of a product depends on its own row of A only, so the rows
    below M come out exact and the stale rows stay in rows the stores
    mask."""
    rng = np.random.default_rng(M)
    rows = -(-M // 8) * 8
    a = rng.standard_normal((M, BK))
    img = np.full(P.WG_BM * BK, np.nan)
    box = np.zeros((rows, 64))
    box[:M] = a
    for g in range(rows // 8):             # 8-line groups of the box
        grp = np.full((64, 64), np.nan)
        grp[:8] = box[8 * g:8 * g + 8]
        part = np.full(BOX // 2, np.nan)
        place(part, 0, grp)
        img[g * 512:(g + 1) * 512] = part[:512]
    read = np.vstack([np.hstack([kmajor(img, wg * BOX + kk * 32)
                                 for kk in range(BK // 16)])
                      for wg in range(2)])              # (128 rows, 64 k)
    np.testing.assert_array_equal(read[:M], a)
    np.testing.assert_array_equal(read[M:rows], 0.0)
    assert np.isnan(read[rows:]).all()
    b = rng.standard_normal((BK, 128))
    out = read @ b
    np.testing.assert_allclose(out[:M], a @ b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the emulated launch
# ---------------------------------------------------------------------------


def emulate(a, b, p, order):
    """``mm_stream``'s launch on f32 operands a (M, K), b (K, N) by plan
    ``p``, the CTAs running in ``order`` (a permutation of the CTAs, each
    walking its segments in turn): a shared tile's contributors but lo
    write their partials to their slots and count in; lo, at its last
    segment, waits (here: is set aside) until the count is hi - lo, then
    adds the slots to its own sums in share order.  Returns (C in f32,
    coverage[m, n, K step], the CTA that summed each shared tile)."""
    M, K = a.shape
    N = b.shape[1]
    mt, _ = _tiles(M, N)
    steps = -(-K // BK)
    ws, cnt, summed, waiting = {}, {}, {}, []
    c_out = np.full((M, N), np.nan, np.float32)
    cover = np.zeros((M, N, steps), np.int32)
    segs = _segments(p, M, N, K)

    def finish(c, tile, rows, cols, acc, lo, hi):
        total = acc.copy()
        for cc in range(lo + 1, hi + 1):      # share order
            total = total + ws[cc]
        c_out[rows, cols] = total
        summed[tile] = c
        cnt[tile] = 0

    for c in order:
        for tile, ks, ke in segs[c]:
            m0, n0 = (tile % mt) * P.WG_BM, (tile // mt) * p.bn
            rows = slice(m0, min(M, m0 + P.WG_BM))
            cols = slice(n0, min(N, n0 + p.bn))
            acc = np.zeros((rows.stop - rows.start, cols.stop - cols.start),
                           np.float32)
            for k in range(ks, ke):
                kk = slice(k * BK, min(K, k * BK + BK))
                acc += a[rows, kk] @ b[kk, cols]
                cover[rows, cols, k] += 1
            lo = _owner(tile * steps, p.units, p.ctas)
            hi = _owner(tile * steps + steps - 1, p.units, p.ctas)
            if lo == hi:
                c_out[rows, cols] = acc
            elif c != lo:
                assert c not in ws                # one slot a CTA
                ws[c] = acc
                cnt[tile] = cnt.get(tile, 0) + 1
            else:
                waiting.append((c, tile, rows, cols, acc, lo, hi))
        for w in list(waiting):                   # the waits that end now
            if cnt.get(w[1], 0) == w[6] - w[5]:
                finish(*w)
                waiting.remove(w)
    assert not waiting and not any(cnt.values())
    return c_out, cover, summed


def _operands(M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    if dtype == "bfloat16":       # the values a bf16 operand holds
        a, b = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in (a, b))
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,ctas", [
    (128, 1024, 3584, None),         # 8 tiles x 56 steps: 56 CTAs
    (32, 640, 1000, 9),              # a refill's rows, K past a step
    (129, 264, 520, 5),              # two row tiles, N past a tile
    (17, 136, 40, 2),                # K under a step
    (64, 520, 72, 3),                # one warpgroup's rows, K < the ring
    (255, 200, 300, 11),             # more CTAs than tiles
])
def test_emulated_launch_matches_the_jax_reference(dtype, M, N, K, ctas):
    p = _plan(M, N, K, ctas=ctas)
    a, b = _operands(M, K, N, dtype, M + N + K)
    ctas_order = list(range(p.ctas))
    c, cover, summed = emulate(a, b, p, ctas_order)
    assert (cover == 1).all()
    # another order of ending: other CTAs sum, the bits stay
    rng = np.random.default_rng(1)
    for order in (ctas_order[::-1], list(rng.permutation(p.ctas))):
        c2, _, summed2 = emulate(a, b, p, order)
        np.testing.assert_array_equal(c2, c)
        assert summed2 == summed
    jdt = getattr(jnp, dtype)
    got = torch.from_numpy(c).to(getattr(torch, dtype)).float().numpy()
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    for want in (jmm_ref.matmul(ja, jb),
                 matmul_pallas(ja, jb, bm=M, bk=K, bn=N, interpret=True)):
        want = np.asarray(want.astype(jnp.float32), np.float64)
        err = np.abs(got - want)
        assert (err <= TOL[dtype] * (1 + np.abs(want))).all(), err.max()


def test_a_shared_tile_is_summed_by_its_first_cta():
    """The qwen2-7b wave's wq: 28 tiles over 132 CTAs, each shared; lo
    sums each, whatever order the CTAs run in, and the counters end at
    0."""
    p = _plan(128, 3584, 3584)
    a, b = _operands(128, 3584, 3584, "float32", 0)
    fwd = emulate(a, b, p, list(range(p.ctas)))
    rev = emulate(a, b, p, list(range(p.ctas))[::-1])
    steps = 3584 // BK
    assert len(fwd[2]) == 28 and fwd[2] == rev[2]
    assert all(c == _owner(t * steps, p.units, p.ctas)
               for t, c in fwd[2].items())
    np.testing.assert_array_equal(fwd[0], rev[0])


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


@pytest.fixture
def n_sm(monkeypatch):
    """``plan_for`` on meta tensors: the card's SM count stands in."""
    monkeypatch.setattr(mm_k, "_n_sm", lambda index: H100_SMS)


def _meta(shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _serving_products(cfg):
    """(K, N, tied) of every product a serving block issues, and the head."""
    prods = (set(encdec_products(cfg)[1]) | set(encdec_products(cfg)[0])
             if cfg.family == "encdec" else set(block_products(cfg)))
    out = [(K, N, False) for K, N in sorted(prods)]
    return out + [(cfg.d_model, cfg.vocab, bool(cfg.tie_embeddings))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("M", (1, 4, 16, 17, 32, 64, 65, 128, 160, 255,
                               256))
def test_serving_shapes_take_their_route(arch, M, n_sm):
    """Decode keeps ``mma``; 17-128 rows take ``stream`` where TMA reads
    both operands in place (a tied head as the table's .T view), K is at
    least 1024 and N holds 16 column tiles (a wave's 65 rows and more) or
    one an SM (a refill's fewer rows), else ``mma``, staged where a row is
    off 16 bytes; a wave of 128 rows takes ``wgmma`` for weights of 2^27
    elements and more (the heads, qwen1.5-110b's MLP) and for the legal
    products ``stream`` does not take, but qwen1.5-110b's k / v (wgmma
    would split K 32 ways, mma 16); ``wgmma`` from 129 rows."""
    cfg = get_config(arch)
    for K, N, tied in _serving_products(cfg):
        a = _meta((M, K))
        b = _meta((N, K)).T if tied else _meta((K, N))
        p = mm_k.plan_for(a, b)
        legal = K % 8 == 0 and N % 8 == 0 if not tied else K % 8 == 0
        tiles = -(-N // 128)
        wide = K >= 1024 and tiles >= (16 if M >= 65 else H100_SMS)
        if not legal or M < 17:
            want = "mma"
        elif M >= 129 or M == 128 and K * N >= 1 << 27:
            want = "wgmma"
        elif wide:
            want = "stream"
        elif M == 128:
            want = "mma" if (arch, K, N) == ("qwen1.5-110b", 8192,
                                             1024) else "wgmma"
        else:
            want = "mma"
        assert p.route == want, (arch, M, K, N, tied, p)
        if want == "stream":
            assert p.bm == P.WG_BM and p.bn == P.STREAM_BN
            assert 1 <= p.ctas <= H100_SMS and p.staged == (False, False)
        if want == "mma":
            assert p.staged == (K % 8 != 0, N % 8 != 0)


def test_qwen2_7b_refill_takes_stream_for_its_wide_products():
    """A refill (one slot's 32 rows): w1 / w3 (148 column tiles, more than
    the SMs) on stream; q / o, k / v and w2 (28 or 4 tiles, each shared by
    several CTAs) stay on mm_mma's 64-row tile; decode's 4 rows keep mma
    everywhere."""
    cfg = get_config("qwen2-7b")
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.head_dim
    for M in (17, 32, 64):
        for K, N, want in ((d, d, "mma"), (d, kv, "mma"), (d, f, "stream"),
                           (f, d, "mma")):
            p = P.plan(M, N, K, bf16=True, is_aligned=(True, True),
                       n_sm=H100_SMS, tma=True)
            assert p.route == want, (M, K, N, p)
    for K, N in ((d, d), (d, kv), (d, f), (f, d)):
        assert P.plan(4, N, K, bf16=True, is_aligned=(True, True),
                      n_sm=H100_SMS, tma=True).route == "mma"


@pytest.mark.parametrize("M,N,K,want", [
    (128, 2048, 1024, True), (128, 1920, 1024, False),   # 16 / 15 tiles
    (128, 2048, 1023, False), (16, 1 << 15, 4096, False),
    (17, 132 * 128, 1024, True), (64, 131 * 128, 4096, False),
    (127, 2048, 1024, True), (129, 2048, 1024, False),
    (128, 128 * P.STREAM_TILES + 8, 4096, False)])
def test_stream_takes_its_limits(M, N, K, want):
    assert P.stream_takes(M, N, K, H100_SMS) == want


def test_qwen2_7b_wave_takes_stream_but_its_kv_products():
    """The qwen2-7b wave's (4 x 32 rows) q / o, w1 / w3 and w2 on stream,
    one CTA an SM; k / v (512 columns: 4 tiles) on mm_wgmma, on the grid
    mm_mma<128> would take (4 tiles x 14 K ranges)."""
    cfg = get_config("qwen2-7b")
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.head_dim
    for K, N, want in ((d, d, "stream"), (d, kv, "wgmma"), (d, f, "stream"),
                       (f, d, "stream")):
        p = P.plan(128, N, K, bf16=True, is_aligned=(True, True),
                   n_sm=H100_SMS, tma=True)
        assert p.route == want, (K, N, p)
        if want == "stream":
            assert p.ctas == H100_SMS and p.units == -(-N // 128) * K // 64
        else:
            mma = P.plan(128, N, K, bf16=True, is_aligned=(True, True),
                         n_sm=H100_SMS, tma=True, route="mma")
            assert (p.bn, p.splits) == (mma.bn, mma.splits) == (128, 14)


def test_stream_takes_bf16_tma_legal_operands_only():
    with pytest.raises(ValueError, match="takes bf16"):
        P.plan(128, 3584, 3584, bf16=False, is_aligned=(True, True),
               n_sm=H100_SMS, tma=True, route="stream")
    with pytest.raises(ValueError, match="stream route reads"):
        P.plan(128, 3584, 3584, bf16=True, is_aligned=(True, True),
               n_sm=H100_SMS, route="stream")
    # f32 keeps the CUDA cores, TMA or not
    assert P.plan(128, 3584, 3584, bf16=False, is_aligned=(True, True),
                  n_sm=H100_SMS, tma=True).route == "tiled"
    # more tiles than the counters: not stream (mma below a full row
    # tile, wgmma at one), and a forced stream plan raises
    for M, want in ((127, "mma"), (128, "wgmma")):
        auto = P.plan(M, 128 * P.STREAM_TILES + 8, 4096, bf16=True,
                      is_aligned=(True, True), n_sm=H100_SMS, tma=True)
        assert auto.route == want, (M, auto)
    with pytest.raises(ValueError, match="counters"):
        _plan(128, 128 * P.STREAM_TILES + 8, 64)

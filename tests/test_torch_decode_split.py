"""The split (flash-decoding) walk of the port's decode-attention kernels.

The CUDA template (``kernels/csrc/decode_attention.cuh``) cuts each
(slot, kv head)'s walk into ``splits`` slices of whole 32-row tiles, runs
the online softmax over each slice in its own CTA, and merges the slices'
(acc, m, l) in split order.  The kernel runs only on a card; these tests
hold what it is built from:

* ``decode_split.plan``: a function of the launch's shapes alone, at least
  1, never more than the walk's tiles; ``split_slice``: whole-tile slices
  that cover every walked row exactly once, empty ones included.
* The algebra: an emulation of the kernel in torch (its walk, its per-tile
  online softmax with p rounded to the compute dtype, its -1e30 masks, its
  empty slices with m = -1e30 and l = 0, its fixed-order f32 combine)
  against the port's plain versions and the JAX package's ``ref.py``, for
  float, int8, e4m3, sparse and dense operands, at 2e-4 (fp32), 3e-2
  (bf16) and 5e-2 (packed pages against the JAX oracle, which keeps the
  dequantized rows in f32).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ref as jfd_ref
from repro.kernels.paged_attention import ref as jpa_ref
from repro.serving import kv_pool as JKV
from repro_torch.bridge import to_torch
from repro_torch.kernels import decode_split
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.paged_attention import ref as pa_ref

NEG = -1e30
KT = decode_split.KT
H100_SMS = 132
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
QTOL = 5e-2


# ---------------------------------------------------------------------------
# the plan and the slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 4), (3, 2), (64, 8)])
def test_plan_bounds_and_determinism(B, Hkv):
    for walk in (1, 31, 32, 33, 64, 96, 4128, 65536):
        for sms in (1, 16, 132):
            tiles = -(-walk // KT)
            n = decode_split.plan(B, Hkv, walk, sms)
            assert n == decode_split.plan(B, Hkv, walk, sms)
            assert 1 <= n <= tiles
            # enough CTAs to cover the SMs twice, unless the tiles run out
            assert B * Hkv * n >= 2 * sms or n == tiles
            # and no more than needed for that
            assert n == 1 or B * Hkv * (n - 1) < 2 * sms


def test_plan_at_the_main_paths_shapes():
    # qwen2-7b: 4 slots x 4 kv heads on an H100's 132 SMs
    assert decode_split.plan(4, 4, 3 * 16, H100_SMS) == 2      # serve run
    assert decode_split.plan(4, 4, 5 * 16, H100_SMS) == 3      # lever runs
    assert decode_split.plan(4, 4, 258 * 16, H100_SMS) == 17   # 4,096 rows
    assert decode_split.plan(4, 4, 4160, H100_SMS) == 17


@pytest.mark.parametrize("walk", [1, 31, 32, 33, 95, 160])
def test_slices_cover_each_walked_row_once(walk):
    tiles = -(-walk // KT)
    for splits in sorted({1, 2, 3, decode_split.plan(2, 2, walk, H100_SMS),
                          tiles, tiles + 3}):
        for n in range(1, walk + 1):
            seen = []
            for s in range(splits):
                lo, hi = decode_split.split_slice(n, splits, s)
                assert 0 <= lo <= hi <= n
                assert lo % KT == 0 or lo == hi == n      # empty: at the end
                assert hi % KT == 0 or hi == n
                seen.extend(range(lo, hi))
            assert seen == list(range(n))        # in order, exactly once
            if splits > -(-n // KT):             # more splits than tiles
                assert decode_split.split_slice(n, splits, splits - 1) \
                    == (n, n)


def test_splits_for_and_workspace():
    q = torch.zeros((3, 4, 16))
    assert decode_split.splits_for(q, 2, 64, 5) == 5
    with pytest.raises(ValueError):
        decode_split.splits_for(q, 2, 64, 0)
    assert decode_split.workspace(q, 1) is None
    ws = decode_split.workspace(q, 4)
    assert ws.shape == (4, 3, 4, 18) and ws.dtype == torch.float32


# ---------------------------------------------------------------------------
# the kernel's algebra, emulated
# ---------------------------------------------------------------------------


def _walk(cur, *, span, bs, window, keep_row=None, dense=False):
    """The kernel's walked positions of one (slot, kv head): -1 for rows
    past ``last`` (inside the last kept block)."""
    last = min(cur, span - 1)
    lo = max(0, cur - window + 1) if window > 0 else 0
    if not dense:
        lo = lo // bs * bs
    if keep_row is not None:
        kept = [t for t in range(len(keep_row))
                if t * bs <= last and keep_row[t]]
        pos = [kept[i // bs] * bs + i % bs for i in range(len(kept) * bs)]
    else:
        pos = list(range(lo, last + 1))
    return [p if p <= last else -1 for p in pos]


def _emulate(q, walks, rows, curs, window, splits, partials=None):
    """The split kernel and its combine on the CPU.  ``walks[b][h]``: the
    walked positions; ``rows(b, h, pos)``: their K and V rows as f32 (n, D)
    (zeros at -1), already rounded as the kernel stages them."""
    B, Hq, D = q.shape
    Hkv = len(walks[0])
    G = Hq // Hkv
    out = torch.empty_like(q)
    for b in range(B):
        cur = int(curs[b])
        for h in range(Hkv):
            pos = torch.tensor(walks[b][h], dtype=torch.int64)
            K, V = rows(b, h, pos.tolist())
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s in range(splits):
                lo, hi = decode_split.split_slice(len(pos), splits, s)
                m = torch.full((G,), NEG)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for i0 in range(lo, hi, KT):
                    i1 = min(i0 + KT, hi)
                    p = pos[i0:i1]
                    exists = p >= 0
                    sc = (qg @ K[i0:i1].T) * (1.0 / math.sqrt(D))
                    ok = exists & ((window <= 0) | (p > cur - window))
                    sc = torch.where(ok, sc, torch.tensor(NEG))
                    m_new = torch.maximum(m, torch.where(
                        exists, sc, torch.tensor(-math.inf)).amax(-1))
                    pe = torch.where(exists, torch.exp(sc - m_new[:, None]),
                                     torch.tensor(0.0))
                    corr = torch.exp(m - m_new)
                    l = l * corr + pe.sum(-1)
                    acc = acc * corr[:, None] \
                        + pe.to(q.dtype).float() @ V[i0:i1]
                    m = m_new
                parts.append((m, l, acc))
            if partials is not None:
                partials[(b, h)] = parts
            if splits == 1:
                o = acc / torch.clamp(l, min=1e-30)[:, None]
            else:
                M = torch.stack([m for m, _, _ in parts]).amax(0)
                num, den = torch.zeros(G, D), torch.zeros(G)
                for m, l, acc in parts:          # split order
                    c = torch.exp(m - M)
                    num = num + c[:, None] * acc
                    den = den + c * l
                o = num / torch.clamp(den, min=1e-30)[:, None]
            out[b, h * G:(h + 1) * G] = o.to(q.dtype)
    return out


def _paged_rows(pages, tables, scales=None, dtype=None,
                k_row=None, curs=None):
    """rows(b, h, pos) over a block table: float pages as they are, packed
    pages as round_to<T>(x * scale), the current row from ``k_row``."""
    bs = pages.shape[1]

    def rows(b, h, pos):
        out = torch.zeros(len(pos), pages.shape[-1])
        for i, p in enumerate(pos):
            if p < 0:
                continue
            if k_row is not None and p == int(curs[b]):
                out[i] = k_row[b, h].float()
                continue
            blk = int(tables[b, p // bs])
            x = pages[blk, p % bs, h].float()
            if scales is not None:
                x = (x * scales[blk, h]).to(dtype).float()
            out[i] = x
        return out
    return rows


def _kv(krows, vrows):
    return lambda b, h, pos: (krows(b, h, pos), vrows(b, h, pos))


def _pool(seed, lens, bs, Hkv, D):
    """numpy pool and tables covering ``lens`` tokens a slot (a slot of
    length 0 keeps its table on null block 0: an inactive slot, cur 0)."""
    rng = np.random.default_rng(seed)
    T = max(-(-n // bs) for n in lens) + 1
    N = 1 + T * len(lens)
    kp = rng.standard_normal((N, bs, Hkv, D), np.float32) \
        + rng.standard_normal((N, 1, Hkv, D), np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D), np.float32)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        for t in range(-(-n // bs)):
            tables[b, t] = free.pop()
    return kp, vp, tables


def _t(x, dtype=None):
    return to_torch(x, "cpu", dtype)


def _split_counts(walk):
    tiles = -(-walk // KT)
    return {"one": 1, "two": 2,
            "plan": decode_split.plan(3, 2, walk, H100_SMS),
            "over": tiles + 3}


def _check(got, want, tol):
    """``got`` against a torch or JAX output, at ``tol`` abs + rel."""
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# slot lengths: an inactive slot (cur 0 on null block 0), ragged, and one
# across two tiles
LENS = [0, 40, 70]
BS, HQ, HKV, D = 16, 4, 2, 32


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["one", "two", "plan", "over"])
def test_split_float_pages(mode, dtype, window):
    kp, vp, tables = _pool(0, LENS, BS, HKV, D)
    q = np.random.default_rng(1).standard_normal((3, HQ, D), np.float32)
    cur = np.asarray([max(n - 1, 0) for n in LENS], np.int32)
    tq, tk, tv = _t(q, dtype), _t(kp, dtype), _t(vp, dtype)
    tt, tc = _t(tables), _t(cur)
    span = tables.shape[1] * BS
    walks = [[_walk(int(c), span=span, bs=BS, window=window)
              for _ in range(HKV)] for c in cur]
    got = _emulate(tq, walks, _kv(_paged_rows(tk, tt), _paged_rows(tv, tt)),
                   cur, window, _split_counts(span)[mode])
    want = pa_ref.paged_decode_attention(tq, tk, tv, tt, tc, window=window)
    _check(got, want, TOL[dtype])
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jwant = jpa_ref.paged_decode_attention(
        jnp.asarray(q).astype(jd), jnp.asarray(kp).astype(jd),
        jnp.asarray(vp).astype(jd), jnp.asarray(tables), jnp.asarray(cur),
        window=window)
    _check(got, jwant, TOL[dtype])


@pytest.mark.parametrize("keep_kind", ["none", "model", "only-current"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["one", "plan", "over"])
def test_split_packed_pages(mode, kind, dtype, keep_kind):
    kp, vp, tables = _pool(2, LENS, BS, HKV, D)
    kq, ks = JKV.quantize_kv(jnp.asarray(kp), kind)
    vq, vs = JKV.quantize_kv(jnp.asarray(vp), kind)
    rng = np.random.default_rng(3)
    q, k_row, v_row = (rng.standard_normal(s, np.float32) for s in
                       ((3, HQ, D), (3, HKV, D), (3, HKV, D)))
    cur = np.asarray([max(n - 1, 0) for n in LENS], np.int32)
    tq, tkr, tvr = _t(q, dtype), _t(k_row, dtype), _t(v_row, dtype)
    tkq, tvq, tks, tvs = _t(kq), _t(vq), _t(ks), _t(vs)
    tt, tc = _t(tables), _t(cur)
    T = tables.shape[1]
    keep = None
    if keep_kind == "model":
        keep = pa_ref.block_keep_mask(tq, tkq, tt, tc, threshold=0.25,
                                      k_scales=tks)
    elif keep_kind == "only-current":
        valid = pa_ref.valid_blocks(tc, T, BS)
        keep = ((torch.arange(T)[None, :] == (tc[:, None] // BS)) & valid
                )[:, None, :].expand(-1, HKV, -1).contiguous()
    rows = keep_kind != "none"          # the model path's current rows
    span = T * BS
    walks = [[_walk(int(c), span=span, bs=BS, window=0,
                    keep_row=None if keep is None else keep[b, h].tolist())
              for h in range(HKV)] for b, c in enumerate(cur)]
    kr = dict(k_row=tkr, curs=cur) if rows else {}
    vr = dict(k_row=tvr, curs=cur) if rows else {}
    got = _emulate(tq, walks, _kv(
        _paged_rows(tkq, tt, scales=tks, dtype=dtype, **kr),
        _paged_rows(tvq, tt, scales=tvs, dtype=dtype, **vr)),
        cur, 0, _split_counts(span)[mode])
    want = pa_ref.paged_decode_attention_quant(
        tq, tkq, tvq, tks, tvs, tt, tc, keep=keep,
        **(dict(k_row=tkr, v_row=tvr) if rows else {}))
    _check(got, want, TOL[dtype])
    # the JAX oracle: f32 dequantized view, the row placed at cur, keep as
    # a per-position head mask
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kd = jpa_ref._dequant_gather(kq, ks, jnp.asarray(tables), jnp.float32)
    vd = jpa_ref._dequant_gather(vq, vs, jnp.asarray(tables), jnp.float32)
    head_keep = None
    if rows:
        b_idx = np.arange(3)
        kd = kd.at[b_idx, cur].set(jnp.asarray(k_row).astype(jd)
                                   .astype(jnp.float32))
        vd = vd.at[b_idx, cur].set(jnp.asarray(v_row).astype(jd)
                                   .astype(jnp.float32))
        head_keep = jnp.repeat(jnp.asarray(keep.numpy()), BS, axis=-1)
    jwant = jpa_ref._attend(jnp.asarray(q).astype(jd), kd, vd,
                            jnp.asarray(cur), 0, head_keep=head_keep)
    _check(got, jwant, TOL[dtype] if dtype == torch.float32 else QTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["model", "half", "only-current"])
@pytest.mark.parametrize("mode", ["one", "plan", "over"])
def test_split_sparse_pages(mode, mask, dtype):
    window = 40
    kp, vp, tables = _pool(4, LENS, BS, HKV, D)
    q = np.random.default_rng(5).standard_normal((3, HQ, D), np.float32)
    cur = np.asarray([max(n - 1, 0) for n in LENS], np.int32)
    tq, tk, tv = _t(q, dtype), _t(kp, dtype), _t(vp, dtype)
    tt, tc = _t(tables), _t(cur)
    T = tables.shape[1]
    valid = pa_ref.valid_blocks(tc, T, BS, window)[:, None, :].expand(
        -1, HKV, -1)
    current = (torch.arange(T)[None, None, :] == (tc[:, None, None] // BS)
               ) & valid
    if mask == "model":
        keep = pa_ref.block_keep_mask(tq, tk, tt, tc, threshold=0.25,
                                      window=window)
    elif mask == "half":
        half = torch.as_tensor(np.random.default_rng(6).random(
            (3, HKV, T)) < 0.5)
        keep = (half & valid) | current
    else:
        keep = current.clone()
    span = T * BS
    walks = [[_walk(int(c), span=span, bs=BS, window=window,
                    keep_row=keep[b, h].tolist())
              for h in range(HKV)] for b, c in enumerate(cur)]
    got = _emulate(tq, walks, _kv(_paged_rows(tk, tt), _paged_rows(tv, tt)),
                   cur, window, _split_counts(span)[mode])
    want = pa_ref.paged_decode_attention_sparse(tq, tk, tv, tt, tc,
                                                window=window, keep=keep)
    _check(got, want, TOL[dtype])
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jk, jv = (jnp.asarray(a).astype(jd)[jnp.asarray(tables)].reshape(
        3, span, HKV, D) for a in (kp, vp))
    jwant = jpa_ref._attend(jnp.asarray(q).astype(jd), jk, jv,
                            jnp.asarray(cur), window,
                            head_keep=jnp.repeat(jnp.asarray(keep.numpy()),
                                                 BS, axis=-1))
    _check(got, jwant, TOL[dtype])


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["one", "two", "plan", "over"])
def test_split_dense_slab(mode, dtype, window):
    B, S = 3, 77
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, HQ, D), np.float32)
    k = rng.standard_normal((B, S, HKV, D), np.float32)
    v = rng.standard_normal((B, S, HKV, D), np.float32)
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for cur in (np.asarray(45, np.int32), np.asarray([0, 31, 76], np.int32)):
        curs = np.broadcast_to(cur, (B,))
        walks = [[_walk(int(c), span=S, bs=1, window=window, dense=True)
                  for _ in range(HKV)] for c in curs]

        def rows(b, h, pos, x=None):
            return x[b, torch.tensor(pos), h].float()
        got = _emulate(tq, walks, lambda b, h, pos: (
            rows(b, h, pos, tk), rows(b, h, pos, tv)), curs, window,
            _split_counts(S)[mode])
        _check(got, fd_ref.decode_attention(tq, tk, tv, _t(cur),
                                            window=window), TOL[dtype])
        if cur.ndim == 0:                # the JAX oracle takes a scalar
            jwant = jfd_ref.decode_attention(
                jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                jnp.asarray(v).astype(jd), jnp.asarray(cur), window=window)
            _check(got, jwant, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_masked_and_empty_slices(dtype):
    """bs = 64 and a 16-row window: the first block's walk starts at 0, so
    the first tile of slot 0 (cur 70) has only masked rows: its slice keeps
    m = -1e30 with l = 32 (each masked row weighs exp(0) against its own
    max) and the combine gives it weight exp(-1e30 - M) = 0.  With more
    splits than tiles the last slices are empty: m = -1e30, l = 0, acc = 0
    exactly."""
    bs, window = 64, 16
    kp, vp, tables = _pool(8, [71, 5], bs, HKV, D)
    q = np.random.default_rng(9).standard_normal((2, HQ, D), np.float32)
    cur = np.asarray([70, 4], np.int32)
    tq, tk, tv = _t(q, dtype), _t(kp, dtype), _t(vp, dtype)
    tt, tc = _t(tables), _t(cur)
    span = tables.shape[1] * bs
    walks = [[_walk(int(c), span=span, bs=bs, window=window)
              for _ in range(HKV)] for c in cur]
    assert len(walks[0][0]) == 71            # 3 tiles, the first all masked
    want = pa_ref.paged_decode_attention(tq, tk, tv, tt, tc, window=window)
    for splits in (3, 7):
        parts = {}
        got = _emulate(tq, walks, _kv(_paged_rows(tk, tt),
                                      _paged_rows(tv, tt)),
                       cur, window, splits, partials=parts)
        assert torch.isfinite(got.float()).all()
        _check(got, want, TOL[dtype])
        m0, l0, _ = parts[(0, 0)][0]
        assert (m0 == NEG).all() and (l0 == KT).all()
        for m, l, acc in parts[(1, 0)][1:]:   # slot 1: one tile, rest empty
            assert (m == NEG).all() and (l == 0).all() and (acc == 0).all()

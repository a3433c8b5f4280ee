"""The launch plan of the port's conv2d kernels (``kernels/conv2d/plan.py``)
and the arithmetic of the tensor-core kernel, emulated.

The kernels (``kernels/csrc/conv2d.cu``) run only on a card; the plan that
picks their route, column tile and R split is a function of shapes, dtype
and operand addresses alone, and is held here:

* every conv of ResNet-50, GoogLeNet and VGG-16 at 224 takes the tensor
  cores in both dtypes, except the three C = 3 stems: the warpgroup route
  (``wgmma``) where TMA reads x in whole 128-byte channel lines and the
  shape is past the measured crossing (``wgmma_wins``), ``mma`` where
  not; any operand ``cp.async`` cannot stage in 16-byte chunks (C not a
  multiple of 8 in bf16 or 4 in f32, Cout not a multiple of 8, an address
  off a 16-byte boundary) takes the CUDA cores (``cuda_core``), and
  forcing ``mma`` on it raises, as forcing ``wgmma`` on what TMA cannot
  read does;
* the R ranges of a split cover every depth row exactly once, in order,
  none empty, each (but the last) whole depth steps;
* the workspace is (splits, M, K) f32 when the plan splits, else nothing,
  and ``wgmma`` in f32 adds R * K f32 slots for the weights' bf16 halves;
* the arithmetic: a torch emulation of what ``conv_mma`` computes (the same
  gather of A from the padded input by row base + tap offset, B the HWIO
  weight as an (R, K) matrix, f32 as three bf16 passes a_lo*b_hi +
  a_hi*b_lo + a_hi*b_hi, bf16 as one, split-R partials added in split
  order and rounded once) against the JAX package's ``ref.conv2d`` and
  ``conv2d_pallas`` in interpret mode, on inputs made with numpy, at
  ``tests/test_kernels.py``'s four shapes and a 3x3 conv with C = 512, at
  the reference's tolerances (2e-4 fp32, 3e-2 bf16).  One bf16 pass on
  f32 inputs breaks 2e-4 there: that is why f32 takes three.
"""
from collections import Counter
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import ops as jconv_ops
from repro.kernels.conv2d import ref as jconv_ref
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d import plan as P
from repro_torch.profiling.conv2d_ab import conv_shapes

H100_SMS = 132
NETS = ("resnet50", "googlenet", "vgg16")


@lru_cache(maxsize=None)
def _net_convs(name):
    """{(H, Cin, Cout, k, stride): calls} of one forward at 224."""
    return conv_shapes(name)


def _dims(batch, H, C, K, k, s):
    """(M, K, R) of a SAME conv on an H x H input."""
    Ho = -(-H // s)
    return batch * Ho * Ho, K, k * k * C


def _plan(M, K, R, bf16=True, C=64, x_off=0, w_off=0, k=None, s=1, **kw):
    """The plan for operands at 16-byte (or offset) addresses; with the
    window ``k`` given, TMA's legality too (else ``wgmma`` is not open)."""
    tma = k is not None and P.tma_legal(C, K, k, k, s, 4096 + x_off,
                                        8192 + w_off, bf16=bf16)
    return P.plan(M, K, R, bf16=bf16,
                  is_aligned=P.aligned(C, K, 4096 + x_off, 8192 + w_off,
                                       bf16=bf16),
                  tma=tma, n_sm=H100_SMS, **kw)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


def test_net_conv_shapes_are_the_op_tables():
    counts = {n: (len(_net_convs(n)), sum(_net_convs(n).values()))
              for n in NETS}
    assert counts == {"resnet50": (20, 53), "googlenet": (49, 57),
                      "vgg16": (9, 13)}


# each net's convs a forward at batch 64, by route (fp32 is the CNN
# forward's dtype on the card: chip_smoke.py's CNN_CONV_ROUTES)
ROUTES_AT_64 = {
    ("resnet50", True): {"wgmma": 52, "cuda_core": 1},
    ("resnet50", False): {"wgmma": 47, "mma": 5, "cuda_core": 1},
    ("googlenet", True): {"wgmma": 33, "mma": 23, "cuda_core": 1},
    ("googlenet", False): {"wgmma": 44, "mma": 12, "cuda_core": 1},
    ("vgg16", True): {"wgmma": 12, "cuda_core": 1},
    ("vgg16", False): {"wgmma": 12, "cuda_core": 1},
}


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("name", NETS)
def test_every_conv_but_the_stem_takes_mma(name, bf16):
    """Each conv's route, at batch 1, 2 and 64: the tensor cores for all
    but the C = 3 stem, ``wgmma`` where TMA reads the operands and the
    crossing says so, ``mma`` elsewhere (the name predates ``wgmma``:
    "mma" here is either tensor-core route)."""
    taken = Counter()
    for (H, C, K, k, s), n in _net_convs(name).items():
        for batch in (1, 2, 64):
            M, K_, R = _dims(batch, H, C, K, k, s)
            p = _plan(M, K_, R, bf16=bf16, C=C, k=k, s=s)
            tma = P.tma_legal(C, K, k, k, s, bf16=bf16)
            want = ("cuda_core" if C == 3 else "wgmma"
                    if tma and P.wgmma_wins(M, K_, R, bf16=bf16) else "mma")
            assert p.route == want, (H, C, K, k, s, batch)
            if p.route == "mma":
                assert (p.bm, p.bn) == (P.MMA_BM, P.mma_bn(K))
            if p.route == "wgmma":
                assert (p.bm, p.bn) == (
                    P.WG_BM, P.wg_bn(M, K_, R, bf16, H100_SMS))
        taken[p.route] += n
    assert taken == Counter(ROUTES_AT_64[name, bf16])


@pytest.mark.parametrize("K,bn", [(16, 64), (24, 64), (64, 64), (96, 128),
                                  (128, 128), (192, 64), (208, 128),
                                  (256, 128), (320, 64), (2048, 128)])
def test_column_tile_pads_least(K, bn):
    assert P.mma_bn(K) == bn


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("C,K,x_off,w_off", [
    (3, 64, 0, 0),           # the stems
    (6, 64, 0, 0),           # 6 % 4 != 0
    (12, 64, 0, 0),          # 12 % 8 != 0: bf16 only
    (64, 70, 0, 0),          # Cout not a multiple of 8
    (64, 20, 0, 0),
    (64, 64, 2, 0),          # x one bf16 off a 16-byte boundary
    (64, 64, 0, 8),          # w half a chunk off
    (64, 64, 4, 4),
])
def test_misaligned_operands_take_the_cuda_cores(C, K, x_off, w_off, bf16):
    ok = P.aligned(C, K, 4096 + x_off, 8192 + w_off, bf16=bf16)
    expected = (C % (8 if bf16 else 4) == 0 and K % 8 == 0
                and x_off % 16 == 0 and w_off % 16 == 0)
    assert ok == expected
    M, _, R = _dims(2, 28, C, K, 3, 1)
    p = _plan(M, K, R, bf16=bf16, C=C, x_off=x_off, w_off=w_off)
    assert p.route == ("mma" if ok else "cuda_core")
    if not ok:
        with pytest.raises(ValueError, match="mma route"):
            _plan(M, K, R, bf16=bf16, C=C, x_off=x_off, w_off=w_off,
                  route="mma")


def test_forced_routes_and_bad_requests():
    M, K, R = _dims(2, 14, 256, 256, 3, 1)
    assert _plan(M, K, R, route="cuda_core") == \
        P.Plan("cuda_core", P.CC_BM, P.CC_BN, 1, R)
    # the CUDA-core kernel does not split R: a forced count is held to 1
    assert _plan(M, K, R, route="cuda_core", splits=7).splits == 1
    assert _plan(M, K, R, bn=64).bn == 64
    assert _plan(M, K, R, k=3, route="wgmma", bn=128).bn == 128
    with pytest.raises(ValueError, match="unknown route"):
        _plan(M, K, R, route="tma")
    with pytest.raises(ValueError, match="wgmma route"):
        _plan(M, K, R, route="wgmma")        # TMA's legality not given
    with pytest.raises(ValueError, match="wgmma route's bn"):
        _plan(M, K, R, k=3, route="wgmma", bn=32)
    with pytest.raises(ValueError, match="splits"):
        _plan(M, K, R, splits=0)
    with pytest.raises(ValueError, match="bn must be"):
        _plan(M, K, R, bn=32)
    with pytest.raises(ValueError, match="cuda_core route's tile"):
        _plan(M, K, R, route="cuda_core", bn=128)
    with pytest.raises(ValueError, match="empty"):
        _plan(0, K, R)


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("C,K,k,s,x_off,w_off", [
    (64, 64, 3, 1, 0, 0),      # a whole bf16 line
    (32, 64, 3, 1, 0, 0),      # a whole f32 line, half a bf16 one
    (96, 128, 1, 2, 0, 0),
    (48, 64, 5, 1, 0, 0),      # GoogLeNet's 48: neither
    (24, 64, 5, 1, 0, 0),
    (3, 64, 7, 2, 0, 0),       # the stems
    (64, 70, 3, 1, 0, 0),      # Cout not a multiple of 8
    (64, 64, 3, 9, 0, 0),      # past TMA's traversal stride
    (64, 64, 3, 8, 0, 0),
    (64, 64, 3, 1, 16, 0),     # x a line later: still 16-byte aligned
    (64, 64, 3, 1, 8, 0),      # x off 16 bytes
    (64, 64, 3, 1, 0, 4),      # w off 16 bytes
])
def test_wgmma_takes_whole_tma_lines(C, K, k, s, x_off, w_off, bf16):
    ok = P.tma_legal(C, K, k, k, s, 4096 + x_off, 8192 + w_off, bf16=bf16)
    expected = (C % (64 if bf16 else 32) == 0 and K % 8 == 0 and s <= 8
                and x_off % 16 == 0 and w_off % 16 == 0)
    assert ok == expected
    M, _, R = _dims(2, 28, C, K, k, s)
    p = _plan(M, K, R, bf16=bf16, C=C, x_off=x_off, w_off=w_off, k=k, s=s)
    if ok:
        assert p.route == ("wgmma" if P.wgmma_wins(M, K, R, bf16=bf16)
                           else "mma")
    else:
        assert p.route != "wgmma"
        with pytest.raises(ValueError, match="wgmma route"):
            _plan(M, K, R, bf16=bf16, C=C, x_off=x_off, w_off=w_off, k=k,
                  s=s, route="wgmma")
    # a line is whole in both dtypes or in f32 alone: a bf16-legal conv
    # is f32-legal too
    if bf16 and ok:
        assert P.tma_legal(C, K, k, k, s, 4096 + x_off, 8192 + w_off,
                           bf16=False)


@pytest.mark.parametrize("K,M,R,bns", [  # (bf16, f32)
    (64, 200_704, 576, (64, 64)),    # Cout <= 64: two 64-column CTAs
    (48, 512, 4_608, (64, 64)),
    (72, 512, 4_608, (128, 128)),    # 56 padded columns, 184 at 256
    (136, 512, 4_608, (128, 128)),   # padding ties; 16 CTAs of half depth
    (256, 200_704, 64, (128, 256)),  # ties: bf16's shallow 1x1 at 128
    (512, 50_176, 128, (128, 256)),
    (1_024, 12_544, 256, (128, 256)),
    (256, 12_544, 1_024, (256, 256)),
    (384, 12_544, 4_608, (128, 128)),  # 0 padded at 128, 128 at 256
    (512, 3_136, 4_608, (256, 256)),   # ResNet-50's 7x7 3x3: split in two
    (512, 3_136, 2_048, (128, 128)),   # its 2048 -> 512 1x1: 100 CTAs
    (256, 12_544, 2_304, (256, 256)),  # its 14x14 3x3: one round either way
    (2_048, 3_136, 512, (256, 256)),
])
def test_wgmma_column_tile(K, M, R, bns):
    """The widths the sweep of ``chip_smoke.py --only conv2d`` found
    fastest at ResNet-50's stages, and the tie-breaks between them."""
    for bf16, bn in zip((True, False), bns):
        assert P.wg_bn(M, K, R, bf16, H100_SMS) == bn, bf16


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("M,K,R", [
    (3_136, 512, 4_608), (3_136, 2_048, 512), (12_544, 256, 2_304),
    (200_704, 64, 64), (162, 72, 576), (49, 64, 6_272),
])
def test_wgmma_splits_and_scratch(M, K, R, bf16):
    """wgmma's split: whole 128-byte steps, every depth row once, as
    many ranges as fit beside the tiles one CTA an SM; its f32 scratch
    holds the partials, then the weights' bf16 halves in f32."""
    bk = P.WG_BK[bf16]
    for splits in (None, 1, 2, 3, 7, 10_000):
        p = P.plan(M, K, R, bf16=bf16, is_aligned=True, tma=True,
                   n_sm=H100_SMS, route="wgmma", splits=splits)
        ranges = p.ranges(R)
        assert p.bm == P.WG_BM and p.bn in P.WG_BNS
        assert ranges[0][0] == 0 and ranges[-1][1] == R
        assert all(lo % bk == 0 and hi > lo for lo, hi in ranges)
        assert p.rows * p.splits >= R > p.rows * (p.splits - 1)
        if splits is None:
            tiles = -(-M // P.WG_BM) * -(-K // p.bn)
            slots = P.WG_CTAS[p.bn, bf16] * H100_SMS
            assert tiles * p.splits <= max(tiles, slots)
            assert p.splits == 1 or p.rows >= P.WG_SPLIT_ROWS
        assert P.workspace_shape(p, M, K) == (
            (p.splits, M, K) if p.splits > 1 else (0,))
        assert P.weights_scratch(p, R, K, bf16=bf16) == (0 if bf16
                                                         else R * K)
    mma = P.plan(M, K, R, bf16=bf16, is_aligned=True, n_sm=H100_SMS)
    assert mma.route == "mma"
    assert P.weights_scratch(mma, R, K, bf16=bf16) == 0


# ---------------------------------------------------------------------------
# splits and the workspace
# ---------------------------------------------------------------------------

SPLIT_SHAPES = sorted({_dims(b, H, C, K, k, s)
                       for (H, C, K, k, s) in _net_convs("resnet50")
                       for b in (2, 64)} | {(3, 70, 600), (200, 8, 8),
                                            (130, 24, 4608), (1, 8, 72)})


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("M,K,R", SPLIT_SHAPES)
def test_splits_cover_every_depth_row_once(M, K, R, bf16):
    bk = P.MMA_BK[bf16]
    for splits in (None, 1, 2, 3, 7, 64, 10_000):
        p = _plan(M, K, R, bf16=bf16, splits=splits)
        ranges = p.ranges(R)
        assert len(ranges) == p.splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == R
        for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
            assert hi == nlo                        # contiguous, in order
        assert all(hi > lo for lo, hi in ranges)    # none empty
        assert all(hi - lo <= p.rows for lo, hi in ranges)
        if splits is not None:
            assert p.splits <= splits
        if p.splits > 1:                            # whole depth steps
            assert p.rows % bk == 0
        # what csrc/conv2d.cu's conv_run checks before it launches
        assert p.rows * p.splits >= R > p.rows * (p.splits - 1)
        ws = P.workspace_shape(p, M, K)
        assert ws == ((p.splits, M, K) if p.splits > 1 else (0,))


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("M,K,R", SPLIT_SHAPES)
def test_split_fills_the_cta_slots_within_its_limits(M, K, R, bf16):
    p = _plan(M, K, R, bf16=bf16)
    if K % 8:                                   # the CUDA cores: no split
        assert (p.route, p.splits) == ("cuda_core", 1)
        return
    bk = P.MMA_BK[bf16]
    tiles = -(-M // p.bm) * -(-K // p.bn)
    want = P.CTAS_PER_SM * H100_SMS // tiles
    target = max(1, min(want, R // (P.MMA_MIN_STEPS * bk),
                        P.WS_MAX_BYTES // (4 * M * K)))
    assert p.splits <= target
    assert 1.25 * p.splits + 1 >= target   # whole steps cost a quarter
    if p.splits > 1:
        assert tiles * p.splits <= P.CTAS_PER_SM * H100_SMS
        assert p.splits * M * K * 4 <= P.WS_MAX_BYTES
        assert p.rows >= P.MMA_MIN_STEPS * bk


def test_resnet50_deep_stages_split_at_batch_64():
    """The 7x7 stage's 100 output tiles (25 row tiles x 4 column tiles)
    leave most of the 264 CTA slots idle: its 3x3 conv splits R; the 14x14
    stage's 196 tiles do not."""
    assert _plan(*_dims(64, 7, 512, 512, 3, 1), bf16=False).splits == 2
    assert _plan(*_dims(64, 14, 256, 256, 3, 1), bf16=False).splits == 1


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _gather(xp, w, stride):
    """A (M, R) and B (R, K) as conv_mma stages them: each row m's corner
    in the flat padded input (the row-base table) plus each depth row r's
    tap offset ((i * Wp + j) * C + c)."""
    N, Hp, Wp, C = xp.shape
    kh, kw, _, K = w.shape
    M, _, R, Ho, Wo = P.gemm_dims(xp.shape, w.shape, stride)
    m = torch.arange(M)
    n, rem = m // (Ho * Wo), m % (Ho * Wo)
    ho, wo = rem // Wo, rem % Wo
    rowbase = n * Hp * Wp * C + (ho * stride * Wp + wo * stride) * C
    r = torch.arange(R)
    t, c = r // C, r % C
    i, j = t // kw, t % kw
    tap = (i * Wp + j) * C + c
    A = xp.reshape(-1)[rowbase[:, None] + tap[None, :]]
    return A, w.reshape(R, K)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulate(xp, w, stride, p, passes=None):
    """conv_mma's result: per split range an f32 sum of bf16 products
    (f32 inputs: three passes, or ``passes=1`` for one), the ranges'
    partials added in split order, rounded once to the input dtype."""
    A, B = _gather(xp, w, stride)
    A, B = A.float(), B.float()
    three = xp.dtype == torch.float32 and passes != 1
    acc = None
    for lo, hi in p.ranges(A.shape[1]):
        a, b = A[:, lo:hi], B[lo:hi]
        ah, bh = _bf16(a), _bf16(b)
        part = ah @ bh
        if three:
            al, bl = _bf16(a - ah), _bf16(b - bh)
            part = al @ bh + ah @ bl + part
        acc = part if acc is None else acc + part
    M, K, _, Ho, Wo = P.gemm_dims(xp.shape, w.shape, stride)
    return acc.reshape(xp.shape[0], Ho, Wo, K).to(xp.dtype)


EMU_SHAPES = [  # N, H, W, C, K, kh, stride
    (2, 16, 16, 32, 64, 3, 1),       # tests/test_kernels.py's four
    (2, 16, 16, 32, 64, 3, 2),
    (1, 14, 14, 16, 32, 1, 1),
    (1, 12, 12, 8, 16, 5, 2),
    (1, 6, 6, 512, 16, 3, 1),        # R = 4,608, ResNet-50's deepest 3x3
]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(shape, dtype):
    N, H, W, C, K, kh, _ = shape
    rng = np.random.default_rng(N * H * C + K + kh)
    x = rng.standard_normal((N, H, W, C), np.float32)
    w = (rng.standard_normal((kh, kh, C, K), np.float32)
         * np.sqrt(2.0 / (kh * kh * C))).astype(np.float32)
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    return jx, jw, tx, tw


@lru_cache(maxsize=None)
def _jax_refs(shape, dtype):
    """The JAX package's oracle and its Pallas kernel (interpret mode) on
    the shape's inputs, SAME padding, as float32 numpy."""
    jx, jw, _, _ = _inputs(shape, dtype)
    stride = shape[-1]
    return (np.asarray(jconv_ref.conv2d(jx, jw, stride=stride), np.float32),
            np.asarray(jconv_ops.conv2d(jx, jw, stride=stride,
                                        padding="SAME", tk=shape[4],
                                        interpret=True), np.float32))


@pytest.mark.parametrize("splits", (None, 1, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_emulated_kernel_vs_jax(shape, dtype, splits):
    _, _, tx, tw = _inputs(shape, dtype)
    kh, stride = shape[5], shape[6]
    xp = conv_ops.pad_same(tx, kh, kh, stride)
    M, K, R, _, _ = P.gemm_dims(xp.shape, tw.shape, stride)
    p = _plan(M, K, R, bf16=dtype == "bfloat16", C=shape[3], splits=splits)
    assert p.route == "mma"
    got = _emulate(xp, tw, stride, p)
    assert got.dtype == tx.dtype
    ref, pallas = _jax_refs(shape, dtype)
    assert tuple(got.shape) == ref.shape
    for want in (ref, pallas):
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_one_bf16_pass_breaks_the_f32_tolerance():
    """At R = 4,608 a single bf16 pass on f32 inputs misses the reference
    by far more than 2e-4; the three passes stay well inside it."""
    shape = EMU_SHAPES[-1]
    _, _, tx, tw = _inputs(shape, "float32")
    xp = conv_ops.pad_same(tx, 3, 3, 1)
    p = _plan(*P.gemm_dims(xp.shape, tw.shape, 1)[:3], bf16=False)
    ref, _ = _jax_refs(shape, "float32")
    lim = 2e-4 + 2e-4 * np.abs(ref)
    one = np.abs(_emulate(xp, tw, 1, p, passes=1).numpy() - ref)
    three = np.abs(_emulate(xp, tw, 1, p).numpy() - ref)
    assert (one / lim).max() > 5
    assert (three / lim).max() < 0.5

"""The launch plan of the port's conv2d kernels (``kernels/conv2d/plan.py``)
and the arithmetic of the tensor-core kernel, emulated.

The kernels (``kernels/csrc/conv2d.cu``) run only on a card; the plan that
picks their route, column tile and R split is a function of shapes, dtype
and operand addresses alone, and is held here:

* every conv of ResNet-50, GoogLeNet and VGG-16 at 224 takes the
  tensor-core route (``mma``) in both dtypes, except the three C = 3 stems;
  any operand ``cp.async`` cannot stage in 16-byte chunks (C not a multiple
  of 8 in bf16 or 4 in f32, Cout not a multiple of 8, an address off a
  16-byte boundary) takes the CUDA cores (``cuda_core``), and forcing
  ``mma`` on it raises;
* the R ranges of a split cover every depth row exactly once, in order,
  none empty, each (but the last) whole depth steps;
* the workspace is (splits, M, K) f32 when the plan splits, else nothing;
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


def _plan(M, K, R, bf16=True, C=64, x_off=0, w_off=0, **kw):
    return P.plan(M, K, R, bf16=bf16,
                  is_aligned=P.aligned(C, K, 4096 + x_off, 8192 + w_off,
                                       bf16=bf16),
                  n_sm=H100_SMS, **kw)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


def test_net_conv_shapes_are_the_op_tables():
    counts = {n: (len(_net_convs(n)), sum(_net_convs(n).values()))
              for n in NETS}
    assert counts == {"resnet50": (20, 53), "googlenet": (49, 57),
                      "vgg16": (9, 13)}


@pytest.mark.parametrize("bf16", (True, False))
@pytest.mark.parametrize("name", NETS)
def test_every_conv_but_the_stem_takes_mma(name, bf16):
    taken = Counter()
    for (H, C, K, k, s), n in _net_convs(name).items():
        for batch in (1, 2, 64):
            M, K_, R = _dims(batch, H, C, K, k, s)
            p = _plan(M, K_, R, bf16=bf16, C=C)
            assert p.route == ("cuda_core" if C == 3 else "mma"), (H, C, K)
            if p.route == "mma":
                assert (p.bm, p.bn) == (P.MMA_BM, P.mma_bn(K))
        taken[p.route] += n
    assert taken == {"resnet50": {"mma": 52, "cuda_core": 1},
                     "googlenet": {"mma": 56, "cuda_core": 1},
                     "vgg16": {"mma": 12, "cuda_core": 1}}[name]


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
    with pytest.raises(ValueError, match="unknown route"):
        _plan(M, K, R, route="wgmma")
    with pytest.raises(ValueError, match="splits"):
        _plan(M, K, R, splits=0)
    with pytest.raises(ValueError, match="bn must be"):
        _plan(M, K, R, bn=32)
    with pytest.raises(ValueError, match="cuda_core route's tile"):
        _plan(M, K, R, route="cuda_core", bn=128)
    with pytest.raises(ValueError, match="empty"):
        _plan(0, K, R)


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

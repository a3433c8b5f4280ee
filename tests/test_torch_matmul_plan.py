"""The launch plan of the port's matmul kernels (``kernels/matmul/plan.py``).

The kernels (``kernels/csrc/matmul.cu``) run only on a card; the plan that
picks their route, row tile and K split is a function of shapes, dtype and
operand addresses alone, and is held here:

* every qwen2-7b and CNN shape takes its route: bf16 on the tensor cores
  (``mma``) with the least row tile that covers M, f32 on the CUDA cores
  (``skinny`` for M <= 16, ``tiled`` past it); a bf16 operand that
  ``cp.async`` cannot stage in 16-byte chunks (N or K not a multiple of
  8, an address off a 16-byte boundary) takes the tensor cores too,
  staged through its windows (``Plan.staged``, per operand);
* the K ranges of a split cover every K row exactly once, none is empty,
  and on the tensor-core route, staged or not, each starts on a whole K
  step;
* the workspace is (splits, M, N) f32 when the plan splits, else nothing;
* the algebra of a split launch: f32 partial sums of the ranges, added in
  split order and rounded once, against the port's plain version and the
  JAX package's ``ref.py`` at the reference's tolerances (2e-4 fp32, 3e-2
  bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import ref as jmm_ref
from repro_torch.configs import get_config
from repro_torch.kernels.matmul import plan as P
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.models import cnn

H100_SMS = 132
CFG = get_config("qwen2-7b")
# (K, N) of every projection and of the LM head
QWEN = [(CFG.d_model, CFG.n_heads * CFG.head_dim),
        (CFG.d_model, CFG.n_kv_heads * CFG.head_dim),
        (CFG.d_model, CFG.d_ff), (CFG.d_ff, CFG.d_model),
        (CFG.d_model, CFG.vocab)]
DECODE_MS = (1, 2, 4, 8, 15, 16)          # slots at decode
PREFILL_MS = (17, 32, 63, 64, 65, 96, 128, 129, 200)   # slots x prompt


def _cnn_fc(name):
    """(K, N) of each fc layer of the net at 224, from its op table."""
    couts = [op["cout"] for op in cnn.CNN_OPS[name]() if op["kind"] == "fc"]
    fcs = [t for t in cnn.model_traces(name) if t.kind == "fc"]
    return [(int(t.flops_per_img // (2 * c)), c) for t, c in zip(fcs, couts)]


CNN_FC = {name: _cnn_fc(name) for name in ("resnet50", "googlenet", "vgg16")}


def _plan(M, N, K, bf16=True, a_off=0, b_off=0, **kw):
    return P.plan(M, N, K, bf16=bf16,
                  is_aligned=P.aligned(N, K, 4096 + a_off, 8192 + b_off),
                  n_sm=H100_SMS, **kw)


def _expected_bm(M):
    return 16 if M <= 16 else 64 if M <= 64 else 128


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", DECODE_MS + PREFILL_MS)
@pytest.mark.parametrize("K,N", QWEN)
def test_qwen_shapes_take_their_route(M, K, N):
    p = _plan(M, N, K)
    assert (p.route, p.bm) == ("mma", _expected_bm(M))
    f = _plan(M, N, K, bf16=False)
    assert f.route == ("skinny" if M <= P.SK_MAXM else "tiled")


def test_cnn_fc_shapes_are_the_op_tables():
    assert CNN_FC == {"resnet50": [(2048, 1000)],
                      "googlenet": [(1024, 1000)],
                      "vgg16": [(25088, 4096), (4096, 4096), (4096, 1000)]}


@pytest.mark.parametrize("name", sorted(CNN_FC))
@pytest.mark.parametrize("M", (2, 64))      # card-vs-CPU batch, the paper's
def test_cnn_fc_shapes_take_their_route(name, M):
    for K, N in CNN_FC[name]:
        # the paper's dtype: f32 on the CUDA cores
        assert _plan(M, N, K, bf16=False).route == \
            ("skinny" if M <= P.SK_MAXM else "tiled")
        if M > P.SK_MAXM:
            assert (_plan(M, N, K).route, _plan(M, N, K).bm) == ("mma", 64)


@pytest.mark.parametrize("M", (1, 4, 16, 17, 64, 128, 200))
@pytest.mark.parametrize("N,K,a_off,b_off", [
    (3584, 3584, 2, 0),      # A one element off a 16-byte boundary
    (3584, 3584, 0, 8),      # B half a chunk off
    (3584, 3584, 14, 14),
    (517, 3584, 0, 0),       # N not a multiple of 8
    (3584, 3583, 0, 0),      # K not a multiple of 8
    (130, 3583, 0, 0),
    (70, 100, 0, 0),         # 100 % 8 == 4
])
def test_unaligned_bf16_takes_the_cuda_cores(M, N, K, a_off, b_off):
    """(The name is the test's first: such operands took the CUDA cores
    until the tensor-core route staged them.)  bf16 operands whose rows
    are not 16-byte aligned take ``mma``, the misaligned ones staged: A
    when K is odd or A is off, B when N is or B is; a forced ``mma``
    agrees, and a forced CUDA-core route refuses them (those routes take
    f32 only); f32 still refuses ``mma``."""
    staged = (K % 8 != 0 or a_off % 16 != 0, N % 8 != 0 or b_off % 16 != 0)
    assert P.aligned(N, K, 4096 + a_off, 8192 + b_off) == (
        not staged[0], not staged[1])
    assert any(staged)
    p = _plan(M, N, K, a_off=a_off, b_off=b_off)
    assert (p.route, p.bm, p.staged) == ("mma", _expected_bm(M), staged)
    assert _plan(M, N, K, a_off=a_off, b_off=b_off, route="mma") == p
    with pytest.raises(ValueError, match="takes f32"):
        _plan(M, N, K, a_off=a_off, b_off=b_off,
              route="skinny" if M <= P.SK_MAXM else "tiled")
    old = _plan(M, N, K, bf16=False, a_off=a_off, b_off=b_off,
                route="skinny" if M <= P.SK_MAXM else "tiled")
    assert old.staged == (False, False)
    with pytest.raises(ValueError, match="mma route"):
        _plan(M, N, K, bf16=False, a_off=a_off, b_off=b_off, route="mma")


@pytest.mark.parametrize("M", DECODE_MS + PREFILL_MS)
def test_f32_never_takes_the_tensor_cores(M):
    for K, N in QWEN + [(1000, 520), (64, 8)]:
        assert _plan(M, N, K, bf16=False).route != "mma"
        with pytest.raises(ValueError, match="mma route"):
            _plan(M, N, K, bf16=False, route="mma")


def test_forced_routes_and_bad_requests():
    f32 = dict(bf16=False)
    assert _plan(4, 3584, 3584, route="skinny", **f32).route == "skinny"
    assert _plan(128, 3584, 3584, route="tiled", **f32).route == "tiled"
    assert _plan(4, 3584, 3584, route="tiled", **f32).route == "tiled"
    # bf16 takes the tensor cores only: a forced CUDA-core route raises
    for M, route in ((4, "skinny"), (128, "tiled"), (4, "tiled")):
        with pytest.raises(ValueError, match=f"the {route} route takes f32"):
            _plan(M, 3584, 3584, route=route)
    with pytest.raises(ValueError, match="skinny route"):
        _plan(17, 3584, 3584, route="skinny", **f32)
    with pytest.raises(ValueError, match="unknown route"):
        _plan(4, 3584, 3584, route="wgmma")
    with pytest.raises(ValueError, match="splits"):
        _plan(4, 3584, 3584, splits=0)
    with pytest.raises(ValueError, match="empty"):
        _plan(0, 3584, 3584)


# ---------------------------------------------------------------------------
# splits and the workspace
# ---------------------------------------------------------------------------

SPLIT_SHAPES = [(M, N, K) for M in (1, 4, 16, 64, 128, 200)
                for K, N in QWEN[:4]] + [
    (4, 1000, 1000), (64, 520, 1000), (128, 520, 1000), (17, 8, 8),
    (5, 130, 3583), (37, 517, 1000), (129, 70, 100)]


@pytest.mark.parametrize("route", ("mma", "skinny", "tiled"))
@pytest.mark.parametrize("M,N,K", SPLIT_SHAPES)
def test_splits_cover_every_k_row_once(M, N, K, route):
    if route == "skinny" and M > P.SK_MAXM:
        route = "tiled"
    for splits in (None, 1, 2, 3, 7, 64, 10_000):
        p = _plan(M, N, K, bf16=route == "mma", splits=splits, route=route)
        ranges = p.ranges(K)
        assert len(ranges) == p.splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
            assert hi == nlo                        # contiguous, no overlap
        assert all(hi > lo for lo, hi in ranges)    # none empty
        assert all(hi - lo <= p.rows for lo, hi in ranges)
        if splits is not None:
            assert p.splits <= splits
        if p.route == "mma" and p.splits > 1:       # whole K steps a range
            assert p.rows % P.MMA_BK[p.bm] == 0     # staged or not
            assert all(lo % P.MMA_BK[p.bm] == 0 for lo, _ in ranges)
        assert p.staged == ((K % 8 != 0, N % 8 != 0) if p.route == "mma"
                            else (False, False))
        # what csrc/matmul.cu's mm_run checks before it launches
        assert p.rows * p.splits >= K > p.rows * (p.splits - 1)


@pytest.mark.parametrize("M,N,K", SPLIT_SHAPES)
def test_workspace_shape(M, N, K):
    for splits in (None, 1, 2, 5):
        p = _plan(M, N, K, splits=splits)
        ws = P.workspace_shape(p, M, N)
        assert ws == ((p.splits, M, N) if p.splits > 1 else (0,))


@pytest.mark.parametrize("M", DECODE_MS + PREFILL_MS)
@pytest.mark.parametrize("K,N", QWEN)
def test_mma_split_fills_the_sms_within_its_limits(M, K, N):
    p = _plan(M, N, K, route="mma")
    tiles = -(-M // p.bm) * -(-N // P.MMA_BN)
    want = H100_SMS // tiles                      # one CTA an SM
    steps_cap = K // (P.MMA_MIN_STEPS * P.MMA_BK[p.bm])
    bytes_cap = K // (2 * M)    # workspace written <= B
    target = max(1, min(want, steps_cap, bytes_cap))
    assert p.splits <= target
    # whole K steps a range cost at most a quarter of the target
    assert 1.25 * p.splits + 1 >= target
    if p.splits > 1:
        assert tiles * p.splits <= H100_SMS
        assert p.splits * M * N * 4 <= K * N * 2
        assert p.rows >= P.MMA_MIN_STEPS * P.MMA_BK[p.bm]


def test_cuda_core_splits_are_the_earlier_kernels():
    """The CUDA-core routes keep the split the kernels had before the
    tensor-core route: about 4 CTAs per SM, at least 64 (skinny) or 256
    (tiled) K rows a split."""
    for M, K, N in ((4, 3584, 3584), (4, 18944, 3584), (4, 3584, 152064),
                    (64, 2048, 1000), (64, 25088, 4096), (128, 3584, 512)):
        p = _plan(M, N, K, bf16=False)
        if M <= P.SK_MAXM:
            tiles, floor = -(-N // P.SK_STRIPE), P.SK_MIN_ROWS
        else:
            tiles = -(-N // P.T_TN) * -(-M // P.T_TM)
            floor = P.T_MIN_ROWS
        want = max(1, min(-(-4 * H100_SMS // tiles), K // floor))
        assert p.rows == -(-K // want)
        assert p.splits == -(-K // p.rows)


# ---------------------------------------------------------------------------
# the algebra of a split launch
# ---------------------------------------------------------------------------


def _split_product(a, b, p):
    """What a split launch computes: per K range an f32 partial product,
    the partials added in split order, rounded once to a's dtype."""
    parts = [a[:, lo:hi].float() @ b[lo:hi].float()
             for lo, hi in p.ranges(a.shape[1])]
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc.to(a.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,splits", [
    (4, 1024, 256, None), (4, 1000, 520, 3), (16, 512, 136, 7),
    (17, 1000, 520, 2), (64, 768, 128, None), (128, 896, 264, 5),
    (129, 100, 70, 2), (5, 3583, 130, 4)])
def test_split_product_vs_plain_and_jax(M, K, N, splits, dtype):
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32) / np.sqrt(K)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    p = _plan(M, N, K, bf16=dtype == "bfloat16", splits=splits)
    got = _split_product(ta, tb, p)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else \
        dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               mm_ref.matmul(ta, tb).float().numpy(), **tol)
    ja = jnp.asarray(a).astype(getattr(jnp, dtype))
    jb = jnp.asarray(b).astype(getattr(jnp, dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jmm_ref.matmul(ja, jb), np.float32),
                               **tol)

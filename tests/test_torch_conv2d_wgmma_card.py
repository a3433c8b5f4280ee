"""The conv2d kernel's warpgroup route (``wgmma``: ``conv_wgmma<T, BN>`` in
``kernels/csrc/conv2d.cu``) on the card.

* TMA's im2col walk: one load read back from shared memory
  (``conv2d.im2col_box``) equals the numpy model of
  ``tests/_torch_wgmma_model.py`` (``walk``, ``im2col``, the 128-byte
  swizzle), bit for bit, at strides 1 and 2, windows 1x1 to 7x7 and 1x3 /
  3x1, boxes that cross output rows and images and run past the last
  image, bf16 and f32.
* the route against the plain version (``ref.conv2d``, cuDNN with TF32
  off) on the same inputs, within 3e-2 (bf16) / 2e-4 (f32) x (1 + |want|): ragged M and
  Cout, both column tiles, forced splits, strides 1 and 2; bit for bit on
  a second launch; a CUDA graph's replay equal to the eager launch; the
  wrapper's count by route.

The kernel has no CPU mode: without a card every case skips.  Run on a
card with ``python -m pytest -q -m card
tests/test_torch_conv2d_wgmma_card.py``.
"""
import math

import numpy as np
import pytest
import torch

from _torch_wgmma_model import PIXELS, im2col, place_lines, walk
from repro_torch.kernels.conv2d import conv2d as cv_k
from repro_torch.kernels.conv2d import ops as cv_ops
from repro_torch.kernels.conv2d import ref as cv_ref

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wgmma kernel runs only there")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False    # the plain version in f32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def _where(xs, row):
    """The (n, h, w) pixels of xs (N, Hp, Wp, ch) whose channels equal
    ``row``: the card's box row traced back to the input (a diagnosis of a
    walk that differs from the model)."""
    if not row.any():
        return "zeros"
    hit = np.argwhere((xs == row).all(axis=-1))
    return [tuple(int(v) for v in h) for h in hit[:2]]


# N, Hp, Wp, kh, kw, stride, C, m0: boxes across rows, images, past M
PROBES = [
    (2, 9, 9, 1, 1, 1, 128, 0), (2, 9, 11, 3, 3, 1, 64, 40),
    (1, 13, 13, 5, 5, 2, 128, 0), (2, 12, 12, 7, 7, 1, 64, 30),
    (1, 14, 14, 1, 1, 2, 256, 0), (3, 8, 8, 3, 3, 2, 64, 5),
    (1, 30, 30, 7, 7, 2, 64, 128), (2, 6, 6, 5, 5, 1, 64, 0),
    (2, 10, 12, 1, 3, 1, 64, 7), (2, 12, 10, 3, 1, 2, 64, 3),
]


@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N,Hp,Wp,kh,kw,s,C,m0", PROBES)
def test_im2col_box_is_the_model(card, dt, N, Hp, Wp, kh, kw, s, C, m0):
    g = torch.Generator(device=card).manual_seed(N * Hp + Wp + kh + m0)
    x = torch.randn((N, Hp, Wp, C), generator=g, device=card).to(dt)
    xs = x.float().cpu().numpy()
    esize = x.element_size()
    ch = 128 // esize
    n, h, w = walk(N, Hp, Wp, kh, kw, s, m0, 1)[0]
    for i, j, c in ((0, 0, 0), (kh - 1, kw - 1, C - ch),
                    (kh // 2, 0, min(ch, C - ch))):
        box = cv_k.im2col_box(x, kh, kw, s, c=c, w=w, h=h, n=n, i=i, j=j)
        got = box.float().cpu().numpy().reshape(-1)
        want = place_lines(im2col(xs, kh, kw, s, m0, c, i, j, ch), esize)
        if not np.array_equal(got, want):
            rows = got[place_lines(np.arange(PIXELS * ch).reshape(
                PIXELS, ch), esize).astype(int).argsort()].reshape(PIXELS, ch)
            trace = [(p, _where(xs[..., c:c + ch], rows[p]))
                     for p in range(0, PIXELS, 9)]
            pytest.fail(f"tap {(i, j)} channels {c}: the card's rows come "
                        f"from {trace}; the model walks "
                        f"{walk(N, Hp, Wp, kh, kw, s, m0)[::9]}")


def _operands(dev, N, H, C, K, k, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, H, H, C), generator=g, device=dev).to(dt)
    w = (torch.randn((k, k, C, K), generator=g, device=dev)
         * math.sqrt(2.0 / (k * k * C))).to(dt)
    return x, w


# N, H, C, K, k, stride, splits, bn
SHAPES = [
    (2, 9, 64, 72, 3, 1, None, None),      # a box over both images
    (1, 12, 128, 136, 1, 2, None, 128),    # 1x1 stride 2, two column tiles
    (2, 7, 64, 264, 5, 1, 2, 256),         # 256 columns, split R
    (1, 13, 128, 64, 7, 2, 3, None),       # 7x7 stride 2, three splits
    (3, 13, 192, 520, 3, 2, None, 256),    # ragged M, Cout past 512
    (64, 7, 512, 512, 3, 1, None, None),   # ResNet-50's last 3x3
    (8, 28, 128, 512, 1, 1, 1, 128),
    (4, 14, 1024, 256, 1, 1, 10_000, None),   # splits past the steps
]


@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N,H,C,K,k,s,splits,bn", SHAPES)
def test_wgmma_matches_its_plain_version(card, dt, N, H, C, K, k, s, splits,
                                         bn):
    x, w = _operands(card, N, H, C, K, k, dt, N + H + C + K)
    xp = cv_ops.pad_same(x, k, k, s)
    p = cv_k.plan_for(xp, w, stride=s, route="wgmma", splits=splits, bn=bn)
    assert p.route == "wgmma" and (bn is None or p.bn == bn)
    got = cv_k.launch(xp, w, p, stride=s)
    want = cv_ref.conv2d(xp, w, stride=s).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    assert bool((err <= TOL[dt] * (1 + want.abs())).all()), float(err.max())
    assert torch.equal(got, cv_k.launch(xp, w, p, stride=s))


@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
def test_a_graph_replay_equals_the_eager_launch(card, dt):
    x, w = _operands(card, 4, 14, 256, 256, 3, dt, 11)
    xp = cv_ops.pad_same(x, 3, 3, 1)
    p = cv_k.plan_for(xp, w, stride=1, route="wgmma", splits=2)
    eager = cv_k.launch(xp, w, p, stride=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cv_k.launch(xp, w, p, stride=1)        # warm: attributes set
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cv_k.launch(xp, w, p, stride=1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.card
def test_the_wrapper_counts_wgmma(card):
    x, w = _operands(card, 2, 14, 256, 256, 3, torch.bfloat16, 7)
    p = cv_k.plan_for(cv_ops.pad_same(x, 3, 3, 1), w)
    assert p.route == "wgmma"
    before = dict(cv_ops.conv2d.routes)
    cv_ops.conv2d(x, w)
    assert cv_ops.conv2d.routes[p.route] == before[p.route] + 1
    assert sum(cv_ops.conv2d.routes.values()) == sum(before.values()) + 1

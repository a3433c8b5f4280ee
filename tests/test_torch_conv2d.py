"""The port's conv2d plain version and wrapper against the JAX package.

``repro_torch.kernels.conv2d.ref.conv2d`` is what the wrapper runs on a CPU
tensor and what ``chip_smoke.py`` holds the CUDA kernel against on the
card.  Here it, and the wrapper ``ops.conv2d`` on the CPU, are held against
the JAX reference's ``ref.conv2d`` and its Pallas kernel in interpret mode
(as ``tests/test_kernels.py`` runs it), on the same inputs made with
numpy, at ``tests/test_kernels.py``'s four shapes and at the asymmetric
SAME paddings the CNNs meet: a 7x7 stride-2 stem on an even input pads
(2, 3), a 1x1 stride-2 conv on an even input pads nothing.  Tolerances are
the reference's own: 2e-4 in fp32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import ops as jconv_ops
from repro.kernels.conv2d import ref as jconv_ref
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d import ref as conv_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

SHAPES = [  # N, H, W, C, K, kh, stride
    (2, 16, 16, 32, 64, 3, 1),
    (2, 16, 16, 32, 64, 3, 2),
    (1, 14, 14, 16, 32, 1, 1),    # pointwise
    (1, 12, 12, 8, 16, 5, 2),
]
ASYMMETRIC = [
    (1, 32, 32, 3, 16, 7, 2),     # ResNet stem on an even input: pads (2, 3)
    (2, 14, 14, 16, 24, 1, 2),    # 1x1 stride 2 on an even input: no pad
]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounding is
    round-to-nearest-even on both sides, so the bits agree)."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return j, t


def _inputs(N, H, W, C, K, kh, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C), np.float32)
    w = rng.standard_normal((kh, kh, C, K), np.float32) * 0.1
    return _pair(x, dtype), _pair(w, dtype)


def _close(t_out, j_out, dtype):
    assert t_out.dtype == getattr(torch, dtype)
    assert tuple(t_out.shape) == tuple(j_out.shape)
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H,W,C,K,kh,stride", SHAPES + ASYMMETRIC)
def test_conv2d_wrapper_vs_ref_and_pallas(N, H, W, C, K, kh, stride, dtype):
    (jx, tx), (jw, tw) = _inputs(N, H, W, C, K, kh, dtype, H * C + kh)
    before = conv_ops.conv2d.launches
    out = conv_ops.conv2d(tx, tw, stride=stride, padding="SAME")
    assert conv_ops.conv2d.launches == before      # the CPU runs no kernel
    _close(out, jconv_ref.conv2d(jx, jw, stride=stride), dtype)
    _close(out, jconv_ops.conv2d(jx, jw, stride=stride, padding="SAME",
                                 tk=K, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H,W,C,K,kh,stride", SHAPES + ASYMMETRIC)
def test_conv2d_plain_on_padded_input_vs_ref(N, H, W, C, K, kh, stride,
                                             dtype):
    """The plain version takes the input the wrapper padded (a VALID
    conv), as the CUDA kernel does."""
    (jx, tx), (jw, tw) = _inputs(N, H, W, C, K, kh, dtype, H * C + kh)
    xp = conv_ops.pad_same(tx, kh, kh, stride)
    _close(conv_ref.conv2d(xp, tw, stride=stride),
           jconv_ref.conv2d(jx, jw, stride=stride), dtype)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)),      # ResNet / GoogLeNet stem
    (112, 3, 2, (0, 1)),      # stem max pool
    (56, 1, 2, (0, 0)),       # projection shortcut: negative pad clipped
    (7, 1, 2, (0, 0)),
    (28, 5, 1, (2, 2)),       # inception 5x5
    (9, 2, 2, (0, 1)),        # VGG pool on an odd input
])
def test_same_pads_match_the_reference_rule(size, k, stride, pads):
    assert conv_ops.same_pads(size, k, stride) == pads
    # the reference's rule, written out (repro/kernels/conv2d/ops.py)
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    assert pads == (total // 2, total - total // 2)


def test_valid_padding_and_unknown_padding():
    (jx, tx), (jw, tw) = _inputs(1, 9, 9, 4, 8, 3, "float32", 5)
    _close(conv_ops.conv2d(tx, tw, stride=2, padding="VALID"),
           jconv_ref.conv2d(jx, jw, stride=2, padding="VALID"), "float32")
    with pytest.raises(ValueError, match="padding"):
        conv_ops.conv2d(tx, tw, padding="FULL")

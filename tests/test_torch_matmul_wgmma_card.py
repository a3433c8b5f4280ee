"""The warpgroup route of the port's matmul (``wgmma``,
``kernels/csrc/matmul_wgmma.cu``) on the card: each layout of A and B
(row-major or the ``.t()`` view of a row-major matrix, read in place by
TMA), ragged edges, both tile widths and a split K, against the plain
version (``ref.matmul``) at bf16's 3e-2, and bit for bit on a second
launch.  The kernel has no CPU mode: without a card every case skips.
Run on a card with ``python -m pytest -q -m card
tests/test_torch_matmul_wgmma_card.py``.
"""
import math

import pytest
import torch

from repro_torch.kernels.matmul import matmul as mm_k
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref

LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wgmma kernel runs only there")
    return torch.device("cuda")


def _operands(dev, M, K, N, a_t, b_t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    a = rnd((K, M)).t() if a_t else rnd((M, K))
    b = (rnd((N, K)).t() if b_t else rnd((K, N))) / math.sqrt(K)
    return a, b


@pytest.mark.card
@pytest.mark.parametrize("a_t,b_t", LAYOUTS)
@pytest.mark.parametrize("M,K,N,splits,bn", [
    (256, 3584, 512, None, 128),      # the plan's own split (7)
    (296, 72, 136, 1, 128),           # ragged rows and columns
    (264, 1000, 520, 3, 128),         # split K, the last range ragged
    (2104, 1000, 2000, 3, 256),       # 256 columns a CTA, ragged edges
])
def test_wgmma_matches_its_plain_version(card, a_t, b_t, M, K, N, splits,
                                         bn):
    a, b = _operands(card, M, K, N, a_t, b_t, M + K + N)
    p = mm_k.plan_for(a, b, route="wgmma", splits=splits)
    assert p.bn == bn
    got = mm_k.launch(a, b, p)
    want = mm_ref.matmul(a, b).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    assert bool((err <= 3e-2 * (1 + want.abs())).all()), float(err.max())
    assert torch.equal(got, mm_k.launch(a, b, p))


@pytest.mark.card
def test_the_wrapper_counts_wgmma(card):
    a, b = _operands(card, 512, 256, 256, False, True, 7)
    before = mm_ops.matmul.routes["wgmma"]
    mm_ops.matmul(a, b)
    assert mm_ops.matmul.routes["wgmma"] == before + 1

"""Flash attention's bf16 backward on the warpgroup tensor cores
(``kernels/csrc/flash_attention_bwd.cu``: ``fa_bwd_delta_wgmma``,
``fa_bwd_dkdv_wgmma``, ``fa_bwd_dq_wgmma``) on the card: every family's
training attention at fewer rows (qwen2-7b 28 / 4 heads of 128, qwen3-moe
32 / 4, internvl2 48 / 8, hymba 25 / 5 of 64 global and with its 1024
window, whisper 8 / 8 of 64: its decoder's causal self attention, its
cross attention and its encoder over 1500 frames, bidirectional), group
sizes 1-8 at D = 64 and 128, ragged edges; dQ, dK and dV against the f32
plain backward on the same bf16 inputs within 3e-2 x (rms + |want|), bit
for bit on a second launch, and through the wrapper on the ``wgmma``
route.  The kernels have no CPU mode: without a card every case skips.
Run on a card with ``python -m pytest -q -m card
tests/test_torch_fa_bwd_wgmma_card.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 3e-2

# (B, Sq, Skv, Hq, Hkv, D, causal, window)
SHAPES = {
    "qwen2-7b": (1, 1024, 1024, 28, 4, 128, True, 0),
    "qwen3-moe": (1, 1024, 1024, 32, 4, 128, True, 0),
    "internvl2": (1, 1024, 1024, 48, 8, 128, True, 0),
    "hymba global": (1, 1024, 1024, 25, 5, 64, True, 0),
    "hymba window": (1, 1280, 1280, 25, 5, 64, True, 1024),
    "whisper self": (1, 1024, 1024, 8, 8, 64, True, 0),
    "whisper cross": (1, 1024, 1500, 8, 8, 64, False, 0),
    "whisper encoder": (2, 1500, 1500, 8, 8, 64, False, 0),
    "G=1 D=128": (2, 200, 200, 3, 3, 128, True, 0),
    "G=2 D=64 ragged": (2, 130, 33, 4, 2, 64, False, 0),
    "G=3 D=128 Sq<Skv": (1, 65, 300, 6, 2, 128, True, 0),
    "G=8 D=64 window": (1, 300, 300, 8, 1, 64, True, 100),
    "G=5 D=80": (1, 190, 190, 10, 2, 80, True, 0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wgmma kernels run only there")
    return torch.device("cuda")


def _inputs(dev, shape, seed):
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    return (rnd((B, Sq, Hq, D)), rnd((B, Skv, Hkv, D)),
            rnd((B, Skv, Hkv, D)), rnd((B, Sq, Hq, D)))


def _ratio(got, want):
    w = want.float()
    rms = float(w.pow(2).mean().sqrt())
    return float(((got.float() - w).abs() / (TOL * (rms + w.abs()))).max())


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_wgmma_backward_matches_its_plain_version(card, name):
    shape = SHAPES[name]
    causal, window = shape[6], shape[7]
    q, k, v, do = _inputs(card, shape, len(name))
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                      window=window)
    want = fa_ref.attention_backward(*(t.float() for t in (q, k, v, do)),
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a.float()).all()), n
        assert _ratio(a, b) <= 1, (n, _ratio(a, b))
    again = fa.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                        window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.card
def test_wrapper_counts_the_wgmma_route(card):
    """Through ``FlashAttention``'s backward, bf16 adds to ``wgmma`` and
    f32 to ``cuda_cores``."""
    w = fa_ops.flash_attention_backward
    before = dict(w.routes)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, _ = (t.to(dt).requires_grad_(True) for t in
                      _inputs(card, (1, 70, 70, 4, 2, 64, True, 0), 1))
        out = fa_ops.flash_attention(q, k, v)
        torch.autograd.grad(out.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert w.routes["wgmma"] == before["wgmma"] + 1
    assert w.routes["cuda_cores"] == before["cuda_cores"] + 1

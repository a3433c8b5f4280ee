"""Flash attention's bf16 forward on the warpgroup tensor cores
(``kernels/csrc/flash_attention.cu``: ``fa_wgmma_kernel``, forced through
``fa_wgmma_launch``) on the card, at the tile edges: Sq and Skv off 64 and
128, Sq != Skv (cross attention), G from 1 to 16, D 16 / 64 / 72 / 128,
windows, causal and bidirectional; the output within 3e-2 x (1 + |want|)
of the plain version on the same bf16 inputs and the LSE within 3e-2 x
(rms + |want|) of ``ref.attention_lse``, bit for bit on a second launch,
a CUDA graph's replay equal to the eager launch, and the wrapper's count
by route.  The kernel has no CPU mode: without a card every case skips.
Run on a card with ``python -m pytest -q -m card
tests/test_torch_fa_fwd_wgmma_card.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 3e-2

# (B, Sq, Skv, Hq, Hkv, D, causal, window)
SHAPES = {
    "G=1 D=128 ragged": (2, 200, 200, 3, 3, 128, True, 0),
    "G=2 D=64 Sq>Skv bidir": (2, 130, 33, 4, 2, 64, False, 0),
    "G=3 D=128 Sq<Skv": (1, 65, 300, 6, 2, 128, True, 0),
    "G=4 D=16 one tile": (1, 64, 64, 8, 2, 16, True, 0),
    "G=5 D=72 window": (1, 333, 333, 10, 2, 72, True, 100),
    "G=7 D=128 qwen2-7b": (1, 1100, 1100, 28, 4, 128, True, 0),
    "G=7 D=128 window 300": (2, 700, 700, 14, 2, 128, True, 300),
    "G=8 D=64 window 1": (1, 257, 257, 8, 1, 64, True, 1),
    "G=16 D=64 cross": (2, 190, 1500, 16, 1, 64, False, 0),
    "G=1 D=64 whisper encoder": (2, 1500, 1500, 8, 8, 64, False, 0),
    "G=6 D=128 internvl2 prompt": (4, 288, 288, 48, 8, 128, True, 0),
    "G=5 D=64 hymba window": (1, 1280, 1280, 25, 5, 64, True, 1024),
    "G=2 D=128 one row": (3, 1, 129, 4, 2, 128, False, 0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wgmma kernel runs only there")
    return torch.device("cuda")


def _inputs(dev, shape, seed):
    B, Sq, Skv, Hq, Hkv, D, _, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    return rnd((B, Sq, Hq, D)), rnd((B, Skv, Hkv, D)), rnd((B, Skv, Hkv, D))


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_wgmma_forward_matches_its_plain_version(card, name):
    shape = SHAPES[name]
    causal, window = shape[6], shape[7]
    q, k, v = _inputs(card, shape, len(name))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     lse=True, route="wgmma")
    want, want_lse = fa_ref.attention_lse(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    w = want.float()
    err = (o.float() - w).abs()
    assert bool(torch.isfinite(o.float()).all())
    assert bool((err <= TOL + TOL * w.abs()).all()), float(err.max())
    rms = float(want_lse.pow(2).mean().sqrt())
    lerr = (lse - want_lse).abs()
    assert bool((lerr <= TOL * (rms + want_lse.abs())).all()), \
        float(lerr.max())
    # the serving call (no LSE) is the same arithmetic
    plain = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    route="wgmma")
    assert torch.equal(plain, o)
    again, lse2 = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, lse=True,
                                          route="wgmma")
    assert torch.equal(again, o) and torch.equal(lse2, lse)


@pytest.mark.card
def test_graph_replay_equals_the_eager_launch(card):
    """The tensor maps are encoded at each launch and passed by value, so
    the launch captures into a CUDA graph; a replay on new inputs copied
    into the captured buffers equals an eager launch on them."""
    shape = (1, 640, 640, 28, 4, 128, True, 0)
    q, k, v = _inputs(card, shape, 3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fa.flash_attention_cuda(q, k, v, lse=True)          # warm: the opt-in
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = fa.flash_attention_cuda(q, k, v, lse=True)
    q2, k2, v2 = _inputs(card, shape, 4)
    for dst, src in ((q, q2), (k, k2), (v, v2)):
        dst.copy_(src)
    graph.replay()
    want, want_lse = fa.flash_attention_cuda(q2, k2, v2, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, want) and torch.equal(lse, want_lse)


@pytest.mark.card
def test_wrapper_counts_the_route(card):
    """The serving wave (4 x 32) on ``mma``, a 256-row prompt at D = 128
    and the training forward on ``wgmma``, f32 on ``cuda_cores``; the
    wrapper's bf16 output at the long prompt is the forced wgmma
    launch's."""
    w = fa_ops.flash_attention
    before = dict(w.routes)
    wave = _inputs(card, (4, 32, 32, 28, 4, 128, True, 0), 5)
    long = _inputs(card, (1, 256, 256, 28, 4, 128, True, 0), 6)
    fa_ops.flash_attention(*wave)
    out = fa_ops.flash_attention(*long)
    fa_ops.flash_attention(*(t.float() for t in wave))
    qt, kt, vt = (t.clone().requires_grad_(True) for t in long)
    fa_ops.flash_attention(qt, kt, vt).float().sum().backward()
    torch.cuda.synchronize()
    assert w.routes["mma"] == before["mma"] + 1
    assert w.routes["wgmma"] == before["wgmma"] + 2
    assert w.routes["cuda_cores"] == before["cuda_cores"] + 1
    assert torch.equal(out, fa.flash_attention_cuda(*long, route="wgmma"))

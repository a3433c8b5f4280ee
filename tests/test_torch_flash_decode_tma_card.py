"""Flash decode's Hopper route (``kernels/csrc/flash_decode.cu``:
``fd_tma::kernel``) on the card: whisper's cross and self attention (G =
1), hymba's dense slab with its 1024 window (G = 5), qwen2-7b's serving and
4,096-token slabs (G = 7), the other configs' groups (4, 6, 8; 1 at D =
128) and the edges (cur 0 / 31 / 32 / 33 and 63 / 64 / 65, S not a tile
multiple, a window cutting a tile, D = 16 and 80, G = 16), scalar and
vector ``cur_pos``, at forced splits (the engine the launch picks by G:
the CUDA cores at G = 1, the tensor cores above); each
against the plain version on the same bf16 inputs within 3e-2, bit for bit
on a second launch; a CUDA-graph replay equal to the eager launch; and the
wrapper's route counts as ``route_of`` picks.  The kernel has no CPU mode:
without a card every case skips.  Run on a card with ``python -m pytest -q
-m card tests/test_torch_flash_decode_tma_card.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode as fd_k
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref

TOL = 3e-2

# (B, S, Hq, Hkv, D, window, cur)
SHAPES = {
    "whisper cross": (4, 1500, 8, 8, 64, 0, 1499),
    "whisper self": (4, 96, 8, 8, 64, 0, [15, 20, 3, 40]),
    "hymba dense window": (4, 1280, 25, 5, 64, 1024, [1279, 1100, 500, 0]),
    "qwen2-7b serving": (4, 96, 28, 4, 128, 0, [65, 71, 67, 69]),
    "qwen2-7b 4096": (4, 4160, 28, 4, 128, 0, [4096, 4101, 4099, 4110]),
    "qwen1.5-4b G=1 D=128": (4, 96, 20, 20, 128, 0, [65, 71, 67, 69]),
    "mistral-nemo G=4": (2, 200, 32, 8, 128, 0, [199, 64]),
    "internvl2 G=6": (2, 200, 48, 8, 128, 0, [150, 33]),
    "qwen3-moe G=8": (2, 200, 32, 4, 128, 0, 190),
    "cur 0/31/32/33": (4, 40, 28, 4, 128, 0, [0, 31, 32, 33]),
    "cur 63/64/65": (3, 70, 8, 8, 64, 0, [63, 64, 65]),
    "ragged S, window mid-tile": (3, 77, 4, 2, 64, 20, [76, 50, 5]),
    "D=16": (2, 30, 4, 2, 16, 0, [29, 7]),
    "D=80 G=3": (2, 100, 6, 2, 80, 0, [99, 40]),
    "G=16": (2, 300, 32, 2, 64, 0, [299, 100]),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tma kernel runs only there")
    return torch.device("cuda")


def _inputs(dev, name):
    B, S, Hq, Hkv, D, window, cur = SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(len(name))

    def rnd(s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    return (rnd((B, Hq, D)), rnd((B, S, Hkv, D)), rnd((B, S, Hkv, D)),
            torch.tensor(cur, dtype=torch.int32, device=dev), window)


def _close(got, want):
    w = want.float()
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert bool(((got.float() - w).abs() <= TOL + TOL * w.abs()).all()), \
        float((got.float() - w).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tma_route_matches_its_plain_version(card, name):
    q, k, v, cur, window = _inputs(card, name)
    want = fd_ref.decode_attention(q, k, v, cur, window=window)
    runs = [dict()] + [dict(splits=n) for n in (1, 3, 8)]
    for kw in runs:
        got = fd_k.flash_decode_cuda(q, k, v, cur, window=window,
                                     route="tma", **kw)
        again = fd_k.flash_decode_cuda(q, k, v, cur, window=window,
                                       route="tma", **kw)
        torch.cuda.synchronize()
        _close(got, want)
        assert torch.equal(got, again), kw
    if cur.ndim:                          # the same function at a scalar
        one = cur[1].clone()
        _close(fd_k.flash_decode_cuda(q, k, v, one, window=window),
               fd_ref.decode_attention(q, k, v, one, window=window))


@pytest.mark.card
def test_graph_replay_equals_the_eager_launch(card):
    q, k, v, cur, window = _inputs(card, "hymba dense window")
    eager = fd_k.flash_decode_cuda(q, k, v, cur, window=window)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd_k.flash_decode_cuda(q, k, v, cur, window=window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd_k.flash_decode_cuda(q, k, v, cur, window=window)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.card
def test_wrapper_counts_each_route(card):
    """bf16 at the configs' shapes on ``tma``; f32, D = 20 and a cache off
    16 bytes on ``template``; as ``route_of`` says."""
    w = fd_ops.flash_decode
    g = torch.Generator(device=card).manual_seed(0)

    def rnd(s, dt=torch.bfloat16):
        return torch.randn(s, generator=g, device=card).to(dt)
    cases = [(rnd((2, 8, 64)), rnd((2, 50, 8, 64)), "tma"),
             (rnd((2, 28, 128)), rnd((2, 50, 4, 128)), "tma"),
             (rnd((2, 8, 64), torch.float32),
              rnd((2, 50, 8, 64), torch.float32), "template"),
             (rnd((2, 4, 20)), rnd((2, 50, 2, 20)), "template"),
             (rnd((2, 4, 64)), rnd((2 * 50 * 2 * 64 + 4,))[4:].view(
                 2, 50, 2, 64), "template")]
    for q, kc, want in cases:
        before = dict(w.routes)
        assert fd_k.route_of(q, kc, kc) == want
        got = fd_ops.flash_decode(q, kc, kc, 30)
        torch.cuda.synchronize()
        _close(got.to(torch.bfloat16),
               fd_ref.decode_attention(q, kc, kc, 30).to(torch.bfloat16))
        assert w.routes[want] == before[want] + 1
        assert sum(w.routes.values()) == sum(before.values()) + 1

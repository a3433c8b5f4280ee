"""The stream route of the port's matmul (``stream``, ``mm_stream`` in
``kernels/csrc/matmul_wgmma.cu``) on the card: the prefill wave's
products at qwen2-7b's widths, M around the warpgroups and row tiles
(forced below the plan's 65 rows), K past a step and shorter than the
ring, N past a tile, B row-major and as the ``.t()`` view of a row-major
matrix, forced shares, against the plain version (``ref.matmul``) at
bf16's 3e-2; bit for bit on a second launch and in a CUDA graph replay;
the wrapper's count by route; a capture as the first launch of a new
process.  The kernel has no CPU mode: without a card every case
skips.  Run on a card with ``python -m pytest -q -m card
tests/test_torch_matmul_stream_card.py``.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.matmul import matmul as mm_k
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the stream kernel runs only there")
    return torch.device("cuda")


def _operands(dev, M, K, N, b_t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    b = (rnd((N, K)).t() if b_t else rnd((K, N))) / math.sqrt(K)
    return rnd((M, K)), b


def _held(got, a, b):
    want = mm_ref.matmul(a, b).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= 3e-2 * (1 + want.abs())).all()), float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (3584, 18944),
                                 (18944, 3584)])
def test_the_wave_shapes_match_their_plain_version(card, K, N):
    a, b = _operands(card, 128, K, N, False, K + N)
    p = mm_k.plan_for(a, b, route="stream")     # k / v's 512: wgmma's plan
    got = mm_k.launch(a, b, p)
    _held(got, a, b)
    assert torch.equal(got, mm_k.launch(a, b, p))


@pytest.mark.card
@pytest.mark.parametrize("b_t", [False, True])
@pytest.mark.parametrize("K,N", [(1032, 2056), (72, 136)])
@pytest.mark.parametrize("M", [17, 63, 64, 65, 127, 128, 129, 255])
def test_edges_match_their_plain_version(card, M, K, N, b_t):
    a, b = _operands(card, M, K, N, b_t, M + K + N)
    # 17 column tiles: the wave's rows take stream, a refill's keep mma;
    # wgmma past a row tile, and at one where K is too short for stream
    assert mm_k.plan_for(a, b).route == (
        "wgmma" if M >= 129 or M == 128 and K < 1024
        else "stream" if M >= 65 and K >= 1024 else "mma")
    p = mm_k.plan_for(a, b, route="stream")
    got = mm_k.launch(a, b, p)
    _held(got, a, b)
    assert torch.equal(got, mm_k.launch(a, b, p))


@pytest.mark.card
@pytest.mark.parametrize("M", [32, 96])
@pytest.mark.parametrize("ctas", [1, 2, 5, 33, 132, 10_000])
def test_forced_shares_match_and_repeat(card, M, ctas):
    a, b = _operands(card, M, 1000, 600, False, ctas + M)
    p = mm_k.plan_for(a, b, route="stream", ctas=ctas)
    got = mm_k.launch(a, b, p)
    _held(got, a, b)
    assert torch.equal(got, mm_k.launch(a, b, p))


@pytest.mark.card
def test_a_graph_replay_equals_the_eager_launch(card):
    a, b = _operands(card, 128, 3584, 3584, False, 11)
    p = mm_k.plan_for(a, b)
    eager = mm_k.launch(a, b, p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mm_k.launch(a, b, p)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    a.copy_(torch.randn_like(a, dtype=torch.float32).to(a.dtype))
    graph.replay()
    assert torch.equal(out, mm_k.launch(a, b, p))


FIRST_CAPTURE = """
import math, torch
from repro_torch.kernels.matmul import matmul as mm_k
g = torch.Generator(device="cuda").manual_seed(3)
a = torch.randn((128, 3584), generator=g, device="cuda").bfloat16()
b = (torch.randn((3584, 3584), generator=g, device="cuda") / 60).bfloat16()
p = mm_k.plan_for(a, b)
assert p.route == "stream", p
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    out = mm_k.launch(a, b, p)
graph.replay()
torch.cuda.synchronize()
assert torch.equal(out, mm_k.launch(a, b, p))
print("ok")
"""


@pytest.mark.card
def test_a_capture_may_be_the_first_launch(card):
    """In a new process the route's first launch is a capture: its tiles'
    counters are the module's, zeroed when it loads, so the replay sums as
    an eager launch does."""
    src = Path(__file__).resolve().parents[1] / "src"
    done = subprocess.run([sys.executable, "-c", FIRST_CAPTURE],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join(
                              [str(src), os.environ.get("PYTHONPATH", "")])})
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr


@pytest.mark.card
def test_the_wrapper_counts_stream(card):
    a, b = _operands(card, 96, 1024, 2048, True, 7)
    before = dict(mm_ops.matmul.routes)
    mm_ops.matmul(a, b)
    assert mm_ops.matmul.routes["stream"] == before["stream"] + 1
    assert sum(mm_ops.matmul.routes.values()) == sum(before.values()) + 1

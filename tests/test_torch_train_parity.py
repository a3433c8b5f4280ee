"""``tools/torch_train_parity.py``'s comparison on the CPU at the smoke
size, and ``chip_smoke.py``'s scale of a vocabulary table: with both sides
on the CPU every way gives the CPU's loss and gradients exactly (a CPU
tensor never reaches the launches the ways swap), and the wrappers are
restored after; the two controls' products are what they say."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import ops as mm_ops

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location(
    "torch_train_parity", ROOT / "tools" / "torch_train_parity.py")
TP = importlib.util.module_from_spec(spec)
spec.loader.exec_module(TP)
CS = TP.CS


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-base"])
def test_every_way_on_the_cpu_is_exact(arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    seq = (cfg.n_img_tokens or 0) + 24
    batch = synth_lm_batch(cfg, ShapeCell("train", seq, 2, "train"), 0)
    before = (fa_ops.flash_attention_lse, fa_ops.flash_attention_backward,
              mm_ops.launch, torch.backends.cuda.matmul.allow_tf32)
    out = TP.compare(cfg, batch, card="cpu", host="cpu")
    assert (fa_ops.flash_attention_lse, fa_ops.flash_attention_backward,
            mm_ops.launch, torch.backends.cuda.matmul.allow_tf32) == before
    for way in TP.WAYS:
        assert out[way]["loss"] == out["host loss"]
        assert set(out[way]["leaves"]) and all(
            r == (0.0, 0.0) for r in out[way]["leaves"].values())
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 64, generator=g), torch.randn(64, 8, generator=g)
    want = TP.mm_ref.matmul(a, b)
    assert torch.equal(TP.PRODUCTS["plain"](a, b, None), want)
    assert torch.equal(TP.PRODUCTS["bf16"](a, b, None), TP.mm_ref.matmul(
        a.bfloat16().float(), b.bfloat16().float()))
    assert not torch.equal(TP.PRODUCTS["bf16"](a, b, None), want)


def test_token_rms_scales_a_vocabulary_table_per_token():
    """With the batch's targets: the embedding by its rows with a nonzero
    entry, an untied head by the targets' columns, any other leaf (and
    every leaf without targets) by its own RMS; an unused row (error and
    bound both 0) counts 0."""
    embed = torch.zeros(100, 4)
    embed[0] = torch.tensor([1.0, -1.0, 1.0, 0.001])
    embed[7] = torch.tensor([2.0, 0.5, -2.0, 0.0])
    targets = torch.tensor([0, 7])
    got = embed.clone()
    got[0, 3] += 1e-5
    over_all, touched = TP.worst("embed", got, embed, targets)
    assert over_all > touched > 0
    assert touched == pytest.approx(
        1e-5 / (1e-3 * (float(embed[[0, 7]].pow(2).mean().sqrt()) + 0.001)),
        rel=1e-4)
    assert float(CS.token_rms(torch, "embed", embed)) == pytest.approx(
        float(embed.pow(2).mean().sqrt()))
    head = embed.T.contiguous()
    assert TP.worst("lm_head", got.T.contiguous(), head, targets) == \
        pytest.approx((over_all, touched))
    assert float(CS.token_rms(torch, "lm_head", head, torch.tensor([7]))) \
        == pytest.approx(float(embed[7].pow(2).mean().sqrt()))
    assert TP.worst("blocks/attn/wq", got, embed, targets)[1] == \
        pytest.approx(over_all)
    err = (got - embed).abs()
    assert float(CS.ratio(torch, err, CS.token_rms(
        torch, "embed", embed, targets), embed, 1e-3)[1:7].abs().max()) == 0

"""The launch counts and the bound of a training step
(``repro_torch/profiling/train_counts.py``) against what one step of each
family issues on the CPU.

``chip_smoke.py`` fails a card run whose wrappers launch anything but
``train_issues``' counts, so these hold the rule before any card run: one
``make_train_step`` step (2 microbatches) of each of its six training
configs at the smoke size, with the wrappers' plain versions made to
count, must issue exactly ``train_issues``' launches, at a length of two
loss chunks and at phase 2's batch shape.  ``block_products`` and the
encoder / decoder products are held against the (K, N) the wrapper sees
in a forward, and ``train_flops`` against qwen2-7b's 6 N D.
"""
import importlib.util
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.models import api as mapi
from repro_torch.optim import adamw_init
from repro_torch.profiling import train_counts as TC
from repro_torch.runtime import steps as RS

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
ARCHS = [CS.TRAIN_ARCH] + list(CS.TRAIN_FAMILIES)


@pytest.fixture
def counting(monkeypatch):
    """The wrappers' plain versions, counting what each wrapper issues:
    {"matmul", "flash_attention", "flash_attention_backward"} and the
    (K, N) of every product."""
    n = Counter()
    shapes = []

    def mm(a, b):
        n["matmul"] += 1
        shapes.append(tuple(b.shape))
        return mm_ref.matmul(a, b)

    def lse(*a, **kw):
        n["flash_attention"] += 1
        return fa_ref.attention_lse(*a, **kw)

    def attention(*a, **kw):
        n["flash_attention"] += 1
        return fa_ref.attention(*a, **kw)

    def bwd(*a, **kw):
        n["flash_attention_backward"] += 1
        return fa_ref.attention_backward(*a, **kw)

    monkeypatch.setattr(mm_ops, "ref", types.SimpleNamespace(matmul=mm))
    monkeypatch.setattr(fa_ops, "ref", types.SimpleNamespace(
        attention=attention, attention_lse=lse, attention_backward=bwd))
    return n, shapes


def _step(cfg, seq):
    api = mapi.build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    step = RS.make_train_step(api, accum=2, warmup=1, total=10)
    batch = synth_lm_batch(cfg, ShapeCell("train", seq, 2, "train"), 0)
    _, _, metrics = step(params, adamw_init(params), batch)
    assert np.isfinite(float(metrics["loss"]))


def _want(cfg, seq, micro):
    return {k: v for k, v in TC.train_issues(cfg, seq, micro).items() if v}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_issues_train_issues(arch, counting):
    """Two loss chunks of text (300 rows: chunks of 150) after the prefix,
    2 microbatches."""
    n, _ = counting
    cfg = get_config(arch, smoke=True)
    seq = (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0) + 300
    _step(cfg, seq)
    assert dict(n) == _want(cfg, seq, 2)


@pytest.mark.parametrize("arch", list(CS.TRAIN_FAMILIES))
def test_phase2_shape_leaves_text_and_issues(arch, counting):
    """Phase 2's batch shape at published width leaves text after the
    prefix (hymba's 1152 rows more than its 1024-key window, and a windowed
    layer among its 3); at the smoke size one step issues
    ``train_issues``."""
    n, _ = counting
    full = get_config(arch)
    layers, seq = CS.train_check_seq(full)
    prefix = (full.n_img_tokens or 0) + (full.n_meta_tokens or 0)
    assert seq - prefix >= CS.TRAIN_CHECK_TEXT
    if full.attn_window:
        from repro_torch.models.transformer import layer_windows

        assert seq > full.attn_window
        assert layer_windows(full.replace(n_layers=layers)).any()
    cfg = get_config(arch, smoke=True).replace(n_layers=layers)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=layers)
    _, seq = CS.train_check_seq(cfg)
    _step(cfg, seq)
    assert dict(n) == _want(cfg, seq, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_products_are_what_the_forward_issues(arch, counting):
    """The (K, N) of every product of a forward: each layer's
    ``block_products`` (an enc-dec's encoder and decoder products) and the
    head."""
    _, shapes = counting
    cfg = get_config(arch, smoke=True)
    api = mapi.build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = RS.to_device(synth_lm_batch(
        cfg, ShapeCell("train", (cfg.n_img_tokens or 0)
                       + (cfg.n_meta_tokens or 0) + 16, 1, "train"), 0), "cpu")
    with torch.no_grad():
        api.forward(params, batch)
    if cfg.family == "encdec":
        enc, dec = TC.encdec_products(cfg)
        want = enc * cfg.enc_layers + dec * cfg.n_layers
    else:
        want = TC.block_products(cfg) * cfg.n_layers
    assert Counter(shapes) == Counter(want + [(cfg.d_model, cfg.vocab)])


def test_flops_dense_is_6nd():
    """qwen2-7b at 8 layers: 6 x the products' parameters x the tokens, the
    bound the first training slice reported (119.7 ms at 989 TFLOP/s)."""
    cfg = get_config("qwen2-7b").replace(n_layers=8)
    n_mm = 8 * (2 * cfg.d_model * cfg.n_heads * cfg.head_dim
                + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
                + 3 * cfg.d_model * cfg.d_ff) + cfg.d_model * cfg.vocab
    f = TC.train_flops(cfg, 4096, 2)
    assert f["products"] == 6 * n_mm * 8192
    assert f["router"] == f["ssd"] == 0
    assert f["bound_ms"] == pytest.approx(119.74, abs=0.01)


@pytest.mark.parametrize("arch", list(CS.TRAIN_FAMILIES))
def test_flops_parts_by_family(arch):
    """A router term only for the MoE, an SSD term only for the SSM and
    the hybrid; the products of a smoke config equal 6 x the (M, K, N) of
    ``block_products`` and the head, rows counted as each runs."""
    cfg = get_config(arch, smoke=True)
    f = TC.train_flops(cfg, 64 + (cfg.n_img_tokens or 0)
                       + (cfg.n_meta_tokens or 0), 2)
    assert (f["router"] > 0) == bool(cfg.n_experts)
    assert (f["ssd"] > 0) == (cfg.family in ("ssm", "hybrid"))
    assert f["products"] > 0 and f["bound_ms"] > 0
    if cfg.family in ("dense", "vlm", "ssm", "hybrid"):
        S = 64 + (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0)
        mnk = (cfg.n_layers * S * sum(K * N for K, N in
                                      TC.block_products(cfg))
               + 64 * cfg.d_model * cfg.vocab)
        assert f["products"] == 6 * mnk * 2


def test_params_cover_block_products():
    """Every wrapper weight of a block is one of ``block_products``: the
    per-layer 2-D weights of hymba (attention, SSM projections, MLP) by
    shape."""
    cfg = get_config("hymba-1.5b", smoke=True)
    params = mapi.build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    blocks = params["blocks"]
    got = sorted(tuple(t.shape[1:]) for part in ("attn", "mlp")
                 for t in blocks[part].values() if t.ndim == 3)
    got += sorted(tuple(blocks["ssm"][k].shape[1:])
                  for k in ("in_proj", "out_proj"))
    assert sorted(got) == sorted(TC.block_products(cfg))

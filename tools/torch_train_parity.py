"""Which part of the card's training path moves a gradient off the CPU's,
and whether phase 2's bound still fails a path of lower precision.

  PYTHONPATH=src python tools/torch_train_parity.py \
      [--arch internvl2-26b] [--layers 1] [--text 128]

Builds the architecture at its published width in fp32 at ``--layers``
layers (random weights from the seed ``chip_smoke.py``'s phase 2 uses) and
one ``synth_lm_batch`` of 2 x (the prefix + ``--text`` rows), takes the
loss's gradient of every parameter on the CPU (the plain versions), then
on the card in several ways: through the kernels; with the attention's
plain version in place of its kernels, with the matmul's, with both
(torch's own ops alone); and two controls of lower precision, the
products by ``torch.matmul`` with TF32 allowed and by f32 products of
bf16-rounded operands.  For each way it prints the worst error of the
embedding, the LM head and the worst other leaf against the CPU as a
fraction of 1e-3 x (rms + |cpu|), rms once the leaf's over all of its
entries and once as ``chip_smoke.py``'s phase 2 [train families] takes
it (``token_rms``: a vocabulary table's over the rows and columns the
batch touches).  The card's kernels are built first; a card is required.
"""
from __future__ import annotations

import argparse
import importlib.util
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.models import api as mapi
from repro_torch.runtime.steps import to_device
from repro_torch.tree import leaves_with_paths, tree_map

TOL = 1e-3
SEED = 4                  # chip_smoke.py phase 2's weights
# way -> (the attention's plain version, the products: the kernel, their
# plain version, torch.matmul under TF32, f32 products of bf16 operands)
WAYS = {"kernels": (False, "kernel"), "plain attention": (True, "kernel"),
        "plain matmul": (False, "plain"), "plain both": (True, "plain"),
        "tf32 products": (False, "tf32"), "bf16 products": (False, "bf16")}
PRODUCTS = {
    "plain": lambda a, b, p: mm_ref.matmul(a, b),
    "tf32": lambda a, b, p: torch.matmul(a, b),
    "bf16": lambda a, b, p: torch.matmul(a.bfloat16().float(),
                                         b.bfloat16().float()).to(a.dtype)}
TABLES = ("embed", "lm_head")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@contextmanager
def plain(attention: bool, products: str):
    """The wrappers' launches replaced while inside (on the launch's own
    device): the attention's forward with LSE and its backward by their
    plain versions, the matmul's launch by PRODUCTS[products] (TF32
    allowed for "tf32")."""
    real = (fa_ops.flash_attention_lse, fa_ops.flash_attention_backward,
            mm_ops.launch, torch.backends.cuda.matmul.allow_tf32)
    if attention:
        fa_ops.flash_attention_lse = fa_ref.attention_lse
        fa_ops.flash_attention_backward = (
            lambda q, k, v, lse, do, **kw: fa_ref.attention_backward(
                q, k, v, do, **kw))
    if products != "kernel":
        mm_ops.launch = PRODUCTS[products]
    torch.backends.cuda.matmul.allow_tf32 = products == "tf32"
    try:
        yield
    finally:
        (fa_ops.flash_attention_lse, fa_ops.flash_attention_backward,
         mm_ops.launch, torch.backends.cuda.matmul.allow_tf32) = real


def gradients(cfg, params, batch, device):
    """The loss and its gradient of every leaf, by path."""
    api = mapi.build(cfg, device)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves_with_paths(live)
    with torch.enable_grad():
        loss, _ = api.loss(live, to_device(batch, device))
        grads = torch.autograd.grad(loss, [t for _, t in flat])
    return float(loss.detach()), {p: g for (p, _), g in zip(flat, grads)}


def worst(path: str, got: torch.Tensor, want: torch.Tensor,
          targets: torch.Tensor) -> tuple:
    """The largest |got - want| as a fraction of TOL x (rms + |want|), rms
    the leaf's over all of its entries and ``token_rms``'s."""
    w = want.to(got.device).float()
    err = (got.float() - w).abs()
    return tuple(float(CS.ratio(torch, err, rms, w, TOL).max())
                 for rms in (CS.token_rms(torch, path, w),
                             CS.token_rms(torch, path, w, targets)))


def compare(cfg, batch, card: str = "cuda", host: str = "cpu",
            ways=tuple(WAYS)) -> dict:
    """{way: {"loss", "leaves": {leaf: (worst with the leaf's RMS, with
    ``token_rms``)}}} and the host's loss, the weights drawn on
    ``card``."""
    params = mapi.build(cfg, card).init(
        torch.Generator(device=card).manual_seed(SEED))
    loss_h, want = gradients(cfg, tree_map(
        lambda t: t.to(host, copy=True), params), batch, host)
    targets = torch.unique(torch.from_numpy(batch["labels"]).long())
    out = {"host loss": loss_h}
    for way in ways:
        with plain(*WAYS[way]):
            loss, got = gradients(cfg, params, batch, card)
        out[way] = {"loss": loss, "leaves": {
            p: worst(p, g, want[p], targets) for p, g in got.items()}}
        del got
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internvl2-26b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--text", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch_train_parity needs a card")
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    _build.build(["matmul", "flash_attention", "flash_attention_bwd"])
    cfg = get_config(args.arch).replace(n_layers=args.layers,
                                        dtype="float32")
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=args.layers)
    seq = (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0) + args.text
    batch = synth_lm_batch(cfg, ShapeCell("train", seq, 2, "train"), 0)
    t0 = time.perf_counter()
    out = compare(cfg, batch)
    print(f"torch_train_parity: {cfg.name} {args.layers} layers fp32, batch "
          f"2 x {seq}, on {torch.cuda.get_device_name(0)}; CPU loss "
          f"{out['host loss']!r} ({time.perf_counter() - t0:.1f} s); worst "
          f"error as a fraction of 1e-3 x (rms + |cpu|), rms the leaf's / "
          f"the batch's rows and columns")
    for way in WAYS:
        leaves = out[way]["leaves"]
        other = max((kv for kv in leaves.items() if kv[0] not in TABLES),
                    key=lambda kv: kv[1][0])
        print(f"  {way}: loss {out[way]['loss']!r}; "
              + ", ".join(f"{p} {a:.3g} / {b:.3g}" for p, (a, b) in
                          [(t, leaves[t]) for t in TABLES if t in leaves]
                          + [other]))
    return out


if __name__ == "__main__":
    main()

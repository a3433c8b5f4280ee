"""Quickstart on the PyTorch / CUDA port: train a small LM for a few steps
with the full substrate (pipeline, AdamW, checkpointing) and decode from
it; the port's counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # no card

``--device`` defaults to ``cuda`` and raises without a card; on the card
the products, attention and its backward run through the port's CUDA
kernels.  The checkpoint goes to ``--ckpt-dir`` (default
``repro_torch_quickstart`` in the temporary directory, ``TMPDIR``).
"""
import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import SMOKE_SHAPES
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.device import resolve
from repro_torch.models import api as mapi
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import steps as RS
from repro_torch.runtime.train_graph import TrainGraph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_quickstart"))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config("qwen2-7b", smoke=True)  # reduced config, CPU-runnable
    api = mapi.build(cfg, dev)
    shape = SMOKE_SHAPES["train_4k"]

    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    # captured once as a CUDA graph on the card (the reference jits it)
    step = TrainGraph(RS.make_train_step(api, peak_lr=5e-3, warmup=2,
                                         total=40), dev)
    ckpt = CheckpointManager(args.ckpt_dir)

    for s in range(20):
        params, opt, m = step(params, opt, synth_lm_batch(cfg, shape, s))
        if s % 5 == 0:
            print(f"step {s:3d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f}")
    ckpt.save(20, {"params": params})

    # greedy decode a few tokens
    prompt = torch.tensor([[5, 17, 42, 7]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": prompt}, max_len=16)
        tok = prompt[:, -1:]
        out = []
        for _ in range(8):
            logits, cache = api.decode(params, tok, cache)
            tok = logits.argmax(-1).to(torch.int32)
            out.append(int(tok[0, 0]))
    print("generated:", out)
    return out


if __name__ == "__main__":
    main()

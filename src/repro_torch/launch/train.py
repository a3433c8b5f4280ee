"""Training CLI of the port: the reference's ``repro/launch/train.py``
with the same flags, on one device in torch.

Real steps with the full substrate: the synthetic pipeline, AdamW,
checkpoints and resume, and the paper's partition runtime when
``--partitions`` > 1 (P replicas stepped round-robin, averaged every
``--sync-every`` steps; ``--fail-at s:p`` drops partition p at step s).
On the card the model's products, attention and attention backward run
through the port's CUDA kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --device cpu --steps 4 --partitions 2    # plain PyTorch path
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --seq 4096 --batch 2 --accum 2 --steps 4         # on the card

``--device`` (default ``cuda``) never falls back: without a card, ask for
the CPU.  ``--ckpt-dir`` defaults to ``repro_torch_ckpt`` in the
temporary directory (``TMPDIR``); checkpoints go to ``<dir>/<config
name>``.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, SMOKE_SHAPES, ShapeCell
from repro_torch.core.partitioning import PartitionConfig
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.device import resolve
from repro_torch.models import api as mapi
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import steps as RS
from repro_torch.runtime.partition_runtime import PartitionRuntime


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="train an LM, synchronously or with P asynchronous "
                    "partitions (PyTorch / CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains; 'cuda' (the default) "
                         "raises when there is no card")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoints per N sync points")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", default="",
                    help="step:partition failure injection, e.g. 12:1")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    base = SMOKE_SHAPES["train_4k"] if args.smoke else SHAPES["train_4k"]
    shape = ShapeCell("train", args.seq or base.seq_len,
                      args.batch or base.global_batch, "train")
    api = mapi.build(cfg, dev)
    pc = PartitionConfig(partitions=args.partitions,
                         sync_every=args.sync_every)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1

    print(f"train: {cfg.name} seq={shape.seq_len} batch={shape.global_batch} "
          f"P={pc.partitions} W={pc.sync_every} devices={n_dev}")

    step_fn = RS.make_train_step(api, peak_lr=args.lr, accum=args.accum,
                                 total=max(args.steps, 100))
    gen = torch.Generator(device=dev).manual_seed(0)

    if pc.partitions > 1:
        rt = PartitionRuntime(api, step_fn, pc, gen)

        def make_batches(step):
            b = synth_lm_batch(cfg, shape, step, partitions=pc.partitions)
            return [{k: v[i] for k, v in b.items()}
                    for i in range(pc.partitions)]

        fail = {}
        if args.fail_at:
            s, p = args.fail_at.split(":")
            fail = {int(s): int(p)}
        t0 = time.time()
        losses = rt.train(make_batches, args.steps, ckpt=ckpt,
                          ckpt_every=args.ckpt_every, fail_at=fail)
        dt = time.time() - t0
        first = np.mean(list(losses[0].values()))
        last = np.mean(list(losses[-1].values()))
        print(f"P={pc.partitions}: loss {first:.4f} -> {last:.4f} "
              f"({args.steps} steps, {dt:.1f}s, {rt.sync_count} syncs)")
        return losses

    # single-partition (synchronous) path with resume
    params = api.init(gen)
    opt = adamw_init(params)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        tmpl = {"params": params, "opt": opt._asdict()}
        state, meta = ckpt.restore(tmpl)
        params = state["params"]
        opt = opt._replace(**{k: state["opt"][k] for k in ("step", "m", "v")})
        start = int(meta["step"])
        print(f"resumed from step {start}")

    t0 = time.time()
    losses = []
    for step in range(start, start + args.steps):
        batch = synth_lm_batch(cfg, shape, step)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 10 == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt._asdict()})
            print(f"step {step+1}: loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)")
    ckpt.save(start + args.steps, {"params": params, "opt": opt._asdict()})
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()

"""The paper's technique in the port's LM training runtime: P asynchronous
partitions with periodic parameter sync, failure injection, and the
reuse-vs-shaping tradeoff report; the port's counterpart of
``examples/partitioned_training.py``.

  PYTHONPATH=src python examples/torch_partitioned_training.py
  PYTHONPATH=src python examples/torch_partitioned_training.py --device cpu

``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.partitioning import PartitionConfig, tradeoff_report
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.device import resolve
from repro_torch.models import api as mapi
from repro_torch.runtime import steps as RS
from repro_torch.runtime.partition_runtime import PartitionRuntime
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config("hymba-1.5b", smoke=True)
    api = mapi.build(cfg, dev)
    pc = PartitionConfig(partitions=4, sync_every=4)
    shape = ShapeCell("train", 64, 8, "train")

    step = RS.make_train_step(api, peak_lr=5e-3, warmup=2, total=100)
    rt = PartitionRuntime(api, step, pc,
                          torch.Generator(device=dev).manual_seed(0))

    n = sum(t.numel() for t in leaves(rt.parts[0].params))
    rep = tradeoff_report(n, pc)
    print(f"params={n:,}  weight-replica bytes={rep['replica_bytes_total']:,} "
          f"(x{pc.partitions} copies)  sync/step="
          f"{rep['sync_bytes_per_step']:,.0f} B")

    def make_batches(s):
        b = synth_lm_batch(cfg, shape, s, partitions=pc.partitions)
        return [{k: v[i] for k, v in b.items()}
                for i in range(pc.partitions)]

    # inject a failure at step 9: partition 2 dies; training continues
    losses = rt.train(make_batches, 16, fail_at={9: 2})
    for s in (0, 5, 10, 15):
        print(f"step {s:2d}: " + "  ".join(
            f"P{i}={v:.3f}" for i, v in losses[s].items()))
    print(f"syncs={rt.sync_count}  alive={len(rt.alive_parts())}/4 "
          f"(P2 failed at step 9; blast radius = its own async window)")
    return losses


if __name__ == "__main__":
    main()

"""The paper in one script, on the port's host modules: simulate ResNet-50
on the KNL setup, sweep partitions, and print the Fig.5/Fig.6 story (+ the
beyond-paper optimized phase offsets); the port's counterpart of
``examples/traffic_shaping_demo.py``, whose output it prints byte for
byte.

  PYTHONPATH=src python examples/torch_traffic_shaping_demo.py

The simulation is numpy on the host (``core/shaping_sim``,
``core/schedule``, ``models/cnn.model_traces``), so unlike the other
examples it takes no ``--device``: nothing of it runs on a card.
"""
from repro_torch.core.schedule import optimize_offsets
from repro_torch.core.shaping_sim import partition_sweep, simulate
from repro_torch.models.cnn import model_traces


def main():
    tr = model_traces("resnet50")

    print("== Fig 6: bandwidth trace std (GB/s) ==")
    for P in (1, 4, 16):
        r = simulate(tr, partitions=P, total_batch=64, n_passes=8,
                     stagger="none" if P == 1 else "uniform")
        bar = "#" * int(r.bw_std / 3e9)
        print(f"P={P:2d}  std={r.bw_std/1e9:6.1f}  mean={r.bw_mean/1e9:6.1f}  {bar}")

    print("\n== Fig 5: partition sweep (ResNet-50, paper: +8.0% @ P16) ==")
    rows = partition_sweep(tr, [2, 4, 8, 16], total_batch=64, n_passes=8)
    base = rows[1]
    for p, r in rows.items():
        if p == 1:
            continue
        print(f"P={p:2d}  perf {r['perf']-1:+.1%}  "
              f"std {r['bw_std']/base['bw_std']-1:+.1%}  "
              f"avg {r['bw_mean']/base['bw_mean']-1:+.1%}")

    print("\n== beyond paper: anti-correlated phase offsets ==")
    off = {p: optimize_offsets(tr, p, 64 // p, 64 // p) for p in (4, 8)}
    rows_o = partition_sweep(tr, [4, 8], total_batch=64, n_passes=8,
                             offsets_map=off)
    for p in (4, 8):
        print(f"P={p}: uniform {rows[p]['perf']-1:+.2%}  "
              f"optimized {rows_o[p]['perf']-1:+.2%}")


if __name__ == "__main__":
    main()

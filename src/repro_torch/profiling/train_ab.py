"""qwen2-7b's bf16 training step against another checkout's, on one card,
in turns: the losses and each step's device time.

  PYTHONPATH=src python -m repro_torch.profiling.train_ab OTHER \
      [--layers 8] [--steps 6]

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Each run is a process of its
own (the two packages share a name) that imports its checkout's
``repro_torch`` and trains qwen2-7b at its published widths cut to
``--layers`` layers, bf16, 4096 positions x batch 2 in 2 microbatches,
from the train CLI's seed on its batches, through the CLI's
``TrainGraph`` (step 1 eager, step 2 captured, the rest replays), no
checkpoint; each step timed with CUDA events.  The runs go other, this,
this, other.  Each checkout's two runs must give the same losses bit for
bit; this checkout's must lie within ``REL_TOL`` (2^-8, bf16's unit
roundoff) of the other's at every step, relative.  Prints one line per
run and one JSON line; exits 1 where a bound fails.  A card is required.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REL_TOL = 2.0 ** -8
SEQ, BATCH, ACCUM = 4096, 2, 2

CHILD = r"""
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.models import api as mapi
from repro_torch.optim import adamw_init
from repro_torch.runtime import steps as RS
from repro_torch.runtime.train_graph import TrainGraph

layers, steps, seq, batch, accum = map(int, sys.argv[1:6])
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config("qwen2-7b").replace(n_layers=layers)
shape = ShapeCell("train", seq, batch, "train")
api = mapi.build(cfg, "cuda")
step = TrainGraph(RS.make_train_step(api, peak_lr=3e-4, accum=accum,
                                     total=max(steps, 100)), api.device)
params = api.init(torch.Generator(device="cuda").manual_seed(0))
opt = adamw_init(params)
losses, ms = [], []
for i in range(steps):
    b = synth_lm_batch(cfg, shape, i)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    params, opt, m = step(params, opt, b)
    e1.record()
    torch.cuda.synchronize()
    losses.append(float(m["loss"]))
    ms.append(e0.elapsed_time(e1))
print("TRAIN_AB " + json.dumps({"losses": losses, "device_ms": ms,
                                "device": torch.cuda.get_device_name(0)}))
"""


def run(root: Path, layers: int, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(layers), str(steps), str(SEQ),
         str(BATCH), str(ACCUM)], cwd=root, env=env, capture_output=True,
        text=True)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("TRAIN_AB ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"train_ab: the run in {root} failed (exit "
                         f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                         f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("TRAIN_AB "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[3]
    runs = []
    for who in ("other", "this", "this", "other"):
        r = run(this if who == "this" else args.other.resolve(), args.layers,
                args.steps)
        runs.append((who, r))
        print(f"{who}: losses {r['losses']}; device ms a step "
              f"{[round(x, 2) for x in r['device_ms']]} ({r['device']})",
              flush=True)
    by = {w: [r for k, r in runs if k == w] for w in ("other", "this")}
    repeat = {w: rs[0]["losses"] == rs[1]["losses"] for w, rs in by.items()}
    rel = [abs(t - o) / abs(o) for t, o in zip(by["this"][0]["losses"],
                                               by["other"][0]["losses"])]
    replays = {w: [x for r in rs for x in r["device_ms"][2:]]
               for w, rs in by.items()}
    out = {"device": runs[0][1]["device"], "other": str(args.other),
           "layers": args.layers, "steps": args.steps,
           "losses": {w: rs[0]["losses"] for w, rs in by.items()},
           "repeat_bitwise": repeat, "max_rel_loss_diff": max(rel),
           "rel_tol": REL_TOL,
           "replay_device_ms": {w: sum(v) / len(v)
                                for w, v in replays.items()},
           "runs": [{"who": w, **r} for w, r in runs]}
    print(json.dumps(out), flush=True)
    if not all(repeat.values()) or max(rel) > REL_TOL:
        raise SystemExit(f"train_ab: repeat bit for bit {repeat}, max "
                         f"relative loss difference {max(rel):.3g} (bound "
                         f"{REL_TOL:.3g})")


if __name__ == "__main__":
    main()

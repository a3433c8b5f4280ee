"""Flash decode's two routes inside a replayed dense-slab decode step, on
one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.dense_step_ab \
      [--arch qwen2-7b hymba-1.5b whisper-base]

For each architecture (published width, bf16, random weights from seed 0)
this serves ``chip_smoke.py``'s lever load on the dense slab (``--dense``;
whisper-base always decodes there): 4 requests of 64 prompt tokens, 8
generated, 1 partition of 4 slots, through ``serve.main`` four times in
turns, with flash decode's route forced to ``template`` (the decode
template of the earlier slices: ``fd_launch`` at ``decode_split.plan``,
its source and instances unchanged), then ``tma`` (what ``route_of``
picks for bf16), ``tma``, ``template``.  After each run it times bare
replays of the first engine's captured decode graph (CUDA events,
``decode_profile.replay_ms``: the step's device ms) and reads the
wrapper's launches by route.  Prints one line a run and one JSON line.
A card is required; without one it raises.
"""
from __future__ import annotations

import argparse
import gc
import json
from contextlib import contextmanager

import torch

from repro_torch.device import resolve
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.launch import serve
from repro_torch.profiling.decode_profile import replay_ms

ARCHS = ("qwen2-7b", "hymba-1.5b", "whisper-base")
LOAD = ["--partitions", "1", "--requests", "4", "--batch", "4",
        "--prompt-len", "64", "--gen", "8", "--device", "cuda"]
TURNS = ("template", "tma", "tma", "template")


@contextmanager
def forced(route: str):
    """The wrapper's route pick replaced by ``route`` for bf16 operands the
    tma route takes (the rest keep ``route_of``'s pick)."""
    pick = fd_ops.route_of
    fd_ops.route_of = lambda q, k, v: route if pick(q, k, v) == "tma" \
        else pick(q, k, v)
    try:
        yield
    finally:
        fd_ops.route_of = pick


def step_ms(arch: str, route: str) -> dict:
    """One served load with the route forced; the replayed step's device
    ms and the run's flash_decode launches by route."""
    argv = ["--arch", arch] + LOAD + (["--dense"] if arch != "whisper-base"
                                      else [])
    routes = fd_ops.flash_decode.routes
    routes.update(dict.fromkeys(routes, 0))
    engines = []
    with forced(route):
        serve.main(argv, engines_out=engines)
    eng = engines[0]
    out = dict(route=route, device_ms=replay_ms(eng.graph.graph, eng.device),
               launches=dict(routes))
    del engines, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    args = ap.parse_args(argv)
    resolve("cuda")
    results = {}
    for arch in args.arch:
        runs = []
        for route in TURNS:
            r = step_ms(arch, route)
            if r["launches"][route] == 0 or sum(r["launches"].values()) \
                    != r["launches"][route]:
                raise SystemExit(f"{arch}: flash_decode launches by route "
                                 f"{r['launches']} with {route} forced")
            runs.append(r)
            slab = "" if arch == "whisper-base" else " --dense"
            print(f"{arch}{slab}, flash_decode on {route}: replayed step "
                  f"{r['device_ms']:.4f} ms device; launches by route "
                  f"{r['launches']}", flush=True)
        results[arch] = {route: [r["device_ms"] for r in runs
                                 if r["route"] == route]
                         for route in ("template", "tma")}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "steps": results}), flush=True)


if __name__ == "__main__":
    main()

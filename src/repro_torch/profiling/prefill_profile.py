"""Where one prefill's time goes on the card: eager prefills against graph
replays, in turns, in one process.

  PYTHONPATH=src python -m repro_torch.profiling.prefill_profile \
      [--arch qwen2-7b] [--ops-only]

Builds the architecture (qwen2-7b by default; any the port serves) at its
published width (bf16, random weights from seed 0)
on one card and two paged ``PartitionEngine``s on those weights, each
seating the same 4 requests of 32 prompt tokens (the load of
``chip_smoke.py``) in one prefill wave.  One engine prefills eagerly
(``cuda_graph=False``), the other through its ``PrefillGraphs`` (the
serving default).  Two ops are measured, each through the engine's own
prefill hook, so a call includes what serving pays around the forward
(the pool install and the first token read back) and rewrites the same
blocks with the same values:

* **refill**: one 32-token prompt into slot 0 (``_refill_slot``), the
  slot refill of continuous batching;
* **wave**: the 4 x 32 ragged wave (``_run_prefill``; for the SSM and
  hybrid families one uniform group of 4 x 32).

After WARM calls of each op in each engine (the graph engine's first runs
eagerly, its second is captured), the two engines run each op in turns,
eager, graph, graph, eager, CALLS calls a turn, and ``decode_profile
.in_turns`` gives for each mode the wall per call (median, min, max), the
device per call from ``torch.profiler``, the idle share and the port's
kernels per call by name.  For the graph also the CUDA-event span of bare
replays of the op's captured graph and the capture seconds.

``capture_ab`` then times one capture of the refill's step both ways in
turns: through ``torch.cuda.graph`` (which synchronises and empties the
allocator's caches first) and through ``CapturedOp._record`` (a bare
capture on a side stream), each followed by one eager refill, whose wall
shows what the emptied caches cost the op after a capture.

Then the same in whole serving loads (``fleet_ab``): a fleet of FLEET
paged engines of SLOTS slots each (the serve CLI's layout in
``chip_smoke.py``), on the same weights, serves a load to its end, each
engine in turn running its wave or a decode step (refills run inside a
step).  Two fleets, built fresh for each run as a server starts cold:
"eager" is the engine without prefill graphs (the decode step replayed,
every prefill eager), "graph" the serving default (one ``PrefillGraphs``
for the fleet).
They run in turns, eager, graph, graph, eager, ROUNDS times; each run's
wall seconds and generated tokens per wall second, and a graph fleet's
prefill counts.
Every fleet must generate the same tokens.  The loads (``LOADS``):

* **refill-heavy**: the calibration's load, 32 requests of 32 prompt
  tokens x GEN (8 in the waves, 24 by refills, one refill shape);
* **mixed**: 24 prompt lengths (17-40), three requests each in a seeded
  order, x GEN: 26 prefill shapes, which the cache (``MAX_GRAPHS``)
  holds; also served by a graph fleet whose cache holds 16, so shapes are
  evicted, run eagerly again and captured again.

After the last graph run the memory its held graphs keep is measured by
dropping them (device memory reserved before and after).  ``--ops-only``
stops after the two ops (no ``capture_ab``, no fleets).  A card is
required; without one it raises.
"""
from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import api as mapi
from repro_torch.profiling.decode_profile import MODES, REPLAYS, in_turns, \
    replay_ms, timed
from repro_torch.serving import PartitionEngine, PrefillGraphs, RequestQueue
from repro_torch.serving.prefill_graph import MAX_GRAPHS

SLOTS, PROMPT, CALLS, WARM = 4, 32, 8, 2
OPS = ("refill", "wave")
FLEET, GEN, ROUNDS = 2, 16, 2
# each load's prompt lengths and fleets: None the eager fleet, a number the
# graph fleet's bound on held prefill graphs
LOADS = {"refill-heavy": ([PROMPT] * 32, {"eager": None,
                                          "graph": MAX_GRAPHS}),
         "mixed": ([int(n) for n in np.random.default_rng(5).permutation(
             np.repeat(np.arange(17, 41), 3))],
             {"eager": None, "graph": MAX_GRAPHS, "graph 16": 16})}


def _prefix(cfg) -> int:
    """Cache positions ahead of the prompt: a VLM's image prefix, a
    hybrid's meta tokens."""
    return (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0)


def _engine(cfg, api, params, cuda_graph: bool) -> PartitionEngine:
    engine = PartitionEngine(cfg, api, params, slots=SLOTS,
                             max_len=_prefix(cfg) + 2 * PROMPT,
                             block_size=16,
                             cuda_graph=cuda_graph)
    queue = RequestQueue()
    rng = np.random.default_rng(0)
    for _ in range(SLOTS):
        queue.submit(rng.integers(1, cfg.vocab, size=(PROMPT,))
                     .astype(np.int32), PROMPT)
    engine.assign(queue.pop(SLOTS))
    engine.prefill_wave(0.0)
    return engine


def _ops(engine):
    wave = list(engine.active)
    return {"refill": lambda: engine._refill_slot(0, wave[0]),
            "wave": lambda: engine._run_prefill(wave)}


def capture_ab(op, eager_refill, device, rounds: int = 2) -> dict:
    """Seconds of one capture (and its first replay) of ``op``'s step
    through ``torch.cuda.graph`` ("context") and ``op._record`` ("bare"),
    in turns (context, bare, bare, context) ``rounds`` times, and the wall
    ms of the eager refill run after each; medians by method."""
    def context():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            op._step(*op.buffers)
        return graph

    ways = {"context": context, "bare": lambda: op._record()[0]}
    got = {w: {"capture_s": [], "next_ms": []} for w in ways}
    for way in ["context", "bare", "bare", "context"] * rounds:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph = ways[way]()
        graph.replay()
        torch.cuda.synchronize(device)
        got[way]["capture_s"].append(time.perf_counter() - t0)
        got[way]["next_ms"] += [w * 1e3 for w in timed(eager_refill, device,
                                                       1)]
        del graph
    return {w: {k: float(np.median(v)) for k, v in r.items()}
            for w, r in got.items()}


def _fleet(cfg, api, params, lens, bound):
    """FLEET engines with ``lens``' requests dealt round robin (``GEN``
    tokens each), sharing one prefill cache of ``bound`` graphs; with
    ``bound`` None, engines without prefill graphs: the decode step
    replays, every prefill runs eagerly.  Returns the engines, the
    requests in order and the fleet's prefill cache (None)."""
    pg = PrefillGraphs(api) if bound else None
    if pg is not None:
        pg.max_graphs = bound
    rng = np.random.default_rng(1)
    queue = RequestQueue()
    for n in lens:
        queue.submit(rng.integers(1, cfg.vocab, size=(n,)).astype(np.int32),
                     GEN)
    requests = queue.pop(len(lens))
    engines = []
    for p in range(FLEET):
        eng = PartitionEngine(cfg, api, params, slots=SLOTS,
                              max_len=_prefix(cfg) + max(lens) + 4 * GEN,
                              pid=p,
                              block_size=16, prefill_graphs=pg)
        if pg is None:
            eng.prefill_graphs = None
        eng.assign(requests[p::FLEET])
        engines.append(eng)
    return engines, requests, pg


def _serve(engines) -> None:
    """Serve the fleet's load to its end, each engine in turn running its
    wave or one decode step (whose commit runs its refills)."""
    while any(not e.idle for e in engines):
        for eng in engines:
            if eng.wants_prefill:
                eng.prefill_wave(0.0)
            elif eng.busy:
                eng.decode_step(0.0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fleet_ab(cfg, api, params, loads=None) -> dict:
    """Each load of ``loads`` (default ``LOADS``) served by each of its
    fleets in turns (in order, then back: eager, graph, graph, eager),
    ``ROUNDS`` times, each run on a fresh fleet.  Returns {load: {mode:
    {wall_s: [..], tokens: n, prefills: {...} of a graph fleet's last
    run}}} and
    ``graph_bytes``, the device memory that the held prefill graphs of the
    last graph run kept, over ``held`` graphs."""
    device = api.device
    out = {}
    for load, (lens, modes) in (loads or LOADS).items():
        rec = {m: {"wall_s": []} for m in modes}
        tokens = None
        for mode in (list(modes) + list(modes)[::-1]) * ROUNDS:
            engines, requests, pg = _fleet(cfg, api, params, lens,
                                           modes[mode])
            _sync(device)
            t0 = time.perf_counter()
            _serve(engines)
            _sync(device)
            rec[mode]["wall_s"].append(time.perf_counter() - t0)
            got = [list(r.tokens) for r in requests]
            if tokens is not None and got != tokens:
                raise RuntimeError(f"prefill_profile: the {mode} fleet's "
                                   f"tokens on {load} differ from the "
                                   "other fleets'")
            tokens = got
            rec[mode]["tokens"] = sum(map(len, got))
            if pg is not None:
                rec[mode]["prefills"] = dict(
                    shapes=len(pg.uses), uses=sum(pg.uses.values()),
                    eager=pg.n_eager, captures=pg.n_captures,
                    replays=pg.n_replays, evictions=pg.n_evictions,
                    capture_s=pg.capture_s, held=len(pg),
                    refills=sum(e.n_refills for e in engines))
                if len(pg) > pg.max_graphs:
                    raise RuntimeError(f"prefill_profile: {len(pg)} graphs "
                                       f"held (bound {pg.max_graphs})")
                if device.type == "cuda":
                    gc.collect()
                    torch.cuda.empty_cache()
                    before = torch.cuda.memory_reserved(device)
                    out["held"] = len(pg)
                    pg._entries.clear()
                    gc.collect()
                    torch.cuda.empty_cache()
                    out["graph_bytes"] = \
                        before - torch.cuda.memory_reserved(device)
            del engines, requests, pg
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out[load] = rec
    return out


def run(arch: str = "qwen2-7b", ops_only: bool = False) -> dict:
    """The A/B above; returns {op: {mode: {wall_ms, wall_min_ms,
    wall_max_ms, device_ms, idle, kernels}, replay_device_ms}} plus the
    graphs' ``capture_s`` and the A/B's ``peak_gb`` (and, unless
    ``ops_only``, ``capture_ab`` and ``fleets``)."""
    device = resolve("cuda")
    cfg = get_config(arch)
    api = mapi.build(cfg, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.reset_peak_memory_stats(device)
    engines = {"eager": _engine(cfg, api, params, cuda_graph=False),
               "graph": _engine(cfg, api, params, cuda_graph=True)}
    ops = {mode: _ops(eng) for mode, eng in engines.items()}
    pg = engines["graph"].prefill_graphs
    keys = {"refill": pg.key(params, 1, PROMPT, _prefix(cfg) + PROMPT,
                             False),
            # an SSM-bearing wave of one prompt length is one uniform group
            "wave": pg.key(params, SLOTS, PROMPT, _prefix(cfg) + 2 * PROMPT,
                           not engines["graph"]._has_ssm())}
    out = {"tables": {}}
    for op in OPS:
        for mode in MODES:
            for _ in range(WARM):
                ops[mode][op]()
        out[op], out["tables"][op] = in_turns(
            {mode: ops[mode][op] for mode in MODES}, device, CALLS)
        out[op]["replay_device_ms"] = replay_ms(pg._entries[keys[op]].graph,
                                                device)
    if pg.n_captures != len(OPS) or pg.n_evictions:
        raise RuntimeError(f"prefill_profile: {pg.n_captures} captures, "
                           f"{pg.n_evictions} evictions (want one capture "
                           "an op)")
    out["capture_s"] = pg.capture_s
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["card"] = torch.cuda.get_device_name(device)
    out["arch"] = cfg.name
    if ops_only:
        return out
    out["capture_ab"] = capture_ab(pg._entries[keys["refill"]],
                                   ops["eager"]["refill"], device)
    del engines, ops, pg
    gc.collect()
    torch.cuda.empty_cache()
    out["fleets"] = fleet_ab(cfg, api, params)
    return out


def report_fleets(out: dict) -> None:
    for load, rec in out.items():
        if load in ("graph_bytes", "held"):
            continue
        for mode, r in rec.items():
            walls = ", ".join(f"{w:.3f}" for w in r["wall_s"])
            rates = ", ".join(f"{r['tokens'] / w:.2f}" for w in r["wall_s"])
            print(f"  fleet {load} {mode}: {FLEET} x {SLOTS} slots, "
                  f"{r['tokens']} tokens; wall s {walls}; generated tokens "
                  f"per wall second {rates}")
            if "prefills" in r:
                print(f"  fleet {load} {mode} prefills (last run): "
                      f"{r['prefills']}")
    if "graph_bytes" in out:
        print(f"  the last graph run's {out['held']} held prefill graphs "
              f"kept {out['graph_bytes'] / 2**20:.1f} MiB of device memory "
              f"({out['graph_bytes'] / 2**20 / max(out['held'], 1):.1f} MiB "
              "a graph)")


def report(out: dict) -> None:
    print(f"prefill_profile: {out['arch']} slots={SLOTS} prompt={PROMPT}, each "
          f"op {2 * CALLS} calls a mode in turns (eager, graph, graph, "
          f"eager) on {out['card']}")
    for op in OPS:
        for mode in MODES:
            r = out[op][mode]
            dev = "not measured (the profiler recorded no device activity)" \
                if r["device_ms"] is None else \
                f"{r['device_ms']:.3f} ms ({r['port_ms']:.3f} in the port's " \
                f"kernels, {r['other_ms']:.3f} in the others), idle share " \
                f"{r['idle']:.3f}"
            print(f"  {op} {mode}: wall per call median {r['wall_ms']:.3f} "
                  f"ms (min {r['wall_min_ms']:.3f}, max "
                  f"{r['wall_max_ms']:.3f}); device per call {dev}; "
                  f"kernels per call (profiler) {r['kernels']}")
        print(f"  {op} graph: {REPLAYS} bare replays "
              f"{out[op]['replay_device_ms']:.3f} ms each (CUDA events)")
    print(f"  captures {out['capture_s']:.3f} s in all; peak memory "
          f"{out['peak_gb']:.2f} GB")
    for way, r in out.get("capture_ab", {}).items():
        print(f"  refill capture by {way}: median {r['capture_s']:.4f} s; "
              f"the eager refill after it {r['next_ms']:.3f} ms wall")
    if "fleets" in out:
        report_fleets(out["fleets"])
    for op in OPS:
        for mode in MODES:
            events = out["tables"][op][mode]
            sort = "self_device_time_total" \
                if hasattr(events[0], "self_device_time_total") \
                else "self_cuda_time_total"
            print(f"  {op} {mode} under the profiler:")
            print(events.table(sort_by=sort, row_limit=10))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--ops-only", action="store_true",
                    help="time the refill and the wave only")
    args = ap.parse_args(argv)
    report(run(args.arch, args.ops_only))


if __name__ == "__main__":
    main()

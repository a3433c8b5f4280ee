"""Where one decode step's time goes on the card: eager steps against graph
replays, in turns, in one process.

  PYTHONPATH=src python -m repro_torch.profiling.decode_profile \
      [--arch qwen2-7b]

Builds the architecture (qwen2-7b by default; any the port serves) at its
published width (bf16, random weights from seed 0)
on one card and two paged ``PartitionEngine``s on those weights, each
seating the same 4 requests of 32 prompt tokens (the load of
``chip_smoke.py``) in one prefill wave.  One engine runs every decode step
eagerly (``cuda_graph=False``), the other through its ``DecodeGraph`` (the
serving default: its first step eager, its second captured, replays after
that).  After WARM steps each, the two step in turns, eager, graph,
graph, eager, STEPS steps a turn, and for each mode this measures:

1. **wall per step**: host clock around ``decode_step``, with
   ``torch.cuda.synchronize()`` on both edges; median, min and max over the
   2 x STEPS steps of the turns;
2. **device per step**: under ``torch.profiler`` (CPU + CUDA activities),
   the device time of every kernel, copy and memset over STEPS more steps,
   summed and divided by STEPS; for the graph also the CUDA-event span of
   REPLAYS bare replays of its captured graph (no host work in between:
   the device time of the replayed step, gaps between its kernels
   included);
3. **idle share**: 1 - device per step / median wall per step;
4. **kernels per step**: the port's own kernels in the same profiler
   trace, by name (``port_kernels``), divided by STEPS.  The trace is the
   source because a replay runs its kernels without the wrappers that
   count launches;
5. **the port's share**: the device ms a step in the port's own kernels
   (``port_ms``) and in every other kernel, copy and memset (``other_ms``:
   the eager torch ops between them, an SSM's decode math among them).

It prints the capture's seconds, peak device memory over the whole A/B and
the profiler's top kernels for each mode; ``run()`` returns the numbers.
A card is required; without one it raises.
"""
from __future__ import annotations

import argparse
import re
import time
from collections import Counter
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import api as mapi
from repro_torch.serving import PartitionEngine, RequestQueue

SLOTS, PROMPT, STEPS, WARM, REPLAYS = 4, 32, 8, 2, 20
GEN = 1 + WARM + 3 * STEPS + 1   # every slot stays active to the end
MODES = ("eager", "graph")
# the __global__ functions of kernels/csrc, as the profiler names them
PORT_KERNEL = re.compile(r"\b(mm_mma|mm_skinny|mm_tiled|split_reduce|"
                         r"fa_kernel|fa_mma_kernel|fa_bwd_delta|fa_bwd_dkdv|"
                         r"fa_bwd_dq|decode::kernel|"
                         r"decode::combine|conv_igemm|conv_mma)\b")


def _device_us(event) -> float:
    """Device microseconds of one profiler row that runs on the card (a
    kernel, memcpy or memset); 0 for a host-side op, whose device time is
    already counted in the rows of the kernels it launched."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def port_kernels(events) -> Dict[str, int]:
    """Launches of the port's own kernels among a profiler's
    ``key_averages()`` rows, by kernel name without its template
    arguments."""
    out = Counter()
    for e in events:
        m = PORT_KERNEL.search(e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            out[m.group(1)] += e.count
    return dict(out)


def _engine(cfg, api, params, cuda_graph: bool) -> PartitionEngine:
    engine = PartitionEngine(cfg, api, params, slots=SLOTS,
                             max_len=(cfg.n_img_tokens or 0) +
                             (cfg.n_meta_tokens or 0) + PROMPT + GEN,
                             block_size=16,
                             cuda_graph=cuda_graph)
    queue = RequestQueue()
    rng = np.random.default_rng(0)
    for _ in range(SLOTS):
        queue.submit(rng.integers(1, cfg.vocab, size=(PROMPT,))
                     .astype(np.int32), GEN)
    engine.assign(queue.pop(SLOTS))
    engine.prefill_wave(0.0)
    return engine


def timed(op, device, n: int):
    """Wall seconds of each of ``n`` calls of ``op()``, with the card
    synchronised on both edges."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        op()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return walls


def profiled(op, device, n: int):
    """``n`` calls of ``op()`` under the profiler: its ``key_averages()``
    rows and the device ms a call (every kernel, copy and memset)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            op()
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    return events, sum(_device_us(e) for e in events) / n / 1e3


def port_ms(events, n: int) -> float:
    """Device ms a call in the port's own kernels among ``events``."""
    return sum(_device_us(e) for e in events
               if PORT_KERNEL.search(e.key)) / n / 1e3


def replay_ms(graph, device) -> float:
    """Mean CUDA-event span of ``REPLAYS`` bare replays of ``graph`` (the
    host queues them all while the card sleeps ~10 ms, so the span is
    device time).  A bare replay of a decode step or a prefill rewrites
    the same K/V rows with the same values."""
    graph.replay()
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(REPLAYS):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / REPLAYS


def in_turns(ops, device, n: int):
    """``ops`` ({"eager": op, "graph": op}) timed in turns, eager, graph,
    graph, eager, ``n`` calls a turn, then ``n`` more of each under the
    profiler.  Returns ({mode: {wall_ms, wall_min_ms, wall_max_ms,
    device_ms, idle, kernels, port_ms, other_ms}}, {mode: profiler
    rows})."""
    walls = {m: [] for m in MODES}
    for mode in ("eager", "graph", "graph", "eager"):
        walls[mode] += timed(ops[mode], device, n)
    out, tables = {}, {}
    for mode in MODES:
        events, dev_ms = profiled(ops[mode], device, n)
        tables[mode] = events
        med = float(np.median(walls[mode]))
        out[mode] = {
            "wall_ms": med * 1e3, "wall_min_ms": min(walls[mode]) * 1e3,
            "wall_max_ms": max(walls[mode]) * 1e3,
            "device_ms": dev_ms if dev_ms > 0 else None,
            "idle": 1 - dev_ms / (med * 1e3) if dev_ms > 0 else None,
            "port_ms": port_ms(events, n) if dev_ms > 0 else None,
            "other_ms": dev_ms - port_ms(events, n) if dev_ms > 0 else None,
            "kernels": {k: c / n
                        for k, c in sorted(port_kernels(events).items())}}
    return out, tables


def run(arch: str = "qwen2-7b") -> dict:
    """The A/B above; returns {mode: {wall_ms, wall_min_ms, wall_max_ms,
    device_ms, idle, kernels}} plus the graph's ``replay_device_ms``,
    ``capture_s`` and the A/B's ``peak_gb``."""
    device = resolve("cuda")
    cfg = get_config(arch)
    api = mapi.build(cfg, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.reset_peak_memory_stats(device)
    engines = {"eager": _engine(cfg, api, params, cuda_graph=False),
               "graph": _engine(cfg, api, params, cuda_graph=True)}
    for eng in engines.values():
        for _ in range(WARM):
            eng.decode_step(0.0)
    ops = {m: (lambda e=e: e.decode_step(0.0)) for m, e in engines.items()}
    out, tables = in_turns(ops, device, STEPS)
    graph = engines["graph"].graph
    out["replay_device_ms"] = replay_ms(graph.graph, device)
    out["capture_s"] = graph.capture_s
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["card"] = torch.cuda.get_device_name(device)
    out["arch"] = cfg.name
    out["tables"] = tables
    return out


def report(out: dict) -> None:
    print(f"decode_profile: {out['arch']} slots={SLOTS} prompt={PROMPT} steps "
          f"{2 * STEPS} a mode in turns (eager, graph, graph, eager) on "
          f"{out['card']}")
    for mode in MODES:
        r = out[mode]
        dev = "not measured (the profiler recorded no device activity)" \
            if r["device_ms"] is None else \
            f"{r['device_ms']:.3f} ms ({r['port_ms']:.3f} in the port's " \
            f"kernels, {r['other_ms']:.3f} in the others), idle share " \
            f"{r['idle']:.3f}"
        print(f"  {mode}: wall per step median {r['wall_ms']:.3f} ms (min "
              f"{r['wall_min_ms']:.3f}, max {r['wall_max_ms']:.3f}); device "
              f"per step {dev}; kernels per step (profiler) {r['kernels']}")
    print(f"  graph: {REPLAYS} bare replays {out['replay_device_ms']:.3f} ms "
          f"each (CUDA events); capture {out['capture_s']:.3f} s; peak "
          f"memory {out['peak_gb']:.2f} GB")
    for mode in MODES:
        events = out["tables"][mode]
        sort = "self_device_time_total" \
            if hasattr(events[0], "self_device_time_total") \
            else "self_cuda_time_total"
        print(f"  {mode} steps under the profiler:")
        print(events.table(sort_by=sort, row_limit=12))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    report(run(ap.parse_args(argv).arch))


if __name__ == "__main__":
    main()

"""Where one decode step's time goes on the card: wall clock vs device busy.

  PYTHONPATH=src python -m repro_torch.profiling.decode_profile

Builds qwen2-7b at its published width (bf16, random weights from seed 0)
on one card, seats 4 requests of 32 prompt tokens (the load of
``chip_smoke.py``) in a paged ``PartitionEngine`` with one prefill wave,
and then measures 8 decode steps twice:

1. host wall clock per step, ``torch.cuda.synchronize()`` on both edges;
2. under ``torch.profiler`` (CPU + CUDA activities): the device time of
   every kernel and copy, summed per step, and the top kernels by device
   time.

It prints the device-busy share of the step (device time under the
profiler / median wall time without it), the kernel launches per step from
the port's wrapper counters, and the profiler's table.  A card is
required; without one it raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import api as mapi
from repro_torch.serving import PartitionEngine, RequestQueue

WRAPPERS = {"matmul": mm_ops.matmul, "flash_attention": fa_ops.flash_attention,
            "paged_decode": pa_ops.paged_decode}
SLOTS, PROMPT, STEPS, WARM = 4, 32, 8, 2


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


def main():
    device = resolve("cuda")
    cfg = get_config("qwen2-7b")
    api = mapi.build(cfg, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    gen = 1 + WARM + 2 * STEPS
    engine = PartitionEngine(cfg, api, params, slots=SLOTS,
                             max_len=PROMPT + gen, block_size=16)
    queue = RequestQueue()
    rng = np.random.default_rng(0)
    for _ in range(SLOTS):
        queue.submit(rng.integers(1, cfg.vocab, size=(PROMPT,))
                     .astype(np.int32), gen)
    engine.assign(queue.pop(SLOTS))
    engine.prefill_wave(0.0)
    for _ in range(WARM):
        engine.decode_step(0.0)

    walls = []
    for w in WRAPPERS.values():
        w.launches = 0
    for _ in range(STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        engine.decode_step(0.0)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    launches = {k: w.launches / STEPS for k, w in WRAPPERS.items()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            engine.decode_step(0.0)
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    dev_us = sum(_device_us(e) for e in events) / STEPS

    med = float(np.median(walls))
    print(f"decode_profile: {cfg.name} slots={SLOTS} prompt={PROMPT} "
          f"steps={STEPS} on "
          f"{torch.cuda.get_device_name(device)}")
    print(f"  wall per decode step: median {med * 1e3:.3f} ms, min "
          f"{min(walls) * 1e3:.3f} ms, max {max(walls) * 1e3:.3f} ms "
          f"(profiler off)")
    print(f"  launches per step: {launches}")
    if dev_us > 0:
        busy = dev_us / 1e6 / med
        print(f"  device time per step: {dev_us / 1e3:.3f} ms; device busy "
              f"share of the median wall step {busy:.3f} (idle "
              f"{1 - busy:.3f})")
    else:
        print("  device time per step: not measured (the profiler recorded "
              "no device activity)")
    sort = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    print(events.table(sort_by=sort, row_limit=15))


if __name__ == "__main__":
    main()

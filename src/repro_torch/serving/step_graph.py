"""One engine's decode step, captured once as a CUDA graph and replayed.

The port's counterpart of the reference's jitted decode step,
``jax.jit(pg, donate_argnums=(2,))`` (paged) and ``jax.jit(api.decode,
donate_argnums=(2,))`` (dense slab) in ``src/repro/serving/engine.py:686-688``:
the reference compiles the step once per engine and the host then only
feeds it.  Run eagerly, the port's step issues about 2,300 torch ops and
ctypes launches from Python, and the card waits on the host for most of
the step.  A ``DecodeGraph`` records those launches once and replays them.

What a replay needs to hold still:

* **inputs** — the graph owns static device buffers for the step's inputs,
  ``token`` (slots, 1), ``lens`` (slots,) and, paged, ``tables`` (slots,
  table_width), all int32, beside pinned host staging buffers.  Each step
  the host writes the staging buffers and issues one non-blocking
  ``copy_`` per buffer on the stream the graph replays on;
* **state** — the KV pool (or the dense slab) is updated in place at fixed
  addresses (the stand-in for ``donate_argnums``); the engine never
  reallocates it;
* **outputs** — the logits (slots, V) f32 and greedy tokens (slots,) int32
  come back in the graph's own buffers, rewritten by every replay.

The first step runs eagerly on the static buffers: a real step whose K/V
rows stay, which builds or loads every kernel library and runs every
first-use setup before anything is captured.  The second is captured once
(``torch.cuda.graph``) and replayed, since capture records work without
running it; every later step is fill, replay, read.  The kernel wrappers
count the launches the capture pass records into the graph, once; a
replay runs them again without the wrappers and adds nothing to their
counts.  The graph counts its eager steps, replays and capture seconds
itself, and a profiler trace of a replay shows its kernels by name
(``profiling/decode_profile.port_kernels``).

There is no fallback: an op that cannot be captured raises out of the
capture with its own error.  On the CPU, where torch has no graphs, every
step runs the same static-buffer path eagerly.  Each graph keeps its own
memory pool (one step's intermediates): torch refuses a shared pool's
handle once every graph captured into it has been released, and the
capture's own ``gc.collect()`` can release them between choosing the pool
and capturing into it.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

# every wrapper a decode step can issue a kernel through
WRAPPERS = (mm_ops.matmul, fa_ops.flash_attention, pa_ops.paged_decode,
            pa_ops.paged_decode_quant, pa_ops.paged_decode_sparse,
            fd_ops.flash_decode)


class DecodeGraph:
    """Static buffers and the captured graph of one engine's decode step.

    ``step(token, lens, tables)`` is the step on the static buffers
    (``tables`` is None for the dense slab) and returns ``(logits (slots,
    V) f32, tokens (slots,) int32)``.  Calling the graph with host arrays
    fills the buffers, runs the step (eagerly the first time, captured the
    second, replayed after that; eagerly every time on the CPU) and returns
    the output tensors, which the next call overwrites.  ``n_eager``,
    ``n_replays`` and ``capture_s`` count its steps and time its capture.
    """

    def __init__(self, step: Callable, *, slots: int, device: torch.device,
                 table_width: Optional[int] = None):
        self._step = step
        self.device = device
        self.on_card = device.type == "cuda"
        shapes = [(slots, 1), (slots,)]
        if table_width is not None:
            shapes.append((slots, table_width))
        self.buffers = [torch.zeros(s, dtype=torch.int32, device=device)
                        for s in shapes]
        self._staging = [torch.zeros(s, dtype=torch.int32,
                                     pin_memory=self.on_card)
                         for s in shapes]
        self.graph = None
        self.out = None
        self.n_eager = 0
        self.n_replays = 0
        self.capture_s = 0.0

    @property
    def warm(self) -> bool:
        """True when the next step is a steady one: a replay on the card,
        any step on the CPU (the first two steps on a card warm up and
        capture)."""
        return self.graph is not None or not self.on_card

    def __call__(self, token: np.ndarray, lens: np.ndarray,
                 tables: Optional[np.ndarray] = None):
        host = [token, lens] + ([tables] if tables is not None else [])
        for src, stage, buf in zip(host, self._staging, self.buffers,
                                   strict=True):
            stage.numpy()[...] = src
            buf.copy_(stage, non_blocking=True)
        if not self.on_card or self.n_eager == 0:
            self.out = self._step(*self.buffers)
            self.n_eager += 1
            return self.out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.n_replays += 1
        return self.out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph):
            out = self._step(*self.buffers)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out = graph, out

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
  the host writes the staging buffers (once the last step's copies have
  run) and issues one non-blocking ``copy_`` per buffer on the stream the
  graph replays on;
* **state** — the KV pool (or the dense slab), and for the SSM families
  each slot's SSM state and conv window beside it, are updated in place
  at fixed addresses (the stand-in for ``donate_argnums``); the engine
  never reallocates them;
* **outputs** — the logits (slots, V) f32 and greedy tokens (slots,) int32
  come back in the graph's own buffers, rewritten by every replay.

The first step runs eagerly on the static buffers: a real step whose K/V
rows stay, which builds or loads every kernel library and runs every
first-use setup before anything is captured.  The second is captured once
(on a side stream, into the graph's own memory pool) and replayed, since
capture records work without running it; every later step is fill,
replay, read.  The kernel wrappers
count the launches the capture pass records into the graph, once; a
replay runs them again without the wrappers and adds nothing to their
counts.  The graph counts its eager steps, replays and capture seconds
itself, and a profiler trace of a replay shows its kernels by name
(``profiling/decode_profile.port_kernels``).

There is no fallback: an op that cannot be captured raises out of the
capture with its own error.  On the CPU, where torch has no graphs, every
step runs the same static-buffer path eagerly.  Each graph keeps its own
memory pool (one step's intermediates): torch refuses a shared pool's
handle once every graph captured into it has been released.

That lifecycle is ``CapturedOp``'s; ``DecodeGraph`` is one, and the
prefill graphs (``serving/prefill_graph.py``) keep one a shape.
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


class CapturedOp:
    """One op on static device buffers: run eagerly at its first call,
    captured as a CUDA graph at its second, replayed after that.

    ``step(*buffers)`` is the op on the static buffers, one of each of
    ``shapes``, int32 unless ``dtypes`` gives each buffer's dtype (an
    enc-dec wave's frames are f32), and returns its output tensors.  Calling the op with host
    arrays, one a buffer, copies them in through pinned staging (one
    non-blocking ``copy_`` each), runs the step (eagerly the first time,
    captured the second, replayed after that; eagerly every time on the
    CPU) and returns the output tensors, which the next call overwrites.
    ``last`` says what the last call did ("eager", "capture" or
    "replay"); ``n_eager``, ``n_replays`` (a capture's own call included)
    and ``capture_s`` count its calls and time its capture.
    """

    def __init__(self, step: Callable, shapes, device: torch.device,
                 dtypes=None):
        self._step = step
        self.device = device
        self.on_card = device.type == "cuda"
        dtypes = dtypes or [torch.int32] * len(shapes)
        self.buffers = [torch.zeros(s, dtype=dt, device=device)
                        for s, dt in zip(shapes, dtypes, strict=True)]
        self._staging = [torch.zeros(s, dtype=dt, pin_memory=self.on_card)
                         for s, dt in zip(shapes, dtypes, strict=True)]
        self._copied = None     # the card's event after the last copy_ in
        self.graph = None
        self.out = None
        self.last = None
        self.n_eager = 0
        self.n_replays = 0
        self.capture_s = 0.0

    @property
    def warm(self) -> bool:
        """True when the next call is a steady one: a replay on the card,
        any call on the CPU (the first two calls on a card warm up and
        capture)."""
        return self.graph is not None or not self.on_card

    def __call__(self, *host: np.ndarray):
        if self._copied is not None:
            self._copied.synchronize()   # staging is free to rewrite
        for src, stage, buf in zip(host, self._staging, self.buffers,
                                   strict=True):
            stage.numpy()[...] = src
            buf.copy_(stage, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        if not self.on_card or self.n_eager == 0:
            self.out = self._step(*self.buffers)
            self.n_eager += 1
            self.last = "eager"
            return self.out
        self.last = "replay"
        if self.graph is None:
            t0 = time.perf_counter()
            self.graph, self.out = self._record()
            self.capture_s = time.perf_counter() - t0
            self.last = "capture"
        self.graph.replay()
        self.n_replays += 1
        return self.out

    def _record(self):
        """Capture the step into a new CUDA graph with its own memory pool,
        on a side stream; returns the graph and the output tensors its
        replays write.  A bare capture: ``torch.cuda.graph`` would first
        synchronise and empty the allocator's caches, so that the ops
        after it allocate their memory again
        (``profiling/prefill_profile.capture_ab`` times both)."""
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.capture_begin()
                out = self._step(*self.buffers)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
        return graph, out


class DecodeGraph(CapturedOp):
    """One engine's decode step as a ``CapturedOp``.

    ``step(token, lens, tables)`` is the step on the static buffers
    (``tables`` is None for the dense slab) and returns ``(logits (slots,
    V) f32, tokens (slots,) int32)``.
    """

    def __init__(self, step: Callable, *, slots: int, device: torch.device,
                 table_width: Optional[int] = None):
        shapes = [(slots, 1), (slots,)]
        if table_width is not None:
            shapes.append((slots, table_width))
        super().__init__(step, shapes, device)

    def __call__(self, token: np.ndarray, lens: np.ndarray,
                 tables: Optional[np.ndarray] = None):
        return super().__call__(
            token, lens, *([tables] if tables is not None else []))

"""Prefill waves and slot refills, captured once per shape as CUDA graphs
and replayed; one cache shared by the engines of a card.

The port's counterpart of the reference's jitted prefills in
``src/repro/serving/engine.py:694-702``: ``jax.jit(lambda p, b, lens:
api.prefill(p, b, max_len=max_len, lens=lens))`` for a ragged wave and
``jax.jit(..., static_argnames=("ml",))`` for a batch-1 refill, both
shareable across engines so that "a fleet compiles each distinct prompt
length once, not once per partition".  Run eagerly, one prefill of the
port issues about 2,000 torch ops and ctypes launches from Python and the
card waits on the host for most of it.  A ``PrefillGraphs`` records them
once per shape and replays them.

A shape is ``(params, rows, width, max_len, ragged)``: the weights (a graph
reads their addresses), the batch rows and padded prompt width of the
token buffer, the cache length, and whether the prefill takes a ``lens``
vector (a ragged wave) or not (a refill: one prompt, every row full; or
one group of an SSM family's wave, every prompt of one length, padded to
the slot width with zero prompts).  An enc-dec wave (``encode``) takes
no tokens: its one input is the frames (rows, enc_seq, d) f32, which the
encoder and each layer's cross K/V are computed from, so its width is
enc_seq whatever the prompts' width and one entry serves every wave of
a fleet (the serve CLI's jitted enc-dec ``prefill_fn`` in the reference,
``src/repro/launch/serve.py:193-194``).  A cache serves one api (an engine refuses another's), so a VLM's image
prefix, the zero patch embeddings ``ModelAPI.prefill_batch`` makes inside
the step, has one width per cache and needs no place in the key.
Each shape's entry is a ``CapturedOp`` (``serving/step_graph.py``, the
lifecycle ``DecodeGraph`` has too), which owns

* **inputs** — static device buffers ``tokens`` (rows, width) and, ragged,
  ``lens`` (rows,), int32 (an enc-dec wave: ``frames`` f32), beside
  pinned host staging buffers; each use writes the staging buffers and
  issues one non-blocking ``copy_`` per buffer;
* **outputs** — ``(logits (rows, V) f32, dense cache)`` in the graph's own
  tensors (the SSM families' cache holds their state and conv window
  too; an enc-dec wave's logits are None), rewritten by the next replay
  of the entry.  The caller copies
  what it keeps (the engine installs the cache into its pool or slab at
  once, outside the graph, which is what lets engines with different
  pools share one graph).

Lifecycle per shape, as ``DecodeGraph``'s per engine: the first use runs
eagerly on the static buffers (it builds or loads every kernel library
and runs every first-use setup), the second is captured
(on a side stream, its own memory pool) and replayed, every later use
fills the buffers and replays.  The cache keeps at most ``MAX_GRAPHS``
entries, least recently used out first (each graph keeps one prefill's
intermediates; the reference's jit cache has no bound).  The kernel
wrappers count what the eager run and the capture issue; a replay adds
nothing to their counts.

There is no fallback: an op that cannot be captured raises out of the
capture with its own error.  On the CPU, where torch has no graphs, every
use runs the same static-buffer path eagerly.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.step_graph import CapturedOp

# a held graph keeps 13-24 MiB of device memory at full-width qwen2-7b
# and prompts of up to 40 tokens (PERF.md §5): 64 hold under 1.6 GB, and a
# load of a few dozen prompt lengths does not evict what it will replay
MAX_GRAPHS = 64


class PrefillGraphs:
    """A bounded cache of captured prefills of one model api, by shape.

    ``graphs(params, tokens, max_len, lens=None)`` runs ``api.prefill`` on
    ``tokens`` ((rows, width) int host array; ``lens`` (rows,) for a ragged
    wave) and returns ``(logits (rows, V) f32, dense cache)``: eagerly at a
    shape's first use, captured at its second, replayed after that (eagerly
    every time on the CPU).  The returned tensors belong to the entry and
    the next use of its shape overwrites them.  It holds at most
    ``max_graphs`` (``MAX_GRAPHS``) entries.  ``n_eager``, ``n_captures``,
    ``n_replays`` (a capture's own use included), ``n_evictions`` and
    ``capture_s`` count and time its uses over every entry it has held;
    ``n_steady`` counts the uses that ran as the steady path does (a
    replay of a graph captured earlier; on the CPU every use); ``uses``
    counts them by shape.
    """

    op_type = CapturedOp

    def __init__(self, api):
        self.api = api
        self.max_graphs = MAX_GRAPHS
        self.device = api.device
        self._entries: OrderedDict = OrderedDict()
        self.uses: Counter = Counter()
        self.n_eager = 0
        self.n_captures = 0
        self.n_replays = 0
        self.n_steady = 0
        self.n_evictions = 0
        self.capture_s = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key(params, rows: int, width: int, max_len: int,
            ragged: bool) -> tuple:
        return (id(params), int(rows), int(width), int(max_len), bool(ragged))

    def __call__(self, params, tokens: np.ndarray, max_len: int,
                 lens: Optional[np.ndarray] = None):
        inputs = [tokens] + ([lens] if lens is not None else [])
        return self._use(params, inputs, max_len, lens is not None)

    def encode(self, params, frames: np.ndarray, max_len: int):
        """An enc-dec api's wave: ``api.prefill`` of the frames ((rows,
        enc_seq, d) f32 host array), returning ``(None, cache)``, keyed
        (params, rows, enc_seq, max_len, False)."""
        return self._use(params, [frames], max_len, False)

    def _use(self, params, inputs, max_len: int, ragged: bool):
        rows, width = inputs[0].shape[:2]
        key = self.key(params, rows, width, max_len, ragged)
        self.uses[key] += 1
        op = self._entries.get(key)
        if op is None:
            if len(self._entries) >= self.max_graphs:
                self._entries.popitem(last=False)
                self.n_evictions += 1
            op = self._entries[key] = self._new_op(
                params, max_len, [a.shape for a in inputs])
        else:
            self._entries.move_to_end(key)
        self.n_steady += op.warm
        out = op(*inputs)
        if op.last == "eager":
            self.n_eager += 1
        else:
            self.n_replays += 1
            if op.last == "capture":
                self.n_captures += 1
                self.capture_s += op.capture_s
        return out

    def _new_op(self, params, max_len: int, shapes) -> CapturedOp:
        """One shape's entry; its step holds ``params``, which keeps
        ``id(params)`` in the key in use while the entry lives."""
        if self.api.cfg.family == "encdec":
            def encode(frames):
                return self.api.prefill(params, self.api.prefill_batch(
                    frames), max_len=max_len)
            return self.op_type(encode, shapes, self.device, [torch.float32])

        def step(tokens, lens=None):
            return self.api.prefill(params, self.api.prefill_batch(tokens),
                                    max_len=max_len, lens=lens)
        return self.op_type(step, shapes, self.device)

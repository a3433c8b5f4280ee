"""The train step, captured once as a CUDA graph and replayed.

The port's counterpart of the reference's jitted step, ``jax.jit(step_fn,
donate_argnums=(0, 1))`` (``src/repro/launch/train.py:102`` and
``src/repro/runtime/partition_runtime.py:49``): the reference compiles its
step once and the host then only feeds it.  Run eagerly, the port's step
issues every microbatch's forward and backward, the f32 accumulation, the
global norm and AdamW over every leaf op by op from Python, and on the
small families the card waits on the host for most of the step.  A
``TrainGraph`` wraps a step of ``runtime/steps.py`` (``make_train_step`` or
``make_partitioned_train_step``, which stay plain functions) and records
the whole step, all of that, as one graph.

What a replay needs to hold still:

* **the batch** — static device buffers, one a batch key (``tokens``,
  ``labels``, any ``mask``, a VLM's ``img_embeds``, an enc-dec's
  ``enc_embeds``), filled through pinned staging as ``CapturedOp`` fills
  its buffers.  The first batch fixes their keys, shapes and dtypes (the
  shape cell's); a batch of another layout raises;
* **the state** — the step updates the params, m and v in place (the
  stand-in for ``donate_argnums``); the wrapper also writes the new step
  count into the caller's counter, ``opt_state.step``, since the step
  returns it as a new tensor and a replay reads the counter it captured:
  without that the learning rate and Adam's bias corrections would freeze
  at the capture.  The caller gets its own trees back, so the state it
  passes next is the state the next replay reads;
* **the replica** — a graph is bound to the addresses of the params, m, v
  and counter it captured.  The graphs are kept by those addresses, one a
  replica (each of the partition runtime's P replicas, a clone that
  ``add_partition`` makes, a restore into new tensors, views of stacked
  tensors), all captured into one memory pool; a graph is never replayed
  over other tensors.  Each graph holds
  its replica's tensors, so their addresses are not reused while it lives;
* **the outputs** — the loss, metrics, ``grad_norm`` and ``lr`` come back
  in the graph's buffers, which the next replay rewrites, so the wrapper
  returns copies of them (a few scalars).

Each replica's step is a ``CapturedOp`` (``serving/step_graph.py``): its
first call runs eagerly on the static buffers and its second is captured
and replayed; both, and every replay, run on the wrapper's side stream,
as PyTorch's whole-network capture recipe warms up and captures (the
lazy first-use setup, cuBLAS's workspace of that stream among it, happens
before the capture).  ``torch.autograd.grad`` runs under the capture: the
backward's kernels, ``MatMul``'s products and the attention backward, take
the stream their forward ran on, the capture's.  The kernel wrappers count
what the eager step and the capture issue, once each; a replay adds
nothing to their counts (``profiling/train_counts.issued_steps``).

There is no fallback: an op that cannot be captured raises out of the
capture with its own error.  The eager step runs only where the caller
calls the unwrapped function.  On the CPU, where torch has no graphs,
every call runs the same static-buffer path eagerly.
"""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from repro_torch.serving.step_graph import CapturedOp
from repro_torch.tree import leaves


def addresses(params, opt_state) -> tuple:
    """The key of a replica: each tensor of its params, m, v and step
    counter as (address, shape, strides, dtype)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in leaves(params) + leaves(opt_state.m)
                 + leaves(opt_state.v) + [opt_state.step])


def _same(got, want) -> bool:
    return all(a is b for a, b in zip(leaves(got), leaves(want), strict=True))


class ReplicaStep(CapturedOp):
    """One replica's step as a ``CapturedOp``, captured into its owner's
    memory pool on the stream it is called on (the owner's side stream).
    ``state`` is the (params, opt_state) the step is bound to."""

    def __init__(self, owner: "TrainGraph", step, state, shapes, dtypes):
        super().__init__(step, shapes, owner.device, dtypes)
        self.owner = owner
        self.state = state

    def _record(self):
        # what torch.cuda.graph does first: the cached blocks of the eager
        # step go back to the card, so the pool can take that memory
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.owner.pool)
        try:
            out = self._step(*self.buffers)
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()     # leave the stream out of capture
            raise
        graph.capture_end()
        if self.owner.pool is None:
            self.owner.pool = graph.pool()
        return graph, out


class TrainGraph:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    a step that updates params, m and v in place, captured once a replica
    and replayed.  Called as the step is; returns the caller's own params
    and ``opt_state`` (its counter advanced in place) and copies of the
    metrics.  ``device`` is the step's (``api.device``).  ``step`` is the
    unwrapped function, for the caller that asks for the eager step."""

    op_type = ReplicaStep

    def __init__(self, step, device):
        self.step = step
        self.device = torch.device(device)
        self.ops = {}          # a ReplicaStep by ``addresses``
        self.pool = None       # the graphs' one memory pool (card)
        self.stream = None     # warm-ups, captures and replays (card)
        self.layout = None     # {key: (shape, dtype)} of the batch

    def __call__(self, params, opt_state, batch):
        host = self._host(batch)
        key = addresses(params, opt_state)
        op = self.ops.get(key)
        if op is None:
            op = self.ops[key] = self.op_type(
                self, self._bind(params, opt_state), (params, opt_state),
                [s for s, _ in self.layout.values()],
                [d for _, d in self.layout.values()])
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                metrics = op(*host)
            cur.wait_stream(self.stream)
        else:
            metrics = op(*host)
        return params, opt_state, {k: v.clone() for k, v in metrics.items()}

    def _host(self, batch) -> list:
        """The batch's arrays on the host in the layout's order; the first
        batch sets the layout, another layout raises."""
        arrays = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(v))
            arrays[k] = t.detach().cpu()
        layout = {k: (tuple(t.shape), t.dtype) for k, t in arrays.items()}
        if self.layout is None:
            self.layout = layout
        elif layout != self.layout:
            raise ValueError(f"TrainGraph: a batch of {layout} after "
                             f"{self.layout}: the graphs' static buffers "
                             "take one layout, the shape cell's")
        return [arrays[k].numpy() for k in self.layout]

    def _bind(self, params, opt_state):
        """The step on the static buffers, bound to one replica's state:
        returns its metrics and writes the new count into the counter."""
        names = list(self.layout)

        def run(*buffers):
            new_params, new_state, metrics = self.step(
                params, opt_state, dict(zip(names, buffers)))
            if not (_same(new_params, params) and _same(
                    new_state.m, opt_state.m) and _same(new_state.v,
                                                        opt_state.v)):
                raise ValueError("TrainGraph: the step must update params, "
                                 "m and v in place and return them")
            opt_state.step.copy_(new_state.step)
            return metrics

        return run

    def stats(self) -> dict:
        """Calls over every replica: replicas seen (one graph each on the
        card), eager steps, replays (a capture's own call included) and
        capture seconds."""
        ops = list(self.ops.values())
        return {"replicas": len(ops), "eager": sum(o.n_eager for o in ops),
                "replays": sum(o.n_replays for o in ops),
                "capture_s": sum(o.capture_s for o in ops)}

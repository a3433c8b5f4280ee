"""Asynchronous-partition training runtime: the paper's technique,
deployed (the port of ``repro/runtime/partition_runtime.py``).

Each partition is an independent synchronous group running its train step
freely for ``sync_every`` steps, after which the live partitions'
parameters are averaged (f32 mean).  On one card the partitions are
emulated as the reference emulates them: P parameter replicas, each with
its own optimizer state and data shard, stepped round-robin.

Fault tolerance, as in the reference: checkpoints at sync points (a lost
partition costs at most ``sync_every`` steps of its own work);
``drop_partition`` removes a failed partition and raises the gradient
accumulation so the global batch survives (``elastic.accum_for_batch``);
``add_partition`` clones a live replica into a fresh one.

The step is wrapped where the reference jits it: a ``TrainGraph``
(``runtime/train_graph.py``) captures each replica's step once on the card
and replays it; a clone gets a graph of its own.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.partitioning import PartitionConfig
from repro_torch.optim import adamw_init
from repro_torch.runtime import elastic
from repro_torch.runtime.train_graph import TrainGraph
from repro_torch.tree import leaves, tree_map


def _clone(tree):
    return tree_map(torch.clone, tree)


@dataclass
class PartitionState:
    params: object
    opt_state: object
    step: int = 0
    alive: bool = True
    last_sync_step: int = 0


class PartitionRuntime:
    """``generator`` draws the initial weights (``api.init``), unless
    ``params`` are given (every replica starts from a copy of them)."""

    def __init__(self, api, train_step, pc: PartitionConfig,
                 generator: torch.Generator | None = None,
                 max_stale: int | None = None, accum: int = 1,
                 global_batch: int = 0, params=None):
        self.api = api
        self.train_step = TrainGraph(train_step, api.device)
        self.pc = pc
        self.max_stale = max_stale or 4 * pc.sync_every
        # grad-accumulation factor callers microbatch by; rescaled on every
        # membership change so the global batch survives a down-scale
        self.accum = int(accum)
        self.global_batch = int(global_batch)
        self._accum0 = self.accum
        self._parts0 = pc.partitions
        if params is None:
            params = api.init(generator)
        self.parts = []
        for _ in range(pc.partitions):
            replica = _clone(params)
            self.parts.append(PartitionState(replica, adamw_init(replica)))
        del params
        self.sync_count = 0
        self.metrics_log = []

    # -- stepping -----------------------------------------------------------

    def alive_parts(self):
        return [p for p in self.parts if p.alive]

    def step_partition(self, i: int, batch):
        """One local step on partition i (its own replica + data shard)."""
        p = self.parts[i]
        if not p.alive:
            return None
        p.params, p.opt_state, m = self.train_step(p.params, p.opt_state,
                                                   batch)
        p.step += 1
        return m

    def run_round(self, batches):
        """One round-robin pass: each live partition takes one step on its
        shard; returns the per-partition metrics."""
        out = {}
        for i, p in enumerate(self.parts):
            if p.alive:
                out[i] = self.step_partition(i, batches[i])
        return out

    # -- sync (statistical traffic shaping boundary) -------------------------

    def maybe_sync(self):
        alive = self.alive_parts()
        if not alive:
            raise RuntimeError("all partitions dead")
        due = [p for p in alive
               if p.step - p.last_sync_step >= self.pc.sync_every]
        if len(due) < len(alive):
            return False
        # bounded staleness: stragglers beyond max_stale still participate
        # with their current (older) params, no barrier stall
        self.sync()
        return True

    @torch.no_grad()
    def sync(self):
        """Average the live replicas' parameters in f32 and write the mean
        into every live replica (in place).  Returns the mean."""
        alive = self.alive_parts()
        n = len(alive)

        def avg(*xs):
            return (sum(x.float() for x in xs) / n).to(xs[0].dtype)

        mean_params = tree_map(avg, *[p.params for p in alive])
        for p in alive:
            for dst, src in zip(leaves(p.params), leaves(mean_params)):
                dst.copy_(src)
            p.last_sync_step = p.step
        self.sync_count += 1
        return mean_params

    # -- elasticity / failures ----------------------------------------------

    def drop_partition(self, i: int):
        """Simulated node failure: partition i's work since the last sync
        is lost; its data shard is rebalanced to the survivors."""
        self.parts[i].alive = False
        self._rescale_accum()

    def add_partition(self, i: int | None = None):
        """Replacement capacity joins: a copy of a live replica."""
        src = self.alive_parts()[0]
        st = PartitionState(_clone(src.params), _clone(src.opt_state),
                            step=src.step, last_sync_step=src.step)
        if i is not None and not self.parts[i].alive:
            self.parts[i] = st
        else:
            self.parts.append(st)
        self._rescale_accum()

    def _rescale_accum(self):
        alive = len(self.alive_parts())
        if alive:
            # absolute, not incremental: re-derived from the initial fleet
            # so a drop followed by a replacement lands back at accum0
            self.accum = elastic.accum_for_batch(
                self.global_batch, self._parts0, alive, self._accum0)

    # -- training loop -------------------------------------------------------

    def train(self, make_batches, n_steps: int, ckpt=None,
              ckpt_every: int | None = None, fail_at: dict | None = None):
        """make_batches(step) -> list of per-partition batches.
        fail_at: {step: partition_idx} injected failures (tests)."""
        losses = []
        for step in range(n_steps):
            if fail_at and step in fail_at:
                self.drop_partition(fail_at[step])
            batches = make_batches(step)
            ms = self.run_round(batches)
            losses.append({i: float(m["loss"]) for i, m in ms.items()})
            synced = self.maybe_sync()
            if synced and ckpt is not None and ckpt_every and \
                    self.sync_count % ckpt_every == 0:
                p0 = self.alive_parts()[0]
                ckpt.save(p0.step, {"params": p0.params,
                                    "opt": p0.opt_state._asdict()},
                          meta={"sync_count": self.sync_count})
        return losses

"""Atomic checkpoint save / restore with keep-last-k (the port of
``repro/ckpt/manager.py``, with its on-disk layout, so a checkpoint
written by either package restores in the other).

Layout: <dir>/step_<N>/{meta.json, arrays.npz}, written to a tmp dir and
renamed (atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint.  Keys are "/"-joined tree paths; bf16 tensors are stored
upcast to f32 (lossless) and cast back to the template's dtype on
restore.  The data cursor is the step number (the pipeline is a function
of (seed, step)), so a resume is exact.  Unlike the reference's, a
restore writes into the template's own tensors (in place, one leaf at a
time): a second copy of a full-width model's weights and moments does
not fit one card beside the first.  ``restore(..., shardings=)`` is the
elastic path: each leaf is built anew and placed on a (possibly
different) device mesh by its (device mesh, placements) pair, so the
template may be a tree of meta tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in leaves_with_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:        # npz-safe (lossless upcast)
            t = t.float()
        flat[key] = t.numpy()
    return flat


@torch.no_grad()
def _restore_into(template, flat: dict):
    """Each array into its template leaf, cast to the leaf's dtype."""
    for key, leaf in leaves_with_paths(template):
        leaf.copy_(torch.from_numpy(np.asarray(flat[key])).reshape(
            leaf.shape))
    return template


@torch.no_grad()
def _restore_placed(template, flat: dict, shardings: dict):
    """Each array as a tensor of its leaf's dtype, placed by its pair."""
    from torch.distributed.tensor import distribute_tensor

    out = []
    for key, leaf in leaves_with_paths(template):
        pair = shardings[key]
        if pair is None:
            _restore_into(leaf, {"": flat[key]})
            out.append(leaf)
            continue
        t = torch.from_numpy(np.asarray(flat[key])).reshape(
            leaf.shape).to(leaf.dtype)
        out.append(distribute_tensor(t, *pair))
    return unflatten(template, out)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: dict, meta: dict | None = None):
        """state: a tree dict (params, optimizer state, ...).  Atomic."""
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _flatten(state)
        np.savez(tmp / "arrays.npz", **flat)
        info = {"step": step, "time": time.time(), "keys": len(flat)}
        info.update(meta or {})
        (tmp / "meta.json").write_text(json.dumps(info))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: int | None = None, shardings=None):
        """Restore into ``template``'s tensors (in place: each array cast
        to its leaf's dtype on its leaf's device); returns (state, meta).
        ``shardings`` ({leaf path: (device mesh, placements) or None}, as
        ``launch.sharding.param_shardings`` gives it): each array, cast to
        its leaf's dtype, is placed by ``distribute_tensor`` on its mesh
        instead, and the state is a new tree of DTensors; a leaf whose
        pair is None is restored into the template in place."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        if shardings is None:
            state = _restore_into(template, flat)
        else:
            state = _restore_placed(template, flat, shardings)
        meta = json.loads((d / "meta.json").read_text())
        return state, meta

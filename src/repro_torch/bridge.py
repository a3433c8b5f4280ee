"""Carry the JAX package's parameters into the port.

The reference draws its weights from ``jax.random``, whose bits torch
cannot reproduce, so the tests hold the two packages against each other on
the SAME weights: ``params_from_jax`` maps nested dicts, lists and tuples
of arrays (numpy, or anything ``np.asarray`` accepts, such as the
reference's own jax arrays) to torch tensors of the same shapes under the
same keys.  bfloat16 crosses exactly, bit for bit, through an int16 view,
and float8_e4m3fn (a packed KV pool) through a uint8 view.  This module
imports numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve


def to_torch(a, device, dtype=None) -> torch.Tensor:
    """One array -> tensor on ``device`` (a copy; bf16 and fp8
    bit-exact)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device=DEFAULT_DEVICE, dtype=None):
    """Tree-map nested dicts, lists and tuples of arrays to torch tensors on
    ``device``, optionally cast to ``dtype``.  Containers keep their type,
    so a CNN's list of per-op dicts (some empty) comes back a list of
    dicts."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, dev, dtype) for v in tree)
    return to_torch(tree, dev, dtype)

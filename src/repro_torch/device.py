"""The explicit-device rule of the port.

Every entry point takes a ``device`` argument whose default is ``"cuda"``.
Asking for CUDA on a machine without a card raises; nothing ever drops to
the CPU on its own.  The CPU runs only when the caller names it (the tests
do, to hold the port against the JAX reference).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is unusable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was asked for but torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' "
                         "or 'cpu'")
    return dev

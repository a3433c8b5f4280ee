"""The conv2d wrapper the CNN forward calls for every convolution.

``conv2d`` pads for SAME exactly as ``repro/kernels/conv2d/ops.py`` does
(asymmetric: the extra row and column go below and to the right, and a
negative pad is clipped to 0), then a CPU tensor goes to the plain version
(``ref.conv2d``) and a CUDA tensor launches the CUDA kernel its plan picks,
adds one to ``conv2d.launches`` and one to that route's count in
``conv2d.routes``.  There is no fallback: any other device, or a tensor
the kernel does not take, raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .conv2d import launch, plan_for
from .plan import ROUTES


def same_pads(size: int, k: int, stride: int):
    """(low, high) padding of one spatial axis for SAME: output
    ceil(size / stride), total pad clipped at 0, low half rounded down."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """x: (N, H, W, C) padded for a SAME window of kh x kw at ``stride``
    (``value`` fills the border: 0 for a conv, -inf for a max pool)."""
    (t, b), (l, r) = (same_pads(x.shape[1], kh, stride),
                      same_pads(x.shape[2], kw, stride))
    if t == b == l == r == 0:
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x: (N, H, W, C) NHWC; w: (kh, kw, C, K) HWIO -> (N, Ho, Wo, K) in
    x's dtype, f32 accumulation.  ``padding`` is "SAME" or "VALID"."""
    if padding == "SAME":
        x = pad_same(x, w.shape[0], w.shape[1], stride)
    elif padding != "VALID":
        raise ValueError(f"conv2d: padding {padding!r} (SAME or VALID)")
    if x.device.type == "cpu":
        return ref.conv2d(x, w, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {x.device}")
    p = plan_for(x, w, stride=stride)
    out = launch(x, w, p, stride=stride)
    conv2d.launches += 1
    conv2d.routes[p.route] += 1
    return out


conv2d.launches = 0
conv2d.routes = dict.fromkeys(ROUTES, 0)   # launches by route

"""Launch of the CUDA conv2d kernel (``kernels/csrc/conv2d.cu``).

Replaces ``repro/kernels/conv2d/conv2d.py::conv2d_pallas``: a VALID,
stride-s convolution of an already padded NHWC input with HWIO weights,
f32 accumulation, output in the input dtype.  Unlike the Pallas kernel it
takes any C and K (ragged tile edges are masked in the kernel) and has no
on-chip budget to respect: it walks the reduction in chunks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"conv_launch": [_P, _P, _P] + [_I] * 11 + [_P]}


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
                ) -> torch.Tensor:
    """x: (N, Hp, Wp, C), padded; w: (kh, kw, C, K); both CUDA, contiguous,
    one dtype.  Returns (N, Ho, Wo, K)."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (NHWC x HWIO)")
    if x.dtype != w.dtype:
        raise TypeError(f"conv2d: dtypes differ ({x.dtype}, {w.dtype})")
    N, Hp, Wp, C = x.shape
    kh, kw, _, K = w.shape
    if stride < 1 or Hp < kh or Wp < kw or min(N, C, K, kh, kw) == 0:
        raise ValueError(f"conv2d: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"stride {stride}")
    _build.check_inputs("conv2d", x, w)
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    if N * Ho * Wo >= 2**31 or kh * kw * C >= 2**31:
        raise ValueError(f"conv2d: GEMM rows {N * Ho * Wo} or depth "
                         f"{kh * kw * C} past the kernel's int32 range")
    out = torch.empty((N, Ho, Wo, K), dtype=x.dtype, device=x.device)
    lib = _build.load("conv2d", SIGNATURES)
    err = lib.conv_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          N, Hp, Wp, C, K, kh, kw, stride, Ho, Wo,
                          _build.dtype_code(x), _build.stream_of(x))
    _build.check(lib, err, "conv_launch")
    return out

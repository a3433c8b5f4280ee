"""Launch of the CUDA conv2d kernels (``kernels/csrc/conv2d.cu``).

Replaces ``repro/kernels/conv2d/conv2d.py::conv2d_pallas``: a VALID,
stride-s convolution of an already padded NHWC input with HWIO weights,
f32 accumulation, output in the input dtype.  Unlike the Pallas kernel it
takes any C and K (ragged tile edges are masked in the kernel) and has no
on-chip budget to respect: it walks the reduction in steps.  The route
(warpgroup tensor cores fed by TMA, ``mma.sync`` tensor cores or CUDA
cores), column tile and R split come from ``plan.plan``, a function of
the shapes, dtype and alignment alone; the f32 scratch it needs (the
split's (splits, M, K) partial sums, the f32 ``wgmma`` launch's bf16
weight halves) is allocated here.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import _build

from . import plan as cv_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"conv_run": [_P] * 4 + [_I] * 16 + [_P],
              "conv_im2col_probe": [_P] * 2 + [_I] * 14 + [_P]}


@lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
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
    M, _, R, _, _ = cv_plan.gemm_dims(x.shape, w.shape, stride)
    if M >= 2**31 or R >= 2**31:
        raise ValueError(f"conv2d: GEMM rows {M} or depth {R} past the "
                         f"kernels' int32 range")


def plan_for(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             route: Optional[str] = None, splits: Optional[int] = None,
             bn: Optional[int] = None) -> cv_plan.Plan:
    """The launch plan of the VALID conv of x (N, Hp, Wp, C) with w (kh,
    kw, C, K) on x's card (``route`` / ``splits`` / ``bn`` force a choice,
    as in ``plan.plan``).  The output is allocated by ``launch``,
    on the allocator's 16-byte (and coarser) boundaries."""
    _check(x, w, stride)
    M, K, R, _, _ = cv_plan.gemm_dims(x.shape, w.shape, stride)
    bf16 = x.dtype == torch.bfloat16
    C, (kh, kw) = x.shape[3], w.shape[:2]
    return cv_plan.plan(
        M, K, R, bf16=bf16,
        is_aligned=cv_plan.aligned(C, K, x.data_ptr(), w.data_ptr(),
                                   bf16=bf16),
        tma=cv_plan.tma_legal(C, K, kh, kw, stride, x.data_ptr(),
                              w.data_ptr(), bf16=bf16),
        n_sm=_n_sm(x.device.index or 0), route=route, splits=splits, bn=bn)


def launch(x: torch.Tensor, w: torch.Tensor, p: cv_plan.Plan, *,
           stride: int = 1) -> torch.Tensor:
    """x: (N, Hp, Wp, C), padded; w: (kh, kw, C, K); both CUDA,
    contiguous, one dtype.  Returns (N, Ho, Wo, K) by plan ``p``."""
    _check(x, w, stride)
    _build.check_inputs("conv2d", x, w)
    N, Hp, Wp, C = x.shape
    kh, kw, _, K = w.shape
    M, _, _, Ho, Wo = cv_plan.gemm_dims(x.shape, w.shape, stride)
    code = _build.dtype_code(x)
    lib = _build.load("conv2d", SIGNATURES)
    out = torch.empty((N, Ho, Wo, K), dtype=x.dtype, device=x.device)
    ws = torch.empty(math.prod(cv_plan.workspace_shape(p, M, K))
                     + cv_plan.weights_scratch(
                         p, kh * kw * C, K, bf16=x.dtype == torch.bfloat16),
                     dtype=torch.float32, device=x.device)
    err = lib.conv_run(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                       ws.data_ptr() if ws.numel() else None,
                       N, Hp, Wp, C, K, kh, kw, stride, Ho, Wo,
                       cv_plan.ROUTE_CODES[p.route], p.bm, p.bn, p.splits,
                       p.rows, code, _build.stream_of(x))
    _build.check(lib, err, f"conv_run ({p})")
    return out


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *,
                stride: int = 1) -> torch.Tensor:
    """x: (N, Hp, Wp, C), padded; w: (kh, kw, C, K) -> (N, Ho, Wo, K), both
    CUDA, contiguous, one dtype, by the plan for these operands (a forced
    plan goes through ``plan_for`` and ``launch``)."""
    return launch(x, w, plan_for(x, w, stride=stride), stride=stride)


def im2col_box(x: torch.Tensor, kh: int, kw: int, stride: int, *, c: int,
               w: int, h: int, n: int, i: int, j: int) -> torch.Tensor:
    """One TMA im2col load of the map the ``wgmma`` route reads for a kh x
    kw conv at ``stride`` over x (N, Hp, Wp, C), padded, on the card: 128
    pixels of one 128-byte line of channels from channel ``c``, the walk
    starting at window corner (``w``, ``h``) of image ``n``, tap (``i``,
    ``j``).  Returns the 16 KB as they lie in shared memory (128-byte
    swizzle), 128 rows of x's dtype, for holding the walk's model to the
    card."""
    _build.check_inputs("im2col_box", x)
    N, Hp, Wp, C = x.shape
    out = torch.empty((128, 128 // x.element_size()), dtype=x.dtype,
                      device=x.device)
    lib = _build.load("conv2d", SIGNATURES)
    err = lib.conv_im2col_probe(x.data_ptr(), out.data_ptr(), N, Hp, Wp, C,
                                kh, kw, stride, c, w, h, n, i, j,
                                _build.dtype_code(x), _build.stream_of(x))
    _build.check(lib, err, "conv_im2col_probe")
    return out

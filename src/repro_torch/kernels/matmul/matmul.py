"""Launch of the CUDA matmul kernels (``kernels/csrc/matmul.cu``).

Replaces ``repro/kernels/matmul/matmul.py::matmul_pallas``.  Unlike the
Pallas kernel it takes any M, K, N and any bf16 addresses: ragged edges
are masked in the kernel, and an operand whose rows are not 16-byte
aligned is staged through its windows.  The route (tensor cores for bf16,
CUDA cores for f32), row tile, K split and staging come from
``plan.plan``, a function of the shapes, dtype and alignment alone; where
the plan splits K, the f32 workspace of (splits, M, N) is allocated here.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import _build

from . import plan as mm_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"mm_run": [_P, _P, _P, _P] + [_I] * 8 + [_P]}


@lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(a: torch.Tensor, b: torch.Tensor, *, route: Optional[str] = None,
             splits: Optional[int] = None) -> mm_plan.Plan:
    """The launch plan of ``a @ b`` on a's card (``route`` / ``splits``
    force a choice, as in ``plan.plan``)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    return mm_plan.plan(
        M, N, K, bf16=a.dtype == torch.bfloat16,
        is_aligned=mm_plan.aligned(N, K, a.data_ptr(), b.data_ptr()),
        n_sm=_n_sm(a.device.index or 0), route=route, splits=splits)


def launch(a: torch.Tensor, b: torch.Tensor, p: mm_plan.Plan) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) by plan ``p``; both CUDA,
    contiguous, one dtype."""
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: dtypes differ ({a.dtype}, {b.dtype})")
    _build.check_inputs("matmul", a, b)
    M, K = a.shape
    N = b.shape[1]
    code = _build.dtype_code(a)
    lib = _build.load("matmul", SIGNATURES)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty(mm_plan.workspace_shape(p, M, N), dtype=torch.float32,
                     device=a.device)
    err = lib.mm_run(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                     ws.data_ptr() if p.splits > 1 else None, M, N, K,
                     mm_plan.ROUTE_CODES[p.route], p.bm, p.splits, p.rows,
                     code, _build.stream_of(a))
    _build.check(lib, err, f"mm_run ({p})")
    return c


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                route: Optional[str] = None,
                splits: Optional[int] = None) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N), both CUDA, contiguous, one dtype,
    by the plan for these operands (or the forced ``route`` / ``splits``)."""
    return launch(a, b, plan_for(a, b, route=route, splits=splits))

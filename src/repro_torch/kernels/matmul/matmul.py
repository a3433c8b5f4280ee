"""Launch of the CUDA matmul kernels (``kernels/csrc/matmul.cu``,
``kernels/csrc/matmul_wgmma.cu``).

Replaces ``repro/kernels/matmul/matmul.py::matmul_pallas``.  Unlike the
Pallas kernel it takes any M, K, N and any bf16 addresses: ragged edges
are masked in the kernel, and an operand whose rows are not 16-byte
aligned is staged through its windows.  The route (bf16 on the tensor
cores: ``wgmma`` at training's sizes, ``stream`` at the prefill waves',
``mma`` otherwise; f32 on the CUDA cores), tile, K split,
shares and staging come from ``plan.plan``, a function of the shapes,
dtype, layout and alignment alone; where the plan splits K, the f32
workspace of (splits, M, N) is allocated here, and so is the stream
route's (a partial slot a CTA).  ``wgmma`` and ``stream`` read each
operand where it lies, a row-major matrix or the ``.t()`` view of one;
the other routes read contiguous operands, so a view is copied first.
The stream route's tile counters (``plan.STREAM_TILES``) are a static
array of its CUDA module, zeroed on each card when the module is loaded
there, and every launch leaves them at zero: a launch needs no reset of
its own, eagerly or replayed in a CUDA graph, and the first may be a
capture.  A card's launches share them, so the stream route's launches
on one card are issued one after another on one stream.
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
WG_SIGNATURES = {"mm_wgmma_run": [_P, _P, _P, _P] + [_I] * 10 + [_P],
                 "mm_stream_run": [_P] * 4 + [_I] * 8 + [_P]}


@lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tma(t: torch.Tensor):
    return mm_plan.tma_operand(tuple(t.shape), tuple(t.stride()),
                               t.data_ptr())


def plan_for(a: torch.Tensor, b: torch.Tensor, *, route: Optional[str] = None,
             splits: Optional[int] = None,
             ctas: Optional[int] = None) -> mm_plan.Plan:
    """The launch plan of ``a @ b`` on a's card (``route`` / ``splits`` /
    ``ctas`` force a choice, as in ``plan.plan``).  ``mma``'s
    alignment is that of the contiguous operands it reads: a view's copy
    is aligned."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    bf16 = a.dtype == torch.bfloat16

    def ptr(t):
        return t.data_ptr() if t.is_contiguous() else 0
    return mm_plan.plan(
        M, N, K, bf16=bf16,
        is_aligned=mm_plan.aligned(N, K, ptr(a), ptr(b)),
        tma=bf16 and _tma(a) is not None and _tma(b) is not None,
        n_sm=_n_sm(a.device.index or 0), route=route, splits=splits,
        ctas=ctas)


def launch(a: torch.Tensor, b: torch.Tensor, p: mm_plan.Plan) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) by plan ``p``; both CUDA, one
    dtype.  ``wgmma`` reads each operand in place (row-major or a ``.t()``
    view); the other routes read contiguous copies of views."""
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: dtypes differ ({a.dtype}, {b.dtype})")
    if p.route in ("wgmma", "stream"):
        return _launch_wgmma(a, b, p)
    a, b = a.contiguous(), b.contiguous()
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


def _launch_wgmma(a: torch.Tensor, b: torch.Tensor,
                  p: mm_plan.Plan) -> torch.Tensor:
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"matmul: operands must share one CUDA device, "
                         f"got {a.device}, {b.device}")
    ta, tb = _tma(a), _tma(b)
    if a.dtype != torch.bfloat16 or ta is None or tb is None:
        raise ValueError(
            f"matmul: the {p.route} route takes bf16 operands TMA reads in "
            f"place (row-major or a .t() view, 16-byte aligned, lines a "
            f"multiple of 16 bytes apart); got {a.dtype} strides "
            f"{a.stride()} / {b.stride()}")
    M, K = a.shape
    N = b.shape[1]
    lib = _build.load("matmul_wgmma", WG_SIGNATURES)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty(mm_plan.workspace_shape(p, M, N), dtype=torch.float32,
                     device=a.device)
    if p.route == "stream":
        err = lib.mm_stream_run(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                ws.data_ptr(), M, N, K, ta[1], tb[1],
                                int(ta[0]), int(not tb[0]), p.ctas,
                                _build.stream_of(a))
        _build.check(lib, err, f"mm_stream_run ({p})")
        return c
    # A read M-major where it is a .t() view; B N-major where row-major
    err = lib.mm_wgmma_run(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           ws.data_ptr() if p.splits > 1 else None, M, N, K,
                           ta[1], tb[1], int(ta[0]), int(not tb[0]), p.bn,
                           p.splits, p.rows, _build.stream_of(a))
    _build.check(lib, err, f"mm_wgmma_run ({p})")
    return c


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                route: Optional[str] = None, splits: Optional[int] = None,
                ctas: Optional[int] = None) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N), both CUDA, one dtype, by the plan
    for these operands (or the forced ``route`` / ``splits`` / ``ctas``)."""
    return launch(a, b, plan_for(a, b, route=route, splits=splits,
                                 ctas=ctas))

"""Launch of the CUDA matmul kernel (``kernels/csrc/matmul.cu``).

Replaces ``repro/kernels/matmul/matmul.py::matmul_pallas``.  Unlike the
Pallas kernel it takes any M, K, N: ragged edges are masked in the kernel.
Where the kernel splits K over several CTAs it needs an f32 workspace of
(splits, M, N), allocated here.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"mm_splits": [_I, _I, _I, _I],
              "mm_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


@lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N), both CUDA, contiguous, one dtype."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: dtypes differ ({a.dtype}, {b.dtype})")
    _build.check_inputs("matmul", a, b)
    M, K = a.shape
    N = b.shape[1]
    if min(M, K, N) == 0:
        raise ValueError(f"matmul: empty operand {(M, K, N)}")
    code = _build.dtype_code(a)
    lib = _build.load("matmul", SIGNATURES)
    splits = lib.mm_splits(M, N, K, _n_sm(a.device.index or 0))
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty((splits, M, N) if splits > 1 else (0,),
                     dtype=torch.float32, device=a.device)
    err = lib.mm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                        ws.data_ptr() if splits > 1 else None, M, N, K,
                        splits, code, _build.stream_of(a))
    _build.check(lib, err, "mm_launch")
    return c

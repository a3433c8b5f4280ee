"""Launch of the CUDA paged decode-attention kernel
(``kernels/csrc/paged_attention.cu``).

Replaces ``repro/kernels/paged_attention/paged_attention.py::
paged_decode_pallas``.  The kernel reads the pool as it stands: the
caller must have written the new token's K/V row into its block first.
Limits: D <= 128 and at most 32 query heads per kv head (one warp each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"pa_launch": [_P] * 6 + [_I] * 8 + [_P]}
MAX_D = 128
MAX_GROUP = 32


def paged_decode_cuda(q, k_pages, v_pages, tables, cur_pos, *,
                      window: int = 0) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int32;
    cur_pos: (B,) int32; all CUDA and contiguous.  Returns (B, Hq, D)."""
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, Hq, D = q.shape
    _, bs, Hkv, Dk = k_pages.shape
    if (Dk != D or Hq % Hkv or tables.ndim != 2 or tables.shape[0] != B
            or tuple(cur_pos.shape) != (B,) or tables.shape[1] == 0):
        raise ValueError(f"paged_decode: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(tables.shape)}, cur_pos "
                         f"{tuple(cur_pos.shape)}")
    if D > MAX_D or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_decode: kernel takes D <= {MAX_D} and "
                         f"<= {MAX_GROUP} query heads per kv head "
                         f"(D={D}, G={Hq // Hkv})")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError("paged_decode: q and page dtypes differ")
    if tables.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise TypeError("paged_decode: tables and cur_pos must be int32")
    _build.check_inputs("paged_decode", q, k_pages, v_pages, tables, cur_pos)
    o = torch.empty_like(q)
    lib = _build.load("paged_attention", SIGNATURES)
    err = lib.pa_launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        tables.data_ptr(), cur_pos.data_ptr(), o.data_ptr(),
                        B, Hq, Hkv, D, bs, tables.shape[1], int(window or 0),
                        _build.dtype_code(q), _build.stream_of(q))
    _build.check(lib, err, "pa_launch")
    return o

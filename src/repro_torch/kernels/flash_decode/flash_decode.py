"""Launch of the CUDA flash-decode kernel (``kernels/csrc/flash_decode.cu``).

Replaces ``repro/kernels/flash_decode/flash_decode.py::flash_decode_pallas``.
Reads the (B, S, Hkv, D) cache in place, any S; ``cur_pos`` is one int32
scalar shared by every slot or a (B,) int32 vector.  Limits: D <= 128 and
at most 32 query heads per kv head (one warp each).  Each launch splits
every (slot, kv head)'s walk over ``splits`` CTAs (flash-decoding,
``kernels/decode_split.py``): by default the plan for the slab's length S,
from shapes alone; ``splits=`` forces a count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, decode_split

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"fd_launch": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 8 + [_P]}
MAX_D = 128
MAX_GROUP = 32


def flash_decode_cuda(q, k_cache, v_cache, cur_pos, *, window: int = 0,
                      splits=None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); cur_pos: () or (B,) int32;
    all CUDA and contiguous.  ``splits``: CTAs per (slot, kv head), default
    the plan's.  Returns (B, Hq, D)."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bc, S, Hkv, Dk = k_cache.shape
    if Bc != B or Dk != D or Hq % Hkv or S == 0 \
            or tuple(cur_pos.shape) not in ((), (B,)):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, cur_pos "
                         f"{tuple(cur_pos.shape)}")
    if D > MAX_D or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: kernel takes D <= {MAX_D} and "
                         f"<= {MAX_GROUP} query heads per kv head "
                         f"(D={D}, G={Hq // Hkv})")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("flash_decode: q and cache dtypes differ")
    if cur_pos.dtype != torch.int32:
        raise TypeError("flash_decode: cur_pos must be int32")
    _build.check_inputs("flash_decode", q, k_cache, v_cache, cur_pos)
    n = decode_split.splits_for(q, Hkv, S, splits)
    ws = decode_split.workspace(q, n)
    o = torch.empty_like(q)
    lib = _build.load("flash_decode", SIGNATURES)
    err = lib.fd_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        cur_pos.data_ptr(), 1 if cur_pos.ndim else 0,
                        o.data_ptr(), None if ws is None else ws.data_ptr(),
                        B, Hq, Hkv, D, S, int(window or 0),
                        _build.dtype_code(q), n, _build.stream_of(q))
    _build.check(lib, err, "fd_launch")
    return o

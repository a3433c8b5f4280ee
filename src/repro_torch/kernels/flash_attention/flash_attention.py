"""Launch of the CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas`` in both of its modes, causal and bidirectional
(``causal=False``, the enc-dec family's encoder and cross attention).
Unlike the Pallas kernel it takes any Sq and Skv (ragged tiles are masked
in the kernel).  bf16 runs on the tensor
cores (``mma.sync``, 64 flattened query rows a CTA), f32 on the CUDA cores
(one CTA packs a tile of query positions times the whole GQA group into
16 rows).  Limits: D <= 128, at most 16 query heads per kv head, and for
bf16 D % 8 == 0 and 16-byte aligned operands (the tiles load 16-byte
chunks of a row).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"fa_launch": [_P, _P, _P, _P] + [_I] * 9 + [_P]}
MAX_D = 128
MAX_GROUP = 16


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Causal (the default) or bidirectional attention.  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D), CUDA, contiguous, one dtype.  window <= 0 means
    no window.  Returns (B, Sq, Hq, D)."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv or min(B, Sq, Skv) == 0:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if D > MAX_D or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: kernel takes D <= {MAX_D} and "
                         f"<= {MAX_GROUP} query heads per kv head "
                         f"(D={D}, G={Hq // Hkv})")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if q.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"flash_attention: the bf16 kernel takes D % 8 == 0 "
                         f"(D={D})")
    _build.check_inputs("flash_attention", q, k, v)
    o = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, o)):
        raise ValueError("flash_attention: the bf16 kernel takes 16-byte "
                         "aligned operands")
    lib = _build.load("flash_attention", SIGNATURES)
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
                        int(window or 0), int(bool(causal)),
                        _build.dtype_code(q),
                        _build.stream_of(q))
    _build.check(lib, err, "fa_launch")
    return o

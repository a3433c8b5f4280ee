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

Training: ``lse=True`` also returns each row's log-sum-exp (B, Sq, Hq) f32,
and ``flash_attention_bwd_cuda`` launches the three backward kernels of
``kernels/csrc/flash_attention_bwd.cu`` (Delta = rowsum(P dP), dK / dV,
dQ) under the same limits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"fa_launch": [_P] * 5 + [_I] * 9 + [_P]}
BWD_SIGNATURES = {"fa_bwd_delta_launch": [_P] * 6 + [_I] * 9 + [_P],
                  "fa_bwd_dkdv_launch": [_P] * 8 + [_I] * 9 + [_P],
                  "fa_bwd_dq_launch": [_P] * 7 + [_I] * 9 + [_P]}
BWD_KERNELS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")
MAX_D = 128
MAX_GROUP = 16


def _check(q, k, v):
    """The kernels' limits (forward and backward); raise on anything else."""
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


def _check_aligned(*tensors):
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                                  for t in tensors):
        raise ValueError("flash_attention: the bf16 kernel takes 16-byte "
                         "aligned operands")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         lse: bool = False):
    """Causal (the default) or bidirectional attention.  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D), CUDA, contiguous, one dtype.  window <= 0 means
    no window.  Returns (B, Sq, Hq, D), or with ``lse`` the pair (out,
    log-sum-exp (B, Sq, Hq) f32)."""
    _check(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _build.check_inputs("flash_attention", q, k, v)
    o = torch.empty_like(q)
    _check_aligned(q, k, v, o)
    stat = torch.empty((B, Sq, Hq), dtype=torch.float32,
                       device=q.device) if lse else None
    lib = _build.load("flash_attention", SIGNATURES)
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), stat.data_ptr() if lse else None,
                        B, Sq, Skv, Hq, Hkv, D,
                        int(window or 0), int(bool(causal)),
                        _build.dtype_code(q),
                        _build.stream_of(q))
    _build.check(lib, err, "fa_launch")
    return (o, stat) if lse else o


def flash_attention_bwd_cuda(q, k, v, lse, do, *, causal: bool = True,
                             window: int = 0):
    """dQ, dK, dV of ``flash_attention_cuda(q, k, v)`` given its
    log-sum-exp ``lse`` (B, Sq, Hq) f32 and the output's gradient ``do``:
    three launches (Delta = rowsum(P o dP), then dK / dV, then dQ), each
    output in the input dtype.  All CUDA and contiguous."""
    _check(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if do.shape != q.shape or tuple(lse.shape) != (B, Sq, Hq):
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention backward: do takes q's dtype, lse "
                        "float32")
    _build.check_inputs("flash_attention backward", q, k, v, lse, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_aligned(q, k, v, do, dq, dk, dv)
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    shape = (B, Sq, Skv, Hq, Hkv, D, int(window or 0), int(bool(causal)),
             _build.dtype_code(q), _build.stream_of(q))
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr())
    lib = _build.load("flash_attention_bwd", BWD_SIGNATURES)
    err = lib.fa_bwd_delta_launch(*qkv, delta.data_ptr(), *shape)
    _build.check(lib, err, "fa_bwd_delta_launch")
    err = lib.fa_bwd_dkdv_launch(*qkv, delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), *shape)
    _build.check(lib, err, "fa_bwd_dkdv_launch")
    err = lib.fa_bwd_dq_launch(*qkv, delta.data_ptr(), dq.data_ptr(), *shape)
    _build.check(lib, err, "fa_bwd_dq_launch")
    return dq, dk, dv

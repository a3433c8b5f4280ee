"""Launch of the CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas`` in both of its modes, causal and bidirectional
(``causal=False``, the enc-dec family's encoder and cross attention).
Unlike the Pallas kernel it takes any Sq and Skv (ragged tiles are masked
in the kernel).  The kernel's route, ``fwd_route``, is picked inside the
launch (``fa_launch``) from the dtype, Sq and D: bf16 from
``WGMMA_MIN_SQ`` query rows (``WGMMA_MIN_SQ_D64`` at D <= 64) on Hopper's
warpgroup tensor cores (``wgmma``: 128 rows of one query head a CTA, Q
and the K / V tiles brought in by TMA), shorter bf16 calls (serving's
waves and refills) on ``mma.sync`` (``mma``: 64 flattened rows of the GQA
group a CTA), f32 on the CUDA cores
(``cuda_cores``: one CTA packs a tile of query positions times the whole
GQA group into 16 rows).  ``route=`` forces a bf16 route (the two timed
and held on the same inputs).  Limits: D <= 128, at most 16 query heads
per kv head, and for bf16 D % 8 == 0 and 16-byte aligned operands (16-byte
rows, TMA's strides).

Training: ``lse=True`` also returns each row's log-sum-exp (B, Sq, Hq) f32,
and ``flash_attention_bwd_cuda`` launches the three backward kernels of
``kernels/csrc/flash_attention_bwd.cu`` (Delta = rowsum(P dP), dK / dV,
dQ) under the same limits, on the route ``bwd_route`` names: bf16 on the
warpgroup tensor cores (``wgmma``, operands read by TMA: every bf16 shape
the limits admit), f32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {name: [_P] * 5 + [_I] * 9 + [_P]
              for name in ("fa_launch", "fa_wgmma_launch", "fa_mma_launch")}
BWD_SIGNATURES = {"fa_bwd_delta_launch": [_P] * 6 + [_I] * 9 + [_P],
                  "fa_bwd_dkdv_launch": [_P] * 8 + [_I] * 9 + [_P],
                  "fa_bwd_dq_launch": [_P] * 7 + [_I] * 9 + [_P]}
BWD_KERNELS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")
BWD_ROUTES = ("wgmma", "cuda_cores")
FWD_ROUTES = ("wgmma", "mma", "cuda_cores")
# bf16 calls with at least this many query rows take the wgmma route, at
# D > 64 and at D <= 64 (csrc/flash_attention.cu's FA_WGMMA_MIN_SQ and
# FA_WGMMA_MIN_SQ_D64)
WGMMA_MIN_SQ = 256
WGMMA_MIN_SQ_D64 = 768
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


def fwd_route(q, k) -> str:
    """The forward's route, as ``fa_launch`` picks it for q (B, Sq, Hq, D)
    over k (B, Skv, Hkv, D): ``wgmma`` for bf16 from WGMMA_MIN_SQ query
    rows (WGMMA_MIN_SQ_D64 at D <= 64), ``mma`` for shorter bf16 calls,
    ``cuda_cores`` for f32 (TF32 would break the f32 tolerance)."""
    if q.dtype != torch.bfloat16:
        return "cuda_cores"
    least = WGMMA_MIN_SQ if q.shape[3] > 64 else WGMMA_MIN_SQ_D64
    return "wgmma" if q.shape[1] >= least else "mma"


def bwd_route(q) -> str:
    """The backward kernels' route for q's dtype: ``wgmma`` for bf16 (the
    three kernels on the warpgroup tensor cores), ``cuda_cores`` for f32
    (TF32 would break the f32 tolerance)."""
    return "wgmma" if q.dtype == torch.bfloat16 else "cuda_cores"


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         lse: bool = False, route=None):
    """Causal (the default) or bidirectional attention.  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D), CUDA, contiguous, one dtype.  window <= 0 means
    no window.  Returns (B, Sq, Hq, D), or with ``lse`` the pair (out,
    log-sum-exp (B, Sq, Hq) f32).  ``route``: None, the launch's own pick
    (``fwd_route``), or ``"wgmma"`` / ``"mma"`` to force a bf16 kernel."""
    _check(q, k, v)
    if route not in (None, "wgmma", "mma"):
        raise ValueError(f"flash_attention: no forced route {route!r}")
    if route is not None and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: route {route!r} takes bf16, not "
                         f"{q.dtype}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _build.check_inputs("flash_attention", q, k, v)
    o = torch.empty_like(q)
    _check_aligned(q, k, v, o)
    stat = torch.empty((B, Sq, Hq), dtype=torch.float32,
                       device=q.device) if lse else None
    lib = _build.load("flash_attention", SIGNATURES)
    entry = "fa_launch" if route is None else f"fa_{route}_launch"
    err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), stat.data_ptr() if lse else None,
                              B, Sq, Skv, Hq, Hkv, D,
                              int(window or 0), int(bool(causal)),
                              _build.dtype_code(q),
                              _build.stream_of(q))
    _build.check(lib, err, entry)
    return (o, stat) if lse else o


def flash_attention_bwd_launches(q, k, v, lse, do, *, causal: bool = True,
                                 window: int = 0, lib=None):
    """The backward's outputs (dQ, dK, dV, allocated, not yet written) and
    its three launches in order, ``{kernel name: launch}`` (each launch a
    function of no arguments that raises on a CUDA error): Delta =
    rowsum(P o dP) into a (B, Sq, Hq) f32 scratch, then dK / dV, then dQ.
    ``flash_attention_bwd_cuda`` runs them; a timing script runs each
    alone.  ``lib``: a library with the entry points of BWD_SIGNATURES
    (another build of the source, for an A/B); by default this one's."""
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
    if lib is None:
        lib = _build.load("flash_attention_bwd", BWD_SIGNATURES)
    writes = {"fa_bwd_delta": (delta,), "fa_bwd_dkdv": (delta, dk, dv),
              "fa_bwd_dq": (delta, dq)}

    def launch(name):
        fn, outs = getattr(lib, f"{name}_launch"), writes[name]

        def run():    # holds its tensors (the Delta scratch among them)
            err = fn(*qkv, *(t.data_ptr() for t in outs), *shape)
            _build.check(lib, err, f"{name}_launch")
        return run

    return (dq, dk, dv), {name: launch(name) for name in BWD_KERNELS}


def flash_attention_bwd_cuda(q, k, v, lse, do, *, causal: bool = True,
                             window: int = 0):
    """dQ, dK, dV of ``flash_attention_cuda(q, k, v)`` given its
    log-sum-exp ``lse`` (B, Sq, Hq) f32 and the output's gradient ``do``:
    three launches (Delta = rowsum(P o dP), then dK / dV, then dQ), each
    output in the input dtype.  All CUDA and contiguous."""
    out, launches = flash_attention_bwd_launches(q, k, v, lse, do,
                                                 causal=causal, window=window)
    for run in launches.values():
        run()
    return out

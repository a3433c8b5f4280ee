"""Launches of the CUDA paged decode-attention kernels
(``kernels/csrc/paged_attention.cu``).

Replace ``repro/kernels/paged_attention/paged_attention.py``'s
``paged_decode_pallas`` (float pages; the caller must have written the new
token's K/V row into its block first), ``paged_decode_sparse_pallas``
(float pages plus a keep mask over blocks) and
``paged_decode_quant_pallas`` (packed int8/fp8 pages with per-(block,
kv-head) scales, an optional keep mask and optional current rows).
Limits: D <= 128 and at most 32 query heads per kv head (one warp each).

Each launch splits every (slot, kv head)'s walk over ``splits`` CTAs
(flash-decoding, ``kernels/decode_split.py``): by default the plan for the
table's span ``T * bs``, from shapes alone; ``splits=`` forces a count.
With more than one split the wrapper allocates the kernel's f32 workspace
and the launch adds the combine pass.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, decode_split

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"pa_launch": [_P] * 7 + [_I] * 9 + [_P],
              "pa_sparse_launch": [_P] * 8 + [_I] * 9 + [_P],
              "pa_quant_launch": [_P] * 12 + [_I] * 10 + [_P]}
MAX_D = 128
MAX_GROUP = 32


def _check(what, q, k_pages, v_pages, tables, cur_pos):
    """Shapes and index dtypes common to every variant; returns
    (B, Hq, Hkv, D, bs, T)."""
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, Hq, D = q.shape
    _, bs, Hkv, Dk = k_pages.shape
    if (Dk != D or Hq % Hkv or tables.ndim != 2 or tables.shape[0] != B
            or tuple(cur_pos.shape) != (B,) or tables.shape[1] == 0):
        raise ValueError(f"{what}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(tables.shape)}, cur_pos "
                         f"{tuple(cur_pos.shape)}")
    if D > MAX_D or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{what}: kernel takes D <= {MAX_D} and "
                         f"<= {MAX_GROUP} query heads per kv head "
                         f"(D={D}, G={Hq // Hkv})")
    if tables.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise TypeError(f"{what}: tables and cur_pos must be int32")
    return B, Hq, Hkv, D, bs, tables.shape[1]


def _check_keep(what, keep, B, Hkv, T):
    if tuple(keep.shape) != (B, Hkv, T) or keep.dtype != torch.int32:
        raise ValueError(f"{what}: keep must be ({B}, {Hkv}, {T}) int32, got "
                         f"{tuple(keep.shape)} {keep.dtype}")


def _split(q, Hkv, bs, T, splits):
    """(splits, workspace pointer or None) of one launch."""
    n = decode_split.splits_for(q, Hkv, T * bs, splits)
    ws = decode_split.workspace(q, n)
    return n, ws


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_decode_cuda(q, k_pages, v_pages, tables, cur_pos, *,
                      window: int = 0, splits=None) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int32;
    cur_pos: (B,) int32; all CUDA and contiguous.  ``splits``: CTAs per
    (slot, kv head), default the plan's.  Returns (B, Hq, D)."""
    B, Hq, Hkv, D, bs, T = _check("paged_decode", q, k_pages, v_pages,
                                  tables, cur_pos)
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError("paged_decode: q and page dtypes differ")
    _build.check_inputs("paged_decode", q, k_pages, v_pages, tables, cur_pos)
    n, ws = _split(q, Hkv, bs, T, splits)
    o = torch.empty_like(q)
    lib = _build.load("paged_attention", SIGNATURES)
    err = lib.pa_launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        tables.data_ptr(), cur_pos.data_ptr(), o.data_ptr(),
                        _ptr(ws), B, Hq, Hkv, D, bs, T, int(window or 0),
                        _build.dtype_code(q), n, _build.stream_of(q))
    _build.check(lib, err, "pa_launch")
    return o


def paged_decode_sparse_cuda(q, k_pages, v_pages, tables, cur_pos, keep, *,
                             window: int = 0, splits=None) -> torch.Tensor:
    """As ``paged_decode_cuda`` plus ``keep``: (B, Hkv, T) int32, nonzero =
    read the block.  Dropped blocks are not read."""
    B, Hq, Hkv, D, bs, T = _check("paged_decode_sparse", q, k_pages,
                                  v_pages, tables, cur_pos)
    _check_keep("paged_decode_sparse", keep, B, Hkv, T)
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError("paged_decode_sparse: q and page dtypes differ")
    _build.check_inputs("paged_decode_sparse", q, k_pages, v_pages, tables,
                        cur_pos, keep)
    n, ws = _split(q, Hkv, bs, T, splits)
    o = torch.empty_like(q)
    lib = _build.load("paged_attention", SIGNATURES)
    err = lib.pa_sparse_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), cur_pos.data_ptr(), keep.data_ptr(), o.data_ptr(),
        _ptr(ws), B, Hq, Hkv, D, bs, T, int(window or 0),
        _build.dtype_code(q), n, _build.stream_of(q))
    _build.check(lib, err, "pa_sparse_launch")
    return o


def paged_decode_quant_cuda(q, k_pages, v_pages, k_scales, v_scales, tables,
                            cur_pos, *, window: int = 0, k_row=None,
                            v_row=None, keep=None,
                            splits=None) -> torch.Tensor:
    """q: (B, Hq, D) f32/bf16; pages: (N, bs, Hkv, D) int8 or
    float8_e4m3fn; scales: (N, Hkv) f32; k_row/v_row: (B, Hkv, D) of q's
    dtype or None; keep: (B, Hkv, T) int32 or None.  Returns (B, Hq, D)."""
    what = "paged_decode_quant"
    B, Hq, Hkv, D, bs, T = _check(what, q, k_pages, v_pages, tables, cur_pos)
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"{what}: k and v page dtypes differ")
    N = k_pages.shape[0]
    for sc in (k_scales, v_scales):
        if tuple(sc.shape) != (N, Hkv) or sc.dtype != torch.float32:
            raise ValueError(f"{what}: scales must be ({N}, {Hkv}) float32, "
                             f"got {tuple(sc.shape)} {sc.dtype}")
    operands = [q, k_pages, v_pages, k_scales, v_scales, tables, cur_pos]
    if (k_row is None) != (v_row is None):
        raise ValueError(f"{what}: pass both k_row and v_row or neither")
    if k_row is not None:
        for r in (k_row, v_row):
            if tuple(r.shape) != (B, Hkv, D) or r.dtype != q.dtype:
                raise ValueError(f"{what}: rows must be ({B}, {Hkv}, {D}) "
                                 f"{q.dtype}, got {tuple(r.shape)} {r.dtype}")
        operands += [k_row, v_row]
    if keep is not None:
        _check_keep(what, keep, B, Hkv, T)
        operands.append(keep)
    _build.check_inputs(what, *operands)
    page = _build.page_code(k_pages)
    n, ws = _split(q, Hkv, bs, T, splits)
    o = torch.empty_like(q)
    lib = _build.load("paged_attention", SIGNATURES)
    err = lib.pa_quant_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), _ptr(k_row), _ptr(v_row),
        tables.data_ptr(), cur_pos.data_ptr(), _ptr(keep), o.data_ptr(),
        _ptr(ws), B, Hq, Hkv, D, bs, T, int(window or 0),
        _build.dtype_code(q), page, n, _build.stream_of(q))
    _build.check(lib, err, "pa_quant_launch")
    return o

"""Launch of the CUDA flash-decode kernels (``kernels/csrc/flash_decode.cu``).

Replaces ``repro/kernels/flash_decode/flash_decode.py::flash_decode_pallas``.
Both kernels read the (B, S, Hkv, D) cache in place, any S; ``cur_pos`` is
one int32 scalar shared by every slot or a (B,) int32 vector.  Each launch
splits every (slot, kv head)'s walk over ``splits`` CTAs (flash-decoding):
by default a plan from the launch's static shapes alone; ``splits=`` forces
a count.  Two routes, picked by ``route_of`` from the operands:

* ``tma``: ``fd_tma_launch``, the Hopper kernel (TMA into an mbarrier ring,
  four consumer warps a CTA whatever the group size, their products on the
  tensor cores or, at G = 1, the CUDA cores).  bf16 q and
  caches, D % 8 == 0 and D <= 128 (a row a whole number of 16-byte chunks,
  at most two 64-column boxes), at most ``TMA_MAX_GROUP`` query heads a kv
  head, caches 16-byte aligned.  Its splits of a (slot, kv head) merge
  inside one thread-block cluster: at most ``TMA_MAX_SPLITS``, the plan
  ``tma_plan``.
* ``template``: ``fd_launch``, the decode template shared with the paged
  kernels (``csrc/decode_attention.cuh``, the plan ``decode_split.plan``).
  Everything else: f32, D = 20 in bf16, misaligned caches, G > 16.
  Limits: D <= 128 and at most 32 query heads per kv head.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, decode_split

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"fd_launch": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 8 + [_P],
              "fd_tma_launch": [_P] * 4 + [_I] + [_P] + [_I] * 7 + [_P]}
MAX_D = 128
MAX_GROUP = 32
ROUTES = ("tma", "template")
TMA_MAX_GROUP = 16       # query heads a kv head: mma.sync's 16 rows
TMA_MAX_SPLITS = 8       # CTAs of a cluster (the portable size)
TMA_WAVES = 2            # resident CTAs an SM the plan aims to fill
TMA_MIN_TILES = 4        # tiles a CTA at least: one a consumer warp


def route_of(q, k_cache, v_cache) -> str:
    """``tma`` where the Hopper kernel takes the operands, else
    ``template``: from the dtypes, D, the group size and the caches'
    alignment alone."""
    D = q.shape[-1]
    G = q.shape[1] // max(1, k_cache.shape[2])
    ok = (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16
          and D % 8 == 0 and D <= MAX_D and G <= TMA_MAX_GROUP
          and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0)
    return "tma" if ok else "template"


def tma_plan(B: int, Hkv: int, walk: int, sm_count: int) -> int:
    """CTAs per (slot, kv head) on the tma route: doubled from 1 while
    each CTA keeps at least ``TMA_MIN_TILES`` of the walk's 32-row tiles,
    ``B * Hkv * splits`` stays below ``TMA_WAVES * sm_count`` and the count
    within ``TMA_MAX_SPLITS`` (a cluster); a power of two.  Static shapes
    only, never ``cur_pos``: a graph replays the same plan."""
    tiles = max(1, -(-walk // decode_split.KT))
    n = 1
    while 2 * n <= TMA_MAX_SPLITS and tiles >= 2 * n * TMA_MIN_TILES \
            and B * Hkv * n < TMA_WAVES * sm_count:
        n *= 2
    return n


def flash_decode_cuda(q, k_cache, v_cache, cur_pos, *, window: int = 0,
                      splits=None, route=None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); cur_pos: () or (B,) int32;
    all CUDA and contiguous.  ``route``: ``tma`` or ``template`` (default
    ``route_of``'s pick; forcing ``tma`` on operands it does not take
    raises).  ``splits``: CTAs per (slot, kv head), default the route's
    plan.  Returns (B, Hq, D)."""
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
    pick = route_of(q, k_cache, v_cache)
    r = pick if route is None else route
    if r not in ROUTES or (r == "tma" and pick != "tma"):
        raise ValueError(f"flash_decode: route {r!r} cannot take q "
                         f"{tuple(q.shape)} {q.dtype}, caches "
                         f"{tuple(k_cache.shape)} (route_of picks {pick!r})")
    o = torch.empty_like(q)
    lib = _build.load("flash_decode", SIGNATURES)
    cur = cur_pos.data_ptr(), 1 if cur_pos.ndim else 0
    if r == "template":
        n = decode_split.splits_for(q, Hkv, S, splits)
        ws = decode_split.workspace(q, n)
        err = lib.fd_launch(q.data_ptr(), k_cache.data_ptr(),
                            v_cache.data_ptr(), *cur, o.data_ptr(),
                            None if ws is None else ws.data_ptr(),
                            B, Hq, Hkv, D, S, int(window or 0),
                            _build.dtype_code(q), n, _build.stream_of(q))
        _build.check(lib, err, "fd_launch")
        return o
    if splits is None:
        n = tma_plan(B, Hkv, S, decode_split.sm_count(q.device))
    else:
        n = decode_split.splits_for(q, Hkv, S, splits)
    if n > TMA_MAX_SPLITS:
        raise ValueError(f"flash_decode: {n} splits in one cluster (at most "
                         f"{TMA_MAX_SPLITS})")
    err = lib.fd_tma_launch(q.data_ptr(), k_cache.data_ptr(),
                            v_cache.data_ptr(), *cur, o.data_ptr(),
                            B, Hq, Hkv, D, S, int(window or 0), n,
                            _build.stream_of(q))
    _build.check(lib, err, "fd_tma_launch")
    return o

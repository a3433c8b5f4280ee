"""The route, tile and split plan of the conv2d kernels (``csrc/conv2d.cu``).

``csrc/conv2d.cu`` computes a VALID conv of a padded NHWC input with HWIO
weights as an implicit GEMM: rows m = (n, ho, wo), M = N*Ho*Wo; columns
k, K = Cout; depth r = (i, j, c), R = kh*kw*C.  Two kernels:

* ``mma``: ``conv_mma<T, BN>``, on the tensor cores (``mma.sync``
  m16n8k16 bf16 -> f32) in both dtypes; f32 runs as three bf16 passes.
  A 128 x BN output tile per CTA (4 warps; BN 64 or 128 by Cout), the
  gathered A tile and the B tile staged by 16-byte ``cp.async`` in a ring
  of 128-byte deep K steps (64 bf16 or 32 f32 depth rows).  A 16-byte
  chunk must be one tap's channels and every B and y row must start on
  16 bytes: C a multiple of 8 (bf16) or 4 (f32), Cout a multiple of 8,
  x, w and y at 16-byte aligned addresses.
* ``cuda_core``: ``conv_igemm``, the CUDA-core kernel, for everything
  else (the C = 3 stems, ragged channel counts, misaligned operands).  It
  does not split R: a forced split count is held to 1.

``plan`` picks the route, column tile and R split from the shapes, dtype
and alignment alone, so every call of one shape takes one route: no
runtime trial, no fallback.  Split R cuts the depth into ``splits``
contiguous ranges of ``rows`` rows each (the last may be shorter, none is
empty), one CTA per (tile, range); the ranges' f32 partial sums go to a
``(splits, M, K)`` workspace that a second kernel adds in split order, so
the result does not depend on which CTA ends first.  ``csrc/conv2d.cu``
repeats the tile constants below and refuses a plan that breaks them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

ROUTES = ("mma", "cuda_core")
ROUTE_CODES = {r: i for i, r in enumerate(ROUTES)}   # conv_run's `route`

# conv_mma<T, BN>: CTA tile MMA_BM x BN (4 warps), depth step MMA_BK[bf16]
MMA_BM = 128
MMA_BNS = (64, 128)
MMA_BK = {True: 64, False: 32}   # 128 bytes of depth a step, by bf16
MMA_MIN_STEPS = 4        # fewest depth steps a split may own
CTAS_PER_SM = 2          # conv_mma's occupancy: both slots filled
WS_MAX_BYTES = 32 << 20  # the f32 workspace, written and read back in L2
ALIGN = 16               # bytes: cp.async's chunk, the rows' alignment

# conv_igemm (the CUDA-core kernel): its fixed tile
CC_BM, CC_BN = 128, 64


@dataclass(frozen=True)
class Plan:
    route: str      # one of ROUTES
    bm: int         # output rows (pixels) a CTA covers
    bn: int         # output columns (Cout) a CTA covers
    splits: int     # depth ranges, one CTA each per output tile
    rows: int       # depth rows a range owns; the last may own fewer

    def ranges(self, R: int):
        """The depth rows ``[lo, hi)`` of each split, in order."""
        return [(z * self.rows, min(R, (z + 1) * self.rows))
                for z in range(self.splits)]


def aligned(C: int, K: int, *ptrs: int, bf16: bool) -> bool:
    """Whether the operands can be staged in 16-byte chunks: a chunk of 8
    bf16 or 4 f32 channels lies in one tap (C a multiple of it), every
    weight and output row starts on 16 bytes (K a multiple of 8, which the
    bf16 epilogue's pairs also need) and so does every pointer."""
    return (C % (8 if bf16 else 4) == 0 and K % 8 == 0
            and all(p % ALIGN == 0 for p in ptrs))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mma_bn(K: int) -> int:
    """The column tile with the fewest padded columns; 128 on a tie."""
    return min(reversed(MMA_BNS), key=lambda bn: _ceil(K, bn) * bn - K)


def _mma_splits(M: int, K: int, R: int, bn: int, bk: int, n_sm: int) -> int:
    """As many depth ranges as fit beside the output tiles in the SMs' CTA
    slots, while each range keeps MMA_MIN_STEPS depth steps and the f32
    workspace stays within WS_MAX_BYTES."""
    tiles = _ceil(M, MMA_BM) * _ceil(K, bn)
    want = CTAS_PER_SM * n_sm // tiles
    by_steps = R // (MMA_MIN_STEPS * bk)
    by_bytes = WS_MAX_BYTES // (4 * M * K)
    return max(1, min(want, by_steps, by_bytes))


def plan(M: int, K: int, R: int, *, bf16: bool, is_aligned: bool, n_sm: int,
         route: Optional[str] = None, splits: Optional[int] = None,
         bn: Optional[int] = None) -> Plan:
    """The launch of a conv with GEMM rows M, columns K (Cout) and depth R:
    the route for this dtype and alignment, its column tile and its R split
    on a card with ``n_sm`` SMs.  ``route``, ``splits`` and ``bn`` force a
    choice (the card's checks and sweeps use them); a forced route the
    operands cannot take raises, and forced splits are rounded to whole
    depth steps, so the plan may hold fewer."""
    if min(M, K, R) < 1:
        raise ValueError(f"conv2d plan: empty GEMM {(M, K, R)}")
    if route is None:
        route = "mma" if is_aligned else "cuda_core"
    elif route not in ROUTES:
        raise ValueError(f"conv2d plan: unknown route {route!r}")
    elif route == "mma" and not is_aligned:
        raise ValueError("conv2d plan: the mma route takes C % 8 == 0 "
                         "(bf16) or C % 4 == 0 (f32), Cout % 8 == 0 and "
                         "operands at 16-byte addresses")
    if splits is not None and splits < 1:
        raise ValueError(f"conv2d plan: splits must be >= 1, got {splits}")
    if route == "cuda_core":
        if bn not in (None, CC_BN):
            raise ValueError(f"conv2d plan: the cuda_core route's tile is "
                             f"{CC_BM} x {CC_BN}, not bn {bn}")
        return Plan(route, CC_BM, CC_BN, 1, R)
    if bn is None:
        bn = mma_bn(K)
    elif bn not in MMA_BNS:
        raise ValueError(f"conv2d plan: bn must be one of {MMA_BNS}, got {bn}")
    bk = MMA_BK[bf16]
    want = _mma_splits(M, K, R, bn, bk, n_sm) if splits is None else splits
    rows = _ceil(_ceil(R, want), bk) * bk
    return Plan(route, MMA_BM, bn, _ceil(R, rows), rows)


def workspace_shape(p: Plan, M: int, K: int) -> Tuple[int, ...]:
    """The f32 partial sums of a split launch; nothing when it is one."""
    return (p.splits, M, K) if p.splits > 1 else (0,)


def gemm_dims(x_shape, w_shape, stride: int) -> Tuple[int, int, int, int,
                                                       int]:
    """(M, K, R, Ho, Wo) of a VALID conv of x (N, Hp, Wp, C) with w (kh,
    kw, C, K) at ``stride``."""
    N, Hp, Wp, C = x_shape
    kh, kw, _, K = w_shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    return N * Ho * Wo, K, kh * kw * C, Ho, Wo

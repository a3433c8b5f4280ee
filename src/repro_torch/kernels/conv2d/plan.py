"""The route, tile and split plan of the conv2d kernels (``csrc/conv2d.cu``).

``csrc/conv2d.cu`` computes a VALID conv of a padded NHWC input with HWIO
weights as an implicit GEMM: rows m = (n, ho, wo), M = N*Ho*Wo; columns
k, K = Cout; depth r = (i, j, c), R = kh*kw*C.  Three kernels:

* ``wgmma``: ``conv_wgmma<T, BN>``, on Hopper's warpgroup tensor cores
  (``wgmma.mma_async`` bf16 -> f32) fed by TMA; f32 runs as three bf16
  passes (A split in registers, the weights split once a launch into a
  bf16 hi / lo scratch after the split's partial sums).  A 128 x BN
  output tile per CTA (two consumer warpgroups and a producer; BN 64,
  128 or 256 by Cout, ``wg_bn``; two CTAs an SM at 64 and at bf16's 128,
  WG_CTAS; f32 at 128 one persistent CTA an SM walking the tiles), a
  depth step one tap's 128-byte line of channels, A gathered
  by TMA's im2col mode (128 pixels, crossing output rows and images;
  zeros past M; a 1x1 stride-1 conv reads x as its (M, C) matrix), B the
  (R, K) weight matrix read in place.  It takes what TMA reads in whole
  lines (``tma_legal``): C a multiple of 64 (bf16) or 32 (f32), Cout a
  multiple of 8, x, w and y 16-byte aligned, the stride at most 8; and
  of those the shapes past the measured crossing (``wgmma_wins``: every
  bf16 conv, f32 past R = 64).
* ``mma``: ``conv_mma<T, BN>``, on the tensor cores (``mma.sync``
  m16n8k16 bf16 -> f32) in both dtypes; f32 runs as three bf16 passes.
  A 128 x BN output tile per CTA (4 warps; BN 64 or 128 by Cout), the
  gathered A tile and the B tile staged by 16-byte ``cp.async`` in a ring
  of 128-byte deep K steps (64 bf16 or 32 f32 depth rows).  A 16-byte
  chunk must be one tap's channels and every B and y row must start on
  16 bytes: C a multiple of 8 (bf16) or 4 (f32), Cout a multiple of 8,
  x, w and y at 16-byte aligned addresses.  It keeps the aligned convs
  ``wgmma`` does not take: GoogLeNet's 16 / 24 / 48 / 112 / 144 / 528
  channels in both dtypes and 32 / 96 / 160 / 480 in bf16, which fill no
  whole line, and f32 convs of R <= 64.
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
from functools import lru_cache
from typing import Optional, Tuple

ROUTES = ("mma", "cuda_core", "wgmma")
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

# conv_wgmma<T, BN>: CTA tile WG_BM x BN, WG_CTAS[bn, bf16] CTAs an SM,
# depth step WG_BK[bf16] (a 128-byte line of channels); TMA's traversal
# stride and im2col corner offsets bound the stride and the window
WG_BM = 128
WG_BNS = (64, 128, 256)
WG_CTAS = {(64, True): 2, (64, False): 2, (128, True): 2, (128, False): 1,
           (256, True): 1, (256, False): 1}
WG_BK = {True: 64, False: 32}
WG_SPLIT_ROWS = 2048     # fewest depth rows a split may own
WG_SHALLOW_R = 256       # depth up to which bf16 prefers 128 on a tie
WG_MAX_STRIDE = 8
WG_MAX_TAPS = 129
WG_THIN_R = 64           # f32 depth from which wgmma_wins


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


def tma_legal(C: int, K: int, kh: int, kw: int, stride: int, *ptrs: int,
              bf16: bool) -> bool:
    """Whether ``wgmma`` can take the conv: TMA's im2col mode reads x in
    whole 128-byte lines of one pixel's channels (C a multiple of 64 bf16
    or 32 f32), its tiled mode reads the weights' rows and the epilogue
    writes y's in 16-byte chunks (Cout a multiple of 8), every pointer
    16-byte aligned, the stride TMA's traversal stride (at most 8) and the
    window's far corner within im2col's offsets (kh, kw at most 129)."""
    return (C % WG_BK[bf16] == 0 and K % 8 == 0 and stride <= WG_MAX_STRIDE
            and max(kh, kw) <= WG_MAX_TAPS
            and all(p % ALIGN == 0 for p in ptrs))


def wgmma_wins(M: int, K: int, R: int, *, bf16: bool) -> bool:
    """Whether a TMA-legal conv takes ``wgmma`` rather than ``mma``: the
    crossing measured at ResNet-50's 19 tensor-core shapes over batches 1
    to 64 in both dtypes (``chip_smoke.py --only conv2d``'s sweep; PERF.md
    row 7).  ``wgmma`` won at every shape and M (bf16: 0.43-1.03x the time
    of ``mma``) but f32 at R <= 64, two depth steps a tile, too few for
    the ring to hide its loads behind three bf16 passes (56x56 64 -> 256
    1x1: 1.05-1.29x; 64 -> 64: 0.95-1.23x).  M did not move it."""
    return bf16 or R > WG_THIN_R


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


def _wg_tiles(M: int, K: int, bn: int) -> int:
    return _ceil(M, WG_BM) * _ceil(K, bn)


def _wg_splits(M: int, K: int, R: int, bn: int, bf16: bool,
               n_sm: int) -> int:
    """As many depth ranges as fit beside the output tiles in the SMs'
    WG_CTAS[bn, bf16] CTA slots each, while each range keeps WG_SPLIT_ROWS
    depth rows (the sweep of ``chip_smoke.py --only conv2d``: a split's f32
    round trip through the workspace outweighed the SMs it fills at R =
    2,048, and paid at R = 4,608) and the workspace stays within
    WS_MAX_BYTES."""
    want = WG_CTAS[bn, bf16] * n_sm // _wg_tiles(M, K, bn)
    by_rows = R // WG_SPLIT_ROWS
    by_bytes = WS_MAX_BYTES // (4 * M * K)
    return max(1, min(want, by_rows, by_bytes))


def wg_bn(M: int, K: int, R: int, bf16: bool, n_sm: int) -> int:
    """64 columns a CTA for Cout <= 64; past it, of 128 and 256, the
    width with the fewest padded columns, then the least work an SM (its
    CTAs, after the width's split, in rounds of one an SM, times the
    columns a CTA and the depth a split); on a tie 256, but 128 where it
    runs two CTAs an SM (bf16) and R <= WG_SHALLOW_R, so that one CTA's
    loads and epilogue overlap the other's few products (the sweep of
    ``chip_smoke.py --only conv2d``: ResNet-50's 56x56 64 -> 256 and 28x28
    128 -> 512 1x1s 7-8 % faster at 128, its 3x3s faster at 256)."""
    if K <= 64:
        return 64
    shallow = WG_CTAS[128, bf16] > 1 and R <= WG_SHALLOW_R

    def cost(bn):
        splits = _wg_splits(M, K, R, bn, bf16, n_sm)
        rounds = _ceil(_wg_tiles(M, K, bn) * splits, n_sm)
        return (_ceil(K, bn) * bn - K, rounds * bn / splits,
                bn if shallow else -bn)
    return min((128, 256), key=cost)


@lru_cache(maxsize=4096)   # a pure function of its arguments, on every call
def plan(M: int, K: int, R: int, *, bf16: bool, is_aligned: bool, n_sm: int,
         tma: bool = False, route: Optional[str] = None,
         splits: Optional[int] = None, bn: Optional[int] = None) -> Plan:
    """The launch of a conv with GEMM rows M, columns K (Cout) and depth R:
    the route for this dtype and alignment, its column tile and its R split
    on a card with ``n_sm`` SMs.  ``is_aligned``: the operands ``mma``
    stages (``aligned``); ``tma``: the conv ``wgmma`` reads (``tma_legal``),
    which it takes where ``wgmma_wins``.  ``route``, ``splits`` and ``bn``
    force a choice (the card's checks and sweeps use them); a forced route
    the operands cannot take raises, and forced splits are rounded to whole
    depth steps, so the plan may hold fewer."""
    if min(M, K, R) < 1:
        raise ValueError(f"conv2d plan: empty GEMM {(M, K, R)}")
    if route is None:
        route = ("wgmma" if tma and wgmma_wins(M, K, R, bf16=bf16)
                 else "mma" if is_aligned else "cuda_core")
    elif route not in ROUTES:
        raise ValueError(f"conv2d plan: unknown route {route!r}")
    elif route == "mma" and not is_aligned:
        raise ValueError("conv2d plan: the mma route takes C % 8 == 0 "
                         "(bf16) or C % 4 == 0 (f32), Cout % 8 == 0 and "
                         "operands at 16-byte addresses")
    elif route == "wgmma" and not tma:
        raise ValueError("conv2d plan: the wgmma route takes C % 64 == 0 "
                         "(bf16) or C % 32 == 0 (f32), Cout % 8 == 0, "
                         "operands at 16-byte addresses and a stride of "
                         f"at most {WG_MAX_STRIDE}")
    if splits is not None and splits < 1:
        raise ValueError(f"conv2d plan: splits must be >= 1, got {splits}")
    if route == "cuda_core":
        if bn not in (None, CC_BN):
            raise ValueError(f"conv2d plan: the cuda_core route's tile is "
                             f"{CC_BM} x {CC_BN}, not bn {bn}")
        return Plan(route, CC_BM, CC_BN, 1, R)
    if route == "wgmma":
        bk = WG_BK[bf16]
        if bn is None:
            bn = wg_bn(M, K, R, bf16, n_sm)
        elif bn not in WG_BNS:
            raise ValueError(f"conv2d plan: the wgmma route's bn must be "
                             f"one of {WG_BNS}, got {bn}")
        want = (_wg_splits(M, K, R, bn, bf16, n_sm) if splits is None
                else splits)
        rows = _ceil(_ceil(R, want), bk) * bk
        return Plan(route, WG_BM, bn, _ceil(R, rows), rows)
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


def weights_scratch(p: Plan, R: int, K: int, *, bf16: bool) -> int:
    """f32 elements of scratch after the partial sums: on ``wgmma`` in
    f32 the weights' bf16 hi and lo halves, (2, R, K) bf16; else none."""
    return R * K if p.route == "wgmma" and not bf16 else 0


def gemm_dims(x_shape, w_shape, stride: int) -> Tuple[int, int, int, int,
                                                       int]:
    """(M, K, R, Ho, Wo) of a VALID conv of x (N, Hp, Wp, C) with w (kh,
    kw, C, K) at ``stride``."""
    N, Hp, Wp, C = x_shape
    kh, kw, _, K = w_shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    return N * Ho * Wo, K, kh * kw * C, Ho, Wo

"""The route, tile and split plan of the matmul kernels (``csrc/matmul.cu``).

``csrc/matmul.cu`` holds three kernels for ``C = A @ B``:

* ``mma``: ``mm_mma<BM, A_VEC, B_VEC>``, bf16 on the tensor cores
  (``mma.sync`` m16n8k16), every bf16 product whatever its shape and
  addresses.  An operand whose rows start on 16-byte boundaries (A: K % 8
  == 0 and A 16-byte aligned; B: N % 8 == 0 and B so) is staged by 16-byte
  ``cp.async``; any other is *staged* through registers from the aligned
  16-byte windows that cover its rows (``Plan.staged``, per operand).  BM
  (16, 64 or 128 rows a CTA) is the least of them that covers M, and 128
  past it.
* ``skinny``: ``mm_skinny``, M <= 16 on the CUDA cores, B streamed through
  registers: the f32 route at decode.
* ``tiled``: ``mm_tiled``, any M on the CUDA cores in f32: the f32 route
  past M = 16 (the CNNs' fc layers).  f32 stays off the tensor cores:
  TF32 would break the reference's 2e-4.

The two CUDA-core routes take f32 only: a forced bf16 ``skinny`` or
``tiled`` raises (``csrc/matmul.cu`` still holds their bf16 instances,
off every path).

``plan`` picks the route and the K split from the launch's shapes, dtype
and alignment alone, so every call of one shape and alignment takes one
route: no runtime trial, no fallback.  Split K cuts the K rows into
``splits`` contiguous ranges of ``rows`` rows each (the last may be
shorter, none is empty), one CTA per (tile, range); the ranges' f32
partial sums go to a ``(splits, M, N)`` workspace that a second kernel
adds in split order, so the result does not depend on which CTA ends
first.  ``csrc/matmul.cu`` repeats the tile constants below and refuses a
plan that breaks them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

ROUTES = ("mma", "skinny", "tiled")
ROUTE_CODES = {r: i for i, r in enumerate(ROUTES)}   # mm_run's `route`

# mm_mma<BM>: CTA tile BM x MMA_BN, K step MMA_BK[BM]
MMA_BMS = (16, 64, 128)
MMA_BN = 128
MMA_BK = {16: 64, 64: 64, 128: 64}
MMA_MIN_STEPS = 4        # fewest K steps a split may own
ALIGN = 16               # bytes: cp.async's chunk, the rows' alignment

# the CUDA-core kernels, as they were planned before the tensor-core route
SK_MAXM, SK_STRIPE, SK_MIN_ROWS = 16, 256, 64
T_TM, T_TN, T_MIN_ROWS = 128, 64, 256
CTAS_PER_SM = 4


@dataclass(frozen=True)
class Plan:
    route: str      # one of ROUTES
    bm: int         # rows of A a CTA covers (skinny: M itself)
    splits: int     # K ranges, one CTA each per output tile
    rows: int       # K rows a range owns; the last may own fewer
    # mma: whether (A, B) go through their windows (rows not 16-byte
    # aligned)
    staged: Tuple[bool, bool] = (False, False)

    def ranges(self, K: int):
        """The K rows ``[lo, hi)`` of each split, in order."""
        return [(z * self.rows, min(K, (z + 1) * self.rows))
                for z in range(self.splits)]


def aligned(N: int, K: int, a_ptr: int, b_ptr: int) -> Tuple[bool, bool]:
    """Whether each bf16 operand, (A, B), can be staged by 16-byte
    ``cp.async``: every row of A (K long) and of B (N long) starts on a
    16-byte boundary."""
    return (K % 8 == 0 and a_ptr % ALIGN == 0,
            N % 8 == 0 and b_ptr % ALIGN == 0)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _route(M: int, bf16: bool) -> str:
    if bf16:
        return "mma"
    return "skinny" if M <= SK_MAXM else "tiled"


def mma_bm(M: int) -> int:
    return next((bm for bm in MMA_BMS if M <= bm), MMA_BMS[-1])


def _mma_splits(M: int, N: int, K: int, bm: int, n_sm: int) -> int:
    """As many K ranges as fit beside the output tiles on the SMs, one CTA
    an SM, while each range keeps MMA_MIN_STEPS K steps and the f32
    workspace the split writes stays no larger than the B it splits."""
    tiles = _ceil(M, bm) * _ceil(N, MMA_BN)
    want = n_sm // tiles
    by_steps = K // (MMA_MIN_STEPS * MMA_BK[bm])
    by_bytes = K // (2 * M)    # splits x M x N x 4 <= K x N x 2
    return max(1, min(want, by_steps, by_bytes))


def _cuda_core_splits(M: int, N: int, K: int, n_sm: int) -> int:
    if M <= SK_MAXM:
        tiles, min_rows = _ceil(N, SK_STRIPE), SK_MIN_ROWS
    else:
        tiles, min_rows = _ceil(N, T_TN) * _ceil(M, T_TM), T_MIN_ROWS
    return max(1, min(_ceil(CTAS_PER_SM * n_sm, tiles), K // min_rows))


def plan(M: int, N: int, K: int, *, bf16: bool,
         is_aligned: Tuple[bool, bool], n_sm: int,
         route: Optional[str] = None,
         splits: Optional[int] = None) -> Plan:
    """The launch of ``(M, K) @ (K, N)``: the route for this dtype, its row
    tile, its K split on a card with ``n_sm`` SMs and, on the tensor cores,
    which operands are staged through their windows (``is_aligned``: A's
    and B's, from ``aligned``).  ``route`` and ``splits`` force a choice
    (the card's checks and A/Bs use them); a forced route the operands
    cannot take raises (``mma`` takes bf16 only, ``skinny`` and ``tiled``
    f32 only), and forced splits are rounded to whole K steps, so
    the plan may hold fewer."""
    if min(M, N, K) < 1:
        raise ValueError(f"matmul plan: empty shape {(M, N, K)}")
    if route is None:
        route = _route(M, bf16)
    elif route not in ROUTES:
        raise ValueError(f"matmul plan: unknown route {route!r}")
    elif route == "mma" and not bf16:
        raise ValueError("matmul plan: the mma route takes bf16 operands")
    elif route != "mma" and bf16:
        raise ValueError(f"matmul plan: the {route} route takes f32 "
                         "operands; bf16 takes the tensor cores (mma)")
    elif route == "skinny" and M > SK_MAXM:
        raise ValueError(f"matmul plan: the skinny route takes M <= "
                         f"{SK_MAXM}, got {M}")
    staged = (False, False)
    if route == "mma":
        bm, step = mma_bm(M), MMA_BK[mma_bm(M)]
        want = _mma_splits(M, N, K, bm, n_sm) if splits is None else splits
        staged = (not is_aligned[0], not is_aligned[1])
    else:
        bm, step = (M, 1) if route == "skinny" else (T_TM, 1)
        want = (_cuda_core_splits(M, N, K, n_sm) if splits is None
                else splits)
    if want < 1:
        raise ValueError(f"matmul plan: splits must be >= 1, got {want}")
    rows = _ceil(_ceil(K, want), step) * step
    return Plan(route, bm, _ceil(K, rows), rows, staged)


def workspace_shape(p: Plan, M: int, N: int) -> Tuple[int, ...]:
    """The f32 partial sums of a split launch; nothing when it is one."""
    return (p.splits, M, N) if p.splits > 1 else (0,)

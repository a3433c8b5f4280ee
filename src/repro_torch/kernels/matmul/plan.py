"""The route, tile and split plan of the matmul kernels (``csrc/matmul.cu``,
``csrc/matmul_wgmma.cu``).

Five kernels compute ``C = A @ B``:

* ``wgmma``: ``mm_wgmma<BN, A_MN, B_MN>`` (``csrc/matmul_wgmma.cu``),
  bf16 on Hopper's warpgroup tensor cores, fed by TMA: training's
  products, and the serving waves' where it is the fastest route.  It
  takes a launch with M >= WG_MIN_M (past one row tile), or a wave of
  WG_WAVE_M rows that ``_wave_on_wgmma`` gives it, whose operands TMA can
  read in place (``tma_operand``): each a row-major matrix or the ``.t()``
  view of one, its base 16-byte aligned and its lines a multiple of 16
  bytes apart.  A CTA owns 128 x BN outputs, BN 256 unless 128 fills more
  SMs (``_wg_bn``).
* ``stream``: ``mm_stream<A_MN, B_MN>`` (``csrc/matmul_wgmma.cu``), bf16
  on the same warpgroup tensor cores and TMA ring, for the bytes-bound
  products of the serving prefill waves and refills (``stream_takes``:
  M from STREAM_MIN_M to one row tile, K from STREAM_MIN_K, enough column
  tiles of STREAM_BN, operands TMA-legal).  The crossings of the three
  tensor-core routes are measured ones: ``chip_smoke.py --only
  matmul``'s sweep of every config's products on each route.  A persistent grid
  of ``ctas`` CTAs, one an SM, walks the flattened (tile, K step) units
  in equal contiguous shares
  (``Plan.shares``: stream-K); a tile whose K steps two or more shares
  hold is summed in the kernel, in share order, by the first of them,
  from f32 partials in a workspace of one slot a CTA.
* ``mma``: ``mm_mma<BM, A_VEC, B_VEC>``, bf16 on the tensor cores
  (``mma.sync`` m16n8k16): every other bf16 product (decode, short or
  narrow products, most of a refill's, products TMA cannot read in
  place, misaligned operands).  It reads contiguous operands:
  the wrapper copies a transposed view first.  An operand whose rows
  start on 16-byte boundaries (A: K % 8 == 0 and A 16-byte aligned; B: N
  % 8 == 0 and B so) is staged by 16-byte ``cp.async``; any other is
  *staged* through registers from the aligned 16-byte windows that cover
  its rows (``Plan.staged``, per operand).  BM (16, 64 or 128 rows a
  CTA) is the least of them that covers M, and 128 past it.
* ``skinny``: ``mm_skinny``, M <= 16 on the CUDA cores, B streamed through
  registers: the f32 route at decode.
* ``tiled``: ``mm_tiled``, any M on the CUDA cores in f32: the f32 route
  past M = 16 (the CNNs' fc layers).  f32 stays off the tensor cores:
  TF32 would break the reference's 2e-4.

The two CUDA-core routes take f32 only and ``csrc/matmul.cu`` compiles
them for f32 alone: a forced bf16 ``skinny`` or ``tiled`` raises, as a
forced f32 ``mma`` or ``wgmma`` does.

``plan`` picks the route and the K split from the launch's shapes, dtype
and alignment alone, so every call of one shape and alignment takes one
route: no runtime trial, no fallback.  Split K cuts the K rows into
``splits`` contiguous ranges of ``rows`` rows each (the last may be
shorter, none is empty), one CTA per (tile, range); the ranges' f32
partial sums go to a ``(splits, M, N)`` workspace that a second kernel
adds in split order, so the result does not depend on which CTA ends
first.  The CUDA sources repeat the tile constants below and refuse a
plan that breaks them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

ROUTES = ("mma", "skinny", "tiled", "wgmma", "stream")
ROUTE_CODES = {r: i for i, r in enumerate(ROUTES[:3])}   # mm_run's `route`

# mm_mma<BM>: CTA tile BM x MMA_BN, K step MMA_BK[BM]
MMA_BMS = (16, 64, 128)
MMA_BN = 128
MMA_BK = {16: 64, 64: 64, 128: 64}
MMA_MIN_STEPS = 4        # fewest K steps a split may own
ALIGN = 16               # bytes: cp.async's chunk, the rows' alignment

# mm_wgmma<BN>: CTA tile WG_BM x BN, K step WG_BK; M from which it is the
# route (operands TMA-legal): past one row tile, where the sweep had it
# beat ``mma`` at every shape and ``stream`` at all but a tie (160 and 255
# rows); a wave of WG_WAVE_M rows it takes where ``_wave_on_wgmma`` says
# (weights of WG_WAVE_KN elements or more, or a product ``stream`` does
# not take)
WG_BM, WG_BNS, WG_BK = 128, (128, 256), 64
WG_MIN_M = 129
WG_WAVE_M = 128
WG_WAVE_KN = 1 << 27
WG_MIN_STEPS = 4

# mm_stream: WG_BM x STREAM_BN tiles, K steps of WG_BK; the launches it
# takes (bf16, operands TMA-legal; ``stream_takes``): M from STREAM_MIN_M
# (decode, M <= 16, stays on mm_mma<16>) to one row tile, K from
# STREAM_MIN_K (a shorter K leaves too few units for one CTA an SM); from
# STREAM_WIDE_M rows at least STREAM_MIN_TILES column tiles, below it (a
# refill, where mm_mma's 64-row tile is fast) a column tile an SM: fewer
# tiles are each shared by more CTAs, and the sum of their partials costs
# more than mm_mma loses; the fewest K steps a CTA's share holds, so that
# a share's weight bytes outweigh its partial's round trip; the tiles'
# counters of the kernel's module (SK_TILES, one a tile)
STREAM_MIN_M, STREAM_WIDE_M = 17, 65
STREAM_MIN_K = 1024
STREAM_BN = 128
STREAM_MIN_TILES = 16
STREAM_MIN_STEPS = 8
STREAM_TILES = 4096

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
    bn: int = MMA_BN    # columns a CTA covers (mma / wgmma / stream)
    ctas: int = 0       # stream: the persistent grid, one CTA an SM
    units: int = 0      # stream: (tile, K step) units, tiles column-major

    def ranges(self, K: int):
        """The K rows ``[lo, hi)`` of each split, in order."""
        return [(z * self.rows, min(K, (z + 1) * self.rows))
                for z in range(self.splits)]

    def shares(self):
        """stream: the units ``[lo, hi)`` each CTA walks, in CTA order."""
        return [(c * self.units // self.ctas,
                 (c + 1) * self.units // self.ctas)
                for c in range(self.ctas)]


def aligned(N: int, K: int, a_ptr: int, b_ptr: int) -> Tuple[bool, bool]:
    """Whether each bf16 operand, (A, B), can be staged by 16-byte
    ``cp.async``: every row of A (K long) and of B (N long) starts on a
    16-byte boundary."""
    return (K % 8 == 0 and a_ptr % ALIGN == 0,
            N % 8 == 0 and b_ptr % ALIGN == 0)


def tma_operand(shape: Tuple[int, int], stride: Tuple[int, int],
                ptr: int) -> Optional[Tuple[bool, int]]:
    """How TMA reads a bf16 matrix of ``shape`` and element ``stride`` at
    address ``ptr`` in place: ``(transposed, ld)``, transposed False where
    its rows are contiguous (stride (ld, 1)), True where its columns are
    (stride (1, ld): the ``.t()`` view of a row-major matrix); ld, the
    elements between lines, at least a line and a multiple of 8 (16
    bytes), the base 16-byte aligned.  None where TMA cannot read it so
    (another layout, a line stride off 16 bytes, a base off 16 bytes)."""
    (R, C), (s0, s1) = shape, stride
    if s1 == 1 and s0 >= C:
        trans, ld = False, s0
    elif s0 == 1 and s1 >= R:
        trans, ld = True, s1
    else:
        return None
    if ptr % ALIGN or ld % (ALIGN // 2):
        return None
    return trans, ld


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _route(M: int, N: int, K: int, bf16: bool, tma: bool, n_sm: int) -> str:
    if bf16:
        if tma and (M >= WG_MIN_M or (M >= WG_WAVE_M and
                                      _wave_on_wgmma(M, N, K, n_sm))):
            return "wgmma"
        if tma and stream_takes(M, N, K, n_sm):
            return "stream"
        return "mma"
    return "skinny" if M <= SK_MAXM else "tiled"


def _wave_on_wgmma(M: int, N: int, K: int, n_sm: int) -> bool:
    """Whether a wave of a full row tile takes ``wgmma``: where its weights
    hold WG_WAVE_KN elements or more (the heads, qwen1.5-110b's MLP: on so
    long a walk wgmma's 256-column tile, reading A half as often, beat
    stream's shares by 2-24 %), and where ``stream`` does not take it (the
    narrow k / v products, mamba2's K < STREAM_MIN_K: wgmma's instruction
    beat mma.sync's on the same grid by 9-27 %) unless wgmma splits K more
    ways than ``mma`` would (its 256-column tile doubling the partials'
    round trip: qwen1.5-110b's 8192->1024, 23 % slower)."""
    if K * N >= WG_WAVE_KN:
        return True
    if stream_takes(M, N, K, n_sm):
        return False
    return (_wg_splits(M, N, K, _wg_bn(M, N, K, n_sm), n_sm)
            <= _mma_splits(M, N, K, mma_bm(M), n_sm))


def stream_takes(M: int, N: int, K: int, n_sm: int) -> bool:
    """Whether a bf16 launch whose operands TMA reads in place takes the
    stream route on a card of ``n_sm`` SMs (the limits above)."""
    if not STREAM_MIN_M <= M < WG_MIN_M or K < STREAM_MIN_K or \
            stream_tiles(M, N) > STREAM_TILES:
        return False
    cols = _ceil(N, STREAM_BN)
    return cols >= (STREAM_MIN_TILES if M >= STREAM_WIDE_M else n_sm)


def stream_tiles(M: int, N: int) -> int:
    return _ceil(M, WG_BM) * _ceil(N, STREAM_BN)


def stream_units(M: int, N: int, K: int) -> int:
    """mm_stream's (tile, K step) units."""
    return stream_tiles(M, N) * _ceil(K, WG_BK)


def _stream_ctas(units: int, n_sm: int) -> int:
    """One CTA an SM, fewer where a share would hold under
    STREAM_MIN_STEPS K steps."""
    return max(1, min(n_sm, units // STREAM_MIN_STEPS))


def stream_slot(M: int) -> int:
    """Floats a workspace slot of mm_stream holds: the f32 fragments of
    the warps whose 16 rows lie below M, STREAM_BN / 2 a thread."""
    return STREAM_BN // 2 * 32 * _ceil(min(M, WG_BM), 16)


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


def _wg_tiles(M: int, N: int, bn: int) -> int:
    return _ceil(M, WG_BM) * _ceil(N, bn)


def _wg_splits(M: int, N: int, K: int, bn: int, n_sm: int) -> int:
    """As ``_mma_splits``, for the 128 x bn tiles of ``wgmma``."""
    want = n_sm // _wg_tiles(M, N, bn)
    by_steps = K // (WG_MIN_STEPS * WG_BK)
    by_bytes = K // (2 * M)    # splits x M x N x 4 <= K x N x 2
    return max(1, min(want, by_steps, by_bytes))


def _wg_bn(M: int, N: int, K: int, n_sm: int) -> int:
    """256 columns a CTA, unless 128 (after each width's split) puts CTAs
    on more of the SMs."""
    def filled(bn):
        return min(n_sm, _wg_tiles(M, N, bn) * _wg_splits(M, N, K, bn, n_sm))
    return 128 if filled(128) > filled(256) else 256


def _cuda_core_splits(M: int, N: int, K: int, n_sm: int) -> int:
    if M <= SK_MAXM:
        tiles, min_rows = _ceil(N, SK_STRIPE), SK_MIN_ROWS
    else:
        tiles, min_rows = _ceil(N, T_TN) * _ceil(M, T_TM), T_MIN_ROWS
    return max(1, min(_ceil(CTAS_PER_SM * n_sm, tiles), K // min_rows))


def plan(M: int, N: int, K: int, *, bf16: bool,
         is_aligned: Tuple[bool, bool], n_sm: int, tma: bool = False,
         route: Optional[str] = None, splits: Optional[int] = None,
         ctas: Optional[int] = None) -> Plan:
    """The launch of ``(M, K) @ (K, N)``: the route for this dtype, its row
    tile, its K split on a card with ``n_sm`` SMs and, on ``mma``, which
    operands are staged through their windows (``is_aligned``: A's and
    B's, from ``aligned``, of the contiguous operands ``mma`` reads).
    ``tma``: whether TMA can read both operands in place
    (``tma_operand``); bf16 then takes ``wgmma`` at M >= WG_MIN_M and at
    a wave of WG_WAVE_M rows where ``_wave_on_wgmma``, ``stream`` where
    ``stream_takes``.
    ``route`` and ``splits`` force a choice (the card's checks and A/Bs
    use them), on ``stream`` ``ctas``; a forced route the
    operands cannot take raises (``mma``, ``wgmma`` and ``stream`` take
    bf16 only, ``wgmma`` and ``stream`` TMA-legal operands only,
    ``skinny`` and ``tiled`` f32 only; ``stream`` splits no K range),
    forced splits are rounded to whole K steps, so the plan may hold
    fewer, and forced ctas are cut to the units and the SMs."""
    if min(M, N, K) < 1:
        raise ValueError(f"matmul plan: empty shape {(M, N, K)}")
    if route is None:
        route = _route(M, N, K, bf16, tma, n_sm)
    elif route not in ROUTES:
        raise ValueError(f"matmul plan: unknown route {route!r}")
    elif route in ("mma", "wgmma", "stream") and not bf16:
        raise ValueError(f"matmul plan: the {route} route takes bf16 "
                         "operands")
    elif route in ("skinny", "tiled") and bf16:
        raise ValueError(f"matmul plan: the {route} route takes f32 "
                         "operands; bf16 takes the tensor cores (mma)")
    elif route == "skinny" and M > SK_MAXM:
        raise ValueError(f"matmul plan: the skinny route takes M <= "
                         f"{SK_MAXM}, got {M}")
    elif route in ("wgmma", "stream") and not tma:
        raise ValueError(f"matmul plan: the {route} route reads its "
                         "operands in place by TMA: each a row-major matrix "
                         "or the .t() view of one, 16-byte aligned, its "
                         "lines a multiple of 16 bytes apart")
    if route == "stream":
        if splits not in (None, 1):
            raise ValueError("matmul plan: the stream route splits no K "
                             "range (its shares are forced by ctas)")
        if stream_tiles(M, N) > STREAM_TILES:
            raise ValueError(f"matmul plan: {stream_tiles(M, N)} tiles, "
                             f"more than the {STREAM_TILES} counters of "
                             "the stream route")
        units = stream_units(M, N, K)
        grid = _stream_ctas(units, n_sm) if ctas is None else ctas
        if grid < 1:
            raise ValueError(f"matmul plan: ctas must be >= 1, got {grid}")
        return Plan(route, WG_BM, 1, K, bn=STREAM_BN,
                    ctas=min(grid, units, n_sm), units=units)
    staged, width = (False, False), MMA_BN
    if route == "wgmma":
        bm, step = WG_BM, WG_BK
        width = _wg_bn(M, N, K, n_sm)
        want = (_wg_splits(M, N, K, width, n_sm) if splits is None
                else splits)
    elif route == "mma":
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
    return Plan(route, bm, _ceil(K, rows), rows, staged, width)


def workspace_shape(p: Plan, M: int, N: int) -> Tuple[int, ...]:
    """The f32 partial sums of a split launch; nothing when it is one.
    stream: one slot a CTA (``stream_slot``)."""
    if p.route == "stream":
        return (p.ctas, stream_slot(M))
    return (p.splits, M, N) if p.splits > 1 else (0,)

// Blocked matrix product C = A @ B with an f32 accumulator, output in the
// input dtype (bf16 or f32), row-major A (M, K), B (K, N), C (M, N).
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul_pallas (_mm_kernel).
//
// What bounds it on an H100: bytes.  On the serving path B is a weight
// matrix and M is small: M = slots (4) at decode, slots x prompt (<= 128)
// in a prefill wave.  2*M FLOPs per B element read stays below the ~295
// FLOP/byte at which the card's bf16 tensor cores, not HBM, would be the
// limit, so the weights must stream from HBM once per call, with enough
// loads in flight on every SM to fill the memory pipe, and the products
// must keep up with them: at M = 128 the CUDA cores' f32 FMAs cannot.
// Training's products (M >= 256, every operand TMA-legal) are bound by
// operations and take matmul_wgmma.cu instead; this file keeps the rest.
//
// The route, row tile and K split come from the wrapper's shapes-only plan
// (kernels/matmul/plan.py), which this file checks and never overrides:
//  * mma (bf16, any shape and address): mm_mma<BM, A_VEC, B_VEC>, a BM x
//    128 output tile per CTA, BM in {16, 64, 128} covering M.  A and
//    B tiles of 64 K rows go global -> shared into a ring of 3 (BM = 128)
//    or 4 stages (2-3 K steps in flight while one is consumed, two CTAs an
//    SM; one barrier a K step), rows padded by 8 bf16 so ldmatrix hits no
//    bank twice.  4 warps a CTA, each with a 16 x 32, 32 x 64 or 64 x 64
//    tile: A fragments by ldmatrix.x4, B's (K, N) row-major tile by
//    ldmatrix.x4.trans, mma.sync m16n8k16 bf16 x bf16 -> f32 in registers,
//    rounded once to bf16 (nearest even).
//    An operand whose rows start on 16-byte boundaries (A: K % 8 == 0 and
//    A 16-byte aligned, A_VEC; B: N % 8 == 0 and B so, B_VEC) is staged by
//    16-byte cp.async.cg; rows past M, columns past N and K rows past the
//    split's end are zero-filled by cp.async's src-size operand.
//    Any other operand (N or K odd, a view off 16 bytes) cannot be: with N
//    odd every other row of B starts 2 bytes off a 4-byte boundary, and
//    cp.async takes 4, 8 or 16 bytes from a source aligned to its size
//    while ldmatrix wants 16-byte rows in shared memory.  It is staged
//    through the aligned 16-byte windows that cover its rows: a thread owns
//    consecutive 8-element chunks of one tile row and reads the windows
//    that hold at least one of their elements (one more than the chunks
//    where the row is off), never a window that holds none; each chunk is
//    shifted into place (__funnelshift_r) and its elements past N, M, K or
//    the split's end are zeroed.  K step t + STAGES - 1's windows are read
//    into registers by ld.global.nc.v4 before step t's products and
//    shifted into the ring after them, so the loads stay in flight while
//    the tensor cores run.  The tile layout and the ldmatrix / mma.sync
//    loop are one for all instances, so a staged launch gives the bits of
//    an aligned launch on the same values; <BM, true, true> is the aligned
//    kernel as it was.  With N odd the epilogue stores a pair only at an
//    even element.
//  * skinny (M <= 16 on the CUDA cores, f32 only): a CTA
//    owns a 256-column stripe of B for every row of A; each lane owns 8
//    columns and reads them as one or two 16-byte vectors per row of B
//    (scalar loads where N or the pointer is not 16-byte aligned), four
//    rows ahead, so every element of B is read once, by one lane, in
//    512-byte warp rows.  The 4 warps split the CTA's K range and are
//    summed through shared memory.
//  * tiled (M > 16 on the CUDA cores, f32 only): a 128 x
//    64 output tile per CTA with a 16-deep K step staged in shared memory
//    as f32, 8 x 4 outputs per thread.  f32 stays off the tensor cores:
//    TF32 would break the reference's 2e-4 tolerance.
//  * Split K (all routes): where the output tiles leave SMs idle, the K
//    range is split over gridDim.z CTAs that write f32 partial sums to a
//    workspace the caller allocates; split_reduce (common.cuh) adds the
//    splits in a fixed order (bitwise deterministic) and rounds once to the
//    output dtype.
// A launch allocates nothing and synchronises nothing.  Ragged edges (M,
// N, K not multiples of the tiles) are masked, never asserted.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

// -- skinny (M <= 16) ---------------------------------------------------------
constexpr int SK_WARPS = 4;
constexpr int SK_COLS = 8;            // columns per lane
constexpr int SK_STRIPE = 32 * SK_COLS;   // 256 columns per CTA
constexpr int SK_AHEAD = 4;           // rows of B in flight per lane
constexpr int SK_MAXM = 16;

// 8 consecutive elements of B at p (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// column of lane's v-th value: contiguous 8 per lane when vectorized,
// lane-interleaved (coalesced scalar loads) otherwise
template <bool VEC>
__device__ __forceinline__ int sk_col(int lane, int v) {
  return VEC ? lane * SK_COLS + v : lane + 32 * v;
}

template <typename T, int MT, bool VEC>
__device__ __forceinline__ void sk_row(const T* __restrict__ A,
                                       const T* __restrict__ B, int N, int K,
                                       int M, int k, int n0, int lane,
                                       float (&acc)[MT][SK_COLS]) {
  float b[SK_COLS];
  if (VEC) {
    if (n0 + lane * SK_COLS < N) {
      load8(B + (size_t)k * N + n0 + lane * SK_COLS, b);
    } else {
#pragma unroll
      for (int v = 0; v < SK_COLS; ++v) b[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) {
      const int n = n0 + sk_col<false>(lane, v);
      b[v] = n < N ? to_f<T>(B[(size_t)k * N + n]) : 0.f;
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float a = to_f<T>(A[(size_t)m * K + k]);
#pragma unroll
      for (int v = 0; v < SK_COLS; ++v) acc[m][v] += a * b[v];
    }
  }
}

template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(SK_WARPS * 32)
mm_skinny(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
          float* __restrict__ ws, int M, int N, int K, int rows_per_split) {
  __shared__ float red[SK_WARPS][SK_COLS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * SK_STRIPE;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  float acc[MT][SK_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) acc[m][v] = 0.f;

  int k = k_begin + warp;
  for (; k + (SK_AHEAD - 1) * SK_WARPS < k_end; k += SK_AHEAD * SK_WARPS) {
#pragma unroll
    for (int u = 0; u < SK_AHEAD; ++u)
      sk_row<T, MT, VEC>(A, B, N, K, M, k + u * SK_WARPS, n0, lane, acc);
  }
  for (; k < k_end; k += SK_WARPS)
    sk_row<T, MT, VEC>(A, B, N, K, M, k, n0, lane, acc);

  // sum the warps' partials row by row; one f32 result per (m, column)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) red[warp][v][lane] = acc[m][v];
    __syncthreads();
    for (int i = threadIdx.x; i < SK_STRIPE; i += blockDim.x) {
      const int v = i / 32, l = i % 32;
      const int n = n0 + sk_col<VEC>(l, v);
      if (n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < SK_WARPS; ++w) s += red[w][v][l];
        if (gridDim.z == 1)
          C[(size_t)m * N + n] = from_f<T>(s);
        else
          ws[((size_t)blockIdx.z * M + m) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// -- tiled (M > 16) -----------------------------------------------------------
constexpr int TM = 128, TN = 64, TK = 16;   // CTA tile
constexpr int TR = 8, TC = 4;               // outputs per thread (rows, cols)
constexpr int T_THREADS = (TM / TR) * (TN / TC);  // 256

template <typename T>
__global__ void __launch_bounds__(T_THREADS)
mm_tiled(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
         float* __restrict__ ws, int M, int N, int K, int rows_per_split) {
  __shared__ float As[TK][TM + 4];   // A tile, transposed (k-major)
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % (TN / TC);    // 16 column lanes: cols tx + 16 * j
  const int ty = tid / (TN / TC);    // 16 row lanes:    rows ty + 16 * i
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    for (int i = tid; i < TM * TK; i += T_THREADS) {
      const int r = i / TK, c = i % TK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end) ? to_f<T>(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < TK * TN; i += T_THREADS) {
      const int r = i / TN, c = i % TN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < k_end && gn < N) ? to_f<T>(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        if (gridDim.z == 1)
          C[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
        else
          ws[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      }
    }
  }
}

// -- tensor cores (bf16) --------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int MMA_BN = 128;          // columns per CTA

// BM = 16 (decode), 64, 128 (prefill), each 4 warps: WM x WN warps of
// MT x 16 rows by NT x 8 columns (16 x 32, 32 x 64, 64 x 64; the larger a
// warp's tile, the fewer ldmatrix bytes a product); K steps of 64; a ring
// of STAGES stages (STAGES - 1 K steps in flight), small enough that two
// CTAs fit an SM's 227 KB
template <int BM>
struct MmaCfg {
  static constexpr int WM = BM == 16 ? 1 : 2;        // warps along M
  static constexpr int WN = 4 / WM;                  // warps along N
  static constexpr int MT = BM / (16 * WM);          // m16 tiles a warp
  static constexpr int NT = MMA_BN / (8 * WN);       // n8 tiles a warp
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int BK = 64;                      // K rows a stage
  static constexpr int STAGES = BM == 128 ? 3 : 4;
  static constexpr int AS = BK + 8;                  // row strides (bf16),
  static constexpr int BS = MMA_BN + 8;              // 16 B of padding
  static constexpr int A_TILE = BM * AS;
  static constexpr int B_TILE = BK * BS;
  static constexpr size_t SMEM =
      sizeof(bf16) * (size_t)STAGES * (A_TILE + B_TILE);
  // a thread stages 16-byte chunks of one column, rows AR (A) / BR (B) apart
  static constexpr int ACH = BK / 8, BCH = MMA_BN / 8;   // chunks a row
  static constexpr int AR = THREADS / ACH, BR = THREADS / BCH;
  static_assert(THREADS % ACH == 0 && BM % AR == 0, "A chunks");
  static_assert(THREADS % BCH == 0 && BK % BR == 0, "B chunks");
  static_assert(NT % 2 == 0 && MT >= 1, "warp tile");
};

// K rows [k0, k0 + BK) of the CTA's A rows into one stage by 16-byte
// cp.async (A_VEC: every chunk wholly inside or wholly outside the problem,
// since K and the split's first row are multiples of 8): outside, zeros
template <int BM>
__device__ __forceinline__ void mma_stage_a(const bf16* __restrict__ A,
                                            bf16* as, int M, int K, int m0,
                                            int k0, int k_end, int tid) {
  using Cfg = MmaCfg<BM>;
  const int ar = tid / Cfg::ACH, ac = (tid % Cfg::ACH) * 8;
  const bool a_in = k0 + ac < k_end;
#pragma unroll
  for (int j = 0; j < BM / Cfg::AR; ++j) {
    const int r = ar + j * Cfg::AR;
    const bool ok = a_in && m0 + r < M;
    cp_async16(as + r * Cfg::AS + ac,
               ok ? A + (size_t)(m0 + r) * K + k0 + ac : A, ok);
  }
}

// ... and of the CTA's B columns (B_VEC: N a multiple of 8)
template <int BM>
__device__ __forceinline__ void mma_stage_b(const bf16* __restrict__ B,
                                            bf16* bs, int N, int n0, int k0,
                                            int k_end, int tid) {
  using Cfg = MmaCfg<BM>;
  const int br = tid / Cfg::BCH, bc = (tid % Cfg::BCH) * 8;
  const bool b_in = n0 + bc < N;
#pragma unroll
  for (int j = 0; j < Cfg::BK / Cfg::BR; ++j) {
    const int r = br + j * Cfg::BR;
    const bool ok = b_in && k0 + r < k_end;
    cp_async16(bs + r * Cfg::BS + bc,
               ok ? B + (size_t)(k0 + r) * N + n0 + bc : B, ok);
  }
}

// -- an operand whose rows are not 16-byte aligned ------------------------------
// A tile of ROWS rows of RC 8-element chunks over THREADS threads: a thread
// owns CPT consecutive chunks of row tid / TPR, from chunk (tid % TPR) *
// CPT, covered by W = CPT + 1 aligned 16-byte windows.
template <int ROWS, int RC, int THREADS>
struct Skew {
  static constexpr int CPT = ROWS * RC / THREADS;
  static constexpr int TPR = RC / CPT;
  static constexpr int W = CPT + 1;
  static_assert(CPT >= 1 && RC % CPT == 0 && ROWS * TPR == THREADS,
                "skew chunks");
};

// One tile row of a staged operand: `base` the aligned 16 bytes that hold
// its first element, `shift` the elements before that one there (0-7),
// `valid` how many of its elements lie in the operand (0 for a row outside
// it).  Window j (base + j) holds elements [8 j - shift, 8 j - shift + 8)
// of the row.
struct Windows {
  const uint4* base;
  int shift, valid;
  // whether window j holds an element of the row: only those are read
  __device__ __forceinline__ bool holds(int j) const {
    return valid > 0 && 8 * j < shift + valid;
  }
};

// the tile row of elements [col, col + n) of row `row` of a row-major
// operand at p with `ld` elements a row; columns from `limit` on, and the
// whole row when !row_ok, are outside
__device__ __forceinline__ Windows windows_of(const bf16* p, int row, int ld,
                                              int col, int limit, bool row_ok,
                                              int n) {
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(p) + 2 * ((size_t)row * ld + col);
  Windows w;
  w.base = reinterpret_cast<const uint4*>(at & ~(uintptr_t)15);
  w.shift = (int)(at & 15) >> 1;
  w.valid = row_ok ? max(0, min(n, limit - col)) : 0;
  return w;
}

// the 8 elements from element `shift` of window lo on (the rest from hi);
// unless `full`, those from `valid` on zeroed (a thread whose chunks all
// lie in the operand skips the masks)
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi,
                                         int shift, int valid, bool full) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = shift >> 1;            // whole words, by two selects
  uint32_t t[6], v[5], o[4];
#pragma unroll
  for (int i = 0; i < 6; ++i) t[i] = (q & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = (q & 1) ? t[i + 1] : t[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)          // then half a word
    o[i] = __funnelshift_r(v[i], v[i + 1], (shift & 1) * 16);
  if (!full) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = valid >= 2 * i + 2 ? o[i]
             : valid == 2 * i + 1 ? (o[i] & 0xffffu) : 0u;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// registers: the thread's W windows (zeros where a window holds none of
// the row's elements) ...
template <class S>
__device__ __forceinline__ void skew_load(uint4 (&win)[S::W], int c0,
                                          const Windows& w) {
#pragma unroll
  for (int j = 0; j < S::W; ++j)
    win[j] = w.holds(c0 + j) ? __ldg(w.base + c0 + j)
                             : make_uint4(0u, 0u, 0u, 0u);
}

// ... shifted into the thread's chunks of the tile row
template <class S>
__device__ __forceinline__ void skew_store(bf16* row, int c0,
                                           const Windows& w,
                                           const uint4 (&win)[S::W]) {
  uint4* dst = reinterpret_cast<uint4*>(row) + c0;
  const bool full = w.valid >= 8 * (c0 + S::CPT);
#pragma unroll
  for (int i = 0; i < S::CPT; ++i)
    dst[i] = realign(win[i], win[i + 1], w.shift, w.valid - 8 * (c0 + i),
                     full);
}

// grid (N tiles, M tiles, splits); each split owns K rows [z * rows,
// min(K, (z + 1) * rows)), rows a multiple of BK when splits > 1.  A_VEC /
// B_VEC: that operand's rows are 16-byte aligned (cp.async); otherwise it
// is staged through its windows in registers
template <int BM, bool A_VEC, bool B_VEC>
__global__ void __launch_bounds__(MmaCfg<BM>::THREADS)
mm_mma(const bf16* __restrict__ A, const bf16* __restrict__ B,
       bf16* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
       int rows) {
  using Cfg = MmaCfg<BM>;
  using SA = Skew<BM, Cfg::ACH, Cfg::THREADS>;
  using SB = Skew<Cfg::BK, Cfg::BCH, Cfg::THREADS>;
  constexpr int BK = Cfg::BK, AS = Cfg::AS, BS = Cfg::BS;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BM][AS]
  bf16* Bs = As + STAGES * Cfg::A_TILE;           // [STAGES][BK][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * MMA_BN;
  const int k_begin = blockIdx.z * rows;
  const int k_end = min(K, k_begin + rows);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  // a staged operand: the thread's tile row and first chunk
  const int sa_r = tid / SA::TPR, sa_c = (tid % SA::TPR) * SA::CPT;
  const int sb_r = tid / SB::TPR, sb_c = (tid % SB::TPR) * SB::CPT;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // the staged operands' tile rows at K step `step`
  auto a_rows = [&](int step) {
    return windows_of(A, m0 + sa_r, K, k_begin + step * BK, k_end,
                      m0 + sa_r < M, BK);
  };
  auto b_rows = [&](int step) {
    const int k = k_begin + step * BK + sb_r;
    return windows_of(B, k, N, n0, N, k < k_end, MMA_BN);
  };
  uint4 a_reg[A_VEC ? 1 : SA::W], b_reg[B_VEC ? 1 : SB::W];
  // K step `step` into stage `st`: the aligned operands by cp.async, the
  // staged ones' windows into a_reg / b_reg (put() stores them)
  auto issue = [&](int step, int st) {
    const int k0 = k_begin + step * BK;
    bf16* as = As + st * Cfg::A_TILE;
    bf16* bs = Bs + st * Cfg::B_TILE;
    if constexpr (A_VEC)
      mma_stage_a<BM>(A, as, M, K, m0, k0, k_end, tid);
    else
      skew_load<SA>(a_reg, sa_c, a_rows(step));
    if constexpr (B_VEC)
      mma_stage_b<BM>(B, bs, N, n0, k0, k_end, tid);
    else
      skew_load<SB>(b_reg, sb_c, b_rows(step));
  };
  auto put = [&](int step, int st) {
    if constexpr (!A_VEC)
      skew_store<SA>(As + st * Cfg::A_TILE + sa_r * AS, sa_c, a_rows(step),
                     a_reg);
    if constexpr (!B_VEC)
      skew_store<SB>(Bs + st * Cfg::B_TILE + sb_r * BS, sb_c, b_rows(step),
                     b_reg);
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) {   // K step t into stage t
      issue(t, t);
      put(t, t);
    }
    cp_async_commit();              // empty groups keep the count aligned
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();    // this thread's chunks of step t
    __syncthreads();                // everyone's; step t - 1 is consumed
    const int tn = t + STAGES - 1;  // into the stage step t - 1 used
    if (tn < steps) issue(tn, tn % STAGES);
    cp_async_commit();
    const bf16* as = As + (t % STAGES) * Cfg::A_TILE + wm * MT * 16 * AS;
    const bf16* bs = Bs + (t % STAGES) * Cfg::B_TILE + wn * NT * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)   // rows i*16 + lane%16, k lo | hi
        ldsm_x4(af[i], as + (i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)   // k lo | hi of columns 16j..+7, +8..+15
        ldsm_x4_trans(bfr[j],
                      bs + (kk + (lane & 15)) * BS + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j / 2][2 * (j & 1)],
                   bfr[j / 2][2 * (j & 1) + 1]);
    }
    if constexpr (!A_VEC || !B_VEC) {  // the stage step t - 1 used: consumed
      if (tn < steps) put(tn, tn % STAGES);
    }
  }
  cp_async_wait<0>();

  // thread holds rows g, g + 8 and columns 2 t4, 2 t4 + 1 of each 16 x 8 tile
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + (wn * NT + j) * 8 + 2 * t4;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + i) * 16 + g + 8 * h;
        if (row >= M) continue;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if constexpr (B_VEC) {       // N % 8 == 0: every pair aligned
          if (gridDim.z == 1)
            *reinterpret_cast<uint32_t*>(C + (size_t)row * N + col) =
                pack_bf16(x, y);
          else
            *reinterpret_cast<float2*>(
                ws + ((size_t)blockIdx.z * M + row) * N + col) =
                make_float2(x, y);
        } else {                     // a pair only at an even element
          const size_t at = ((size_t)blockIdx.z * M + row) * N + col;
          const bool two = col + 1 < N, pair = two && at % 2 == 0;
          if (gridDim.z == 1) {
            bf16* c = C + (size_t)row * N + col;
            if (pair) {
              *reinterpret_cast<uint32_t*>(c) = pack_bf16(x, y);
            } else {
              c[0] = __float2bfloat16(x);
              if (two) c[1] = __float2bfloat16(y);
            }
          } else if (pair) {
            *reinterpret_cast<float2*>(ws + at) = make_float2(x, y);
          } else {
            ws[at] = x;
            if (two) ws[at + 1] = y;
          }
        }
      }
    }
  }
}

int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

template <typename T, int MT>
void launch_skinny(const T* A, const T* B, T* C, float* ws, int M, int N,
                   int K, int splits, int rows, cudaStream_t s) {
  dim3 grid(ceil_div(N, SK_STRIPE), 1, splits);
  const bool vec = N % SK_COLS == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if (vec)
    mm_skinny<T, MT, true><<<grid, SK_WARPS * 32, 0, s>>>(A, B, C, ws, M, N, K, rows);
  else
    mm_skinny<T, MT, false><<<grid, SK_WARPS * 32, 0, s>>>(A, B, C, ws, M, N, K, rows);
}

template <int BM, bool A_VEC, bool B_VEC>
cudaError_t launch_mma(const bf16* A, const bf16* B, bf16* C, float* ws, int M,
                       int N, int K, int splits, int rows, cudaStream_t s) {
  using Cfg = MmaCfg<BM>;
  if (splits > 1 && rows % Cfg::BK != 0) return cudaErrorInvalidValue;
  static bool smem_set = false;   // above 48 KB needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_mma<BM, A_VEC, B_VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(ceil_div(N, MMA_BN), ceil_div(M, BM), splits);
  mm_mma<BM, A_VEC, B_VEC><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(
      A, B, C, ws, M, N, K, rows);
  return cudaSuccess;
}

// the instance for the operands' alignment
template <int BM>
cudaError_t launch_mma(bool a_vec, bool b_vec, const bf16* A, const bf16* B,
                       bf16* C, float* ws, int M, int N, int K, int splits,
                       int rows, cudaStream_t s) {
  if (a_vec && b_vec)
    return launch_mma<BM, true, true>(A, B, C, ws, M, N, K, splits, rows, s);
  if (a_vec)
    return launch_mma<BM, true, false>(A, B, C, ws, M, N, K, splits, rows, s);
  if (b_vec)
    return launch_mma<BM, false, true>(A, B, C, ws, M, N, K, splits, rows, s);
  return launch_mma<BM, false, false>(A, B, C, ws, M, N, K, splits, rows, s);
}

enum { ROUTE_MMA = 0, ROUTE_SKINNY = 1, ROUTE_TILED = 2 };

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, float* ws, int M,
                   int N, int K, int route, int bm, int splits, int rows,
                   cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  if (route == ROUTE_MMA) {
    if constexpr (std::is_same<T, bf16>::value) {
      const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                      pb = reinterpret_cast<uintptr_t>(b),
                      pc = reinterpret_cast<uintptr_t>(c);
      if (pa % 2 || pb % 2 || pc % 4) return cudaErrorInvalidValue;
      const bool a_vec = K % 8 == 0 && pa % 16 == 0,
                 b_vec = N % 8 == 0 && pb % 16 == 0;
      cudaError_t e;
      if (bm == 16 && M <= 16)
        e = launch_mma<16>(a_vec, b_vec, A, B, C, ws, M, N, K, splits, rows,
                           s);
      else if (bm == 64 && M <= 64)
        e = launch_mma<64>(a_vec, b_vec, A, B, C, ws, M, N, K, splits, rows,
                           s);
      else if (bm == 128)
        e = launch_mma<128>(a_vec, b_vec, A, B, C, ws, M, N, K, splits, rows,
                            s);
      else
        return cudaErrorInvalidValue;
      if (e != cudaSuccess) return e;
    } else {
      return cudaErrorInvalidValue;   // f32 stays off the tensor cores
    }
  } else if constexpr (!std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;     // the CUDA-core routes take f32 only
  } else if (route == ROUTE_SKINNY) {
    if (M <= 1)
      launch_skinny<T, 1>(A, B, C, ws, M, N, K, splits, rows, s);
    else if (M <= 2)
      launch_skinny<T, 2>(A, B, C, ws, M, N, K, splits, rows, s);
    else if (M <= 4)
      launch_skinny<T, 4>(A, B, C, ws, M, N, K, splits, rows, s);
    else if (M <= 8)
      launch_skinny<T, 8>(A, B, C, ws, M, N, K, splits, rows, s);
    else if (M <= SK_MAXM)
      launch_skinny<T, SK_MAXM>(A, B, C, ws, M, N, K, splits, rows, s);
    else
      return cudaErrorInvalidValue;
  } else if (route == ROUTE_TILED) {
    dim3 grid(ceil_div(N, TN), ceil_div(M, TM), splits);
    mm_tiled<T><<<grid, T_THREADS, 0, s>>>(A, B, C, ws, M, N, K, rows);
  } else {
    return cudaErrorInvalidValue;
  }
  if (splits > 1) launch_split_reduce<T>(ws, C, splits, (size_t)M * N, s);
  return cudaSuccess;
}

}  // namespace

// C = A @ B on `stream` by the wrapper's plan (kernels/matmul/plan.py):
// route 0 mma (bf16 only, any N, K and 2-byte aligned address; bm 16 / 64
// / 128), 1 skinny (f32, M <= 16), 2 tiled (f32); K split into `splits` ranges of
// `rows` rows (the last may be shorter, none empty); ws: (splits, M, N)
// f32 scratch, unused when splits == 1; dtype DT_F32 or DT_BF16 for all
// three matrices.  A plan the kernels cannot take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int mm_run(const void* a, const void* b, void* c, void* ws, int M,
                      int N, int K, int route, int bm, int splits, int rows,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || rows < 1 ||
      (long)rows * splits < K || (long)rows * (splits - 1) >= K ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch<float>(a, b, c, w, M, N, K, route, bm, splits, rows, s);
  else if (dtype == DT_BF16)
    e = launch<bf16>(a, b, c, w, M, N, K, route, bm, splits, rows, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

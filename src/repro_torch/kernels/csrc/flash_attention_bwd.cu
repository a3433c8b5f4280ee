// Flash attention's backward: dQ, dK and dV of the prefill kernel
// (flash_attention.cu) from q, k, v, dO and each row's log-sum-exp LSE,
// which the forward writes when it is given a pointer.
// Causal or bidirectional, the one-sided window, GQA, any Sq and Skv;
// q / dO / dQ (B, Sq, Hq, D), k / v / dK / dV (B, Skv, Hkv, D), bf16 or
// f32; every sum in f32, the outputs rounded to the input dtype.
//
// Replaces: the reverse pass that the reference's training step takes by
// differentiating its XLA chunked attention (src/repro/models/layers.py::
// flash_attention, under jax.checkpoint); the Pallas kernel
// (src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas) has no backward.
//
// The math is FA2's: with S = scale Q K^T and P = exp(S - LSE) rebuilt tile
// by tile (masked entries exactly 0: keys past Skv, past the query when
// causal, window or more behind it),
//   dP = dO V^T,  Delta = rowsum(P o dP)         fa_bwd_delta*
//   dS = P o (dP - Delta)
//   dV = P^T dO,  dK = scale dS^T Q              fa_bwd_dkdv*
//   dQ = scale dS K                              fa_bwd_dq*
// Delta is the softmax backward's sum over the row's weights, taken over P
// and dP themselves where FA2 takes rowsum(dO o O) from the stored bf16
// output: that O carries the forward's bf16 rounding (2^-9 of each
// element), which lands coherently on every dS of its row, and at
// qwen2-7b's training shape dQ missed the plain version by 2.6x the bf16
// bound (3e-2 of its RMS) that way.  The exact sum costs one more pass of
// S and dP over the visible tiles.
// Each output element is written by one CTA and summed in a fixed order: no
// atomics, so two runs give the same bits.
//
// What bounds it on an H100: operations.  At qwen2-7b's training shape (q
// (1, 4096, 28, 128), k / v (1, 4096, 4, 128), causal) the backward is 2.5x
// the forward's 120 GFLOP (FA2's 5 products a visible (query, key) pair),
// 0.304 ms at the tensor cores' 989 TFLOP/s; the bytes (q, k, v, dO, LSE
// in; dQ, dK, dV out) are 0.1 ms.  This layout does 12 products a pair
// (Delta: S, dP; dK / dV: S, dP, dV twice, dK twice; dQ: S, dP, dQ twice),
// 722 GFLOP, so its own floor is 0.73 ms.
//
// What the design does (bf16: fa_bwd_delta_wgmma, fa_bwd_dkdv_wgmma and
// fa_bwd_dq_wgmma, each <DC>, DC = ceil(D / 64)): FA2's structure on
// Hopper's warpgroup product wgmma.mma_async (bf16 in, f32 accumulate),
// the instruction that reaches the tensor cores' rate (the mma.sync
// m16n8k16 layout before it reached 201 TFLOP/s of its 12 products).  A
// CTA is two consumer warpgroups of 64 rows and one producer warp that
// keeps TMA loads (cp.async.bulk.tensor.4d over the (D, H, S, B) view of
// each operand, 128-byte swizzle) in flight through an mbarrier ring: a
// tile is DC boxes of 64 rows x 64 columns, 8 KB each, and TMA fills
// columns past D and rows past S with zeros.  The softmax is in exp2
// form, P = exp2(S scale log2(e) - LSE log2(e)); masked entries are
// exactly 0.  S and dP take both operands from shared memory, K-major
// (m64n64k16); P and dS stay in registers, where the accumulator's
// fragment layout is the A operand's, and go to their products as two
// bf16 parts each, hi = x rounded and lo = the rest rounded (split_bf16),
// both into one f32 sum: P or dS rounded once to bf16, as FA2 does, puts
// an early key's dV / dK 1.13 / 1.03x outside the bf16 bound (3e-2 of the
// output's RMS) at 4096 causal rows (tests/test_torch_train_kernels.py
// emulates both): its first rows' weights are O(1), each off by up to
// 2^-9, against an RMS set by the many small ones.  The second part costs
// 3 of the 12 products.  Those products read B (dO and Q for dV and dK, K
// for dQ) MN-major from the same tiles (the transpose bit): no copy.
// Registers bound the layout: 9 warps get at most 168 a thread, and
// ptxas kept to 168 under setmaxnreg too (it spilled), so no warpgroup
// holds more than one 64 x D accumulator beside a 64 x 64 tile at D = 128.
// - fa_bwd_dkdv_wgmma: a CTA owns 64 keys of one kv head, K and V resident,
//   and the producer streams the (query head, 64-row query tile) pairs of
//   the group that can see them, with their rows' LSE and Delta (its lanes
//   load those: their (B, Sq, Hq) rows are no TMA box).  D > 64: warpgroup
//   0 computes S^T = K Q^T and P^T and sums dV += P^T dO; warpgroup 1
//   computes dP^T = V dO^T, takes P^T through shared memory (two tiles,
//   named barriers: ready, and read) for dS^T = P^T o (dP^T - Delta), and
//   sums dK += dS^T Q.  D <= 64: pair i goes to warpgroup i % 2, which
//   sums both, and warpgroup 1's f32 sums are added to 0's at the end
//   through the freed ring (1.4x faster there than the product split,
//   which leaves warpgroup 1 waiting on 0's exponentials, and ptxas's 168
//   registers hold both sums only at D <= 64).  Every sum runs in a fixed
//   order.
// - fa_bwd_delta_wgmma and fa_bwd_dq_wgmma (rows_walk): a CTA owns 128
//   query rows of one head, Q and dO resident, 64 rows a warpgroup, and
//   streams the K / V tiles of 64 keys they can see: S = Q K^T, dP = dO
//   V^T; dQ: dS in registers and dQ += dS K; Delta: each thread sums P o
//   dP over its columns in key order, then the quad by shuffles.  A
//   warpgroup skips a tile none of its rows sees (the causal diagonal's
//   last).  At D <= 64 two Delta CTAs share an SM.
// The balance (causal): a key tile's walk shrinks from the longest (tile 0,
// every query tile of the G heads) to the shortest; the grid is one
// dimension in that order and one CTA fills an SM (~201 KB of shared
// memory at D = 128), so each SM that frees takes the longest walk left.
// With 64 keys a CTA, qwen2-7b's 256 dK / dV CTAs (1.94 waves of 132 SMs)
// end within 2 % of an even split, where 128 keys a CTA (a warpgroup each)
// would leave the longest walk at 2x the mean
// (tests/test_torch_fa_bwd_wgmma.py models both).  The Delta and dQ grids
// (128-row tiles, 896 CTAs at qwen2-7b) run the longest walks first too.
// Tensor maps are encoded on the host at each launch and passed as
// __grid_constant__ parameters (legal under stream capture); a barrier
// wait past ~17 s traps, never hangs.
// Measured (NVIDIA H100 80GB HBM3, 700 W; profiling/flash_attention_bwd_ab
// against the mma.sync layout in one process): at qwen2-7b's training
// shape 2.33 ms for the three kernels against 3.55 (Delta 0.49, dK / dV
// 1.19, dQ 0.64; ~310 TFLOP/s of the 12 products), its outputs bit for bit
// the mma.sync layout's; whisper's encoder 0.55-0.57 ms, as before.
// f32 (fa_bwd_delta / fa_bwd_dkdv / fa_bwd_dq, only reached by the
// card-versus-CPU checks and the f32 tile edges) stays on the CUDA cores,
// as the forward's f32 fa_kernel does: TF32 would break the reference's
// 2e-4 f32 tolerance.  A CTA of 256 threads holds two 64-row tiles of each
// side in shared memory as f32, each thread a 4 x 4 block of S and dP, P
// and dS through shared memory.
#include <climits>
#include <initializer_list>

#include "attention_tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int BT = 64;            // rows of a query tile and keys of a kv tile
constexpr int THREADS = 256;
constexpr int RPT = BT / 16;      // rows (keys) of S a thread owns
constexpr int PS = BT + 1;        // P / dS row stride

template <int E>
struct BwdSmem {                  // E: the D columns a thread owns (D <= 16 E)
  static constexpr int DW = 16 * E;       // D padded with zeros
  static constexpr int DP = DW + 1;       // odd row stride
  static constexpr size_t BYTES =
      sizeof(float) * (4 * (size_t)BT * DP + 2 * (size_t)BT * PS + 2 * BT);
};

// rows [r0, r0 + BT) of head h of a (B, S, H, D) tensor -> dst [BT][DP] f32;
// rows past S and columns past D are zeros
template <int E>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int b, int S, int H, int h, int r0,
                                      int D) {
  constexpr int DW = BwdSmem<E>::DW, DP = BwdSmem<E>::DP;
  for (int i = threadIdx.x; i < BT * DW; i += THREADS) {
    const int r = i / DW, d = i % DW, rr = r0 + r;
    float x = 0.f;
    if (rr < S && d < D) x = src[(((size_t)b * S + rr) * H + h) * D + d];
    dst[r * DP + d] = x;
  }
}

// one (query tile, kv tile) pair: S = Q K^T and dP = dO V^T over D, then
// P = exp(scale S - LSE) and dS = P (dP - Delta) into ps / dss [BT][PS]
template <int E>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* ls, const float* dls,
                                         float* ps, float* dss, int q0, int k0,
                                         int Sq, int Skv, int D, int window,
                                         int causal, float scale) {
  constexpr int DP = BwdSmem<E>::DP;
  const int tr = threadIdx.x >> 4, tk = threadIdx.x & 15;
  float s[RPT][RPT], dp[RPT][RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[RPT], dov[RPT], kv[RPT], vv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = qs[(tr + 16 * i) * DP + d];
      dov[i] = dos[(tr + 16 * i) * DP + d];
      kv[i] = ks[(tk + 16 * i) * DP + d];
      vv[i] = vs[(tk + 16 * i) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += dov[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int c = tk + 16 * j, kj = k0 + c;
      const bool ok = qi < Sq && kj < Skv && (!causal || qi >= kj) &&
                      (window <= 0 || qi - kj < window);
      const float p = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
      ps[r * PS + c] = p;
      dss[r * PS + c] = p * (dp[i][j] - dls[r]);
    }
  }
}

// LSE and Delta of rows [q0, q0 + BT) of query head hq -> ls, dls [BT]
__device__ __forceinline__ void stage_rows(float* ls, float* dls,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int Sq, int Hq, int hq,
                                           int q0) {
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const int qi = q0 + i;
    const size_t row = ((size_t)b * Sq + qi) * Hq + hq;
    ls[i] = qi < Sq ? lse[row] : 0.f;
    dls[i] = qi < Sq ? delta[row] : 0.f;
  }
}

// grid (query tiles, Hq, B): Delta = rowsum(P o dP) over the visible keys
template <int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_delta(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             int Sq, int Skv, int Hq, int Hkv, int D, int window, int causal,
             float scale) {
  constexpr int DP = BwdSmem<E>::DP;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP]
  float* dos = qs + BT * DP;
  float* ks = dos + BT * DP;
  float* vs = ks + BT * DP;
  float* ps = vs + BT * DP;        // [BT query rows][PS]
  float* pdp = ps + BT * PS;       // P o dP
  float* ls = pdp + BT * PS;       // [BT]
  float* zeros = ls + BT;          // a Delta of 0: p_and_ds then gives P o dP

  const int G = Hq / Hkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int hq = blockIdx.y, b = blockIdx.z, h = hq / G;
  const int q_last = min(q0 + BT, Sq) - 1;
  stage<E>(qs, q, b, Sq, Hq, hq, q0, D);
  stage<E>(dos, dout, b, Sq, Hq, hq, q0, D);
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const int qi = q0 + i;
    ls[i] = qi < Sq ? lse[((size_t)b * Sq + qi) * Hq + hq] : 0.f;
    zeros[i] = 0.f;
  }
  float row_sum = 0.f;             // thread t < BT: row t's sum, in key order
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  for (int k0 = k_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();   // the previous tile is consumed (and Q / dO staged)
    stage<E>(ks, k, b, Skv, Hkv, h, k0, D);
    stage<E>(vs, v, b, Skv, Hkv, h, k0, D);
    __syncthreads();
    p_and_ds<E>(qs, dos, ks, vs, ls, zeros, ps, pdp, q0, k0, Sq, Skv, D,
                window, causal, scale);
    __syncthreads();
    if (threadIdx.x < BT) {
      const int kn = min(BT, Skv - k0);
      for (int c = 0; c < kn; ++c) row_sum += pdp[threadIdx.x * PS + c];
    }
  }
  const int qi = q0 + threadIdx.x;
  if (threadIdx.x < BT && qi < Sq)
    delta[((size_t)b * Sq + qi) * Hq + hq] = row_sum;
}

// grid (kv tiles, Hkv, B)
template <int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
            int Hq, int Hkv, int D, int window, int causal, float scale) {
  constexpr int DP = BwdSmem<E>::DP;
  extern __shared__ float smem[];
  float* ks = smem;                // [BT][DP]
  float* vs = ks + BT * DP;
  float* qs = vs + BT * DP;
  float* dos = qs + BT * DP;
  float* ps = dos + BT * DP;       // [BT query rows][PS]
  float* dss = ps + BT * PS;
  float* ls = dss + BT * PS;       // [BT]
  float* dls = ls + BT;

  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int k_last = min(k0 + BT, Skv) - 1;
  const int tk = threadIdx.x & 15, tc = threadIdx.x >> 4;
  stage<E>(ks, k, b, Skv, Hkv, h, k0, D);
  stage<E>(vs, v, b, Skv, Hkv, h, k0, D);

  float acc_k[RPT][E], acc_v[RPT][E];   // keys tk + 16j, columns tc + 16e
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // the query rows that can see a key of this tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int hq = h * G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += BT) {
      __syncthreads();   // the previous pair is consumed (and K / V staged)
      stage<E>(qs, q, b, Sq, Hq, hq, q0, D);
      stage<E>(dos, dout, b, Sq, Hq, hq, q0, D);
      stage_rows(ls, dls, lse, delta, b, Sq, Hq, hq, q0);
      __syncthreads();
      p_and_ds<E>(qs, dos, ks, vs, ls, dls, ps, dss, q0, k0, Sq, Skv, D,
                  window, causal, scale);
      __syncthreads();
      const int qn = min(BT, Sq - q0);
      for (int r = 0; r < qn; ++r) {
        float pv[RPT], dsv[RPT], dov[E], qv[E];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          pv[j] = ps[r * PS + tk + 16 * j];
          dsv[j] = dss[r * PS + tk + 16 * j];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dov[e] = dos[r * DP + tc + 16 * e];
          qv[e] = qs[r * DP + tc + 16 * e];
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[j][e] += pv[j] * dov[e];
            acc_k[j][e] += dsv[j] * qv[e];
          }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int kj = k0 + tk + 16 * j;
    if (kj >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kj) * Hkv + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = tc + 16 * e;
      if (d < D) {
        dk[base + d] = acc_k[j][e] * scale;
        dv[base + d] = acc_v[j][e];
      }
    }
  }
}

// grid (query tiles, Hq, B)
template <int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
          int window, int causal, float scale) {
  constexpr int DP = BwdSmem<E>::DP;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP]
  float* dos = qs + BT * DP;
  float* ks = dos + BT * DP;
  float* vs = ks + BT * DP;
  float* ps = vs + BT * DP;        // [BT query rows][PS]
  float* dss = ps + BT * PS;
  float* ls = dss + BT * PS;       // [BT]
  float* dls = ls + BT;

  const int G = Hq / Hkv;
  // the longest causal walks first (without causal all walks are equal)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int hq = blockIdx.y, b = blockIdx.z, h = hq / G;
  const int q_last = min(q0 + BT, Sq) - 1;
  const int tr = threadIdx.x & 15, tc = threadIdx.x >> 4;
  stage<E>(qs, q, b, Sq, Hq, hq, q0, D);
  stage<E>(dos, dout, b, Sq, Hq, hq, q0, D);
  stage_rows(ls, dls, lse, delta, b, Sq, Hq, hq, q0);

  float acc[RPT][E];               // rows tr + 16i, columns tc + 16e
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  // the keys that a row of this tile can see
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  for (int k0 = k_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();   // the previous pair is consumed (and Q / dO staged)
    stage<E>(ks, k, b, Skv, Hkv, h, k0, D);
    stage<E>(vs, v, b, Skv, Hkv, h, k0, D);
    __syncthreads();
    p_and_ds<E>(qs, dos, ks, vs, ls, dls, ps, dss, q0, k0, Sq, Skv, D, window,
                causal, scale);
    __syncthreads();
    const int kn = min(BT, Skv - k0);
    for (int c = 0; c < kn; ++c) {
      float dsv[RPT], kv[E];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dss[(tr + 16 * i) * PS + c];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = ks[c * DP + tc + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += dsv[i] * kv[e];
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const size_t base = (((size_t)b * Sq + qi) * Hq + hq) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = tc + 16 * e;
      if (d < D) dq[base + d] = acc[i][e] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warpgroup tensor-core kernels (wgmma.mma_async fed by TMA)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int FB_STATS = 1024;       // a stage's LSE and Delta (2 x 64 f32),
                                     // padded to keep the tiles 1024-aligned

// x0, x1 ~ hi + lo, each a bf16 pair (nearest even): lo carries the
// rounding error of hi, so hi + lo is x within 2^-16 of its value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// a 64 x 64 f32 accumulator (the warpgroup's fragments, 32 a thread) as the
// A operands of four 16-deep K slices, hi and lo: slice kk's registers are
// hi[4 kk .. 4 kk + 3] (rows g, g + 8 x columns 16 kk + 2 t4 .. and + 8)
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split_bf16(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// d (64 x 64 DC) += A B twice over a 64-deep K (four 16-deep slices), A
// the hi then the lo fragments, B 64 K lines of DC boxes (MN-major: the
// transpose bit; a slice is 16 lines, 2048 bytes, on)
template <int DC>
__device__ __forceinline__ void acc_hi_lo(float (&d)[32 * DC],
                                          const uint32_t (&hi)[16],
                                          const uint32_t (&lo)[16],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 2048, BOX);
    if constexpr (DC == 2) {
      wgmma_rs_n128<1>(d, hi + 4 * kk, db);
      wgmma_rs_n128<1>(d, lo + 4 * kk, db);
    } else {
      wgmma_rs_n64<1>(d, hi + 4 * kk, db);
      wgmma_rs_n64<1>(d, lo + 4 * kk, db);
    }
  }
}

// s = A1 B1^T and t = A2 B2^T, 64 x 64 each over 64 DC columns: A1 / A2 the
// warpgroup's 64 rows, B1 / B2 64 rows, each DC boxes (K-major)
template <int DC>
__device__ __forceinline__ void two_abt(float (&s)[32], float (&t)[32],
                                        uint32_t a1, uint32_t b1, uint32_t a2,
                                        uint32_t b2) {
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = c * BOX + kk * 32;
      const int acc = c > 0 || kk > 0;
      wgmma_n64<0, 0>(s, smem_desc(a1 + off, 16), smem_desc(b1 + off, 16),
                      acc);
      wgmma_n64<0, 0>(t, smem_desc(a2 + off, 16), smem_desc(b2 + off, 16),
                      acc);
    }
}

// rows g and g + 8 (ra, rb; < 0: not stored) of a warpgroup's 64 x 64 DC
// accumulator, times mul, rounded to bf16 into a (.., D) tensor
template <int DC>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[32 * DC],
                                           long long ra, long long rb, int D,
                                           float mul, int t4) {
#pragma unroll
  for (int n = 0; n < 8 * DC; ++n) {
    const int col = n * 8 + 2 * t4;
    if (n * 8 >= D) break;
    if (ra >= 0)
      *reinterpret_cast<uint32_t*>(out + ra * D + col) =
          pack_bf16(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (rb >= 0)
      *reinterpret_cast<uint32_t*>(out + rb * D + col) =
          pack_bf16(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// The Delta and dQ kernels: a CTA owns 128 query rows of one head (its two
// consumer warpgroups 64 each) with Q and dO resident, and streams the K /
// V tiles of 64 keys that the rows can see through a ring of STAGES.
template <int DC>
struct RowCfg {
  static constexpr int Q_BYTES = 2 * DC * BOX;   // 128 rows of Q (or dO)
  static constexpr int KV_BYTES = DC * BOX;      // 64 keys of K (or V)
  static constexpr int STAGES = DC == 1 ? 4 : 3;
  static constexpr int STAGE = 2 * KV_BYTES;     // K, then V
  static constexpr size_t SMEM = 1024 + 2 * (size_t)Q_BYTES +
                                 (size_t)STAGES * STAGE +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
};

// The Delta and dQ kernels' walk: grid (128-row query tiles x Hq x B), one
// dimension, the longest causal walks first.  DQ: dQ = scale dS K; else
// Delta = rowsum(P o dP).  tq .. tdo: the kernel's __grid_constant__ maps.
template <int DC, bool DQ>
__device__ __forceinline__ void rows_walk(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int window, int causal, float scale_log2,
    float scale) {
  using Cfg = RowCfg<DC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, dos = base + Cfg::Q_BYTES;
  const uint32_t ring = base + 2 * Cfg::Q_BYTES;
  const uint32_t bars = ring + Cfg::STAGES * Cfg::STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (Cfg::STAGES + s); };
  const uint32_t qbar = bars + 16u * Cfg::STAGES;
  auto ks = [&](int s) { return ring + (uint32_t)(s * Cfg::STAGE); };
  auto vs = [&](int s) { return ks(s) + Cfg::KV_BYTES; };

  const int per = Hq * B, n_qt = (Sq + 127) / 128;
  const int qt = n_qt - 1 - (int)blockIdx.x / per;
  const int hq = blockIdx.x % Hq, b = blockIdx.x / Hq % B;
  const int h = hq / (Hq / Hkv), q0 = qt * 128;
  // the keys that a row of this tile can see
  const int q_last = min(q0 + 128, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(full(s), 1);    // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 2);   // one arrival per consumer warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // -- the producer: one thread keeps the ring's loads in flight ----------
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(qbar, 2 * Cfg::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < DC; ++c) {
          const uint32_t at = (w * DC + c) * BOX;
          tma_load_4d(qs + at, tq, qbar, 64 * c, hq, q0 + 64 * w, b);
          tma_load_4d(dos + at, tdo, qbar, 64 * c, hq, q0 + 64 * w, b);
        }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % Cfg::STAGES, k0 = k_lo + t * 64;
        mbar_wait(empty(s), ((t / Cfg::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), Cfg::STAGE);
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(ks(s) + c * BOX, tk, full(s), 64 * c, h, k0, b);
          tma_load_4d(vs(s) + c * BOX, tv, full(s), 64 * c, h, k0, b);
        }
      }
    }
    return;
  }
  // -- two consumers: rows [q0 + 64 wg, q0 + 64 wg + 64) ---------------------
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * wg;
  const int qa = r0 + 16 * warp + g, qb = qa + 8;   // the thread's two rows
  const size_t ra = ((size_t)b * Sq + qa) * Hq + hq;
  const size_t rb = ((size_t)b * Sq + qb) * Hq + hq;
  const float la = qa < Sq ? lse[ra] * LOG2E : 0.f;
  const float lb = qb < Sq ? lse[rb] * LOG2E : 0.f;
  // DQ: the rows' Delta; else their running sums of P o dP
  float da = 0.f, db = 0.f;
  if constexpr (DQ) {
    da = qa < Sq ? delta[ra] : 0.f;
    db = qb < Sq ? delta[rb] : 0.f;
  }
  float acc[DQ ? 32 * DC : 1];                      // dQ
#pragma unroll
  for (int i = 0; i < (DQ ? 32 * DC : 1); ++i) acc[i] = 0.f;
  const uint32_t qw = qs + wg * DC * BOX, dow = dos + wg * DC * BOX;

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % Cfg::STAGES, k0 = k_lo + t * 64;
    mbar_wait(full(s), (t / Cfg::STAGES) & 1);
    if (tile_any(r0, k0, Sq, Skv, window, causal)) {
      float sc[32], dp[32];
      wg_fence();
      two_abt<DC>(sc, dp, qw, ks(s), dow, vs(s));   // S = Q K^T, dP = dO V^T
      wg_commit();
      wg_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const bool all = tile_full(r0, k0, Sq, Skv, window, causal);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = c < 2 ? qa : qb, kj = k0 + 8 * j + 2 * t4 + (c & 1);
          const int i = 4 * j + c;
          const float p = all || visible(qi, kj, Sq, Skv, window, causal)
                              ? exp2f(fmaf(sc[i], scale_log2,
                                           -(c < 2 ? la : lb)))
                              : 0.f;
          if constexpr (DQ)
            sc[i] = p * (dp[i] - (c < 2 ? da : db));
          else if (c < 2)
            da += p * dp[i];
          else
            db += p * dp[i];
        }
      if constexpr (DQ) {      // dQ += dS K, K read MN-major
        uint32_t hi[16], lo[16];
        split_frags(sc, hi, lo);
        wg_fence();
        acc_hi_lo<DC>(acc, hi, lo, ks(s));
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
      }
    }
    if (threadIdx.x % WG == 0) mbar_arrive(empty(s));   // the stage is free
  }

  if constexpr (DQ) {
    store_rows<DC>(dq, acc, qa < Sq ? (long long)ra : -1,
                   qb < Sq ? (long long)rb : -1, D, scale, t4);
  } else {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad shares a row
      da += __shfl_xor_sync(FULL_MASK, da, off);
      db += __shfl_xor_sync(FULL_MASK, db, off);
    }
    if (t4 == 0) {
      if (qa < Sq) delta[ra] = da;
      if (qb < Sq) delta[rb] = db;
    }
  }
}

// D <= 64: two CTAs an SM (its registers fit 9 warps twice; one CTA
// measured 1.5x slower at whisper's encoder)
template <int DC>
__global__ void __launch_bounds__(FB_THREADS, DC == 1 ? 2 : 1)
fa_bwd_delta_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   int B, int Sq, int Skv, int Hq, int Hkv, int D,
                   int window, int causal, float scale_log2) {
  rows_walk<DC, false>(&tq, &tk, &tv, &tdo, lse, delta, nullptr, B, Sq, Skv,
                       Hq, Hkv, D, window, causal, scale_log2, 0.f);
}

template <int DC>
__global__ void __launch_bounds__(FB_THREADS, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int B, int Sq, int Skv, int Hq, int Hkv, int D, int window,
                int causal, float scale_log2, float scale) {
  rows_walk<DC, true>(&tq, &tk, &tv, &tdo, lse, const_cast<float*>(delta),
                      dq, B, Sq, Skv, Hq, Hkv, D, window, causal, scale_log2,
                      scale);
}

// bar.sync / bar.arrive on named barrier `id` (1-15; 0 is __syncthreads')
// among `count` threads, the id chosen at run time
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The dK / dV kernel: a CTA owns 64 keys of one kv head with K and V
// resident, and streams the (query head, 64-row query tile) pairs of the
// group that can see them, with their LSE and Delta, through a ring of
// STAGES.  D > 64 (SPLIT): warpgroup 0 computes S^T and P^T and sums dV,
// warpgroup 1 dP^T and dS^T (P^T handed over through shared memory) and
// sums dK.  D <= 64: pair i goes to warpgroup i % 2, which computes all of
// it into its own dK and dV, and the two sums are added at the end.
template <int DC>
struct KvCfg {
  // D > 64: the warpgroups split the products (dK and dV in one would not
  // fit its registers); D <= 64: they split the pairs
  static constexpr bool SPLIT = DC == 2;
  static constexpr int KV_BYTES = DC * BOX;          // 64 keys of K (or V)
  static constexpr int STAGES = 4;
  static constexpr int STAGE = 2 * DC * BOX + FB_STATS;   // Q, dO, stats
  static constexpr int P_BYTES = SPLIT ? 64 * 64 * 4 : 0;   // a P^T, f32
  static constexpr size_t SMEM = 1024 + 2 * (size_t)KV_BYTES +
                                 (size_t)STAGES * STAGE + 2 * P_BYTES +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
  // the pair split's f32 dK and dV of warpgroup 1, staged in the freed ring
  static_assert(SPLIT || 2 * 64 * 64 * DC * 4 <= STAGES * STAGE, "ring");
};

// grid: (64-key tiles x Hkv x B), one dimension, the longest causal walks
// (key tile 0) first
template <int DC>
__global__ void __launch_bounds__(FB_THREADS, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int B, int Sq, int Skv, int Hq,
                  int Hkv, int D, int window, int causal, float scale_log2,
                  float scale) {
  using Cfg = KvCfg<DC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kbase = base, vbase = base + Cfg::KV_BYTES;
  const uint32_t ring = base + 2 * Cfg::KV_BYTES;
  const uint32_t pbase = ring + Cfg::STAGES * Cfg::STAGE;   // two P^T tiles
  const uint32_t bars = pbase + 2 * Cfg::P_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (Cfg::STAGES + s); };
  const uint32_t kvbar = bars + 16u * Cfg::STAGES;
  auto qst = [&](int s) { return ring + (uint32_t)(s * Cfg::STAGE); };
  auto dost = [&](int s) { return qst(s) + DC * BOX; };
  auto stats = [&](int s) {    // LSE log2(e), then Delta, of the tile's rows
    return reinterpret_cast<float*>(gbase + (qst(s) - base) + 2 * DC * BOX);
  };

  const int per = Hkv * B;
  const int h = blockIdx.x % Hkv, b = blockIdx.x / Hkv % B;
  const int k0 = (int)(blockIdx.x / per) * 64;
  const int G = Hq / Hkv;
  // the query rows that can see a key of this tile, for each query head
  const int k_last = min(k0 + 64, Skv) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + 63) / 64 : 0;
  const int n_it = G * n_q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(full(s), 32);   // the producer warp's lanes (one expect_tx)
      mbar_init(empty(s), Cfg::SPLIT ? 2 : 1);   // the consuming warpgroups
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // -- the producer warp: TMA for the tiles, its lanes for the stats -------
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * Cfg::KV_BYTES);
      for (int c = 0; c < DC; ++c) {
        tma_load_4d(kbase + c * BOX, &tk, kvbar, 64 * c, h, k0, b);
        tma_load_4d(vbase + c * BOX, &tv, kvbar, 64 * c, h, k0, b);
      }
    }
    for (int i = 0; i < n_it; ++i) {
      const int s = i % Cfg::STAGES;
      const int hq = h * G + i / n_q, q0 = q_lo + (i % n_q) * 64;
      mbar_wait(empty(s), ((i / Cfg::STAGES) & 1) ^ 1);
      float* st = stats(s);
      for (int j = lane; j < 64; j += 32) {
        const int qi = q0 + j;
        const size_t row = ((size_t)b * Sq + qi) * Hq + hq;
        st[j] = qi < Sq ? lse[row] * LOG2E : 0.f;
        st[64 + j] = qi < Sq ? delta[row] : 0.f;
      }
      if (lane == 0) {       // after its own stats, as the others
        mbar_expect_tx(full(s), 2 * DC * BOX);
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(qst(s) + c * BOX, &tq, full(s), 64 * c, hq, q0, b);
          tma_load_4d(dost(s) + c * BOX, &tdo, full(s), 64 * c, hq, q0, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }
  // -- two consumers over the tile's 64 keys -------------------------------
  const int warp = (threadIdx.x % WG) / 32, g = lane / 4, t4 = lane % 4;
  const int tid = threadIdx.x % WG;
  const int ka = k0 + 16 * warp + g, kb = ka + 8;   // the thread's two keys
  if constexpr (!Cfg::SPLIT) {
    // -- two consumers, pair i to warpgroup i % 2, each summing dK and dV --
    float acc_k[32 * DC], acc_v[32 * DC];
#pragma unroll
    for (int i = 0; i < 32 * DC; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int i = wg; i < n_it; i += 2) {
      const int s = i % Cfg::STAGES, q0 = q_lo + (i % n_q) * 64;
      mbar_wait(full(s), (i / Cfg::STAGES) & 1);
      // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 queries
      float sc[32], dp[32];
      wg_fence();
      two_abt<DC>(sc, dp, kbase, qst(s), vbase, dost(s));
      wg_commit();
      wg_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const float* ls = stats(s);
      const bool all = tile_full(q0, k0, Sq, Skv, window, causal);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + 64 + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kj = c < 2 ? ka : kb, qi = q0 + col + (c & 1);
          const int e = 4 * j + c;
          const float p = all || visible(qi, kj, Sq, Skv, window, causal)
                              ? exp2f(fmaf(sc[e], scale_log2,
                                           -((c & 1) ? l2.y : l2.x)))
                              : 0.f;
          sc[e] = p;
          dp[e] = p * (dp[e] - ((c & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major from the tiles
      uint32_t p_hi[16], p_lo[16], s_hi[16], s_lo[16];
      split_frags(sc, p_hi, p_lo);
      split_frags(dp, s_hi, s_lo);
      wg_fence();
      acc_hi_lo<DC>(acc_v, p_hi, p_lo, dost(s));
      acc_hi_lo<DC>(acc_k, s_hi, s_lo, qst(s));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc_v);
      fence_acc(acc_k);
      if (tid == 0) mbar_arrive(empty(s));   // the stage is free
    }
    // the two sums in a fixed order, warpgroup 0's + 1's: 1 stages its f32
    // fragments in the freed ring (both are past their last product),
    // thread by thread, and 0 adds them
    float* part = reinterpret_cast<float*>(gbase + (ring - base));
    named_sync<1, 2 * WG>();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32 * DC; ++i) {
        part[i * WG + tid] = acc_k[i];
        part[(32 * DC + i) * WG + tid] = acc_v[i];
      }
    }
    named_sync<1, 2 * WG>();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32 * DC; ++i) {
        acc_k[i] += part[i * WG + tid];
        acc_v[i] += part[(32 * DC + i) * WG + tid];
      }
      const long long row0 = (long long)b * Skv * Hkv + h;
      const long long ra = ka < Skv ? row0 + (long long)ka * Hkv : -1;
      const long long rb = kb < Skv ? row0 + (long long)kb * Hkv : -1;
      store_rows<DC>(dk, acc_k, ra, rb, D, scale, t4);
      store_rows<DC>(dv, acc_v, ra, rb, D, 1.f, t4);
    }
  } else {
    // -- warpgroup 0 sums dV, 1 sums dK ---------------------------------------
    float acc[32 * DC];                               // dV (0) or dK (1)
#pragma unroll
    for (int i = 0; i < 32 * DC; ++i) acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int i = 0; i < n_it; ++i) {
      const int s = i % Cfg::STAGES, q0 = q_lo + (i % n_q) * 64, buf = i & 1;
      float* pt = reinterpret_cast<float*>(gbase + (pbase - base)) +
                  buf * 64 * 64;
      mbar_wait(full(s), (i / Cfg::STAGES) & 1);
      const float* st = stats(s);
      // 0: S^T = K Q^T; 1: dP^T = V dO^T (64 keys x 64 queries)
      float x[32];
      const uint32_t a_op = wg == 0 ? kbase : vbase;
      const uint32_t b_op = wg == 0 ? qst(s) : dost(s);
      wg_fence();
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = c * BOX + kk * 32;
          wgmma_n64<0, 0>(x, smem_desc(a_op + off, 16),
                          smem_desc(b_op + off, 16), c > 0 || kk > 0);
        }
      wg_commit();
      wg_wait<0>();
      fence_acc(x);
      if (wg == 0) {
        // P^T, handed to warpgroup 1 once it has read the tile two back
        const bool all = tile_full(q0, k0, Sq, Skv, window, causal);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(st + col);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kj = c < 2 ? ka : kb, qi = q0 + col + (c & 1);
            const int e = 4 * j + c;
            x[e] = all || visible(qi, kj, Sq, Skv, window, causal)
                       ? exp2f(fmaf(x[e], scale_log2,
                                    -((c & 1) ? l2.y : l2.x)))
                       : 0.f;
          }
        }
        if (i >= 2) bar_sync(4 + buf, 2 * WG);
#pragma unroll
        for (int e = 0; e < 32; ++e) pt[e * WG + tid] = x[e];
        bar_arrive(2 + buf, 2 * WG);
      } else {
        // dS^T = P^T o (dP^T - Delta)
        bar_sync(2 + buf, 2 * WG);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(st + 64 + 8 * j + 2 * t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * j + c;
            x[e] = pt[e * WG + tid] * (x[e] - ((c & 1) ? d2.y : d2.x));
          }
        }
        if (i + 2 < n_it) bar_arrive(4 + buf, 2 * WG);
      }
      // dV += P^T dO (0), dK += dS^T Q (1): dO and Q read MN-major from the
      // same tiles
      uint32_t hi[16], lo[16];
      split_frags(x, hi, lo);
      wg_fence();
      acc_hi_lo<DC>(acc, hi, lo, wg == 0 ? dost(s) : qst(s));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty(s));   // the stage is free
    }

    const long long row0 = (long long)b * Skv * Hkv + h;
    const long long ra = ka < Skv ? row0 + (long long)ka * Hkv : -1;
    const long long rb = kb < Skv ? row0 + (long long)kb * Hkv : -1;
    if (wg == 0)
      store_rows<DC>(dv, acc, ra, rb, D, 1.f, t4);
    else
      store_rows<DC>(dk, acc, ra, rb, D, scale, t4);
  }
}

template <int E>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int Sq, int Skv, int Hq, int Hkv, int D, int window,
                int causal, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dkdv<E>, smem, smem_set)) return e;
  dim3 grid((Skv + BT - 1) / BT, Hkv, B);
  fa_bwd_dkdv<E><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, Hq,
      Hkv, D, window, causal, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_delta(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, int B,
                 int Sq, int Skv, int Hq, int Hkv, int D, int window,
                 int causal, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_delta<E>, smem, smem_set)) return e;
  dim3 grid((Sq + BT - 1) / BT, Hq, B);
  fa_bwd_delta<E><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, Sq, Skv, Hq, Hkv, D, window, causal, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Skv, int Hq, int Hkv, int D, int window, int causal,
              cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dq<E>, smem, smem_set)) return e;
  dim3 grid((Sq + BT - 1) / BT, Hq, B);
  fa_bwd_dq<E><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), Sq, Skv, Hq, Hkv, D, window, causal,
      1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

bool encode_maps(Maps& m, const void* q, const void* k, const void* v,
                 const void* dout, int B, int Sq, int Skv, int Hq, int Hkv,
                 int D) {
  return encode_bshd(&m.q, q, B, Sq, Hq, D) &&
         encode_bshd(&m.k, k, B, Skv, Hkv, D) &&
         encode_bshd(&m.v, v, B, Skv, Hkv, D) &&
         encode_bshd(&m.dout, dout, B, Sq, Hq, D);
}

// Delta on the warpgroup route
template <int DC>
int launch_delta_wgmma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, float* delta,
                       int B, int Sq, int Skv, int Hq, int Hkv, int D,
                       int window, int causal, cudaStream_t s) {
  constexpr size_t smem = RowCfg<DC>::SMEM;
  Maps m;
  if (!encode_maps(m, q, k, v, dout, B, Sq, Skv, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_delta_wgmma<DC>, smem, smem_set)) return e;
  const long long n = (long long)((Sq + 127) / 128) * Hq * B;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_delta_wgmma<DC><<<(unsigned)n, FB_THREADS, smem, s>>>(
      m.q, m.k, m.v, m.dout, lse, delta, B, Sq, Skv, Hq, Hkv, D, window,
      causal, LOG2E / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

// dQ on the warpgroup route
template <int DC>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                    int window, int causal, cudaStream_t s) {
  constexpr size_t smem = RowCfg<DC>::SMEM;
  Maps m;
  if (!encode_maps(m, q, k, v, dout, B, Sq, Skv, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dq_wgmma<DC>, smem, smem_set)) return e;
  const long long n = (long long)((Sq + 127) / 128) * Hq * B;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_dq_wgmma<DC><<<(unsigned)n, FB_THREADS, smem, s>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dq), B, Sq, Skv,
      Hq, Hkv, D, window, causal, LOG2E / sqrtf((float)D),
      1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int DC>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                      int Hkv, int D, int window, int causal, cudaStream_t s) {
  constexpr size_t smem = KvCfg<DC>::SMEM;
  Maps m;
  if (!encode_maps(m, q, k, v, dout, B, Sq, Skv, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dkdv_wgmma<DC>, smem, smem_set)) return e;
  const long long n = (long long)((Skv + 63) / 64) * Hkv * B;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_dkdv_wgmma<DC><<<(unsigned)n, FB_THREADS, smem, s>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Sq, Skv, Hq, Hkv, D, window, causal,
      LOG2E / sqrtf((float)D), 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

// the checks shared by the entry points (the Python wrapper checks the same
// first): shapes, the dtype, and for bf16 D % 8 == 0 and 16-byte aligned
// operands (the tiles load 16-byte chunks of a row)
bool bad_args(int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
              std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return B < 1 || Sq < 1 || Skv < 1 || D < 1 || D > 128 || Hkv < 1 ||
         Hq % Hkv != 0 || Hq / Hkv > 16 ||
         (dtype != DT_F32 && dtype != DT_BF16) ||
         (dtype == DT_BF16 && (D % 8 != 0 || (bits & 15) != 0));
}

}  // namespace

// Delta (B, Sq, Hq) f32 = rowsum(P o dP)
extern "C" int fa_bwd_delta_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, void* delta, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D,
                                   int window, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(B, Sq, Skv, Hq, Hkv, D, dtype, {q, k, v, dout}))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int c = causal != 0;
#define FA_DELTA(F, P)                                                       \
  return F<P>(q, k, v, dout, l, dl, B, Sq, Skv, Hq, Hkv, D, window, c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DELTA(launch_delta, 2);
    if (D <= 64) FA_DELTA(launch_delta, 4);
    FA_DELTA(launch_delta, 8);
  }
  if (D <= 64) FA_DELTA(launch_delta_wgmma, 1);
  FA_DELTA(launch_delta_wgmma, 2);
#undef FA_DELTA
}

// dK, dV (B, Skv, Hkv, D) in the input dtype
extern "C" int fa_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int D,
                                  int window, int causal, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(B, Sq, Skv, Hq, Hkv, D, dtype, {q, k, v, dout, dk, dv}))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int c = causal != 0;
#define FA_DKDV(F, P)                                                        \
  return F<P>(q, k, v, dout, l, dl, dk, dv, B, Sq, Skv, Hq, Hkv, D, window,  \
              c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DKDV(launch_dkdv, 2);
    if (D <= 64) FA_DKDV(launch_dkdv, 4);
    FA_DKDV(launch_dkdv, 8);
  }
  if (D <= 64) FA_DKDV(launch_dkdv_wgmma, 1);
  FA_DKDV(launch_dkdv_wgmma, 2);
#undef FA_DKDV
}

// dQ (B, Sq, Hq, D) in the input dtype
extern "C" int fa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Skv, int Hq, int Hkv, int D, int window,
                                int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(B, Sq, Skv, Hq, Hkv, D, dtype, {q, k, v, dout, dq}))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int c = causal != 0;
#define FA_DQ(F, P)                                                         \
  return F<P>(q, k, v, dout, l, dl, dq, B, Sq, Skv, Hq, Hkv, D, window, c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DQ(launch_dq, 2);
    if (D <= 64) FA_DQ(launch_dq, 4);
    FA_DQ(launch_dq, 8);
  }
  if (D <= 64) FA_DQ(launch_dq_wgmma, 1);
  FA_DQ(launch_dq_wgmma, 2);
#undef FA_DQ
}

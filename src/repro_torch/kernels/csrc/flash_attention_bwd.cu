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
// What the design does (bf16, the *_mma kernels): FA2's structure on the
// warp tensor-core product mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// built from the forward's pieces (fa_mma_kernel): 64-row tiles staged by
// 16-byte cp.async in two stages (the next tile loads while this one is
// used), rows padded by 8 bf16 so that ldmatrix hits no bank twice, the
// softmax in exp2 form, P = exp2(S scale log2(e) - LSE log2(e)), and f32
// accumulators turned straight into A fragments (pack_bf16).  P and dS go
// to their products as two bf16 fragments each, hi = x rounded and lo = the
// rest rounded (split_bf16), both multiplied by the same B fragment into
// one f32 sum: P or dS rounded once to bf16, as FA2 does, puts an early
// key's dV / dK 1.13 / 1.03x outside the bf16 bound (3e-2 of the output's
// RMS) at 4096 causal rows (an emulation in tests/test_torch_train_kernels
// .py): its first rows' weights are O(1), each off by up to 2^-9, against
// an RMS set by the many small ones.  The second pass costs 3 of the 12
// products and no shared-memory traffic (the B fragment is loaded once).
// A CTA is 4 warps of 16 rows; P and dS live in registers and never touch
// shared memory.
// - fa_bwd_dkdv_mma: one CTA per (kv tile of 64 keys, kv head, batch); each
//   warp owns 16 keys.  It walks the G query heads of its kv head in order
//   and, for each, every 64-row query tile that can see the tile: S^T = K
//   Q^T and dP^T = V dO^T (Q, dO by ldmatrix), P^T and dS^T = P^T o (dP^T
//   - Delta) in registers, dV += P^T dO and dK += dS^T Q (dO, Q by
//   ldmatrix.trans), dK and dV 16 x D f32 each in registers.
// - fa_bwd_dq_mma: one CTA per (64-row query tile, query head, batch), the
//   longest causal walks first; S = Q K^T, dP = dO V^T, dS in registers,
//   dQ += dS K (K by ldmatrix.trans).
// - fa_bwd_delta_mma: the dQ kernel's S / dP walk, summing P o dP from the
//   f32 accumulators: each thread over its columns in key order, then the
//   quad by shuffles (a warp owns whole rows).
// The balance rule (dK / dV, causal): kv tile t sees Sq/64 - t query
// tiles, so in launch order the walks fall from the longest (tile 0) to
// the shortest.  Two CTAs fit an SM (~105 KB of shared memory each), and
// the first SMs CTAs of a launch take one SM each, the next ones the
// second slots in the same order; so block i < SMs takes the i-th longest
// walk and block SMs + j the j-th shortest, and each SM pairs a long walk
// with a short one (a permutation: any placement gives the same bits).
// The query tile of the dK / dV walk is 64 rows: at D = 128 that kernel
// takes 255 registers and spills 48 bytes, and 32 rows (243 registers, no
// spill) measured 13 % slower at the training shape.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 1 [train] and
// profiling/flash_attention_bwd_ab.py against the CUDA-core layout): at the
// training shape 3.59 ms for the three kernels (Delta 0.77, dK / dV 1.68,
// dQ 1.11; 201 TFLOP/s of the 12 products), against 50.9 on the CUDA cores
// and SDPA's forward + backward 0.92; dK / dV took 1.99 ms in launch order
// against 1.71 under the balance rule.  whisper's encoder (4 x 1500, 8
// heads of 64, bidirectional) 0.58 ms (SDPA 0.20), its cross attention (32
// rows over 1500) 0.16 ms (SDPA 0.043).
// f32 (fa_bwd_delta / fa_bwd_dkdv / fa_bwd_dq, only reached by the
// card-versus-CPU checks and the f32 tile edges) stays on the CUDA cores,
// as the forward's f32 fa_kernel does: TF32 would break the reference's
// 2e-4 f32 tolerance.  A CTA of 256 threads holds two 64-row tiles of each
// side in shared memory as f32, each thread a 4 x 4 block of S and dP, P
// and dS through shared memory.
// Next redesign: wgmma on 64-row warpgroup tiles with Q / dO brought in by
// TMA and a producer warp, as FA3 does.
#include <climits>
#include <initializer_list>

#include "common.cuh"

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
// bf16: tensor-core kernels (mma.sync m16n8k16, cp.async double buffer)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BK = 64;      // keys of a kv tile; rows of dQ's query tile
constexpr int TC_BQ = 64;      // query rows of the dK / dV walk's tile
constexpr float LOG2E = 1.4426950408889634f;

// 4 bytes global -> shared (full == false writes a zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

// rows [r0, r0 + ROWS) of head h of a (B, S, H, D) tensor -> dst
// [ROWS][DPAD + 8], by cp.async; rows past S and columns past D are zeros
template <int DPAD, int ROWS>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int b, int S, int H, int h, int r0,
                                           int D) {
  constexpr int ST = DPAD + 8, CH = DPAD / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH, rr = r0 + r;
    const bool ok = rr < S && c < D / 8;
    const bf16* p = ok ? src + (((size_t)b * S + rr) * H + h) * D + c * 8
                       : src;
    cp_async16(dst + r * ST + c * 8, p, ok);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv,
                                        int window, int causal) {
  return qi < Sq && kj < Skv && (!causal || qi >= kj) &&
         (window <= 0 || qi - kj < window);
}

// every (query, key) of the tiles [q0, q0 + BQ) x [k0, k0 + BK) visible
template <int BQ, int BK>
__device__ __forceinline__ bool tile_full(int q0, int k0, int Sq, int Skv,
                                          int window, int causal) {
  return q0 + BQ <= Sq && k0 + BK <= Skv && (!causal || q0 >= k0 + BK - 1) &&
         (window <= 0 || q0 + BQ - 1 - k0 < window);
}

// s = A1 B1^T and t = A2 B2^T (16 x N each) over DPAD columns: a1 / a2 the
// warp's 16 rows of two tiles, b1 / b2 N rows of two others
template <int DPAD, int N>
__device__ __forceinline__ void two_abt(float (&s)[N / 8][4],
                                        float (&t)[N / 8][4], const bf16* a1,
                                        const bf16* b1, const bf16* a2,
                                        const bf16* b2, int lane) {
  constexpr int ST = DPAD + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = t[j][c] = 0.f;
  const int ar = (lane & 15) * ST + (lane >> 4) * 8;
  const int br = ((lane & 7) + ((lane >> 4) << 3)) * ST + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk) {
    uint32_t x[4], y[4];
    ldsm_x4(x, a1 + ar + kk * 16);
    ldsm_x4(y, a2 + ar + kk * 16);
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t u[4], w[4];   // rows 16jp..+7 | d lo, d hi; rows +8..+15
      ldsm_x4(u, b1 + br + jp * 16 * ST + kk * 16);
      ldsm_x4(w, b2 + br + jp * 16 * ST + kk * 16);
      mma_bf16(s[2 * jp], x, u[0], u[1]);
      mma_bf16(s[2 * jp + 1], x, u[2], u[3]);
      mma_bf16(t[2 * jp], y, w[0], w[1]);
      mma_bf16(t[2 * jp + 1], y, w[2], w[3]);
    }
  }
}

// x0, x1 ~ hi + lo, each a bf16 pair (nearest even): lo carries the
// rounding error of hi, so hi + lo is x within 2^-16 of its value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// acc (16 x DPAD) += P V: P 16 x N f32, split into two bf16 A fragments
// (hi + lo, each from two adjacent 8-column tiles) whose products both go
// into acc, V N rows of DPAD by ldmatrix.trans (one load for both)
template <int DPAD, int N>
__device__ __forceinline__ void acc_pv(float (&acc)[DPAD / 8][4],
                                       const float (&p)[N / 8][4],
                                       const bf16* vs, int lane) {
  constexpr int ST = DPAD + 8;
  const int vr = ((lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < DPAD / 16; ++np) {
      uint32_t vb[4];   // rows lo | hi for d 16np..+7, then for d +8..+15
      ldsm_x4_trans(vb, vs + vr + kk * 16 * ST + np * 16);
      mma_bf16(acc[2 * np], hi, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], hi, vb[2], vb[3]);
      mma_bf16(acc[2 * np], lo, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], lo, vb[2], vb[3]);
    }
  }
}

// rows g and g + 8 of a warp's 16 x DPAD accumulator, times mul, rounded to
// bf16 into rows ra / rb of a (.., D) tensor (row < 0: not stored)
template <int DPAD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[DPAD / 8][4],
                                           long long ra, long long rb, int D,
                                           float mul, int t4) {
#pragma unroll
  for (int n = 0; n < DPAD / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (n * 8 >= D) break;
    if (ra >= 0)
      *reinterpret_cast<uint32_t*>(out + ra * D + col) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (rb >= 0)
      *reinterpret_cast<uint32_t*>(out + rb * D + col) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

template <int DPAD>
struct RowSmem {   // Q, dO; two stages of K, V
  static constexpr size_t BYTES = sizeof(bf16) * 6 * (size_t)TC_BK * (DPAD + 8);
};

// The Delta and dQ kernels' walk: grid (query tiles, Hq, B), TC_THREADS
// threads.  DQ: dQ = scale dS K from Delta; else Delta = rowsum(P o dP).
template <int DPAD, bool DQ>
__device__ __forceinline__ void row_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
    int window, int causal, float scale_log2, float scale) {
  constexpr int ST = DPAD + 8, TILE = TC_BK * ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [TC_BK][ST]
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;                            // [2][TC_BK][ST]
  bf16* vs = ks + 2 * TILE;                         // [2][TC_BK][ST]

  const int G = Hq / Hkv;
  // the longest causal walks first (without causal all walks are equal)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BK;
  const int hq = blockIdx.y, b = blockIdx.z, h = hq / G;
  const int q_last = min(q0 + TC_BK, Sq) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_tile<DPAD, TC_BK>(qs, q, b, Sq, Hq, hq, q0, D);
  stage_tile<DPAD, TC_BK>(dos, dout, b, Sq, Hq, hq, q0, D);

  // the keys that a row of this tile can see
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + TC_BK - 1) / TC_BK : 0;
  auto load_kv = [&](int t) {
    const int k0 = k_lo + t * TC_BK;
    stage_tile<DPAD, TC_BK>(ks + (t & 1) * TILE, k, b, Skv, Hkv, h, k0, D);
    stage_tile<DPAD, TC_BK>(vs + (t & 1) * TILE, v, b, Skv, Hkv, h, k0, D);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();                                // Q, dO and the first tile

  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const int qa = q0 + wr + g, qb = qa + 8;          // the thread's two rows
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
  float acc[DQ ? DPAD / 8 : 1][4];                  // dQ
#pragma unroll
  for (int n = 0; n < (DQ ? DPAD / 8 : 1); ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + (t & 1) * TILE;
    const bf16* vt = vs + (t & 1) * TILE;
    float s[TC_BK / 8][4], dp[TC_BK / 8][4];
    two_abt<DPAD, TC_BK>(s, dp, qs + wr * ST, kt, dos + wr * ST, vt, lane);

    const int k0 = k_lo + t * TC_BK;
    const bool full = tile_full<TC_BK, TC_BK>(q0, k0, Sq, Skv, window, causal);
#pragma unroll
    for (int j = 0; j < TC_BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = c < 2 ? qa : qb;
        const int kj = k0 + j * 8 + 2 * t4 + (c & 1);
        const float p =
            full || visible(qi, kj, Sq, Skv, window, causal)
                ? exp2f(fmaf(s[j][c], scale_log2, -(c < 2 ? la : lb)))
                : 0.f;
        if constexpr (DQ)
          s[j][c] = p * (dp[j][c] - (c < 2 ? da : db));
        else if (c < 2)
          da += p * dp[j][c];
        else
          db += p * dp[j][c];
      }
    }
    if constexpr (DQ) acc_pv<DPAD, TC_BK>(acc, s, kt, lane);
    __syncthreads();   // this stage is consumed before tile t + 2 lands in it
  }
  cp_async_wait<0>();

  if constexpr (DQ) {
    store_rows<DPAD>(dq, acc, qa < Sq ? (long long)ra : -1,
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

template <int DPAD>
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_delta_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 int Sq, int Skv, int Hq, int Hkv, int D, int window,
                 int causal, float scale_log2) {
  row_walk<DPAD, false>(q, k, v, dout, lse, delta, nullptr, Sq, Skv, Hq, Hkv,
                        D, window, causal, scale_log2, 0.f);
}

template <int DPAD>
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
              int window, int causal, float scale_log2, float scale) {
  row_walk<DPAD, true>(q, k, v, dout, lse, const_cast<float*>(delta), dq, Sq,
                       Skv, Hq, Hkv, D, window, causal, scale_log2, scale);
}

template <int DPAD>
struct KvSmem {    // K, V; two stages of Q, dO and of the rows' LSE, Delta
  static constexpr size_t BYTES =
      sizeof(bf16) * (2 * (size_t)TC_BK + 4 * (size_t)TC_BQ) * (DPAD + 8) +
      sizeof(float) * 4 * TC_BQ;
};

// grid (kv tiles x Hkv x B), one dimension, in the balance rule's order;
// slots: the SMs of the card
template <int DPAD>
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq,
                int Skv, int Hq, int Hkv, int D, int window, int causal,
                int slots, float scale_log2, float scale) {
  constexpr int ST = DPAD + 8, KT = TC_BK * ST, QT = TC_BQ * ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [TC_BK][ST]
  bf16* vs = ks + KT;
  bf16* qs = vs + KT;                               // [2][TC_BQ][ST]
  bf16* dos = qs + 2 * QT;                          // [2][TC_BQ][ST]
  // [2][LSE, Delta][TC_BQ]
  float* stats = reinterpret_cast<float*>(dos + 2 * QT);

  // block i < slots takes the i-th longest walk, block slots + j the j-th
  // shortest (kv tile 0 is the longest when causal)
  const int n = gridDim.x, L = blockIdx.x;
  const int r = L < slots ? L : n - 1 - (L - slots);
  const int tile = r / (Hkv * B), h = r % Hkv, b = r / Hkv % B;
  const int k0 = tile * TC_BK;
  const int k_last = min(k0 + TC_BK, Skv) - 1;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_tile<DPAD, TC_BK>(ks, k, b, Skv, Hkv, h, k0, D);
  stage_tile<DPAD, TC_BK>(vs, v, b, Skv, Hkv, h, k0, D);

  // the query rows that can see a key of this tile, for each query head
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + TC_BQ - 1) / TC_BQ : 0;
  const int n_it = G * n_q;
  auto load_q = [&](int i) {
    const int hq = h * G + i / n_q, q0 = q_lo + (i % n_q) * TC_BQ;
    stage_tile<DPAD, TC_BQ>(qs + (i & 1) * QT, q, b, Sq, Hq, hq, q0, D);
    stage_tile<DPAD, TC_BQ>(dos + (i & 1) * QT, dout, b, Sq, Hq, hq, q0, D);
    float* st = stats + (i & 1) * 2 * TC_BQ;
    for (int j = threadIdx.x; j < TC_BQ; j += TC_THREADS) {
      const int qi = q0 + j;
      const size_t row = qi < Sq ? ((size_t)b * Sq + qi) * Hq + hq : 0;
      cp_async4(st + j, lse + row, qi < Sq);
      cp_async4(st + TC_BQ + j, delta + row, qi < Sq);
    }
  };
  if (n_it > 0) load_q(0);
  cp_async_commit();                                // K, V and the first tile

  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const int ka = k0 + wr + g, kb = ka + 8;          // the thread's two keys
  float acc_k[DPAD / 8][4], acc_v[DPAD / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < DPAD / 8; ++n8)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n8][c] = acc_v[n8][c] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    if (i + 1 < n_it) {
      load_q(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + (i & 1) * QT;
    const bf16* dot = dos + (i & 1) * QT;
    const float* ls = stats + (i & 1) * 2 * TC_BQ;
    const float* dls = ls + TC_BQ;
    const int q0 = q_lo + (i % n_q) * TC_BQ;
    // s = S^T, t = dP^T: 16 keys x TC_BQ queries a warp
    float s[TC_BQ / 8][4], t[TC_BQ / 8][4];
    two_abt<DPAD, TC_BQ>(s, t, ks + wr * ST, qt, vs + wr * ST, dot, lane);

    const bool full = tile_full<TC_BQ, TC_BK>(q0, k0, Sq, Skv, window, causal);
#pragma unroll
    for (int j = 0; j < TC_BQ / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = c < 2 ? ka : kb, qi = q0 + col + (c & 1);
        const float lv = (c & 1) ? l2.y : l2.x;
        const float dl = (c & 1) ? d2.y : d2.x;
        const float p = full || visible(qi, kj, Sq, Skv, window, causal)
                            ? exp2f(fmaf(s[j][c], scale_log2, -lv * LOG2E))
                            : 0.f;
        s[j][c] = p;
        t[j][c] = p * (t[j][c] - dl);
      }
    }
    acc_pv<DPAD, TC_BQ>(acc_v, s, dot, lane);   // dV += P^T dO
    acc_pv<DPAD, TC_BQ>(acc_k, t, qt, lane);    // dK += dS^T Q
    __syncthreads();   // this stage is consumed before tile i + 2 lands in it
  }
  cp_async_wait<0>();

  const long long base = (long long)b * Skv * Hkv + h;
  const long long ra = ka < Skv ? base + (long long)ka * Hkv : -1;
  const long long rb = kb < Skv ? base + (long long)kb * Hkv : -1;
  store_rows<DPAD>(dk, acc_k, ra, rb, D, scale, t4);
  store_rows<DPAD>(dv, acc_v, ra, rb, D, 1.f, t4);
}

// above 48 KB of dynamic shared memory needs an opt-in, once per kernel
template <typename K>
int allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
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

template <int DPAD>
int launch_delta_mma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, float* delta, int B,
                     int Sq, int Skv, int Hq, int Hkv, int D, int window,
                     int causal, cudaStream_t s) {
  constexpr size_t smem = RowSmem<DPAD>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_delta_mma<DPAD>, smem, smem_set)) return e;
  dim3 grid((Sq + TC_BK - 1) / TC_BK, Hq, B);
  fa_bwd_delta_mma<DPAD><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      Sq, Skv, Hq, Hkv, D, window, causal, LOG2E / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                  int window, int causal, cudaStream_t s) {
  constexpr size_t smem = RowSmem<DPAD>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dq_mma<DPAD>, smem, smem_set)) return e;
  dim3 grid((Sq + TC_BK - 1) / TC_BK, Hq, B);
  fa_bwd_dq_mma<DPAD><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, D, window, causal,
      LOG2E / sqrtf((float)D), 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_dkdv_mma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                    int Hkv, int D, int window, int causal, cudaStream_t s) {
  constexpr size_t smem = KvSmem<DPAD>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dkdv_mma<DPAD>, smem, smem_set)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)((Skv + TC_BK - 1) / TC_BK) * Hkv * B;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_dkdv_mma<DPAD><<<(unsigned)n, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, Hq, Hkv, D,
      window, causal, sms, LOG2E / sqrtf((float)D), 1.f / sqrtf((float)D));
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
  if (D <= 32) FA_DELTA(launch_delta_mma, 32);
  if (D <= 64) FA_DELTA(launch_delta_mma, 64);
  if (D <= 96) FA_DELTA(launch_delta_mma, 96);
  FA_DELTA(launch_delta_mma, 128);
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
  if (D <= 32) FA_DKDV(launch_dkdv_mma, 32);
  if (D <= 64) FA_DKDV(launch_dkdv_mma, 64);
  if (D <= 96) FA_DKDV(launch_dkdv_mma, 96);
  FA_DKDV(launch_dkdv_mma, 128);
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
  if (D <= 32) FA_DQ(launch_dq_mma, 32);
  if (D <= 64) FA_DQ(launch_dq_mma, 64);
  if (D <= 96) FA_DQ(launch_dq_mma, 96);
  FA_DQ(launch_dq_mma, 128);
#undef FA_DQ
}

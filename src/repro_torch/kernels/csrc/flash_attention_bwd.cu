// Flash attention's backward: dQ, dK and dV of the prefill kernel
// (flash_attention.cu) from q, k, v, dO and each row's log-sum-exp LSE,
// which the forward writes when it is given a pointer.
// Causal or bidirectional, the one-sided window, GQA, any Sq and Skv;
// q / dO / dQ (B, Sq, Hq, D), k / v / dK / dV (B, Skv, Hkv, D), bf16 or
// f32; every product and sum in f32, the outputs rounded to the input dtype.
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
//   dP = dO V^T,  Delta = rowsum(P o dP)         fa_bwd_delta
//   dS = P o (dP - Delta)
//   dV = P^T dO,  dK = scale dS^T Q              fa_bwd_dkdv
//   dQ = scale dS K                              fa_bwd_dq
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
// the forward's 120 GFLOP, ~0.3 ms at the tensor cores' 989 TFLOP/s; the
// bytes (q, k, v, dO, LSE in; dQ, dK, dV out) are 0.1 ms.
//
// What the design does: the simplest correct layout, on the CUDA cores in
// f32.  A CTA of 256 threads holds two 64-row tiles of each side in shared
// memory as f32 (rows padded to an odd stride, so the 16 lanes that read 16
// rows at one column hit 16 banks).  Each thread computes a 4 x 4 block of
// S and dP (rows t/16 + 16i, keys t%16 + 16j), writes P and dS to shared
// memory, then accumulates a 4-row x D/16-column block of its outputs in
// registers.  fa_bwd_dkdv: one CTA per (kv tile, kv head, batch), walking
// the G query heads of its kv head and every query tile that can see the
// tile; fa_bwd_delta and fa_bwd_dq: one CTA per (query tile, query head,
// batch), walking every visible kv tile (the longest causal walks first).  The causal dK /
// dV walk is unbalanced (the first kv tile sees every query tile, the last
// one), and shared-memory loads bound the inner loops at about half the
// CUDA cores' rate.  Next redesign: mma.sync / wgmma tiles with P and dS in
// registers, as FA2 / FA3 do.
#include "common.cuh"

namespace {

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
template <typename T, int E>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int S, int H, int h, int r0,
                                      int D) {
  constexpr int DW = BwdSmem<E>::DW, DP = BwdSmem<E>::DP;
  for (int i = threadIdx.x; i < BT * DW; i += THREADS) {
    const int r = i / DW, d = i % DW, rr = r0 + r;
    float x = 0.f;
    if (rr < S && d < D) x = to_f<T>(src[(((size_t)b * S + rr) * H + h) * D + d]);
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
template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_delta(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
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
  stage<T, E>(qs, q, b, Sq, Hq, hq, q0, D);
  stage<T, E>(dos, dout, b, Sq, Hq, hq, q0, D);
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
    stage<T, E>(ks, k, b, Skv, Hkv, h, k0, D);
    stage<T, E>(vs, v, b, Skv, Hkv, h, k0, D);
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
template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq,
            int Hkv, int D, int window, int causal, float scale) {
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
  stage<T, E>(ks, k, b, Skv, Hkv, h, k0, D);
  stage<T, E>(vs, v, b, Skv, Hkv, h, k0, D);

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
      stage<T, E>(qs, q, b, Sq, Hq, hq, q0, D);
      stage<T, E>(dos, dout, b, Sq, Hq, hq, q0, D);
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
        dk[base + d] = from_f<T>(acc_k[j][e] * scale);
        dv[base + d] = from_f<T>(acc_v[j][e]);
      }
    }
  }
}

// grid (query tiles, Hq, B)
template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
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
  stage<T, E>(qs, q, b, Sq, Hq, hq, q0, D);
  stage<T, E>(dos, dout, b, Sq, Hq, hq, q0, D);
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
    stage<T, E>(ks, k, b, Skv, Hkv, h, k0, D);
    stage<T, E>(vs, v, b, Skv, Hkv, h, k0, D);
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
      if (d < D) dq[base + d] = from_f<T>(acc[i][e] * scale);
    }
  }
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

template <typename T, int E>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int Sq, int Skv, int Hq, int Hkv, int D, int window,
                int causal, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dkdv<T, E>, smem, smem_set)) return e;
  dim3 grid((Skv + BT - 1) / BT, Hkv, B);
  fa_bwd_dkdv<T, E><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv, D, window,
      causal, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_delta(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, int B,
                 int Sq, int Skv, int Hq, int Hkv, int D, int window,
                 int causal, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_delta<T, E>, smem, smem_set)) return e;
  dim3 grid((Sq + BT - 1) / BT, Hq, B);
  fa_bwd_delta<T, E><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, Sq,
      Skv, Hq, Hkv, D, window, causal, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Skv, int Hq, int Hkv, int D, int window, int causal,
              cudaStream_t s) {
  constexpr size_t smem = BwdSmem<E>::BYTES;
  static bool smem_set = false;
  if (int e = allow_smem(fa_bwd_dq<T, E>, smem, smem_set)) return e;
  dim3 grid((Sq + BT - 1) / BT, Hq, B);
  fa_bwd_dq<T, E><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Skv, Hq, Hkv, D, window, causal,
      1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

// the shape checks shared by the entry points (the Python wrapper checks
// the same first, and the bf16 alignment)
bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype) {
  return B < 1 || Sq < 1 || Skv < 1 || D < 1 || D > 128 || Hkv < 1 ||
         Hq % Hkv != 0 || Hq / Hkv > 16 ||
         (dtype != DT_F32 && dtype != DT_BF16) ||
         (dtype == DT_BF16 && D % 8 != 0);
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
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int c = causal != 0;
#define FA_DELTA(T, E)                                                       \
  return launch_delta<T, E>(q, k, v, dout, l, dl, B, Sq, Skv, Hq, Hkv, D,    \
                            window, c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DELTA(float, 2);
    if (D <= 64) FA_DELTA(float, 4);
    FA_DELTA(float, 8);
  }
  if (D <= 32) FA_DELTA(__nv_bfloat16, 2);
  if (D <= 64) FA_DELTA(__nv_bfloat16, 4);
  FA_DELTA(__nv_bfloat16, 8);
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
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int c = causal != 0;
#define FA_DKDV(T, E)                                                        \
  return launch_dkdv<T, E>(q, k, v, dout, l, dl, dk, dv, B, Sq, Skv, Hq, Hkv, \
                           D, window, c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DKDV(float, 2);
    if (D <= 64) FA_DKDV(float, 4);
    FA_DKDV(float, 8);
  }
  if (D <= 32) FA_DKDV(__nv_bfloat16, 2);
  if (D <= 64) FA_DKDV(__nv_bfloat16, 4);
  FA_DKDV(__nv_bfloat16, 8);
#undef FA_DKDV
}

// dQ (B, Sq, Hq, D) in the input dtype
extern "C" int fa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Skv, int Hq, int Hkv, int D, int window,
                                int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int c = causal != 0;
#define FA_DQ(T, E)                                                         \
  return launch_dq<T, E>(q, k, v, dout, l, dl, dq, B, Sq, Skv, Hq, Hkv, D,  \
                         window, c, s)
  if (dtype == DT_F32) {
    if (D <= 32) FA_DQ(float, 2);
    if (D <= 64) FA_DQ(float, 4);
    FA_DQ(float, 8);
  }
  if (D <= 32) FA_DQ(__nv_bfloat16, 2);
  if (D <= 64) FA_DQ(__nv_bfloat16, 4);
  FA_DQ(__nv_bfloat16, 8);
#undef FA_DQ
}

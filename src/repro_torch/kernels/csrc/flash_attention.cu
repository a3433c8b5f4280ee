// Prefill flash attention: causal + sliding-window + GQA, online softmax.
// q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D), out (B, Sq, Hq, D), bf16 or f32;
// query i attends to keys j <= i (and i - j < window when window > 0);
// scores, running max m, running sum l and the accumulator in f32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel).
//
// What bounds it on an H100: at the serving path's prefill widths (a wave of
// 4 x 32 tokens, G = 7 query heads per kv head, D = 128) the work is a few
// MFLOP per (slot, kv head) and the inputs a few hundred KB: the kernel is
// bound by its latency (launch, one pass over K/V per CTA), not by HBM or
// by the tensor cores.  Longer prompts make it operations-bound
// (2 * 2 * Sq * Skv * D per head, halved by the causal mask).
//
// What the design does about it: one CTA per (batch, kv head, tile of BQ
// query positions x all G heads of that kv head), so the K/V rows a CTA
// stages in shared memory serve every query head that reads them (the GQA
// packing of the Pallas kernel, bq * G rows).  A loop inside the CTA over
// 32-key tiles replaces Pallas's sequential grid axis; tiles wholly past
// the causal limit or wholly before the window are skipped, which is exact.
// In a tile, each lane scores one key against a row (D-long dot from
// shared memory), the warp reduces max and sum by shuffles, and each lane
// then owns D / 32 output elements of the row for the p @ v update.
// Masked keys score -1e30, never -inf, and the output divides by
// max(l, 1e-30): a row that meets a fully masked tile before any real key
// accumulates junk that the next real tile's correction exp(m - m_new)
// wipes exactly, as in the reference (flash_attention.py:52-60).
// CUDA-core FMAs in f32; tensor cores and TMA staging are later work.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int BK = 32;                 // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int RPW = 4;                 // rows (query position x head) per warp
constexpr int ROWS = WARPS * RPW;      // rows per CTA: BQ * G <= ROWS

template <typename T, int DPL>         // DPL = ceil(D / 32): row elements per lane
__global__ void __launch_bounds__(WARPS * 32)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int Hq,
          int Hkv, int D, int BQ, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;                // padded rows: lanes read distinct banks
  float* qs = smem;                    // [ROWS][DP]
  float* ks = qs + ROWS * DP;          // [BK][DP]
  float* vs = ks + BK * DP;            // [BK][D]
  const int G = Hq / Hkv;
  const int R = BQ * G;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // rows are [query position major, group head minor], as in the Pallas kernel
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r / G;
    float val = 0.f;
    if (r < R && qi < Sq)
      val = to_f<T>(q[(((size_t)b * Sq + qi) * Hq + h * G + r % G) * D + d]);
    qs[r * DP + d] = val;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);   // earlier keys: masked for every row
  k_lo = (k_lo / BK) * BK;
  const int k_hi = min(Skv, q_last + 1);   // later keys: masked for every row

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * Hkv + h) * D + d;
        kv = to_f<T>(k[off]);
        vv = to_f<T>(v[off]);
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool exists = kj < Skv;      // keys past Skv are not part of the problem
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * WARPS;
      const int qi = q0 + r / G;
      if (r >= R || qi >= Sq) continue;   // uniform across the warp
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[r * DP + d] * ks[lane * DP + d];
      float s = dot * scale;
      const bool ok = exists && qi >= kj && (window <= 0 || qi - kj < window);
      if (!ok) s = NEG;
      const float m_new = fmaxf(m[i], warp_max(exists ? s : -INFINITY));
      const float p = exists ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      const float pr = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL_MASK, pr, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[i][e] += pj * vs[j * D + d];
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * WARPS;
    const int qi = q0 + r / G;
    if (r >= R || qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qi) * Hq + h * G + r % G) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = from_f<T>(acc[i][e] * inv);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, int window,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int BQ = ROWS / G;
  const size_t smem = sizeof(float) * ((size_t)ROWS * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * D);
  dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  fa_kernel<T, DPL><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D, BQ,
      window, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int D, int window,
               cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, s);
  if (D <= 64) return launch<T, 2>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, s);
  return launch<T, 4>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, s);
}

}  // namespace

// Limits checked by the Python wrapper: D <= 128, Hq % Hkv == 0,
// Hq / Hkv <= 16.  window <= 0 means no window.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int Hq, int Hkv, int D,
                         int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return dispatch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, s);
  if (dtype == DT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One query token per (slot, kv head) against its K/V rows: the online-
// softmax decode attention shared by the paged kernels (paged_attention.cu:
// float pages, packed int8/e4m3 pages with per-(block, kv-head) scales, an
// optional keep mask over blocks) and the dense-slab kernel
// (flash_decode.cu).  Only the operands differ, so one template serves all
// of them:
//
//   T      the compute dtype of q, of the output and of the k_row / v_row
//          operands (float or bf16);
//   P      the page (or cache) element type: T itself, int8_t or
//          __nv_fp8_e4m3 (packed; then QUANT);
//   KEEP   a (B, Hkv, T) int32 keep mask over blocks: a dropped block is
//          skipped with no read at all;
//   DENSE  dense addressing ((b * S + p) * Hkv + h) * D instead of a block
//          table;
//   DPL    ceil(D / 32), the output elements each lane owns.
//
// What bounds every variant on an H100: bytes.  Each (slot, kv head) reads
// its context's K and V rows once and does 4 * G * D FLOPs per row (G = 7
// at qwen2-7b): ~7 FLOP per bf16 byte, ~28 per packed byte, far below the
// ~295 (bf16) or ~590 (int8/fp8) FLOP per byte at which the tensor cores
// would bind.
//
// The design: one CTA per (slot, kv head) with one warp per query head of
// the GQA group, so every row read from HBM serves all G heads from shared
// memory.  The CTA walks its positions in tiles of 32 (one per lane): the
// tile is staged in shared memory as f32 (dequantized there for packed
// pages: packed value * scale in f32, rounded to T as the reference's
// model path rounds its gathered view), each lane scores one position, the
// warp reduces max and sum by shuffles, and each lane then owns D / 32
// output elements for the p @ v update.  With a keep mask, warp 0 first
// compacts the kept block ids into shared memory (ballot + popc) and the
// tiles walk only those blocks' rows.  Numerics are the reference's: masked
// positions score -1e30 (never -inf), scores are q . k in f32 scaled by
// 1/sqrt(D), p is rounded to T before p @ v, and the output divides by
// max(l, 1e-30).
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace decode {

constexpr float NEG = -1e30f;
constexpr int KT = 32;   // positions per tile (one per lane)

struct Args {
  const void* q;        // (B, Hq, D) T
  const void* kp;       // pages (N, bs, Hkv, D) or dense cache (B, S, Hkv, D), P
  const void* vp;
  const float* ks;      // (N, Hkv) scales (QUANT)
  const float* vs;
  const void* k_row;    // (B, Hkv, D) T: the row at cur (QUANT; may be null)
  const void* v_row;
  const int* tables;    // (B, T) block ids (paged)
  const int* keep;      // (B, Hkv, T) (KEEP)
  const int* cur;       // cur[b * cur_stride]: 0 = one shared scalar
  void* o;              // (B, Hq, D) T
  int cur_stride, Hq, Hkv, D, bs, T, S, window;
  float scale;
};

template <typename P> __device__ __forceinline__ float load_f(P x);
template <> __device__ __forceinline__ float load_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float load_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float load_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float load_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, int DPL>
__global__ void __launch_bounds__(1024) kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DP = D + 1;       // padded rows: lanes read distinct banks
  const int G = a.Hq / a.Hkv, Hkv = a.Hkv, bs = a.bs;
  float* qs = smem;                    // [G][DP]
  float* ks = qs + G * DP;             // [KT][DP]
  float* vs = ks + KT * DP;            // [KT][D]
  int* kept = reinterpret_cast<int*>(vs + KT * D);   // [T] kept block ids
  __shared__ int n_kept;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;   // one warp per head
  const T* q = static_cast<const T*>(a.q);
  const P* kp = static_cast<const P*>(a.kp);
  const P* vp = static_cast<const P*>(a.vp);

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int gg = i / D, d = i % D;
    qs[gg * DP + d] = to_f<T>(q[((size_t)b * a.Hq + h * G + gg) * D + d]);
  }
  const int cur = a.cur[(size_t)b * a.cur_stride];
  const int span = DENSE ? a.S : a.T * bs;   // the view ends at T * bs (or S)
  const int last = min(cur, span - 1);
  int lo = a.window > 0 ? max(0, cur - a.window + 1) : 0;
  if (!DENSE) lo = (lo / bs) * bs;           // from the first block the window reaches
  int n;                                     // positions walked
  if (KEEP) {
    if (threadIdx.x < 32) {                  // warp 0 compacts the kept blocks
      const int* kr = a.keep + ((size_t)b * Hkv + h) * a.T;
      int c = 0;
      for (int t0 = 0; t0 < a.T; t0 += 32) {
        const int t = t0 + lane;
        const bool k = t < a.T && t * bs <= last && kr[t] != 0;
        const unsigned m = __ballot_sync(FULL_MASK, k);
        if (k) kept[c + __popc(m & ((1u << lane) - 1u))] = t;
        c += __popc(m);
      }
      if (lane == 0) n_kept = c;
    }
    __syncthreads();
    n = n_kept * bs;
  } else {
    n = last - lo + 1;
  }
  // logical position of the i-th walked row, or -1 past the end
  auto pos_of = [&](int i) -> int {
    if (i >= n) return -1;
    const int p = KEEP ? kept[i / bs] * bs + i % bs : lo + i;
    return p <= last ? p : -1;
  };

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  for (int i0 = 0; i0 < n; i0 += KT) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < KT * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int p = pos_of(i0 + j);
      float kv = 0.f, vv = 0.f;
      if (p >= 0) {
        if (QUANT && p == cur && a.k_row != nullptr) {
          const size_t r = ((size_t)b * Hkv + h) * D + d;
          kv = to_f<T>(static_cast<const T*>(a.k_row)[r]);
          vv = to_f<T>(static_cast<const T*>(a.v_row)[r]);
        } else {
          size_t row;
          int blk = 0;
          if (DENSE) {
            row = ((size_t)b * a.S + p) * Hkv + h;
          } else {
            blk = a.tables[(size_t)b * a.T + p / bs];
            row = ((size_t)blk * bs + p % bs) * Hkv + h;
          }
          kv = load_f<P>(kp[row * D + d]);
          vv = load_f<P>(vp[row * D + d]);
          if (QUANT) {
            kv = round_to<T>(kv * a.ks[(size_t)blk * Hkv + h]);
            vv = round_to<T>(vv * a.vs[(size_t)blk * Hkv + h]);
          }
        }
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    const int p = pos_of(i0 + lane);
    const bool exists = p >= 0;      // rows past the end: masked, contribute 0
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qs[g * DP + d] * ks[lane * DP + d];
    float s = dot * a.scale;
    if (!(exists && (a.window <= 0 || p > cur - a.window))) s = NEG;
    const float m_new = fmaxf(m, warp_max(exists ? s : -INFINITY));
    const float pe = exists ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(pe);
    const float pr = round_to<T>(pe);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] *= corr;
    for (int j = 0; j < KT; ++j) {
      const float pj = __shfl_sync(FULL_MASK, pr, j);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] += pj * vs[j * D + d];
      }
    }
    m = m_new;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = static_cast<T*>(a.o) + ((size_t)b * a.Hq + h * G + g) * D;
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) orow[d] = from_f<T>(acc[e] * inv);
  }
}

template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, int DPL>
int launch_dpl(const Args& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * (a.D + 1) +
                                       (size_t)KT * (a.D + 1) + (size_t)KT * a.D) +
                      (KEEP ? sizeof(int) * (size_t)a.T : 0);
  auto fn = kernel<T, P, QUANT, KEEP, DENSE, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<dim3(a.Hkv, B), G * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on D; limits (checked here and by the Python wrappers): 1 <= D
// <= 128, Hq % Hkv == 0, Hq / Hkv <= 32.
template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE>
int launch(const Args& a, int B, cudaStream_t s) {
  if (a.D < 1 || a.D > 128 || a.Hkv < 1 || a.Hq % a.Hkv != 0 ||
      a.Hq / a.Hkv > 32 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= 32) return launch_dpl<T, P, QUANT, KEEP, DENSE, 1>(a, B, s);
  if (a.D <= 64) return launch_dpl<T, P, QUANT, KEEP, DENSE, 2>(a, B, s);
  return launch_dpl<T, P, QUANT, KEEP, DENSE, 4>(a, B, s);
}

}  // namespace decode

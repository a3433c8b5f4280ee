// Paged decode attention: one query token per slot against its chain of KV
// blocks in a shared pool, through a block table.  q (B, Hq, D), pages
// (N, bs, Hkv, D), tables (B, T) int32, cur_pos (B,) int32, out (B, Hq, D);
// bf16 or f32 values, f32 scores / softmax state / accumulator.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py::
// paged_decode_pallas (_pa_kernel).
//
// What bounds it on an H100: bytes.  Each (slot, kv head) reads its context
// of K and V rows once and does 4 * G * D FLOPs per row (G = 7 at
// qwen2-7b): ~7 FLOP per byte in bf16, far below the ~295 at which the
// tensor cores would bind.  At the serving path's short contexts (tens of
// tokens) the whole pool read is a few hundred KB and launch latency
// dominates instead.
//
// What the design does about it: one CTA per (slot, kv head) with one warp
// per query head of the GQA group, so every K/V row is read from HBM once
// and serves all G heads from shared memory.  The CTA reads its own
// tables[b, t] (replacing Pallas's scalar prefetch) and loops over its
// context only up to cur_pos[b] (and from the first block the window can
// reach), in tiles of 32 positions gathered through the table: each lane
// scores one position, the warp reduces max and sum by shuffles, and each
// lane then owns D / 32 output elements for the p @ v update.  Masked
// positions score -1e30, never -inf, and the output divides by
// max(l, 1e-30).  Scores are scaled by 1/sqrt(D) in f32, as the model path
// does (layers.py:236), not folded into a bf16 q.
//
// The new token's K/V row must already be in the pool: the caller writes it
// before the launch (the model path places it in its gathered view before
// attending).  Inactive slots (cur_pos 0, null tables) read null block 0;
// their output is ignored but stays finite.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int KT = 32;   // positions per tile (one per lane)

template <typename T, int DPL>   // DPL = ceil(D / 32): row elements per lane
__global__ void __launch_bounds__(1024)
pa_kernel(const T* __restrict__ q, const T* __restrict__ kp,
          const T* __restrict__ vp, const int* __restrict__ tables,
          const int* __restrict__ cur_pos, T* __restrict__ o, int Hq, int Hkv,
          int D, int bs, int T_, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;                // padded rows: lanes read distinct banks
  const int G = Hq / Hkv;
  float* qs = smem;                    // [G][DP]
  float* ks = qs + G * DP;             // [KT][DP]
  float* vs = ks + KT * DP;            // [KT][D]
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;   // one warp per head

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int gg = i / D, d = i % D;
    qs[gg * DP + d] = to_f<T>(q[((size_t)b * Hq + h * G + gg) * D + d]);
  }
  const int cur = cur_pos[b];
  const int last = min(cur, T_ * bs - 1);   // the table's view ends at T * bs
  int lo = 0;
  if (window > 0) lo = max(0, cur - window + 1);
  lo = (lo / bs) * bs;                      // from the first block the window reaches

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  for (int p0 = lo; p0 <= last; p0 += KT) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < KT * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int p = p0 + j;
      float kv = 0.f, vv = 0.f;
      if (p <= last) {
        const int blk = tables[(size_t)b * T_ + p / bs];
        const size_t off = (((size_t)blk * bs + p % bs) * Hkv + h) * D + d;
        kv = to_f<T>(kp[off]);
        vv = to_f<T>(vp[off]);
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    const int p = p0 + lane;
    const bool exists = p <= last;   // later positions: masked, contribute 0
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qs[g * DP + d] * ks[lane * DP + d];
    float s = dot * scale;
    if (!(exists && (window <= 0 || p > cur - window))) s = NEG;
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
  T* orow = o + ((size_t)b * Hq + h * G + g) * D;
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) orow[d] = from_f<T>(acc[e] * inv);
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* cur_pos, void* o, int B, int Hq, int Hkv, int D, int bs,
           int T_, int window, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * (D + 1) + (size_t)KT * (D + 1) +
                                       (size_t)KT * D);
  dim3 grid(Hkv, B);
  pa_kernel<T, DPL><<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, cur_pos, static_cast<T*>(o), Hq, Hkv,
      D, bs, T_, window, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kp, const void* vp,
               const int* tables, const int* cur_pos, void* o, int B, int Hq,
               int Hkv, int D, int bs, int T_, int window, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, kp, vp, tables, cur_pos, o, B, Hq, Hkv, D, bs, T_, window, s);
  if (D <= 64) return launch<T, 2>(q, kp, vp, tables, cur_pos, o, B, Hq, Hkv, D, bs, T_, window, s);
  return launch<T, 4>(q, kp, vp, tables, cur_pos, o, B, Hq, Hkv, D, bs, T_, window, s);
}

}  // namespace

// Limits checked by the Python wrapper: D <= 128, Hq % Hkv == 0,
// Hq / Hkv <= 32.  window <= 0 means no window.
extern "C" int pa_launch(const void* q, const void* kp, const void* vp,
                         const void* tables, const void* cur_pos, void* o,
                         int B, int Hq, int Hkv, int D, int bs, int T_,
                         int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > 32 ||
      bs < 1 || T_ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tb = static_cast<const int*>(tables);
  const int* cp = static_cast<const int*>(cur_pos);
  if (dtype == DT_F32)
    return dispatch_d<float>(q, kp, vp, tb, cp, o, B, Hq, Hkv, D, bs, T_, window, s);
  if (dtype == DT_BF16)
    return dispatch_d<__nv_bfloat16>(q, kp, vp, tb, cp, o, B, Hq, Hkv, D, bs, T_, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

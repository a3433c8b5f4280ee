// Prefill flash attention: causal or bidirectional, sliding window, GQA,
// online softmax.  q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D), out (B, Sq, Hq,
// D), bf16 or f32; query i attends to keys j < Skv, j <= i when causal (and
// i - j < window when window > 0: one-sided, as in the reference);
// scores, running max m, running sum l and the accumulator in f32, the
// softmax weights rounded to the value dtype before p @ v.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel).
//
// What bounds it on an H100: at the serving path's prefill wave (q (4, 32,
// 28, 128), k / v (4, 32, 4, 128), G = 7 query heads per kv head) the work
// is 30 MFLOP on 2.1 MB of operands; the least time is the bytes' 0.6 us,
// and a kernel of one or two key tiles per CTA is bound by its latency
// (launch, one load of Q and K/V, the softmax's dependent steps).  A long
// prompt (1 x 2048 tokens, causal) is 30.1 GFLOP on 33.6 MB: bound by
// operations, 30 us at the tensor cores' 989 TFLOP/s against 450 us at the
// CUDA cores' 67 TFLOP/s in f32.
//
// What the design does (bf16, fa_mma_kernel): FA2's structure on the warp
// tensor-core product mma.sync.m16n8k16 (bf16 in, f32 accumulate).  The
// query rows of one (batch, kv head) are flattened as in the Pallas kernel,
// r = q_pos * G + g (position major, group head minor), so the K/V tile a
// CTA stages serves every query head that reads it; a CTA takes 64 rows (4
// warps x 16) and walks 64-key tiles of K and V, staged in shared memory by
// 16-byte cp.async in two stages (the next tile loads while this one is
// used), rows padded by 8 bf16 so that ldmatrix hits no bank twice.  Key
// tiles wholly past the CTA's last query position (causal) or wholly before
// its first position's window are skipped, which is exact; without causal
// every walk runs to Skv (whisper's encoder: 24 tiles of 64 keys for every
// CTA of 64 positions at G = 1).  Q's fragments are loaded once with
// ldmatrix and stay in registers; S = Q K^T takes K's fragments by
// ldmatrix, O += P V takes V's by ldmatrix.trans.  Scores are scaled
// after the dot (log2(e) folded in, exp2), masked keys score -1e30,
// never -inf (a row that meets a fully masked tile first accumulates junk
// that the next real tile's correction exp(m - m_new) wipes exactly, as in
// the reference), keys past Skv score -inf and weigh exactly 0.  The online
// softmax runs in registers: each thread owns two rows of its warp's 16,
// row max by shuffles within a quad, and the S accumulators are rounded to
// bf16 straight into P's A fragments (no shared-memory round trip).  O is
// 16 x D f32 per warp in registers, divided by max(l, 1e-30) and stored
// as bf16x2.  D <= 128 with D % 8 == 0 (16-byte rows), zero-padded to a
// multiple of 32 in shared memory.
// f32 (fa_kernel, only reached by the card-versus-CPU checks) stays on the
// CUDA cores: TF32 would break the reference's 2e-4 f32 tolerance.  One CTA
// per (batch, kv head, BQ query positions x G heads <= 16 rows), each lane
// scoring one key of a 32-key tile with a D-long dot from shared memory.
// Next redesign: wgmma on 64-row warpgroup tiles with K/V brought in by TMA
// and a producer warp (warp specialisation), as FA3 does.
// Training: with a non-null ``lse`` both kernels also write each row's
// log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural
// units, f32, (B, Sq, Hq): the statistic the backward kernels
// (flash_attention_bwd.cu) rebuild the softmax weights from.  The store is
// a template flag (LSE), so serving's calls (null) run instances compiled
// exactly as they were before it existed.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BK = 32;                 // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int RPW = 4;                 // rows (query position x head) per warp
constexpr int ROWS = WARPS * RPW;      // rows per CTA: BQ * G <= ROWS

// DPL = ceil(D / 32): row elements per lane; LSE: write each row's LSE
template <typename T, int DPL, bool LSE>
__global__ void __launch_bounds__(WARPS * 32)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int Sq, int Skv, int Hq, int Hkv, int D, int BQ, int window,
          int causal, float scale) {
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
  // later keys: masked for every row when causal
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;

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
      const bool ok = exists && (!causal || qi >= kj) &&
                      (window <= 0 || qi - kj < window);
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
    const size_t row = ((size_t)b * Sq + qi) * Hq + h * G + r % G;
    T* orow = o + row * D;
    if (LSE && lane == 0) lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = from_f<T>(acc[i][e] * inv);
    }
  }
}

template <typename T, int DPL, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, int window,
           int causal, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int BQ = ROWS / G;
  const size_t smem = sizeof(float) * ((size_t)ROWS * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * D);
  dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  fa_kernel<T, DPL, LSE><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, Hq, Hkv, D,
      BQ, window, causal, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
               int window, int causal, cudaStream_t s) {
#define FA_F32(DPL)                                                         \
  return lse ? launch<T, DPL, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, \
                                    window, causal, s)                       \
             : launch<T, DPL, false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,   \
                                     D, window, causal, s)
  if (D <= 32) FA_F32(1);
  if (D <= 64) FA_F32(2);
  FA_F32(4);
#undef FA_F32
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, cp.async double buffer)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = TC_WARPS * 16;   // flattened query rows per CTA
constexpr int TC_BK = 64;                // keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DPAD>
struct TcSmem {
  static constexpr int STRIDE = DPAD + 8;   // bf16 per row: 16 B of padding
  static constexpr int TILE = TC_BK * STRIDE;
  static constexpr size_t BYTES =
      sizeof(bf16) * ((size_t)TC_ROWS * STRIDE + 4 * (size_t)TILE);
};

// grid (row tiles, Hkv, B), TC_WARPS * 32 threads; DPAD = D rounded up to
// 32; LSE: write each row's LSE
template <int DPAD, bool LSE>
__global__ void __launch_bounds__(TC_WARPS * 32)
fa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
              int D, int window, int causal, float scale_log2) {
  constexpr int S = TcSmem<DPAD>::STRIDE;
  constexpr int CH = DPAD / 8;       // 16-byte chunks of a padded row
  constexpr int KSTEPS = DPAD / 16;  // k-steps of Q K^T
  constexpr int DT = DPAD / 8;       // 8-wide column tiles of O
  constexpr int NT = TC_BK / 8;      // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [TC_ROWS][S]
  bf16* ks = qs + TC_ROWS * S;                     // [2][TC_BK][S]
  bf16* vs = ks + 2 * TcSmem<DPAD>::TILE;          // [2][TC_BK][S]

  const int G = Hq / Hkv;
  const int R = Sq * G;                            // flattened rows
  // the longest causal walks first (without causal all walks are equal)
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * TC_ROWS;
  const int q_first = r0 / G;
  const int q_last = (min(r0 + TC_ROWS, R) - 1) / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d_chunks = D / 8;

  // Q tile: row r reads q[b, r / G, h * G + r % G, :]; rows past R and
  // columns past D are zeros
  for (int i = tid; i < TC_ROWS * CH; i += TC_WARPS * 32) {
    const int r = i / CH, c = i % CH, rr = r0 + r;
    const bool ok = rr < R && c < d_chunks;
    const bf16* src =
        ok ? q + (((size_t)b * Sq + rr / G) * Hq + h * G + rr % G) * D + c * 8
           : q;
    cp_async16(qs + r * S + c * 8, src, ok);
  }

  int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  k_lo = (k_lo / TC_BK) * TC_BK;                   // earlier keys: masked for every row
  // later keys: masked for every row when causal
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + TC_BK - 1) / TC_BK : 0;

  auto load_kv = [&](int t) {
    const int k0 = k_lo + t * TC_BK;
    bf16* kd = ks + (t & 1) * TcSmem<DPAD>::TILE;
    bf16* vd = vs + (t & 1) * TcSmem<DPAD>::TILE;
    for (int i = tid; i < TC_BK * CH; i += TC_WARPS * 32) {
      const int j = i / CH, c = i % CH, kj = k0 + j;
      const bool ok = kj < Skv && c < d_chunks;
      const size_t off = ok ? (((size_t)b * Skv + kj) * Hkv + h) * D + c * 8 : 0;
      cp_async16(kd + j * S + c * 8, k + off, ok);
      cp_async16(vd + j * S + c * 8, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();                               // Q and the first K/V tile

  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coordinates
  const int wr = warp * 16;                        // the warp's first row
  const int qi0 = (r0 + wr + g) / G;               // query positions of the
  const int qi1 = (r0 + wr + g + 8) / G;           // thread's two rows
  uint32_t qf[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's columns only

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qf[kk], qs + (wr + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + (t & 1) * TcSmem<DPAD>::TILE;
    const bf16* vt = vs + (t & 1) * TcSmem<DPAD>::TILE;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kb[4];   // keys 16jp..+7 | d lo, d hi; keys +8..+15 | d lo, d hi
        ldsm_x4(kb, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale after the dot; mask unless every key is valid for every row
    const int k0 = k_lo + t * TC_BK;
    const bool full = k0 + TC_BK <= Skv &&
                      (!causal || k0 + TC_BK - 1 <= q_first) &&
                      (window <= 0 || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale_log2;
        if (!full) {
          const int kj = k0 + j * 8 + 2 * t4 + (c & 1);
          const int qi = c < 2 ? qi0 : qi1;
          if (kj >= Skv)
            x = -INFINITY;   // not part of the problem: weight exactly 0
          else if ((causal && kj > qi) || (window > 0 && qi - kj >= window))
            x = NEG;
        }
        s[j][c] = x;
      }
    }

    // online softmax, rows g (c = 0, 1) and g + 8 (c = 2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, off));
    }
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // O += P V: P's A fragments are two adjacent S tiles rounded to bf16
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t vb[4];   // keys lo | hi for d 16np..+7, then for d +8..+15
        ldsm_x4_trans(vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                              np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is consumed before tile t + 2 lands in it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(FULL_MASK, l0, off);
    l1 += __shfl_xor_sync(FULL_MASK, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int ra = r0 + wr + g, rb = ra + 8;
  const size_t row_a = ((size_t)b * Sq + ra / G) * Hq + h * G + ra % G;
  const size_t row_b = ((size_t)b * Sq + rb / G) * Hq + h * G + rb % G;
  bf16* oa = o + row_a * D;
  bf16* ob = o + row_b * D;
  if (LSE && t4 == 0) {   // m is in log2 units: m ln 2 + log l
    if (ra < R) lse[row_a] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (rb < R) lse[row_b] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = n * 8 + 2 * t4;
    if (n * 8 >= D) break;
    if (ra < R)
      *reinterpret_cast<uint32_t*>(oa + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (rb < R)
      *reinterpret_cast<uint32_t*>(ob + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int DPAD, bool LSE>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
               int window, int causal, cudaStream_t stream) {
  constexpr size_t smem = TcSmem<DPAD>::BYTES;
  static bool smem_set = false;   // above 48 KB needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_mma_kernel<DPAD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int rows = Sq * (Hq / Hkv);
  dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, Hkv, B);
  fa_mma_kernel<DPAD, LSE><<<grid, TC_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Skv, Hq,
      Hkv, D, window, causal, LOG2E / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                 int window, int causal, cudaStream_t s) {
#define FA_MMA(DPAD)                                                        \
  return lse ? launch_mma<DPAD, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,  \
                                      D, window, causal, s)                  \
             : launch_mma<DPAD, false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, \
                                       D, window, causal, s)
  if (D <= 32) FA_MMA(32);
  if (D <= 64) FA_MMA(64);
  if (D <= 96) FA_MMA(96);
  FA_MMA(128);
#undef FA_MMA
}

}  // namespace

// Limits checked by the Python wrapper: D <= 128, Hq % Hkv == 0,
// Hq / Hkv <= 16; bf16 also D % 8 == 0 and 16-byte aligned pointers.
// window <= 0 means no window; causal != 0 masks the keys past each
// query's position.  bf16 runs fa_mma_kernel, f32 fa_kernel.  lse: null,
// or f32 (B, Sq, Hq) for each row's log-sum-exp (training).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int window, int causal, int dtype,
                         void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return dispatch_d<float>(q, k, v, o, lse_f, B, Sq, Skv, Hq, Hkv, D,
                             window, causal != 0, s);
  if (dtype == DT_BF16) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(o);
    if (D % 8 != 0 || (bits & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_mma(q, k, v, o, lse_f, B, Sq, Skv, Hq, Hkv, D, window,
                        causal != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// CUDA cores' 67 TFLOP/s in f32; training's forward at qwen2-7b's shape (1
// x 4096, 28 / 4 heads of 128, causal) is 120.3 GFLOP, 0.122 ms.
//
// The bf16 route is picked in fa_launch from Sq and D: fa_wgmma_kernel from
// 256 query rows at D > 64 and 768 at D <= 64 (training, long prompts,
// whisper's encoder, internvl2's 288-row prompts), fa_mma_kernel below
// (serving's waves and refills, hymba's 160-row waves: few CTAs of one
// head's 128 rows against the mma kernel's 64 rows packed from the G
// heads).  fa_wgmma_launch and fa_mma_launch force either.
//
// What the design does (bf16, long: fa_wgmma_kernel): FA3's structure on
// Hopper's warpgroup product wgmma.mma_async (bf16 in, f32 accumulate), the
// instruction that reaches the tensor cores' rate (mma.sync m16n8k16 below
// held this kernel at ~200 TFLOP/s).  A CTA owns 128 query rows of one
// query head, 64 a consumer warpgroup, and one producer warp; the grid is
// one dimension, the longest causal walks first.  Q comes in once as DC =
// ceil(D / 64) TMA boxes a warpgroup (cp.async.bulk.tensor.4d over the (D,
// H, S, B) view, 64 columns x 64 rows, 128-byte swizzle, zeros past Sq and
// past D); the producer streams K / V tiles through an mbarrier ring: at D
// > 64 tiles of 128 keys (128-row boxes) in 2 stages, 160 KB, one CTA an
// SM; at D <= 64 tiles of 64 keys in 4 stages, 80 KB, two CTAs an SM.
// Key tiles outside the CTA's causal range or window are never loaded, and
// a warpgroup skips a tile none of its rows sees.  S = Q K^T is
// m64n128k16 (m64n64k16 at D <= 64) with both operands K-major in shared
// memory; the online softmax runs on the accumulator's fragments (each
// thread two rows, the row max by quad shuffles, exp2 with log2(e) folded
// into the scale, by the special-function unit with results below 2^-126
// flushed to 0, the masks as below); P is rounded once to bf16 straight
// into the registers of O += P V's A operand (the accumulator's layout is
// the A fragment's), and V is read MN-major from the same tile through the
// transpose bit.  Each warpgroup runs S, its softmax and P V in sequence,
// so the softmax is not hidden behind the products; FA3's ping-pong and
// the next tile's S issued before this one's P V were both slower here (9
// warps get 168 registers a thread; measured alternatives at the loop).
// The helpers are shared with the backward (attention_tma.cuh,
// hopper.cuh); tensor maps are encoded at each launch and passed as
// __grid_constant__ (legal under stream capture), and a barrier wait past
// ~17 s traps.
//
// What the design does (bf16, short: fa_mma_kernel): FA2's structure on the
// warp tensor-core product mma.sync.m16n8k16 (bf16 in, f32 accumulate). The
// query rows of one (batch, kv head) are flattened as in the Pallas kernel, r =
// q_pos * G + g (position major, group head minor), so the K/V tile a CTA
// stages serves every query head that reads it; a CTA takes 64 rows (4 warps x
// 16) and walks 64-key tiles of K and V, staged in shared memory by 16-byte
// cp.async in two stages (the next tile loads while this one is used), rows
// padded by 8 bf16 so that ldmatrix hits no bank twice.  Key tiles wholly past
// the CTA's last query position (causal) or wholly before its first position's
// window are skipped, which is exact; without causal every walk runs to Skv
// (whisper's encoder: 24 tiles of 64 keys for every CTA of 64 positions at G =
// 1).  Q's fragments are loaded once with ldmatrix and stay in registers; S = Q
// K^T takes K's fragments by ldmatrix, O += P V takes V's by ldmatrix.trans.
// Scores are scaled after the dot (log2(e) folded in, exp2), masked keys score
// -1e30, never -inf (a row that meets a fully masked tile first accumulates
// junk that the next real tile's correction exp(m - m_new) wipes exactly, as in
// the reference), keys past Skv score -inf and weigh exactly 0.  The online
// softmax runs in registers: each thread owns two rows of its warp's 16, row
// max by shuffles within a quad, and the S accumulators are rounded to bf16
// straight into P's A fragments (no shared-memory round trip).  O is 16 x D f32
// per warp in registers, divided by max(l, 1e-30) and stored as bf16x2.  D <=
// 128 with D % 8 == 0 (16-byte rows), zero-padded to a multiple of 32 in shared
// memory.
// f32 (fa_kernel, only reached by the card-versus-CPU checks) stays on the
// CUDA cores: TF32 would break the reference's 2e-4 f32 tolerance.  One CTA
// per (batch, kv head, BQ query positions x G heads <= 16 rows), each lane
// scoring one key of a 32-key tile with a D-long dot from shared memory.
// Training: with a non-null ``lse`` both kernels also write each row's
// log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural
// units, f32, (B, Sq, Hq): the statistic the backward kernels
// (flash_attention_bwd.cu) rebuild the softmax weights from.  The store is
// a template flag (LSE) in both tensor-core kernels, so serving's calls
// (null) run instances compiled exactly as they were before it existed.
#include <climits>

#include "attention_tma.cuh"

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

// ---------------------------------------------------------------------------
// bf16, long: warpgroup tensor-core kernel (wgmma.mma_async fed by TMA)
// ---------------------------------------------------------------------------

// bf16 calls with at least this many query rows take fa_wgmma_kernel,
// shorter ones fa_mma_kernel (the Python wrapper's fwd_route mirrors it):
// where the measured sweep of Sq crosses (causal, B = 4) at qwen2-7b's
// heads (28 / 4 of 128) and at whisper's (8 / 8 of 64)
constexpr int FA_WGMMA_MIN_SQ = 256;       // D > 64
constexpr int FA_WGMMA_MIN_SQ_D64 = 768;   // D <= 64

bool wgmma_route(int Sq, int D) {
  return Sq >= (D > 64 ? FA_WGMMA_MIN_SQ : FA_WGMMA_MIN_SQ_D64);
}

// A CTA owns 128 query rows of one head (64 a consumer warpgroup), Q
// resident, and streams the BN-key K / V tiles its rows see through a ring
// of STAGES: at D > 64 (DC = 2) tiles of 128 keys in 2 stages, one CTA an
// SM; at D <= 64 tiles of 64 keys in 4 stages, two CTAs an SM (the 64 x
// 128 S of a 128-key tile would not fit the registers two CTAs leave)
template <int DC>
struct FwdCfg {
  static constexpr int BN = DC == 2 ? 128 : 64;  // keys a tile
  static constexpr int Q_BYTES = 2 * DC * BOX;   // 128 query rows
  static constexpr int KV_BYTES = DC * BN * 128; // BN keys of K (or V)
  static constexpr int STAGES = DC == 2 ? 2 : 4;
  static constexpr int STAGE = 2 * KV_BYTES;     // K, then V
  static constexpr size_t SMEM = 1024 + (size_t)Q_BYTES +
                                 (size_t)STAGES * STAGE +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
};

// 2^x, x <= 0, by the special-function unit (MUFU.EX2) alone, results
// below 2^-126 flushed to 0 (exp2f adds the handling of subnormal
// results): a weight that small is nothing beside the row's largest (1) in
// the f32 sum and in P's bf16
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid (128-row query tiles x Hq x B), one dimension, the longest causal
// walks first; FB_THREADS threads: consumer warpgroups 0 and 1, the
// producer warp; DC = ceil(D / 64) column boxes a row; tq a map of 64-row
// boxes, tk / tv of BN-row boxes (a column box of a K or V tile is BN
// swizzled lines, the next at BN * 128 bytes); LSE: write each row's LSE
template <int DC, bool LSE>
__global__ void __launch_bounds__(FB_THREADS, DC == 1 ? 2 : 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int B, int Sq, int Skv, int Hq,
                int Hkv, int D, int window, int causal, float scale_log2) {
  using Cfg = FwdCfg<DC>;
  constexpr int BN = Cfg::BN, NJ = BN / 8;   // 8-key column groups of S
  constexpr uint32_t CB = BN * 128;          // bytes of a K / V column box
  // the dynamic shared memory's base, 1024-aligned for the swizzle (the
  // array is declared as fa_mma_kernel declares it)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ring = base + Cfg::Q_BYTES;
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
  // the keys that a row of this tile can see, from a multiple of BN
  const int q_last = min(q0 + 128, Sq) - 1;
  const int k_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / BN * BN;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

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
      mbar_expect_tx(qbar, Cfg::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < DC; ++c)
          tma_load_4d(qs + (w * DC + c) * BOX, &tq, qbar, 64 * c, hq,
                      q0 + 64 * w, b);
      for (int t = 0; t < n_t; ++t) {
        const int s = t % Cfg::STAGES, k0 = k_lo + t * BN;
        mbar_wait(empty(s), ((t / Cfg::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), Cfg::STAGE);
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(ks(s) + c * CB, &tk, full(s), 64 * c, h, k0, b);
          tma_load_4d(vs(s) + c * CB, &tv, full(s), 64 * c, h, k0, b);
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
  const uint32_t qw = qs + wg * DC * BOX;
  float acc[32 * DC];                 // O: rows qa, qb x columns 8n + 2 t4
#pragma unroll
  for (int i = 0; i < 32 * DC; ++i) acc[i] = 0.f;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;   // l: this thread's columns
  float sc[BN / 2];                   // S of the tile in hand
  uint32_t pa[BN / 4];                // its P, the A operand of O += P V
  // Each warpgroup runs its tiles in sequence: S, its softmax, then P V,
  // each product waited for.  Measured against it at qwen2-7b's training
  // shape (NVIDIA H100 80GB HBM3, 700 W; profiling/flash_attention_ab):
  // FA3's ping-pong of the two warpgroups on named barriers (1.7x slower:
  // S, P and O live together spill at the 168 registers 9 warps get),
  // the next tile's S issued before this one's P V (1.08x slower, 64-key
  // tiles), and Q's fragments held in registers (no gain).

  auto ready = [&](int t) {
    mbar_wait(full(t % Cfg::STAGES), (t / Cfg::STAGES) & 1);
  };
  auto release = [&](int t) {         // the stage is free
    if (threadIdx.x % WG == 0) mbar_arrive(empty(t % Cfg::STAGES));
  };
  // S = Q K^T of tile t, both K-major (m64nBNk16 over 64 DC columns),
  // issued
  auto issue_s = [&](int t) {
    const uint32_t kt = ks(t % Cfg::STAGES);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = smem_desc(qw + c * BOX + kk * 32, 16);
        const uint64_t db = smem_desc(kt + c * CB + kk * 32, 16);
        if constexpr (BN == 128)
          wgmma_n128<0, 0>(sc, da, db);
        else
          wgmma_n64<0, 0>(sc, da, db, c > 0 || kk > 0);
      }
  };
  auto zero_s = [&]() {
    if constexpr (BN == 128) {        // wgmma_n128 always accumulates
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    }
  };
  // O += P V of tile t: V read MN-major from the same tile (the transpose
  // bit), 16 keys (2048 bytes) a slice, the next column box CB bytes on
  auto issue_pv = [&](int t) {
    const uint32_t vt = vs(t % Cfg::STAGES);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = smem_desc(vt + kk * 2048, CB);
      if constexpr (DC == 2)
        wgmma_rs_n128<1>(acc, pa + 4 * kk, db);
      else
        wgmma_rs_n64<1>(acc, pa + 4 * kk, db);
    }
  };
  // the online softmax of tile t's S: scale after the dot, mask unless
  // every key is valid for every row; P = exp2(S - m) rounded once to bf16
  // straight into pa (pair i is (sc[2 i], sc[2 i + 1]), row qa for even
  // i); l updated and O rescaled to the new max before tile t's P V
  auto softmax = [&](int t) {
    const int k0 = k_lo + t * BN;
    const bool all = tile_full(r0, k0, Sq, Skv, window, causal, BN);
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = sc[4 * j + c] * scale_log2;
        if (!all) {
          const int kj = k0 + 8 * j + 2 * t4 + (c & 1);
          const int qi = c < 2 ? qa : qb;
          if (kj >= Skv)
            x = -INFINITY;   // not part of the problem: weight exactly 0
          else if ((causal && kj > qi) || (window > 0 && qi - kj >= window))
            x = NEG;
        }
        sc[4 * j + c] = x;
        if (c < 2)
          mxa = fmaxf(mxa, x);
        else
          mxb = fmaxf(mxb, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad shares a row
      mxa = fmaxf(mxa, __shfl_xor_sync(FULL_MASK, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(FULL_MASK, mxb, off));
    }
    const float ca = exp2_ftz(ma - mxa), cb = exp2_ftz(mb - mxb);
    ma = mxa;
    mb = mxb;
    float psa = 0.f, psb = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const float m = (i & 1) ? mxb : mxa;
      const float p0 = exp2_ftz(sc[2 * i] - m);
      const float p1 = exp2_ftz(sc[2 * i + 1] - m);
      if (i & 1)
        psb += p0 + p1;
      else
        psa += p0 + p1;
      pa[i] = pack_bf16(p0, p1);
    }
    la = la * ca + psa;
    lb = lb * cb + psb;
#pragma unroll
    for (int n = 0; n < 8 * DC; ++n) {
      acc[4 * n] *= ca;
      acc[4 * n + 1] *= ca;
      acc[4 * n + 2] *= cb;
      acc[4 * n + 3] *= cb;
    }
  };

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_t; ++t) {
    ready(t);
    if (tile_any(r0, k_lo + t * BN, Sq, Skv, window, causal, BN)) {
      zero_s();
      wg_fence();
      issue_s(t);
      wg_commit();
      wg_wait<0>();
      fence_acc(sc);
      softmax(t);
      wg_fence();
      issue_pv(t);
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
    }
    release(t);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(FULL_MASK, la, off);
    lb += __shfl_xor_sync(FULL_MASK, lb, off);
  }
  const float inva = 1.f / fmaxf(la, 1e-30f), invb = 1.f / fmaxf(lb, 1e-30f);
  const size_t ra = ((size_t)b * Sq + qa) * Hq + hq;
  const size_t rb = ((size_t)b * Sq + qb) * Hq + hq;
  if (LSE && t4 == 0) {   // m is in log2 units: m ln 2 + log l
    if (qa < Sq) lse[ra] = ma * LN2 + logf(fmaxf(la, 1e-30f));
    if (qb < Sq) lse[rb] = mb * LN2 + logf(fmaxf(lb, 1e-30f));
  }
  bf16* oa = o + ra * D;
  bf16* ob = o + rb * D;
#pragma unroll
  for (int n = 0; n < 8 * DC; ++n) {
    const int col = n * 8 + 2 * t4;
    if (n * 8 >= D) break;
    if (qa < Sq)
      *reinterpret_cast<uint32_t*>(oa + col) =
          pack_bf16(acc[4 * n] * inva, acc[4 * n + 1] * inva);
    if (qb < Sq)
      *reinterpret_cast<uint32_t*>(ob + col) =
          pack_bf16(acc[4 * n + 2] * invb, acc[4 * n + 3] * invb);
  }
}

template <int DC, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                 int window, int causal, cudaStream_t stream) {
  constexpr size_t smem = FwdCfg<DC>::SMEM;
  CUtensorMap tq, tk, tv;   // encoded at each launch: legal under capture
  constexpr int BN = FwdCfg<DC>::BN;
  if (!encode_bshd(&tq, q, B, Sq, Hq, D) ||
      !encode_bshd(&tk, k, B, Skv, Hkv, D, BN) ||
      !encode_bshd(&tv, v, B, Skv, Hkv, D, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (int e = allow_smem(fa_wgmma_kernel<DC, LSE>, smem, smem_set)) return e;
  const long long n = (long long)((Sq + 127) / 128) * Hq * B;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fa_wgmma_kernel<DC, LSE><<<(unsigned)n, FB_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, B, Sq, Skv, Hq, Hkv, D, window,
      causal, LOG2E / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                   int window, int causal, cudaStream_t s) {
#define FA_WG(DC)                                                            \
  return lse ? launch_wgmma<DC, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,   \
                                      D, window, causal, s)                   \
             : launch_wgmma<DC, false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,  \
                                       D, window, causal, s)
  if (D <= 64) FA_WG(1);
  FA_WG(2);
#undef FA_WG
}

// the checks shared by the entry points (the Python wrapper checks the same
// first): shapes, the dtype, and for bf16 D % 8 == 0 and 16-byte aligned
// operands (16-byte rows, TMA's strides)
bool bad_args(const void* q, const void* k, const void* v, const void* o,
              int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return B < 1 || Sq < 1 || Skv < 1 || D < 1 || D > 128 || Hkv < 1 ||
         Hq % Hkv != 0 || Hq / Hkv > ROWS ||
         (dtype != DT_F32 && dtype != DT_BF16) ||
         (dtype == DT_BF16 && (D % 8 != 0 || (bits & 15) != 0));
}

}  // namespace

// Limits checked by the Python wrapper: D <= 128, Hq % Hkv == 0,
// Hq / Hkv <= 16; bf16 also D % 8 == 0 and 16-byte aligned pointers.
// window <= 0 means no window; causal != 0 masks the keys past each
// query's position.  f32 runs fa_kernel; bf16 fa_wgmma_kernel from
// FA_WGMMA_MIN_SQ query rows (FA_WGMMA_MIN_SQ_D64 at D <= 64),
// fa_mma_kernel below.  lse: null, or f32 (B, Sq, Hq) for each row's
// log-sum-exp (training).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int window, int causal, int dtype,
                         void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return dispatch_d<float>(q, k, v, o, lse_f, B, Sq, Skv, Hq, Hkv, D,
                             window, causal != 0, s);
  if (wgmma_route(Sq, D))
    return dispatch_wgmma(q, k, v, o, lse_f, B, Sq, Skv, Hq, Hkv, D, window,
                          causal != 0, s);
  return dispatch_mma(q, k, v, o, lse_f, B, Sq, Skv, Hq, Hkv, D, window,
                      causal != 0, s);
}

// fa_launch with the bf16 route forced, whatever Sq (the two routes timed
// and held on the same inputs): fa_wgmma_kernel, or fa_mma_kernel
extern "C" int fa_wgmma_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int Sq, int Skv,
                               int Hq, int Hkv, int D, int window, int causal,
                               int dtype, void* stream) {
  if (dtype != DT_BF16 || bad_args(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_wgmma(q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Hq,
                        Hkv, D, window, causal != 0,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int fa_mma_launch(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Skv,
                             int Hq, int Hkv, int D, int window, int causal,
                             int dtype, void* stream) {
  if (dtype != DT_BF16 || bad_args(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_mma(q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Hq,
                      Hkv, D, window, causal != 0,
                      static_cast<cudaStream_t>(stream));
}

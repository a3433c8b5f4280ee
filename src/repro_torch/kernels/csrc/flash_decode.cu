// Flash decode: one query token per slot against a dense KV cache.
// q (B, Hq, D), caches (B, S, Hkv, D), cur_pos a scalar or (B,) int32
// (positions [0, cur_pos[b]] of slot b are valid), out (B, Hq, D); bf16 or
// f32, f32 scores / softmax state / accumulator.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py::
// flash_decode_pallas (_fd_kernel).  The Pallas kernel streams (bk = 512)-
// row tiles of a (B * Hkv, S, D) transposed copy of the cache through VMEM
// with the kv axis sequential.  Two routes here, both reading the (B, S,
// Hkv, D) cache in place, any S, `splits` CTAs per (slot, kv head) each
// walking one slice of whole 32-row tiles of the positions up to cur_pos[b]
// (and from the first the window reaches), so a partially filled slab costs
// the bytes of its live rows, not of S:
//
// - fd_launch, the template route: the decode template of
//   decode_attention.cuh (design there), shared with the paged kernels.
//   f32, and bf16 shapes TMA cannot read (D % 8 != 0, an operand off 16
//   bytes) or groups of more than 16 query heads, take it.
// - fd_tma_launch, the Hopper route (bf16, D % 8 == 0, D <= 128, G = Hq /
//   Hkv <= 16, k / v 16-byte aligned): fd_tma::kernel below.
//
// What bounds fd_tma::kernel on an H100: bytes.  Each (slot, kv head)
// reads its live K and V rows once and does 4 G D FLOPs a row: at G = 1
// (whisper) 1 FLOP a byte, at G = 8 8, far below the ~295 at which the
// tensor cores would bind; whisper's cross attention (4 x 1500 rows x 8
// heads of 64) is 12.3 MB, 3.7 us at 3.35 TB/s.  The template route keeps
// one 32-row tile (8 KB) in flight a CTA of one warp a query head (at G = 1
// one warp), its next tile issued only once the current one has landed,
// and walks the p V product as 32 serial shuffles a tile.  So the design
// is bytes in flight without registers or instructions, and enough warps
// to consume them:
// - A CTA is 4 consumer warps and one producer warp.  The producer's lane 0
//   keeps a ring of STAGES tiles in flight with TMA (cp.async.bulk.tensor
//   .4d over the (D, Hkv, S, B) view of each cache: DC boxes of 64 columns
//   x 1 head x 32 rows x 1 batch, 128-byte swizzle, 4 KB each; rows past S
//   and columns past D read as zeros), each stage's K and V tiles under a
//   full / empty mbarrier pair: 8 stages of 8 KB at D <= 64, 4 of 16 KB
//   at D <= 128, 64 KB in flight a CTA.
// - The consumer warps take alternate tiles (warp w the tiles t = w mod 4
//   of the slice), each keeping its own online softmax (m, l, acc) per
//   query head, whatever G is: at G = 1 all four warps stream.  The
//   products run on one of two engines, picked by G:
//   consume_mma, the tensor cores, from G = 2: mma.sync m16n8k16 with the
//   G heads as
//   the 16 rows of A (so G <= 16), Q's fragments in registers, K's and V's
//   by ldmatrix(.trans) from their swizzled places, P rounded to bf16 as
//   A: ~130 instructions a warp and tile at D = 128 whatever G is;
//   consume_cores, the CUDA cores, at G = 1: a lane scores one row, and
//   for p V owns 8 columns of a row a step: ~2 D instructions a tile (on
//   more heads, ~2 G D, latency-bound with one consumer warp a scheduler:
//   slower than the tensor cores at every measured G >= 2).
// - The four warps' states merge through shared memory (the idle ring) in
//   warp order, then the splits' states (max m, sum exp(m_i - M) acc_i over
//   sum exp(m_i - M) l_i, in split order): the splits of a (slot, kv head)
//   are one thread-block cluster (splits <= 8, the portable size) and merge
//   through distributed shared memory, each CTA writing its share of the
//   outputs, in one launch (1-2 us less than the template's f32 workspace
//   and second `combine` launch at every measured shape).  No atomics: the
//   same bits on every run.
// - A barrier wait past ~17 s traps (hopper.cuh): a broken pipeline fails
//   the launch, it never hangs.  The tensor maps are encoded at each launch
//   and passed as __grid_constant__ parameters (legal under capture).
// Numerics are the template's and the reference's: masked positions score
// -1e30, scores are q . k in f32 scaled by 1/sqrt(D), p is rounded to bf16
// before p V while l sums the unrounded p, the output divides by max(l,
// 1e-30).
#include <cooperative_groups.h>

#include "decode_attention.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

// cur_stride: 1 for a (B,) cur_pos vector, 0 for one shared scalar.
// window <= 0 means no window.  ws: the (splits, B, Hq, D + 2) f32
// workspace, null iff splits == 1.  Limits: D <= 128, Hq % Hkv == 0,
// Hq / Hkv <= 32.
extern "C" int fd_launch(const void* q, const void* kc, const void* vc,
                         const void* cur_pos, int cur_stride, void* o,
                         void* ws, int B, int Hq, int Hkv, int D, int S,
                         int window, int dtype, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || (cur_stride != 0 && cur_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  decode::Args a{};
  a.q = q;
  a.kp = kc;
  a.vp = vc;
  a.cur = static_cast<const int*>(cur_pos);
  a.cur_stride = cur_stride;
  a.o = o;
  a.ws = static_cast<float*>(ws);
  a.splits = splits;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.bs = 1;
  a.S = S;
  a.window = window;
  a.scale = 1.f / sqrtf((float)D);
  if (dtype == DT_F32)
    return decode::launch<float, float, false, false, true>(a, B, s);
  if (dtype == DT_BF16)
    return decode::launch<__nv_bfloat16, __nv_bfloat16, false, false, true>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace fd_tma {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 32;                    // rows a tile, one a lane
constexpr int CONSUMERS = 4;                // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);   // + the producer warp
constexpr int BOX = ROWS * 128;             // 32 rows x 64 bf16 columns
constexpr int MAX_CLUSTER = 8;              // the portable cluster size
constexpr int MAX_GROUP = 16;               // query heads: mma.sync's 16 rows

// Byte offsets of the dynamic shared memory from its 1024-aligned base.
// The warps' states and the CTA's state reuse the ring once it is idle.
template <int DC, int GM>
struct Smem {
  static constexpr int STAGES = DC == 1 ? 8 : 4;
  static constexpr int TILE = DC * BOX;          // K or V of one tile
  static constexpr int STAGE = 2 * TILE;         // K, then V
  static constexpr int DP = 64 * DC;             // D padded with zeros
  static constexpr int PS = DP + 2;              // a state: acc[DP], m, l
  static constexpr int RING = 0;
  static constexpr int PARTS = 0;                // [warp][GM][PS] f32
  static constexpr int CTA = PARTS + 4 * CONSUMERS * GM * PS;   // [GM][PS]
  static constexpr int QS = RING + STAGES * STAGE;   // [GM][DP] f32
  static constexpr int BARS = QS + 4 * GM * DP;      // full, empty
  static constexpr size_t BYTES = 1024 + BARS + 16 * STAGES;
  static_assert(CTA + 4 * GM * PS <= QS, "states past the ring");
};

struct Args {
  const bf16* q;       // (B, Hq, D)
  const int* cur;      // cur[b * cur_stride]
  bf16* o;             // (B, Hq, D)
  int cur_stride, B, Hq, Hkv, D, S, window, splits;
  float scale;
};

// A consumer warp's view of its CTA's slice: rows [i_lo, i_hi) of the
// walk from position lo, n_t tiles, the warp's tiles t = warp mod 4.
struct Walk {
  int i_lo, i_hi, n_t, lo, cur, window, G;
  float scale;
  // the score of walked row i, masked as the reference masks it
  __device__ __forceinline__ float masked(float s, int i) const {
    const int p = lo + i;
    return i < i_hi && (window <= 0 || p > cur - window) ? s * scale
                                                         : decode::NEG;
  }
};

// the 16 bytes of chunk c (8 columns) of row r of a tile of DC boxes, at
// its swizzled place
__device__ __forceinline__ const unsigned char* chunk_at(
    const unsigned char* tile, int r, int c) {
  return tile + (c / 8) * BOX + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

// The CUDA cores (G = 1): a lane scores one row, the warp reduces max and
// sum by shuffles; for p V a lane owns 8 columns of one row of each step
// (32 / (8 DC) rows a step) and the step's rows are added by shuffles at
// the end.  Writes the warp's state to st[0 ..].
template <int DC>
__device__ __forceinline__ void consume_cores(
    const Walk& w, const unsigned char* ring, uint32_t bars,
    const float* qs, float* st, int warp, int lane) {
  using L = Smem<DC, 1>;
  constexpr int DP = L::DP;
  constexpr int CPR = 8 * DC;           // 16-byte chunks of a row
  constexpr int RPS = 32 / CPR;         // rows of a p V step
  float m = decode::NEG, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const int ch = lane % CPR, rs = lane / CPR;   // p V: chunk, row of a step
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int t = warp; t < w.n_t; t += CONSUMERS) {
    const int s = t % L::STAGES;
    const unsigned char* kt = ring + s * L::STAGE;
    const unsigned char* vt = kt + L::TILE;
    mbar_wait(bars + 8u * s, (t / L::STAGES) & 1);
    const int i = w.i_lo + t * ROWS + lane;     // this lane's row
    const bool exists = i < w.i_hi;
    float sc = 0.f;
#pragma unroll
    for (int c = 0; c < CPR; ++c) {             // K row `lane`, chunk c
      float k[8];
      decode::unpack<bf16>(
          *reinterpret_cast<const uint4*>(chunk_at(kt, lane, c)), k);
      const float4 x = q4[2 * c], y = q4[2 * c + 1];
      sc += x.x * k[0] + x.y * k[1] + x.z * k[2] + x.w * k[3] +
            y.x * k[4] + y.y * k[5] + y.z * k[6] + y.w * k[7];
    }
    const float sg = w.masked(sc, i);
    const float m_new = fmaxf(m, warp_max(exists ? sg : -INFINITY));
    const float pe = exists ? expf(sg - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(pe);
    const float pr = round_to<bf16>(pe);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
    m = m_new;
#pragma unroll
    for (int j = 0; j < ROWS / RPS; ++j) {      // p V, RPS rows a step
      const int r = j * RPS + rs;
      float v[8];
      decode::unpack<bf16>(
          *reinterpret_cast<const uint4*>(chunk_at(vt, r, ch)), v);
      const float pj = __shfl_sync(FULL_MASK, pr, r);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += pj * v[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8u * (L::STAGES + s));   // free
  }
#pragma unroll
  for (int off = CPR; off < 32; off <<= 1)      // a step's rows, in order
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(FULL_MASK, acc[e], off);
  named_sync<1, 32 * CONSUMERS>();   // every warp is off the ring
  if (rs == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) st[ch * 8 + e] = acc[e];
  }
  if (lane == 0) {
    st[DP] = m;
    st[DP + 1] = l;
  }
}

// The tensor cores (G <= 16): mma.sync m16n8k16 with the G heads as the
// 16 rows of A (zeros past G).  S = Q K^T takes Q's fragments from
// registers and K's by ldmatrix; P, rounded to bf16, is S's accumulator
// fragments repacked as A; V's fragments by ldmatrix.trans.  Lane (g, t4)
// holds heads g and g + 8.
template <int DC>
__device__ __forceinline__ void consume_mma(
    const Walk& w, const unsigned char* ring, uint32_t bars,
    const float* qs, float* st, int warp, int lane) {
  using L = Smem<DC, 16>;
  constexpr int DP = L::DP, PS = L::PS;
  constexpr int KS = DP / 16;           // k-steps of S, n-blocks / 2 of O
  const int g = lane / 4, t4 = lane % 4;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* r0 = qs + g * DP + 16 * kk + 2 * t4;
    const float* r1 = r0 + 8 * DP;
    qa[kk][0] = pack_bf16(r0[0], r0[1]);
    qa[kk][1] = pack_bf16(r1[0], r1[1]);
    qa[kk][2] = pack_bf16(r0[8], r0[9]);
    qa[kk][3] = pack_bf16(r1[8], r1[9]);
  }
  float m0 = decode::NEG, m1 = decode::NEG, l0 = 0.f, l1 = 0.f;
  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int t = warp; t < w.n_t; t += CONSUMERS) {
    const int s = t % L::STAGES;
    const unsigned char* kt = ring + s * L::STAGE;
    const unsigned char* vt = kt + L::TILE;
    mbar_wait(bars + 8u * s, (t / L::STAGES) & 1);
    // S: heads x 32 rows, n-block j the rows 8j .. 8j + 7
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < KS / 2; ++k2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];   // rows 8j .. 8j + 7, chunks 4 k2 .. 4 k2 + 3
        ldsm_x4(kb, reinterpret_cast<const bf16*>(chunk_at(
                        kt, 8 * j + (lane & 7), 4 * k2 + (lane >> 3))));
        mma_bf16(sc[j], qa[2 * k2], kb[0], kb[1]);
        mma_bf16(sc[j], qa[2 * k2 + 1], kb[2], kb[3]);
      }
    }
    const int i0 = w.i_lo + t * ROWS;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + 8 * j + 2 * t4 + (c & 1);
        sc[j][c] = w.masked(sc[j][c], i);
        if (i < w.i_hi) {
          if (c < 2) mx0 = fmaxf(mx0, sc[j][c]);
          else mx1 = fmaxf(mx1, sc[j][c]);
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {     // the quad shares a head
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + 8 * j + 2 * t4 + (c & 1);
        const float pe = i < w.i_hi ? expf(sc[j][c] - (c < 2 ? n0 : n1)) : 0.f;
        sc[j][c] = pe;
        if (c < 2) ps0 += pe;
        else ps1 += pe;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(FULL_MASK, ps0, off);
      ps1 += __shfl_xor_sync(FULL_MASK, ps1, off);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // O += P V over the tile's two 16-row halves
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * k2][0], sc[2 * k2][1]),
                              pack_bf16(sc[2 * k2][2], sc[2 * k2][3]),
                              pack_bf16(sc[2 * k2 + 1][0], sc[2 * k2 + 1][1]),
                              pack_bf16(sc[2 * k2 + 1][2], sc[2 * k2 + 1][3])};
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        uint32_t vb[4];   // rows lo | hi of chunk 2 np, then of chunk 2 np + 1
        const int mi = lane >> 3;
        ldsm_x4_trans(vb, reinterpret_cast<const bf16*>(chunk_at(
                              vt, 16 * k2 + (mi & 1) * 8 + (lane & 7),
                              2 * np + (mi >> 1))));
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8u * (L::STAGES + s));   // free
  }
  named_sync<1, 32 * CONSUMERS>();   // every warp is off the ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gg = g + 8 * h;
    if (gg >= w.G) continue;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      st[gg * PS + 8 * n + 2 * t4] = acc[n][2 * h];
      st[gg * PS + 8 * n + 2 * t4 + 1] = acc[n][2 * h + 1];
    }
    if (t4 == 0) {
      st[gg * PS + DP] = h ? m1 : m0;
      st[gg * PS + DP + 1] = h ? l1 : l0;
    }
  }
}

// grid (splits, Hkv, B); the splits of a (slot, kv head) are one
// cluster.  GM >= G: the heads a CTA keeps state for, 1 on the CUDA cores
// (G = 1) and 16 on the tensor cores.
template <int DC, int GM>
__global__ void __launch_bounds__(THREADS)
kernel(const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<DC, GM>;
  constexpr int DP = L::DP, PS = L::PS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);     // the same bytes, generic
  float* qs = reinterpret_cast<float*>(sm + L::QS);
  float* parts = reinterpret_cast<float*>(sm + L::PARTS);
  float* cta = reinterpret_cast<float*>(sm + L::CTA);
  const uint32_t bars = base + L::BARS;            // full[s], then empty[s]

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv, D = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * a.Hq + (size_t)h * G;   // first output row

  for (int i = threadIdx.x; i < GM * DP; i += THREADS) {
    const int g = i / DP, d = i % DP;
    qs[i] = g < G && d < D ? __bfloat162float(a.q[(row0 + g) * D + d]) : 0.f;
  }
  // this CTA's slice [i_lo, i_hi) of the walk [lo, last]: whole tiles
  Walk w;
  w.cur = a.cur[(size_t)b * a.cur_stride];
  w.window = a.window;
  w.G = G;
  w.scale = a.scale;
  const int last = min(w.cur, a.S - 1);
  w.lo = a.window > 0 ? max(0, w.cur - a.window + 1) : 0;
  const int n = max(0, last - w.lo + 1);
  const int per = ((n + ROWS - 1) / ROWS + a.splits - 1) / a.splits;
  w.i_lo = min(n, z * per * ROWS);
  w.i_hi = min(n, (z + 1) * per * ROWS);
  w.n_t = (w.i_hi - w.i_lo + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bars + 8u * s, 1);   // the producer's expect_tx, the bytes
      mbar_init(bars + 8u * (L::STAGES + s), 1);   // the consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // -- the producer: lane 0 keeps the ring's loads in flight ------------
    if (lane == 0) {
      for (int t = 0; t < w.n_t; ++t) {
        const int s = t % L::STAGES, r = w.lo + w.i_lo + t * ROWS;
        const uint32_t full = bars + 8u * s;
        mbar_wait(bars + 8u * (L::STAGES + s), ((t / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(full, L::STAGE);
        const uint32_t ks = base + L::RING + s * L::STAGE;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(ks + c * BOX, &tk, full, 64 * c, h, r, b);
          tma_load_4d(ks + L::TILE + c * BOX, &tv, full, 64 * c, h, r, b);
        }
      }
    }
  } else if constexpr (GM == 1) {
    consume_cores<DC>(w, sm + L::RING, bars, qs, parts + warp * PS, warp,
                      lane);
  } else {
    consume_mma<DC>(w, sm + L::RING, bars, qs, parts + warp * GM * PS, warp,
                    lane);
  }
  __syncthreads();

  // -- the four warps' states merged in warp order -------------------------
  const bool one = a.splits == 1;
  for (int i = threadIdx.x; i < G * DP; i += THREADS) {
    const int g = i / DP, d = i % DP;
    float M = decode::NEG;
#pragma unroll
    for (int k = 0; k < CONSUMERS; ++k)
      M = fmaxf(M, parts[(k * GM + g) * PS + DP]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int k = 0; k < CONSUMERS; ++k) {
      const float* st = parts + (k * GM + g) * PS;
      const float c = expf(st[DP] - M);
      num += c * st[d];
      den += c * st[DP + 1];
    }
    if (one) {
      if (d < D)
        a.o[(row0 + g) * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      cta[g * PS + d] = num;
      if (d == 0) {
        cta[g * PS + DP] = M;
        cta[g * PS + DP + 1] = den;
      }
    }
  }
  if (one) return;

  // -- the splits merged through distributed shared memory, in split
  // order; CTA z writes outputs z, z + splits, ... of the (slot, kv head)
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                         // every CTA's state is written
  for (int i = z * THREADS + threadIdx.x; i < G * DP;
       i += a.splits * THREADS) {
    const int g = i / DP, d = i % DP;
    if (d >= D) continue;
    float M = decode::NEG;
    for (int r = 0; r < a.splits; ++r)
      M = fmaxf(M, cl.map_shared_rank(cta, r)[g * PS + DP]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < a.splits; ++r) {
      const float* st = cl.map_shared_rank(cta, r) + g * PS;
      const float c = expf(st[DP] - M);
      num += c * st[d];
      den += c * st[DP + 1];
    }
    a.o[(row0 + g) * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  cl.sync();                         // no CTA leaves while it is read
}

// the map of a (B, S, H, D) bf16 cache as (D, H, S, B): boxes of 64
// columns x 1 head x 32 rows x 1 batch, 128-byte swizzle; columns past D
// and rows past S read as zeros
bool encode_cache(CUtensorMap* map, const void* p, int B, int S, int H,
                  int D) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)H * D * sizeof(bf16),
                                 (cuuint64_t)S * H * D * sizeof(bf16)};
  const cuuint32_t box[4] = {64u, 1u, (cuuint32_t)ROWS, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DC, int GM>
int run(const CUtensorMap& tk, const CUtensorMap& tv, const Args& a,
        cudaStream_t s) {
  constexpr size_t smem = Smem<DC, GM>::BYTES;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel<DC, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel<DC, GM>, tk, tv, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// the engine by group size: the CUDA cores at G = 1, the tensor cores
// from G = 2 (faster there at every measured shape)
template <int DC>
int dispatch(const CUtensorMap& tk, const CUtensorMap& tv, const Args& a,
             int G, cudaStream_t s) {
  return G == 1 ? run<DC, 1>(tk, tv, a, s) : run<DC, MAX_GROUP>(tk, tv, a, s);
}

}  // namespace fd_tma

// The Hopper route, bf16 only: the products on the CUDA cores at G = 1,
// else on the tensor cores (G <= 16).  The splits of a (slot, kv
// head) merge in one cluster: 1 <= splits <= 8.  cur_stride and window as
// fd_launch's.  Limits: D % 8 == 0, D <= 128, Hq % Hkv == 0, k and v
// 16-byte aligned.
extern "C" int fd_tma_launch(const void* q, const void* kc, const void* vc,
                             const void* cur_pos, int cur_stride, void* o,
                             int B, int Hq, int Hkv, int D, int S, int window,
                             int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(kc) |
                         reinterpret_cast<uintptr_t>(vc);
  if (S < 1 || B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || D < 8 ||
      D > 128 || D % 8 != 0 || Hq % Hkv != 0 ||
      Hq / Hkv > fd_tma::MAX_GROUP ||
      (bits & 15) != 0 || (cur_stride != 0 && cur_stride != 1) ||
      splits < 1 || splits > fd_tma::MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  if (!fd_tma::encode_cache(&tk, kc, B, S, Hkv, D) ||
      !fd_tma::encode_cache(&tv, vc, B, S, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  fd_tma::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cur = static_cast<const int*>(cur_pos);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.cur_stride = cur_stride;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.S = S;
  a.window = window;
  a.splits = splits;
  a.scale = 1.f / sqrtf((float)D);
  const int G = Hq / Hkv;
  return D <= 64 ? fd_tma::dispatch<1>(tk, tv, a, G, s)
                 : fd_tma::dispatch<2>(tk, tv, a, G, s);
}

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
//   VEC    16-byte staging: a row of D elements of P is a whole number of
//          16-byte chunks and both pools are 16-byte aligned (bf16: D % 8
//          == 0, f32: D % 4, int8 / e4m3: D % 16; so D = 16 and 128 take
//          it, D = 20 does not in bf16 or the packed types);
//   DPL    ceil(D / 32) rounded up to 1, 2 or 4: the output elements each
//          lane owns.
//
// What bounds every variant on an H100: bytes.  Each (slot, kv head) reads
// its context's K and V rows once and does 4 * G * D FLOPs per row (G = 7
// at qwen2-7b): ~7 FLOP per bf16 byte, ~28 per packed byte, far below the
// ~295 (bf16) or ~590 (int8/fp8) FLOP per byte at which the tensor cores
// would bind.
//
// The design (flash-decoding): the walk of each (slot, kv head) is split
// over gridDim.z CTAs ("splits", planned on the host from the launch's
// static shapes by kernels/decode_split.py), so B * Hkv * splits CTAs
// share the 132 SMs where one CTA per pair left 16 of them busy.  Each CTA
// has one warp per query head of the GQA group, so every row read from
// HBM serves all G heads from shared memory.  A CTA works out its walk
// length n on the device (from cur, the window's first block and, under
// KEEP, the compacted kept blocks), takes its contiguous slice of whole
// 32-row tiles of [0, n) (ceil(tiles / splits) tiles each, in order), and
// walks it.  First it loads once what addressing needs: its table row
// (block ids and, for packed pages, the per-(block, head) scales) and the
// current rows.  With a keep mask, warp 0 also compacts all kept block ids
// (ballot + popc); the slice is taken over those blocks' rows, so dropped
// blocks are never read.
//
// Under VEC each tile's K and V rows arrive by 16-byte cp.async into a
// two-stage buffer (rows padded by 16 bytes, so lanes reading 16 bytes of
// consecutive rows hit distinct banks), the next tile in flight while this
// one is scored; the warps take whole rows, the lanes a row's chunks.
// Float pages are scored straight from that buffer (rows past the end are
// zero-filled), one barrier a tile; packed pages are first converted to T
// in a second buffer (packed value * scale in f32, rounded to T as the
// reference's model path rounds its gathered view), by the threads that
// copied them.  Without VEC the rows are read element by element into the
// T buffer.  Each lane scores one position (16-byte reads, f32 sums), the
// warp reduces max and sum by shuffles, and each lane owns DPL output
// elements for the p @ v update.
//
// With one split the CTA writes the output; with more, each writes its
// unnormalised (acc[D], m, l) to an f32 workspace and `combine` merges them
// in split order: M = max m_i, out = sum exp(m_i - M) acc_i / max(sum
// exp(m_i - M) l_i, 1e-30).  No atomics, so the result is the same on
// every run.  An empty slice writes m = -1e30 and l = 0 (never -inf, which
// would make the combine NaN).  Numerics are the reference's: masked
// positions score -1e30, scores are q . k in f32 scaled by 1/sqrt(D), p is
// rounded to T before p @ v while l sums the unrounded p, and the output
// divides by max(l, 1e-30).
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
  float* ws;            // (splits, B, Hq, D + 2) f32 partials; null iff splits == 1
  int cur_stride, B, Hq, Hkv, D, bs, T, S, window, splits;
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

// the 16 / sizeof(P) elements of one 16-byte chunk, as f32
template <typename P> __device__ __forceinline__ void unpack(const uint4& u, float* x);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* x) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* x) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // bf16 is the top half of an f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void unpack<int8_t>(const uint4& u, float* x) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
}
template <> __device__ __forceinline__ void unpack<__nv_fp8_e4m3>(const uint4& u, float* x) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    x[i] = static_cast<float>(f);
  }
}

// N consecutive elements of T in shared memory as f32, in one read
// (N * sizeof(T)-byte aligned)
template <typename T, int N> struct Wide;
template <> struct Wide<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
};
template <> struct Wide<float, 2> {
  __device__ static void load(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
};
template <> struct Wide<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
template <> struct Wide<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};
template <> struct Wide<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Wide<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  }
};

// N (a multiple of 16 / sizeof(T)) f32 values stored as T, 16 bytes a store
template <typename T, int N>
__device__ __forceinline__ void store16(T* dst, const float* x) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(x[8 * i + 2 * k], x[8 * i + 2 * k + 1]);
        w[k] = *reinterpret_cast<const unsigned*>(&h);
      }
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Byte offsets of the dynamic shared memory, the same on host and device.
template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, bool VEC>
struct Smem {
  // row strides in elements: the cp.async buffer RS (P), the T tile TS,
  // q's f32 rows QS; under VEC each is padded by 16 bytes, so 16-byte
  // reads of consecutive rows by 8 lanes fall on distinct banks
  __host__ __device__ static int rs(int D) { return D + 16 / (int)sizeof(P); }
  __host__ __device__ static int ts(int D) {
    return VEC ? D + 16 / (int)sizeof(T) : D + 1;
  }
  __host__ __device__ static int qs_stride(int D) { return VEC ? D + 4 : D + 1; }
  // float pages under VEC are scored in the cp.async buffer itself
  static constexpr bool TILE = QUANT || !VEC;
  size_t raw, tile, qs, rows, scales, blk, kept, bytes;
  __host__ __device__ Smem(int G, int D, int T_) {
    size_t o = 0;
    raw = o;      // [stage][K | V][KT][RS] P (VEC), 16-byte aligned (first)
    o += VEC ? sizeof(P) * 2 * 2 * KT * rs(D) : 0;
    tile = o;     // [K | V][KT][TS] T: the converted tile
    o += TILE ? sizeof(T) * 2 * KT * ts(D) : 0;
    o = (o + 15) / 16 * 16;
    qs = o;       // [G][QS] f32
    o += sizeof(float) * G * qs_stride(D);
    rows = o;     // [K | V][D] f32: the current rows (QUANT)
    o += QUANT ? sizeof(float) * 2 * D : 0;
    scales = o;   // [K | V][T] f32: each table entry's scale (QUANT)
    o += QUANT && !DENSE ? sizeof(float) * 2 * T_ : 0;
    blk = o;      // [T] block ids (paged)
    o += DENSE ? 0 : sizeof(int) * T_;
    kept = o;     // [T] kept table entries (KEEP)
    o += KEEP ? sizeof(int) * T_ : 0;
    bytes = o;
  }
};

template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, bool VEC,
          int DPL>
__global__ void __launch_bounds__(1024) kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Layout = Smem<T, P, QUANT, KEEP, DENSE, VEC>;
  const int D = a.D, RS = Layout::rs(D), TS = Layout::ts(D);
  const int QS = Layout::qs_stride(D);
  const int G = a.Hq / a.Hkv, Hkv = a.Hkv, bs = a.bs;
  const Layout L(G, D, a.T);
  P* raw = reinterpret_cast<P*>(smem + L.raw);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  float* scl = reinterpret_cast<float*>(smem + L.scales);
  int* blkid = reinterpret_cast<int*>(smem + L.blk);
  int* kept = reinterpret_cast<int*>(smem + L.kept);
  __shared__ int n_kept;
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;   // one warp per head
  const T* q = static_cast<const T*>(a.q);
  const P* kp = static_cast<const P*>(a.kp);
  const P* vp = static_cast<const P*>(a.vp);
  const bool has_row = QUANT && a.k_row != nullptr;

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int gg = i / D, d = i % D;
    qs[gg * QS + d] = to_f<T>(q[((size_t)b * a.Hq + h * G + gg) * D + d]);
  }
  if (has_row) {
    for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
      const T* r = static_cast<const T*>(i < D ? a.k_row : a.v_row);
      rows[i] = to_f<T>(r[((size_t)b * Hkv + h) * D + i % D]);
    }
  }
  if (!DENSE) {
    for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
      const int blk = a.tables[(size_t)b * a.T + t];
      blkid[t] = blk;
      if (QUANT) {
        scl[t] = a.ks[(size_t)blk * Hkv + h];
        scl[a.T + t] = a.vs[(size_t)blk * Hkv + h];
      }
    }
  }
  const int cur = a.cur[(size_t)b * a.cur_stride];
  const int span = DENSE ? a.S : a.T * bs;   // the view ends at T * bs (or S)
  const int last = min(cur, span - 1);
  int lo = a.window > 0 ? max(0, cur - a.window + 1) : 0;
  if (!DENSE) lo = (lo / bs) * bs;           // from the first block the window reaches
  if (KEEP && threadIdx.x < 32) {            // warp 0 compacts the kept blocks
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
  const int n = KEEP ? n_kept * bs : last - lo + 1;   // positions walked
  // logical position of the i-th walked row, or -1 past the end
  auto pos_of = [&](int i) -> int {
    if (i >= n) return -1;
    const int p = KEEP ? kept[i / bs] * bs + i % bs : lo + i;
    return p <= last ? p : -1;
  };
  // the pool row (in units of D elements) holding position p
  auto row_of = [&](int p) -> size_t {
    if (DENSE) return ((size_t)b * a.S + p) * Hkv + h;
    return ((size_t)blkid[p / bs] * bs + p % bs) * Hkv + h;
  };

  // Under VEC a row's K and V are CH = 2 * CPR 16-byte chunks.  Warp g
  // takes rows g * RPP + sub, stepping by G * RPP, where RPP rows share a
  // warp when a row has fewer than 32 chunks (lane = sub * CH + chunk);
  // the thread that copies a chunk also converts it.
  constexpr int CW = 16 / sizeof(P);         // elements per chunk
  const int CH = VEC ? 2 * (D / CW) : 32;   // (unused without VEC)
  const int RPP = CH >= 32 ? 1 : 32 / CH;
  const int sub = CH >= 32 ? 0 : lane / CH;
  const int c0 = CH >= 32 ? lane : lane % CH, cstep = CH >= 32 ? 32 : CH;
  auto kv_raw = [&](int st, int v, int j) {  // row j of K (v = 0) or V
    return raw + (((size_t)st * 2 + v) * KT + j) * RS;
  };
  auto issue = [&](int i0, int st) {         // cp.async of tile i0 into stage st
    if (sub < RPP) {
      for (int j = g * RPP + sub; j < KT; j += G * RPP) {
        const int p = pos_of(i0 + j);
        const bool row = has_row && p == cur;
        if (QUANT && (p < 0 || row)) continue;   // converted from elsewhere
        const size_t src = p >= 0 ? row_of(p) * D : 0;
        for (int c = c0; c < CH; c += cstep) {
          const int v = c >= CH / 2, cc = (c - v * (CH / 2)) * CW;
          // float pages: rows past the end are zero-filled, never stale
          cp_async16(kv_raw(st, v, j) + cc, (v ? vp : kp) + src + cc, p >= 0);
        }
      }
    }
    cp_async_commit();
  };
  // the T tile: K rows then V rows, TS elements apart
  auto stage = [&](int i0, int st) {
    if constexpr (VEC) {                     // packed: convert this thread's chunks
      if (sub < RPP) {
        for (int j = g * RPP + sub; j < KT; j += G * RPP) {
          const int p = pos_of(i0 + j);
          const bool row = has_row && p == cur;
          float sk = 1.f, sv = 1.f;
          if (p >= 0) {
            sk = scl[p / bs];
            sv = scl[a.T + p / bs];
          }
          for (int c = c0; c < CH; c += cstep) {
            const int v = c >= CH / 2, cc = (c - v * (CH / 2)) * CW;
            float x[CW];
            if (p < 0) {
#pragma unroll
              for (int e = 0; e < CW; ++e) x[e] = 0.f;
            } else if (row) {
#pragma unroll
              for (int e = 0; e < CW; ++e) x[e] = rows[v * D + cc + e];
            } else {
              unpack<P>(*reinterpret_cast<const uint4*>(kv_raw(st, v, j) + cc), x);
              const float sc = v ? sv : sk;
#pragma unroll
              for (int e = 0; e < CW; ++e) x[e] = round_to<T>(x[e] * sc);
            }
            store16<T, CW>(tile + ((size_t)v * KT + j) * TS + cc, x);
          }
        }
      }
    } else {                                 // element by element from HBM
      for (int i = threadIdx.x; i < KT * D; i += blockDim.x) {
        const int j = i / D, d = i % D;
        const int p = pos_of(i0 + j);
        float kv = 0.f, vv = 0.f;
        if (p >= 0) {
          if (has_row && p == cur) {
            kv = rows[d];
            vv = rows[D + d];
          } else {
            const size_t r = row_of(p) * D + d;
            kv = load_f<P>(kp[r]);
            vv = load_f<P>(vp[r]);
            if (QUANT) {
              kv = round_to<T>(kv * scl[p / bs]);
              vv = round_to<T>(vv * scl[a.T + p / bs]);
            }
          }
        }
        tile[j * TS + d] = from_f<T>(kv);
        tile[(KT + j) * TS + d] = from_f<T>(vv);
      }
    }
  };

  // this CTA's slice [i_lo, i_hi) of the walk: whole tiles, in order
  const int per = ((n + KT - 1) / KT + a.splits - 1) / a.splits;
  const int i_lo = min(n, z * per * KT), i_hi = min(n, (z + 1) * per * KT);

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  if (VEC && i_lo < i_hi) issue(i_lo, 0);
  int st = 0;
  for (int i0 = i_lo; i0 < i_hi; i0 += KT, st ^= 1) {
    if (VEC) cp_async_wait<0>();   // this thread's chunks of tile i0
    __syncthreads();                // ... everyone's; the last tile is consumed
    if (VEC && i0 + KT < i_hi) issue(i0 + KT, st ^ 1);
    const T* kt;                    // the tile's K and V rows, `ts` apart
    const T* vt;
    int ts;
    if constexpr (Layout::TILE) {
      stage(i0, st);
      __syncthreads();
      kt = tile;
      vt = tile + (size_t)KT * TS;
      ts = TS;
    } else {
      kt = reinterpret_cast<const T*>(kv_raw(st, 0, 0));
      vt = reinterpret_cast<const T*>(kv_raw(st, 1, 0));
      ts = RS;
    }

    const int p = pos_of(i0 + lane);
    const bool exists = p >= 0;      // rows past the end: masked, contribute 0
    float dot = 0.f;
    if constexpr (VEC) {             // 16-byte reads, four partial sums
      constexpr int EW = 16 / sizeof(T);
      const float4* qr = reinterpret_cast<const float4*>(qs + g * QS);
      const uint4* kr = reinterpret_cast<const uint4*>(kt + (size_t)lane * ts);
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int c = 0; c < D / EW; ++c) {
        float k[EW];
        unpack<T>(kr[c], k);
#pragma unroll
        for (int e = 0; e < EW / 4; ++e) {
          const float4 x = qr[c * (EW / 4) + e];
          s4.x += x.x * k[4 * e];
          s4.y += x.y * k[4 * e + 1];
          s4.z += x.z * k[4 * e + 2];
          s4.w += x.w * k[4 * e + 3];
        }
      }
      dot = (s4.x + s4.y) + (s4.z + s4.w);
    } else {
      for (int d = 0; d < D; ++d)
        dot += qs[g * QS + d] * to_f<T>(kt[(size_t)lane * ts + d]);
    }
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
      if (VEC) {                     // DPL contiguous elements, one read
        if (lane * DPL < D) {
          float v[DPL];
          Wide<T, DPL>::load(vt + (size_t)j * ts + lane * DPL, v);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[e] += pj * v[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[e] += pj * to_f<T>(vt[(size_t)j * ts + d]);
        }
      }
    }
    m = m_new;
  }

  // the output element of acc[e]: lane * DPL + e under VEC, else
  // lane + 32 * e
  auto col = [&](int e) { return VEC ? lane * DPL + e : lane + 32 * e; };
  const size_t r = (size_t)b * a.Hq + h * G + g;   // output row
  if (a.ws == nullptr) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(a.o) + r * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = col(e);
      if (d < D) orow[d] = from_f<T>(acc[e] * inv);
    }
  } else {
    float* w = a.ws + ((size_t)z * a.B * a.Hq + r) * (D + 2);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = col(e);
      if (d < D) w[d] = acc[e];
    }
    if (lane == 0) {
      w[D] = m;
      w[D + 1] = l;
    }
  }
}

// The splits' partials of one output row (b, hq) merged in split order,
// in f32, then cast to T.  One CTA per row, one thread per element.
template <typename T>
__global__ void combine(const float* ws, void* o, int splits, int rows,
                        int D) {
  const int r = blockIdx.x;
  const size_t stride = (size_t)rows * (D + 2);      // one split's partials
  const float* w = ws + (size_t)r * (D + 2);
  float M = NEG;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, w[s * stride + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ws_s = w + s * stride;
      const float c = expf(ws_s[D] - M);
      num += c * ws_s[d];
      den += c * ws_s[D + 1];
    }
    static_cast<T*>(o)[(size_t)r * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, bool VEC,
          int DPL>
int launch_dpl(const Args& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = Smem<T, P, QUANT, KEEP, DENSE, VEC>(G, a.D, a.T).bytes;
  auto fn = kernel<T, P, QUANT, KEEP, DENSE, VEC, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<dim3(a.Hkv, B, a.splits), G * 32, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  combine<T><<<B * a.Hq, 32 * ((a.D + 31) / 32), 0, stream>>>(
      a.ws, a.o, a.splits, B * a.Hq, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE, int DPL>
int launch_vec(const Args& a, int B, cudaStream_t s) {
  const bool vec = (a.D * sizeof(P)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.vp) % 16 == 0;
  return vec ? launch_dpl<T, P, QUANT, KEEP, DENSE, true, DPL>(a, B, s)
             : launch_dpl<T, P, QUANT, KEEP, DENSE, false, DPL>(a, B, s);
}

// Dispatch on D; limits (checked here and by the Python wrappers): 1 <= D
// <= 128, Hq % Hkv == 0, Hq / Hkv <= 32, 1 <= splits <= 65535, and a
// workspace exactly when splits > 1.
template <typename T, typename P, bool QUANT, bool KEEP, bool DENSE>
int launch(const Args& a, int B, cudaStream_t s) {
  if (a.D < 1 || a.D > 128 || a.Hkv < 1 || a.Hq % a.Hkv != 0 ||
      a.Hq / a.Hkv > 32 || B < 1 || B != a.B || a.splits < 1 ||
      a.splits > 65535 || (a.splits > 1) != (a.ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= 32) return launch_vec<T, P, QUANT, KEEP, DENSE, 1>(a, B, s);
  if (a.D <= 64) return launch_vec<T, P, QUANT, KEEP, DENSE, 2>(a, B, s);
  return launch_vec<T, P, QUANT, KEEP, DENSE, 4>(a, B, s);
}

}  // namespace decode

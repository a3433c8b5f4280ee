// C = A @ B on Hopper's warpgroup tensor cores: bf16 operands read by TMA
// where they lie, an f32 accumulator in registers, rounded once to bf16.
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul_pallas (_mm_kernel),
// at training's sizes (the plan's `wgmma` route, kernels/matmul/plan.py:
// bf16, M >= 256, every operand TMA-legal); mm_mma (matmul.cu) keeps
// decode, prefill waves and misaligned operands.
//
// What bounds it on an H100: operations.  At M >= 256 a product does 2 M
// FLOPs per element of B it reads, at or above the ~295 FLOP/byte where
// the card's bf16 tensor cores, not HBM, set the pace (at M = 4096: 8,192
// FLOP/byte), and only wgmma on 64-row warpgroups reaches their rate
// (mma.sync m16n8k16, mm_mma's instruction, reached 244 TFLOP/s here).
// What the design does about it:
//  * a CTA owns a 128 x BN output tile (BN 256, or 128 where 256-wide
//    tiles leave SMs idle; the plan picks), two consumer warpgroups of 64
//    rows each issuing wgmma.mma_async m64nBNk16 into BN / 2 f32 registers
//    a thread (setmaxnreg 232), and one producer warp (setmaxnreg 40) that
//    keeps TMA loads (cp.async.bulk.tensor.2d, 128-byte swizzle) in flight
//    into a ring of STAGES stages of 64 K rows, paced by mbarrier full /
//    empty pairs: no thread spends an instruction on an address, and the
//    tensor cores wait on no __syncthreads;
//  * each operand is read as it lies in memory: a row-major matrix or the
//    .t() view of one.  wgmma reads a 16-bit operand from shared memory
//    K-major or MN-major (its transpose bits), and the TMA box is cut from
//    the operand's own lines, so a transposed operand costs no copy:
//    A (M, K) row-major is K-major, its .t() view (A^T of a (K, M) matrix)
//    MN-major; B (K, N) row-major is MN-major, the .t() view of an (N, K)
//    matrix K-major.  Shared memory holds, a stage: A as 128 rows of 64 K
//    (K-major, one box) or two 64-row atoms of 64 K lines (MN-major); B
//    as BN rows of 64 K (K-major, one box) or BN / 64 atoms of 64 K lines
//    of 64 columns (MN-major), every line 128 bytes, swizzled by TMA;
//  * the tiles are walked in bands of WG_BAND row tiles, rows fastest, so
//    a wave of 132 CTAs reads about 16 row tiles of A and 8 column tiles
//    of B, and the operands are read from HBM about once per band;
//  * split K where the tiles leave SMs idle: each split writes f32 partial
//    sums to the caller's workspace and split_reduce (common.cuh) adds
//    them in split order, so the result does not depend on CTA timing;
//  * the epilogue rounds each sum once to bf16 into the freed ring and
//    stores whole 16-byte chunks, a warp a row, the ragged edges masked
//    (a split writes its f32 sums from registers); TMA fills rows, columns
//    and K rows past the operand with zeros, so nothing else needs a mask.
// The tensor maps are encoded on the host at each launch (libcuda's
// cuTensorMapEncodeTiled, reached through the runtime's entry-point
// query: nothing links libcuda) and passed by value as __grid_constant__
// parameters, so a launch captured in a CUDA graph carries its own maps.
// A launch allocates nothing and synchronises nothing.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_BM = 128;        // rows a CTA: two consumer warpgroups
constexpr int WG_BK = 64;         // K rows a stage: 128 bytes of bf16
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;   // consumers 0-255, the producer's 256-383
constexpr int WG_BAND = 16;       // row tiles a band of the tile walk
constexpr int ATOM = 64 * 128;    // bytes of 64 lines of 128 bytes

template <int BN>
struct WgCfg {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;      // 16 KB
  static constexpr int B_BYTES = BN * WG_BK * 2;         // 32 or 16 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ACC = BN / 2;                     // f32 a thread
  // the ring, 1024-byte aligned (the swizzle's period), then the barriers
  static constexpr size_t SMEM =
      1024 + (size_t)WG_STAGES * STAGE + 2 * WG_STAGES * sizeof(uint64_t);
  static_assert(BN == 128 || BN == 256, "BN");
  static_assert(STAGE % 1024 == 0, "stage alignment");
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// grid (row tiles x column tiles, 1, splits); split z owns K rows
// [z * rows, min(K, (z + 1) * rows)), rows a multiple of WG_BK when splits
// > 1.  A_MN: A is read M-major (the .t() view of a row-major matrix);
// B_MN: B is read N-major (row-major B).  ta / tb: the operands' tensor
// maps, boxes as the file's head describes.
template <int BN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(WG_THREADS, 1)
mm_wgmma(const __grid_constant__ CUtensorMap ta,
         const __grid_constant__ CUtensorMap tb, bf16* __restrict__ C,
         float* __restrict__ ws, int M, int N, int K, int rows) {
  using Cfg = WgCfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + WG_STAGES * Cfg::STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (WG_STAGES + s); };
  auto stage_a = [&](int s) { return base + (uint32_t)(s * Cfg::STAGE); };
  auto stage_b = [&](int s) { return stage_a(s) + Cfg::A_BYTES; };

  // the tile walk: bands of WG_BAND row tiles, rows fastest in a band
  const int m_tiles = (M + WG_BM - 1) / WG_BM, n_tiles = (N + BN - 1) / BN;
  const int band = WG_BAND * n_tiles;
  const int first = (int)(blockIdx.x / band) * WG_BAND;
  const int in_band = min(WG_BAND, m_tiles - first);
  const int local = (int)(blockIdx.x % band);
  const int m0 = (first + local % in_band) * WG_BM;
  const int n0 = (local / in_band) * BN;
  const int k_begin = blockIdx.z * rows;
  const int k_end = min(K, k_begin + rows);
  const int steps = (k_end - k_begin + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);    // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- the producer: one thread keeps the ring's loads in flight --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(empty(s), ((t / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), Cfg::STAGE);
        const int k0 = k_begin + t * WG_BK;
        if constexpr (A_MN) {
          tma_load(stage_a(s), &ta, full(s), m0, k0);
          tma_load(stage_a(s) + ATOM, &ta, full(s), m0 + 64, k0);
        } else {
          tma_load(stage_a(s), &ta, full(s), k0, m0);
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(stage_b(s) + j * ATOM, &tb, full(s), n0 + 64 * j, k0);
        } else {
          tma_load(stage_b(s), &tb, full(s), k0, n0);
        }
      }
    }
  } else {
    // -- two consumers: rows [64 wg, 64 wg + 64) of the tile ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[Cfg::ACC];
#pragma unroll
    for (int i = 0; i < Cfg::ACC; ++i) acc[i] = 0.f;
    for (int t = 0; t < steps; ++t) {
      const int s = t % WG_STAGES;
      mbar_wait(full(s), (t / WG_STAGES) & 1);
      fence_acc(acc);
      // the warpgroup's 64 rows of A: 64 lines of K (K-major) or one atom
      // of 64 K lines (MN-major); a 16-deep K slice is 32 bytes along a
      // K-major line or 16 lines of an MN-major atom
      const uint32_t a0 = stage_a(s) + wg * ATOM, b0 = stage_b(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = A_MN ? smem_desc(a0 + kk * 2048, ATOM)
                                 : smem_desc(a0 + kk * 32, 16);
        const uint64_t db = B_MN ? smem_desc(b0 + kk * 2048, ATOM)
                                 : smem_desc(b0 + kk * 32, 16);
        wgmma_tile<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      wg_commit();
      wg_wait<1>();              // step t - 1's products are done ...
      fence_acc(acc);
      if (t > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty((t - 1) % WG_STAGES));   // ... its stage is free
    }
    wg_wait<0>();
    fence_acc(acc);

    // thread holds rows r, r + 8 and columns 8 j + 2 (lane % 4) + {0, 1}
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;
    if (gridDim.z == 1) {
      // bf16 through shared memory, stored as whole 16-byte chunks: once
      // both consumers are past their last wgmma the ring is free; each
      // warpgroup rounds its 64 x BN outputs into rows padded by 16 bytes
      // (no bank taken twice), then writes them out a row per warp
      constexpr int LD = BN * 2 + 16;            // bytes a staged row
      constexpr int CPR = BN / 8, RPP = 128 / CPR;   // chunks a row, rows
                                                     // a pass
      named_sync<1, 256>();
      unsigned char* tile =
          smem_raw + (base - smem_addr(smem_raw)) + wg * 64 * LD;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              tile + (r0 + 8 * h) * LD + (8 * j + 2 * (lane % 4)) * 2) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (wg == 0)   // each warpgroup's rows, its own barrier
        named_sync<2, 128>();
      else
        named_sync<3, 128>();
      const int t = threadIdx.x % 128, cc = t % CPR;
      const int col = n0 + 8 * cc;
      const bool vec =
          N % 8 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
      for (int r = t / CPR; r < 64; r += RPP) {
        const int row = m0 + wg * 64 + r;
        if (row >= M || col >= N) continue;
        const uint4 v =
            *reinterpret_cast<const uint4*>(tile + r * LD + 16 * cc);
        bf16* c = C + (size_t)row * N + col;
        if (vec && col + 8 <= N) {
          *reinterpret_cast<uint4*>(c) = v;
        } else {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (col + i < N)
              c[i] = __ushort_as_bfloat16(
                  (unsigned short)(w[i / 2] >> (16 * (i % 2))));
        }
      }
    } else {
      // f32 partial sums of this split into the workspace, a pair at a
      // time where it is 8-byte aligned
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;
        const bool two = col + 1 < N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wg * 64 + r0 + 8 * h;
          if (row >= M) continue;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          const size_t at = ((size_t)blockIdx.z * M + row) * N + col;
          if (two && at % 2 == 0) {
            *reinterpret_cast<float2*>(ws + at) = make_float2(x, y);
          } else {
            ws[at] = x;
            if (two) ws[at + 1] = y;
          }
        }
      }
    }
  }
}

// -- host --------------------------------------------------------------------
// the map of a bf16 operand as it lies in memory: `outer` lines of `inner`
// contiguous elements, `ld` elements apart; boxes of box_inner (64: one
// 128-byte swizzle line) x box_outer lines; zeros past the edges
bool encode(CUtensorMap* map, const void* p, int inner, int outer, int ld,
            int box_outer) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool A_MN, bool B_MN>
cudaError_t launch_wgmma(const void* a, const void* b, bf16* C, float* ws,
                         int M, int N, int K, int lda, int ldb, int splits,
                         int rows, cudaStream_t s) {
  using Cfg = WgCfg<BN>;
  CUtensorMap ta, tb;
  const bool ok_a = A_MN ? encode(&ta, a, M, K, lda, 64)
                         : encode(&ta, a, K, M, lda, WG_BM);
  const bool ok_b = B_MN ? encode(&tb, b, N, K, ldb, 64)
                         : encode(&tb, b, K, N, ldb, BN);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  static bool smem_set = false;   // above 48 KB needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_wgmma<BN, A_MN, B_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const long tiles = (long)((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN);
  dim3 grid((unsigned)tiles, 1, splits);
  mm_wgmma<BN, A_MN, B_MN><<<grid, WG_THREADS, Cfg::SMEM, s>>>(
      ta, tb, C, ws, M, N, K, rows);
  return cudaSuccess;
}

template <int BN>
cudaError_t launch_wgmma(bool a_mn, bool b_mn, const void* a, const void* b,
                         bf16* C, float* ws, int M, int N, int K, int lda,
                         int ldb, int splits, int rows, cudaStream_t s) {
  if (a_mn && b_mn)
    return launch_wgmma<BN, true, true>(a, b, C, ws, M, N, K, lda, ldb,
                                        splits, rows, s);
  if (a_mn)
    return launch_wgmma<BN, true, false>(a, b, C, ws, M, N, K, lda, ldb,
                                         splits, rows, s);
  if (b_mn)
    return launch_wgmma<BN, false, true>(a, b, C, ws, M, N, K, lda, ldb,
                                         splits, rows, s);
  return launch_wgmma<BN, false, false>(a, b, C, ws, M, N, K, lda, ldb,
                                        splits, rows, s);
}

}  // namespace

// C (M, N) = A (M, K) @ B (K, N), bf16, on `stream` by the wrapper's plan
// (kernels/matmul/plan.py, route wgmma).  A: a_mn == 0 row-major (element
// (m, k) at a[m * lda + k]), 1 the .t() view of a row-major (K, M) matrix
// (at a[k * lda + m]); B: b_mn == 1 row-major (b[k * ldb + n]), 0 the .t()
// view of a row-major (N, K) matrix (b[n * ldb + k]).  Both bases 16-byte
// aligned, lda / ldb multiples of 8 and at least a line; C row-major (M, N),
// 4-byte aligned; bn 128 or 256 columns a CTA; K split into `splits`
// ranges of `rows` rows (a multiple of 64 when splits > 1; the last may be
// shorter, none empty); ws: (splits, M, N) f32 scratch, unused when splits
// == 1.  Anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int mm_wgmma_run(const void* a, const void* b, void* c, void* ws,
                            int M, int N, int K, int lda, int ldb, int a_mn,
                            int b_mn, int bn, int splits, int rows,
                            void* stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                  pb = reinterpret_cast<uintptr_t>(b),
                  pc = reinterpret_cast<uintptr_t>(c);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || rows < 1 ||
      (long)rows * splits < K || (long)rows * (splits - 1) >= K ||
      (splits > 1 && (ws == nullptr || rows % WG_BK != 0)) || pa % 16 ||
      pb % 16 || pc % 4 || lda % 8 || ldb % 8 || lda < (a_mn ? M : K) ||
      ldb < (b_mn ? N : K) || (bn != 128 && bn != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* C = static_cast<bf16*>(c);
  float* w = static_cast<float*>(ws);
  const cudaError_t e =
      bn == 256 ? launch_wgmma<256>(a_mn != 0, b_mn != 0, a, b, C, w, M, N,
                                    K, lda, ldb, splits, rows, s)
                : launch_wgmma<128>(a_mn != 0, b_mn != 0, a, b, C, w, M, N,
                                    K, lda, ldb, splits, rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) launch_split_reduce<bf16>(w, C, splits, (size_t)M * N, s);
  return static_cast<int>(cudaGetLastError());
}

// C = A @ B on Hopper's warpgroup tensor cores: bf16 operands read by TMA
// where they lie, an f32 accumulator in registers, rounded once to bf16.
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul_pallas (_mm_kernel),
// at training's sizes (the plan's `wgmma` route, kernels/matmul/plan.py:
// bf16, M >= 256, every operand TMA-legal); mm_stream below takes the
// prefill waves' and refills' wide products (17-255 rows), mm_mma
// (matmul.cu) decode, the rest and misaligned operands.
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

// one stage's TMA loads onto barrier `bar`: A's 128 rows x 64 K at (m0,
// k0) into sa (MN-major: the second 64-row atom only where `a_hi`; K-major:
// the rows of the map's box), B's 64 K x BN columns at (k0, n0) into sb,
// boxes as the file's head describes
template <int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(uint32_t sa, uint32_t sb,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint32_t bar, int m0, int n0,
                                           int k0, bool a_hi = true) {
  if constexpr (A_MN) {
    tma_load(sa, ta, bar, m0, k0);
    if (a_hi) tma_load(sa + ATOM, ta, bar, m0 + 64, k0);
  } else {
    tma_load(sa, ta, bar, k0, m0);
  }
  if constexpr (B_MN) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load(sb + j * ATOM, tb, bar, n0 + 64 * j, k0);
  } else {
    tma_load(sb, tb, bar, k0, n0);
  }
}

// one stage's products issued into acc (committed, not waited for): the
// warpgroup's 64 rows of A at a0, 64 lines of K (K-major) or one atom of
// 64 K lines (MN-major), B at b0; a 16-deep K slice is 32 bytes along a
// K-major line or 16 lines of an MN-major atom
template <int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a0,
                                          uint32_t b0) {
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
}

// a warpgroup's 64 x BN sums rounded once to bf16 into `tile`, rows
// BN * 2 + 16 bytes apart (no bank taken twice): the thread holds rows r0,
// r0 + 8 and columns 8 j + 2 (lane % 4) + {0, 1}
template <int BN>
__device__ __forceinline__ void stage_bf16(const float (&acc)[BN / 2],
                                           unsigned char* tile, int r0,
                                           int lane) {
  constexpr int LD = BN * 2 + 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          tile + (r0 + 8 * h) * LD + (8 * j + 2 * (lane % 4)) * 2) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// the staged rows out to C rows row0 .. row0 + 63, columns from n0, as
// whole 16-byte chunks a row per warp (t: the thread in its warpgroup),
// the ragged edges masked
template <int BN>
__device__ __forceinline__ void store_staged(const unsigned char* tile,
                                             bf16* __restrict__ C, int M,
                                             int N, int row0, int n0,
                                             int t) {
  constexpr int LD = BN * 2 + 16;
  constexpr int CPR = BN / 8, RPP = 128 / CPR;   // chunks a row, rows a pass
  const int cc = t % CPR;
  const int col = n0 + 8 * cc;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  for (int r = t / CPR; r < 64; r += RPP) {
    const int row = row0 + r;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * LD + 16 * cc);
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
        load_stage<BN, A_MN, B_MN>(stage_a(s), stage_b(s), &ta, &tb, full(s),
                                   m0, n0, k_begin + t * WG_BK);
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
      mma_stage<BN, A_MN, B_MN>(acc, stage_a(s) + wg * ATOM, stage_b(s));
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
      // warpgroup stages its 64 rows there, then writes them out
      named_sync<1, 256>();
      unsigned char* tile = smem_raw + (base - smem_addr(smem_raw)) +
                            wg * 64 * (BN * 2 + 16);
      stage_bf16<BN>(acc, tile, r0, lane);
      if (wg == 0)   // each warpgroup's rows, its own barrier
        named_sync<2, 128>();
      else
        named_sync<3, 128>();
      store_staged<BN>(tile, C, M, N, m0 + wg * 64, n0, threadIdx.x % 128);
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

// -- the stream route: mm_stream, bytes-bound products of 17-255 rows -------
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul_pallas (_mm_kernel)
// at the serving prefill waves' and refills' sizes (the plan's `stream`
// route, `stream_takes`: bf16, 17-255 rows, K from 1024, 16 column tiles
// or, under 65 rows, one an SM, operands TMA-legal), where mm_mma
// (matmul.cu, mma.sync fed by cp.async) ran them before; short and narrow
// products (k / v, mamba2's) stay on mm_mma, faster there (the sweep).
//
// What bounds it on an H100: bytes.  At M = 128 a product does 128 FLOPs
// per byte of B, below the ~295 FLOP/byte where the tensor cores would
// set the pace, so the floor is B's bytes over HBM's 3.35 TB/s.  Two
// things kept mm_mma off it: mma.sync's ~244 TFLOP/s puts an MLP
// product's arithmetic above its bytes, and 128 x 128 tiles, one CTA
// each, leave SMs idle or carry a tail (148 tiles on 132 SMs) unless K is
// split through a workspace and a second launch.  What the design does:
//  * wgmma.mma_async on the same ring, producer warp and descriptors as
//    mm_wgmma (the operands read in place, row-major or .t() views), so the
//    arithmetic sits well under the bytes; a consumer warpgroup whose 64
//    rows all lie past M (M <= 64) issues no products, and where M fits
//    one row tile a row-major A's box holds only its rows (rounded up to
//    8, the swizzle's period), so no stage moves the zeros past M;
//  * a persistent grid of `ctas` CTAs, one an SM, over the flattened
//    (tile, K step) units, tiles column-major and each tile's K steps in
//    order (stream-K): CTA c walks units [c U / ctas, (c + 1) U / ctas), so
//    every SM streams the same weight bytes to within one K step, and the
//    producer's loads run on across tile ends, under the epilogues;
//  * a tile whose K steps CTAs lo .. hi share is summed in the kernel, in
//    share order, so the sum does not depend on which CTA ends first: each
//    of lo + 1 .. hi writes its f32 partial to its slot of the workspace
//    (one a CTA: only a share's first tile can be another's) and counts
//    itself in on the tile's counter; lo, whose share ends with the tile's
//    first K steps, waits for the count at the end of its share (the
//    others wrote theirs at the start of theirs, or end with it), adds the
//    slots to its own sums, rounds and stores the tile, and sets the
//    counter back to 0 for the next launch (the counters are a static
//    array of the module, zeroed when it is loaded on a card, before any
//    launch: no capture or first launch has to make them), so a launch is
//    the same inside a CUDA graph replay.  Launches on one card share the
//    counters, so they run one after another, on one stream (as the
//    serving path issues them); two in flight at once on two streams would
//    count into each other's tiles.  The grid is one CTA an SM at most,
//    all resident together, so the wait always ends;
//  * the epilogue rounds once to bf16 through a staging tile of its own
//    (the ring stays in flight) and stores whole 16-byte chunks.
// Tiles are 128 x 128: 256 columns (half of A's reads from L2 a weight
// byte, twice the partials) measured slower at every wave shape, and so
// did a deeper ring without the staging tile.
constexpr int SK_THREADS = 384;   // consumers 0-255, the producer's 256-383
constexpr int SK_TILES = 4096;    // the most tiles a launch (plan.py's)

// one counter a tile, 0 between launches; per card, zeroed at load
__device__ unsigned sk_counters[SK_TILES];

struct SkCfg {
  static constexpr int BN = 128;                         // columns a tile
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;      // 16 KB
  static constexpr int B_BYTES = BN * WG_BK * 2;         // 16 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = 5;                       // 80 KB of B
  static constexpr int ACC = BN / 2;                     // f32 a thread
  static constexpr int LD = BN * 2 + 16;                 // a staged row
  static constexpr int OUT = WG_BM * LD;                 // the staging tile
  // the ring (1024-byte aligned), the staging tile, the barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + OUT +
                                 2 * STAGES * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "shared memory");
};

// the CTA whose share holds unit u: the largest c with c U / G <= u
__device__ __forceinline__ int sk_owner(long long u, long long units,
                                        int ctas) {
  return (int)(((u + 1) * ctas + units - 1) / units) - 1;
}

// one more on a tile's counter, after this CTA's writes before it (a
// barrier among the writers first: their writes are then this thread's)
__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
      : "memory");
}

// until the counter reaches `want`, the writes counted in visible; a wait
// past WATCHDOG cycles traps, as a barrier's does
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned want) {
  const long long t0 = clock64();
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    if (v >= want) return;
    if (clock64() - t0 > WATCHDOG) __trap();
  }
}

// grid (ctas); ws: a slot of `slot` floats a CTA (its first tile's
// partial), the consumers' fragments of the rows below M, float4 by
// float4; the tiles' counters in sk_counters; a_bytes: A's bytes a stage
// (its box rows x 128, or one or two atoms)
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(SK_THREADS, 1)
mm_stream(const __grid_constant__ CUtensorMap ta,
          const __grid_constant__ CUtensorMap tb, bf16* __restrict__ C,
          float* __restrict__ ws, int M, int N, int K, int slot,
          int a_bytes) {
  unsigned* const cnt = sk_counters;
  using Cfg = SkCfg;
  constexpr int ST = Cfg::STAGES, BN = Cfg::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t out = base + ST * Cfg::STAGE;
  const uint32_t bars = out + Cfg::OUT;
  unsigned char* staged = smem_raw + (out - smem_addr(smem_raw));
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (ST + s); };
  auto stage_a = [&](int s) { return base + (uint32_t)(s * Cfg::STAGE); };
  auto stage_b = [&](int s) { return stage_a(s) + Cfg::A_BYTES; };

  const int m_tiles = (M + WG_BM - 1) / WG_BM;
  const int steps = (K + WG_BK - 1) / WG_BK;
  const long long units =
      (long long)m_tiles * ((N + BN - 1) / BN) * steps;
  const int ctas = (int)gridDim.x;
  const long long u0 = (long long)blockIdx.x * units / ctas;
  const long long u1 = (long long)(blockIdx.x + 1) * units / ctas;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- the producer: every unit of the share, across tile ends ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&ta) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tb) : "memory");
      int t = 0;
      for (long long u = u0; u < u1; ++u, ++t) {
        const long long tile = u / steps;
        const int m0 = (int)(tile % m_tiles) * WG_BM;
        const int n0 = (int)(tile / m_tiles) * BN;
        const int k0 = (int)(u % steps) * WG_BK;
        const int s = t % ST;
        mbar_wait(empty(s), ((t / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), a_bytes + Cfg::B_BYTES);
        load_stage<BN, A_MN, B_MN>(stage_a(s), stage_b(s), &ta, &tb, full(s),
                                   m0, n0, k0, a_bytes > ATOM);
      }
    }
    return;
  }

  // -- two consumers: rows [64 wg, 64 wg + 64) of each tile ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 16 + lane / 4;   // in the warpgroup's rows
  const int per = slot / Cfg::ACC;             // float4s a fragment index
  float acc[Cfg::ACC];
  int t = 0;
  for (long long u = u0; u < u1;) {
    const long long tile = u / steps;
    const int m0 = (int)(tile % m_tiles) * WG_BM;
    const int n0 = (int)(tile / m_tiles) * BN;
    const int ks = (int)(u % steps);
    const int ke = (int)min((long long)steps, ks + (u1 - u));
    const bool rows = m0 + 64 * wg < M;         // this warpgroup's rows
#pragma unroll
    for (int i = 0; i < Cfg::ACC; ++i) acc[i] = 0.f;
    for (int k = ks; k < ke; ++k, ++t) {
      const int s = t % ST;
      mbar_wait(full(s), (t / ST) & 1);
      if (rows) {
        fence_acc(acc);
        mma_stage<BN, A_MN, B_MN>(acc, stage_a(s) + wg * ATOM, stage_b(s));
        wg_wait<1>();            // step k - 1's products are done ...
        fence_acc(acc);
      }
      if (k > ks && threadIdx.x % 128 == 0)
        mbar_arrive(empty((t - 1) % ST));   // ... its stage is free
    }
    if (rows) {
      wg_wait<0>();
      fence_acc(acc);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(empty((t - 1) % ST));
    u += ke - ks;

    if (ks != 0 || ke != steps) {
      // -- a shared tile: CTAs lo .. hi hold its K steps in share order --
      const int c = (int)blockIdx.x;
      const int lo = sk_owner(tile * steps, units, ctas);
      const int hi = sk_owner(tile * steps + steps - 1, units, ctas);
      const bool mine = m0 + 16 * warp < M;     // this warp's 16 rows
      if (c != lo) {
        // its partial into the CTA's slot, then counted in on the tile
        float4* own = reinterpret_cast<float4*>(ws + (size_t)c * slot);
        if (mine)
#pragma unroll
          for (int i = 0; i < Cfg::ACC / 4; ++i)
            __stcg(own + i * per + threadIdx.x,
                   make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                               acc[4 * i + 3]));
        named_sync<1, 256>();
        if (threadIdx.x == 0) red_release(cnt + tile);
        continue;
      }
      // lo, at the end of its share: the others' partials added to its
      // own in share order, once all hi - lo are counted in
      if (threadIdx.x == 0) {
        wait_count(cnt + tile, (unsigned)(hi - lo));
        cnt[tile] = 0u;                // ready for the next launch
      }
      named_sync<1, 256>();
      if (mine)
        for (int cc = lo + 1; cc <= hi; ++cc) {
          const float4* p =
              reinterpret_cast<const float4*>(ws + (size_t)cc * slot);
#pragma unroll
          for (int i = 0; i < Cfg::ACC / 4; ++i) {
            const float4 v = __ldcg(p + i * per + threadIdx.x);
            acc[4 * i] += v.x, acc[4 * i + 1] += v.y;
            acc[4 * i + 2] += v.z, acc[4 * i + 3] += v.w;
          }
        }
    }
    if (!rows) continue;

    // -- the tile's sums, rounded once, through the staging tile ----------
    unsigned char* out_rows = staged + wg * 64 * Cfg::LD;
    if (wg == 0)       // the last tile's rows are out of the staging tile
      named_sync<2, 128>();
    else
      named_sync<3, 128>();
    stage_bf16<BN>(acc, out_rows, r0, lane);
    if (wg == 0)
      named_sync<2, 128>();
    else
      named_sync<3, 128>();
    store_staged<BN>(out_rows, C, M, N, m0 + wg * 64, n0, threadIdx.x % 128);
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

template <bool A_MN, bool B_MN>
cudaError_t launch_stream(const void* a, const void* b, bf16* C, float* ws,
                          int M, int N, int K, int lda, int ldb, int ctas,
                          int slot, cudaStream_t s) {
  // A's box: where M fits one row tile, only its rows (K-major: rounded
  // up to 8, the swizzle's period; MN-major: the 64-row atoms holding them)
  const int a_rows = M > WG_BM ? WG_BM
                     : A_MN    ? (M + 63) / 64 * 64
                               : (M + 7) / 8 * 8;
  CUtensorMap ta, tb;
  const bool ok_a = A_MN ? encode(&ta, a, M, K, lda, 64)
                         : encode(&ta, a, K, M, lda, a_rows);
  const bool ok_b = B_MN ? encode(&tb, b, N, K, ldb, 64)
                         : encode(&tb, b, K, N, ldb, SkCfg::BN);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_stream<A_MN, B_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SkCfg::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  mm_stream<A_MN, B_MN><<<ctas, SK_THREADS, SkCfg::SMEM, s>>>(
      ta, tb, C, ws, M, N, K, slot, a_rows * WG_BK * 2);
  return cudaSuccess;
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

// C (M, N) = A (M, K) @ B (K, N), bf16, on `stream` by the wrapper's plan
// (kernels/matmul/plan.py, route stream): operands as mm_wgmma_run takes
// them; tiles of 128 x 128; ctas CTAs, at most one a unit and one an SM
// (all resident at once); ws: ctas slots of `slot` floats, slot = 64 x 32
// x the warps with rows (min(8, ceil(min(M, 128) / 16))); at most
// SK_TILES tiles.  Launches on one card run one after another (they share
// the tiles' counters).  Anything else returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int mm_stream_run(const void* a, const void* b, void* c, void* ws,
                             int M, int N, int K, int lda, int ldb, int a_mn,
                             int b_mn, int ctas, void* stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                  pb = reinterpret_cast<uintptr_t>(b),
                  pc = reinterpret_cast<uintptr_t>(c);
  constexpr int bn = SkCfg::BN;
  if (M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + bn - 1) / bn);
  const long long units = tiles * ((K + WG_BK - 1) / WG_BK);
  const int warps = (min(M, WG_BM) + 15) / 16;
  int dev = 0, sms = 0;   // lo waits on the others: all resident at once
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ctas < 1 || ctas > units || ctas > sms || tiles > SK_TILES ||
      ws == nullptr || pa % 16 || pb % 16 || pc % 4 || lda % 8 || ldb % 8 ||
      lda < (a_mn ? M : K) || ldb < (b_mn ? N : K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* C = static_cast<bf16*>(c);
  float* w = static_cast<float*>(ws);
  const int slot = bn / 2 * 32 * warps;
  const cudaError_t e =
      a_mn && b_mn ? launch_stream<true, true>(a, b, C, w, M, N, K, lda,
                                               ldb, ctas, slot, s)
      : a_mn       ? launch_stream<true, false>(a, b, C, w, M, N, K, lda,
                                                ldb, ctas, slot, s)
      : b_mn       ? launch_stream<false, true>(a, b, C, w, M, N, K, lda,
                                                ldb, ctas, slot, s)
                   : launch_stream<false, false>(a, b, C, w, M, N, K, lda,
                                                 ldb, ctas, slot, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

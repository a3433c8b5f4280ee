// Convolution as an implicit GEMM: y = conv(x, w), VALID, stride s, over an
// already padded NHWC input x (N, Hp, Wp, C) and HWIO weights w (kh, kw,
// C, K), f32 accumulation, output NHWC (N, Ho, Wo, K) in the input dtype
// (bf16 or f32).
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::conv2d_pallas (_conv_kernel).
//
// The GEMM view: rows m = (n, ho, wo), M = N*Ho*Wo; columns k, K = Cout;
// depth r = (i, j, c), R = kh*kw*C.  A[m, r] = x[n, ho*s + i, wo*s + j, c]
// is gathered on the fly and never written out (no im2col in HBM, as in
// the Pallas kernel); w is already the row-major (R, K) matrix B; y is the
// row-major (M, K) matrix C.
//
// What bounds it on an H100: operations, 2*M*K*R of them.  At batch 64 the
// 3x3 / 5x5 / 7x7 convs and the wide 1x1s of the paper's CNNs do 60-600
// FLOPs per byte they must move.  On the tensor cores bf16 takes 2*M*K*R /
// 989 TFLOP/s; f32 runs as three bf16 passes, 3 x that (ResNet-50's 53
// convs at batch 64: bf16 0.50 ms of products, 0.94 ms with the bytes of
// the 1x1s that HBM bounds; f32 1.50 and 2.17 ms).  On the CUDA cores
// (cuda_core route) f32 FMAs at 67 TFLOP/s.
//
// The route, column tile and R split come from the wrapper's shapes-only
// plan (kernels/conv2d/plan.py), which this file checks and never
// overrides:
//  * wgmma (C a whole 128-byte line of channels: 64 bf16 / 32 f32; K % 8
//    == 0; x, w, y 16-byte aligned; stride <= 8; of these all bf16 and the
//    f32 convs with R > 64, the measured crossing): conv_wgmma<T, BN>
//    below, on Hopper's warpgroup tensor cores fed by TMA.  A 128 x BN
//    output tile a CTA (BN 64, 128 or 256 by K), two consumer warpgroups
//    of 64 rows issuing wgmma.mma_async, a producer keeping loads in
//    flight through an mbarrier ring.  A depth step is one tap's 128-byte
//    channel line: A, 128 output pixels x that line, comes from one TMA
//    load in im2col mode (the map's bounding box is the window corners,
//    traversed at the stride across output rows and images; the tap is the
//    load's im2col offset; zeros past the last image), or for a 1x1 conv
//    at stride 1 from x's (M, C) matrix by a tiled load laid out the same
//    way; B is the (R, K) weights read in place, MN-major through wgmma's
//    transpose bit.  BN 256 and f32 at 128 run one CTA an SM (384 threads,
//    setmaxnreg), f32 at 128 walking the tiles persistently, its output
//    staged past the ring while the producer loads the next tile; BN 64
//    and bf16 at 128 two CTAs an SM (288 threads), so that one CTA's
//    loads and epilogue overlap the other's products.
//    - bf16: both operands from shared memory, rounded once.
//    - f32: three bf16 passes in the order below (a_lo*b_hi + a_hi*b_lo +
//      a_hi*b_hi): A's fragments read from the swizzled f32 tile and split
//      in registers (wgmma's register-A form), the weights split once a
//      launch by split_weights into a bf16 hi / lo scratch after the
//      split's partial sums in the caller's workspace.  At ResNet-50's
//      shapes its outputs equal conv_mma's bit for bit: the same products
//      in the same order into f32 accumulators (conv2d_ab).
//  * mma (bf16 with C % 8 == 0, f32 with C % 4 == 0; K % 8 == 0; x, w, y
//    16-byte aligned; what wgmma does not take: GoogLeNet's channel counts
//    that fill no whole line, f32 convs of R <= 64): conv_mma<T, BN>, a
//    128 x BN output tile per CTA (BN 64 or 128 by K), 4 warps of 64 x
//    BN/2.  Each thread finds its output
//    pixel's corner in x once (a table of the CTA's 128 row bases in shared
//    memory).  A depth step is 128 bytes a row (64 bf16 or 32 f32): each
//    16-byte chunk of the A tile is 8 bf16 or 4 f32 channels of one tap
//    (i, j) of one pixel, gathered straight from x by cp.async.cg; B rows
//    as mm_mma stages them.  Rows past M, columns past K and depth past the
//    split's end are zero-filled by cp.async's src-size operand.  A ring of
//    3-4 stages in <= 112 KB, so two CTAs share an SM (at ResNet-50's
//    shapes a 256-row, 8-warp tile, one CTA an SM, ran 0-15 % slower, and
//    8 warps of 32 rows up to 19 % slower in f32, 1-8 % faster in bf16);
//    rows padded so the fragment reads hit no bank twice.  The output tile,
//    rounded to T, goes through shared memory and out in 16-byte chunks,
//    whole sectors (bf16 fragments' 4-byte stores fill half of one).
//    - bf16: A fragments by ldmatrix.x4, B's by ldmatrix.x4.trans,
//      mma.sync m16n8k16 bf16 x bf16 -> f32, rounded once (nearest even).
//    - f32: the fragments are read at their m16n8k16 positions (A by
//      64-bit, B by 32-bit loads; ldmatrix cannot split an f32) and split
//      in registers into hi = bf16(v) and lo = bf16(v - hi); three
//      mma.sync into one f32 accumulator: a_lo*b_hi + a_hi*b_lo +
//      a_hi*b_hi (jax's Precision.HIGH: "3 bfloat16 passes").
//      Error: v - hi is exact in f32 and |v - hi - lo| <= 2^-16 |v|, and
//      each bf16 product is exact in f32, so a product a*b carries at most
//      (2^-16 + 2^-16 + 2^-16) |a*b| (the dropped a_lo*b_lo and the two
//      residues) against f32's 2^-24: the sum over R is off by at most
//      ~4.6e-5 * sum |a*b| plus f32's own rounding.  Emulated in float64
//      at 3x3 convs with C = 64 and 512, He-scaled weights: max |err| =
//      2.0-2.1e-5 x rms(out), under a tenth of the reference's 2e-4.  The
//      named alternative, 3xTF32 on mma.sync.m16n8k8.tf32 (~2e-7 x rms),
//      runs at half this rate; it is not needed at these shapes.
//  * cuda_core (everything else: the C = 3 stems, ragged channel counts,
//    misaligned operands): conv_igemm below, f32 FMAs, 128 x 64 tiles,
//    no split.
//  * Split R (wgmma, mma): where the output tiles leave the SMs' CTA slots
//    idle, the depth is split over gridDim.z CTAs that write f32 partial
//    sums to a workspace the caller allocates; split_reduce (common.cuh)
//    adds them in split order (bitwise deterministic) and rounds once.
// A launch allocates nothing and synchronises nothing; wgmma's tensor maps
// are encoded on the host at each launch and passed as __grid_constant__
// parameters, so a launch captured in a CUDA graph carries its own.  M (up
// to 3.2 M rows at batch 64) is walked by a linear CTA index, column tiles
// fastest, so the CTAs on the card at one time share their A rows;
// offsets into x, y and the workspace are 64-bit (VGG-16's first
// activations at batch 64 are 822 MB).
//
// Next (left out here): the three eager scale / shift / ReLU passes after
// each conv fused into the epilogue; the SAME pad copies removed (TMA's
// im2col load zero-fills out-of-image taps: a bounding box with negative
// corners); the C = 3 stems on the tensor cores (0.56-0.59 ms of a
// ResNet-50 forward's convs on conv_igemm); a TMA-store epilogue, so that
// the products of a persistent CTA's next tile start before its stores.
#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

// -- CUDA cores (conv_igemm, the first kernel) ------------------------------
// 128 threads, each owning an 8 x 8 register micro-tile of a 128 x 64 output
// tile; R walked in chunks of 16 staged in registers while the previous
// chunk is consumed; bf16 widened to f32 as it is staged; 16-byte vector
// loads where C % 16 == 0 (one tap a chunk) and K % 8 == 0, a scalar gather
// otherwise; ragged edges masked.
namespace cc {

constexpr int BM = 128, BN = 64, BK = 16;   // CTA tile and depth chunk
constexpr int THREADS = 128;                // 16 row lanes x 8 column lanes

struct Geom {
  int M, K, R;                 // GEMM rows, columns, depth
  int Wp, C, kw, stride;       // padded width, channels, taps, stride
  int HoWo, Wo;                // output pixels per image, output width
  long long img;               // elements per padded image, Hp * Wp * C
};

// 8 contiguous elements at p (16-byte aligned), widened to f32
__device__ __forceinline__ void ld8(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* o) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// 4 results rounded to T at p (aligned to 4 elements)
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = reinterpret_cast<const unsigned&>(lo);
  u.y = reinterpret_cast<const unsigned&>(hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// A chunk [k0, k0 + BK) of this thread's row (pixel offset base in x)
template <typename T, bool AVEC>
__device__ __forceinline__ void load_a(const T* __restrict__ x,
                                       const Geom& g, bool ok,
                                       long long base, int k0, float* ra) {
  if (!ok) {
#pragma unroll
    for (int q = 0; q < BK; ++q) ra[q] = 0.f;
    return;
  }
  const int tap = k0 / g.C;
  int c = k0 - tap * g.C;
  int i = tap / g.kw, j = tap - i * g.kw;
  if (AVEC) {   // C % BK == 0: one tap, BK contiguous channels
    const T* p = x + base + ((long long)i * g.Wp + j) * g.C + c;
    ld8(p, ra);
    ld8(p + 8, ra + 8);
  } else {
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      ra[q] = k0 + q < g.R
                  ? to_f<T>(x[base + ((long long)i * g.Wp + j) * g.C + c])
                  : 0.f;
      if (++c == g.C) {
        c = 0;
        if (++j == g.kw) { j = 0; ++i; }
      }
    }
  }
}

// B piece: row r of w, columns [col, col + 8)
template <typename T, bool KVEC>
__device__ __forceinline__ void load_b(const T* __restrict__ w,
                                       const Geom& g, int r, int col,
                                       float* rb) {
  if (KVEC) {   // K % 8 == 0: the piece is all in or all out
    if (r < g.R && col < g.K) {
      ld8(w + (long long)r * g.K + col, rb);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) rb[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < 8; ++v)
      rb[v] = (r < g.R && col + v < g.K)
                  ? to_f<T>(w[(long long)r * g.K + col + v]) : 0.f;
  }
}

// registers -> one shared-memory buffer: A transposed (k-major), B as is
__device__ __forceinline__ void stage(float (&as)[BK][BM],
                                      float (&bs)[BK][BN], int tid,
                                      int b_row, int b_col, const float* ra,
                                      const float* rb) {
#pragma unroll
  for (int q = 0; q < BK; ++q) as[q][tid] = ra[q];
  float4* b = reinterpret_cast<float4*>(&bs[b_row][b_col]);
  b[0] = make_float4(rb[0], rb[1], rb[2], rb[3]);
  b[1] = make_float4(rb[4], rb[5], rb[6], rb[7]);
}

template <typename T, bool AVEC, bool KVEC>
__global__ void __launch_bounds__(THREADS)
conv_igemm(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, Geom g) {
  __shared__ __align__(16) float As[2][BK][BM];   // A chunk, k-major
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;   // column lane, row lane
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's A row: output pixel m0 + tid, its window's corner in x
  const int am = m0 + tid;
  const bool a_ok = am < g.M;
  long long a_base = 0;
  if (a_ok) {
    const int n = am / g.HoWo, rem = am - n * g.HoWo;
    const int ho = rem / g.Wo, wo = rem - ho * g.Wo;
    a_base = n * g.img +
             ((long long)ho * g.stride * g.Wp + (long long)wo * g.stride) * g.C;
  }
  // this thread's B piece: chunk row tid / 8, columns (tid % 8) * 8 + [0, 8)
  const int b_row = tid / 8, b_col = (tid % 8) * 8;

  float ra[BK], rb[8];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int chunks = (g.R + BK - 1) / BK;
  load_a<T, AVEC>(x, g, a_ok, a_base, 0, ra);
  load_b<T, KVEC>(w, g, b_row, n0 + b_col, rb);
  stage(As[0], Bs[0], tid, b_row, b_col, ra, rb);
  __syncthreads();

  for (int t = 0; t < chunks; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < chunks;
    if (more) {   // next chunk into registers while this one is consumed
      const int k1 = (t + 1) * BK;
      load_a<T, AVEC>(x, g, a_ok, a_base, k1, ra);
      load_b<T, KVEC>(w, g, k1 + b_row, n0 + b_col, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][32 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) stage(As[cur ^ 1], Bs[cur ^ 1], tid, b_row, b_col, ra, rb);
    __syncthreads();
  }

  // rows ty*4 + [0,4) and 64 + ty*4 + [0,4); columns tx*4 + [0,4) and
  // 32 + tx*4 + [0,4)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= g.M) continue;
    T* row = y + (long long)m * g.K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 32 + tx * 4;
      if (KVEC) {
        if (n < g.K) st4(row + n, &acc[i][h * 4]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < g.K) row[n + q] = from_f<T>(acc[i][h * 4 + q]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch(const void* xv, const void* wv, void* yv, const Geom& g,
            cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  const dim3 grid((g.M + BM - 1) / BM, (g.K + BN - 1) / BN);
  const bool avec = g.C % BK == 0 && aligned16(x);
  const bool kvec = g.K % 8 == 0 && aligned16(w) && aligned16(y);
  if (avec && kvec)
    conv_igemm<T, true, true><<<grid, THREADS, 0, s>>>(x, w, y, g);
  else if (avec)
    conv_igemm<T, true, false><<<grid, THREADS, 0, s>>>(x, w, y, g);
  else if (kvec)
    conv_igemm<T, false, true><<<grid, THREADS, 0, s>>>(x, w, y, g);
  else
    conv_igemm<T, false, false><<<grid, THREADS, 0, s>>>(x, w, y, g);
}

}  // namespace cc

using cc::Geom;

// -- tensor cores (conv_mma) --------------------------------------------------
using bf16 = __nv_bfloat16;

// 128 x BN output tile, 4 warps (2 x 2) of 64 x BN/2: MT m16 tiles by NT
// n8 tiles a warp; depth steps of 128 bytes a row; a ring of STAGES stages
// (at most 4) within 112 KB, so two CTAs share an SM
template <typename T, int BN>
struct MmaCfg {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  static constexpr int BM = 128, THREADS = 128;
  static constexpr int WM = 2, WN = 2;              // warps along M, N
  static constexpr int MT = BM / (16 * WM);         // 4
  static constexpr int NT = BN / (8 * WN);          // 8 or 4
  static constexpr int BUDGET = 112 * 1024;
  static constexpr int CH = 16 / (int)sizeof(T);    // elements a chunk
  static constexpr int BK = 8 * CH;                 // 64 bf16 / 32 f32
  // row strides (elements): A's 144 / 160 bytes put ldmatrix's 8 rows, or
  // the f32 pairs of rows g = 0..3, on distinct banks; B's (BN + 4) f32
  // puts depth rows 2 t4 on banks 8 t4 apart
  static constexpr int AS = BK + 8;
  static constexpr int BS = BN + (BF16 ? 8 : 4);
  static constexpr int A_TILE = BM * AS, B_TILE = BK * BS;
  static constexpr int STAGE = (int)sizeof(T) * (A_TILE + B_TILE);
  static constexpr int STAGES = BUDGET / STAGE < 4 ? BUDGET / STAGE : 4;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE;
  // the epilogue's output tile, in the ring's memory: rows of BN + 8
  // elements put the fragments' 4- (bf16) or 8-byte (f32) writes on
  // distinct banks
  static constexpr int CS = BN + 8;
  // a thread stages 16-byte chunks of one column, rows AR (A) / BR (B) apart
  static constexpr int ACH = BK / CH, AR = THREADS / ACH;
  static constexpr int BCH = BN / CH, BR = THREADS / BCH;
  static_assert(THREADS == BM, "one row base a thread");
  static_assert(BM % AR == 0 && THREADS % BCH == 0 && BK % BR == 0,
                "chunks");
  static_assert(STAGES >= 3 && NT % 2 == 0, "ring, warp tile");
  static_assert((size_t)BM * CS * sizeof(T) <= SMEM, "output tile");
};

// depth rows [k0, k0 + BK) of the CTA's pixels (A, gathered from x) and
// columns (B) into one stage.  C is a multiple of CH, so a chunk is one
// tap's channels, and K and the split's first row are multiples of CH, so
// every chunk is wholly inside or wholly outside the problem: outside,
// zeros.  rowbase[row] < 0 marks a row past M.
template <typename T, int BN>
__device__ __forceinline__ void mma_stage(
    const T* __restrict__ x, const T* __restrict__ w, T* as, T* bs,
    const long long* rowbase, const Geom& g, int n0, int k0, int k_end,
    int tid) {
  using Cfg = MmaCfg<T, BN>;
  const int ar = tid / Cfg::ACH, ac = (tid % Cfg::ACH) * Cfg::CH;
  const int r = k0 + ac;
  const bool a_in = r < k_end;
  long long tap = 0;   // offset of depth row r from a pixel's corner
  if (a_in) {
    const int t = r / g.C, c = r - t * g.C;
    const int i = t / g.kw, j = t - i * g.kw;
    tap = ((long long)i * g.Wp + j) * g.C + c;
  }
#pragma unroll
  for (int q = 0; q < Cfg::BM / Cfg::AR; ++q) {
    const int row = ar + q * Cfg::AR;
    const long long base = rowbase[row];
    const bool ok = a_in && base >= 0;
    cp_async16(as + row * Cfg::AS + ac, ok ? x + base + tap : x, ok);
  }
  const int br = tid / Cfg::BCH, bc = (tid % Cfg::BCH) * Cfg::CH;
  const bool b_in = n0 + bc < g.K;
#pragma unroll
  for (int q = 0; q < Cfg::BK / Cfg::BR; ++q) {
    const int rr = br + q * Cfg::BR;
    const bool ok = b_in && k0 + rr < k_end;
    cp_async16(bs + rr * Cfg::BS + bc,
               ok ? w + (long long)(k0 + rr) * g.K + n0 + bc : w, ok);
  }
}

// an f32 pair split into its bf16 pair hi (nearest even) and the bf16 pair
// of what hi missed (a - hi is exact in f32); low half = first element
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// two adjacent outputs rounded to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// grid (M tiles x K tiles, 1, splits), column tiles fastest; each split
// owns depth rows [z * rows, min(R, (z + 1) * rows)), rows a multiple of
// BK when splits > 1
template <typename T, int BN>
__global__ void __launch_bounds__(MmaCfg<T, BN>::THREADS)
conv_mma(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
         float* __restrict__ ws, Geom g, int rows) {
  using Cfg = MmaCfg<T, BN>;
  constexpr int BM = Cfg::BM, BK = Cfg::BK, AS = Cfg::AS, BS = Cfg::BS;
  constexpr int CS = Cfg::CS;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long rowbase[BM];
  T* As = reinterpret_cast<T*>(smem_raw);     // [STAGES][BM][AS]
  T* Bs = As + STAGES * Cfg::A_TILE;           // [STAGES][BK][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
  const int col_tiles = (g.K + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / col_tiles) * BM;
  const int n0 = (int)(blockIdx.x % col_tiles) * BN;
  const int k_begin = blockIdx.z * rows;
  const int k_end = min(g.R, k_begin + rows);
  const int steps = (k_end - k_begin + BK - 1) / BK;

  {   // this thread's output pixel m0 + tid: its window's corner in x
    const int m = m0 + tid;
    long long base = -1;
    if (m < g.M) {
      const int n = m / g.HoWo, rem = m - n * g.HoWo;
      const int ho = rem / g.Wo, wo = rem - ho * g.Wo;
      base = n * g.img + ((long long)ho * g.stride * g.Wp +
                          (long long)wo * g.stride) * g.C;
    }
    rowbase[tid] = base;
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps)   // depth step t into stage t
      mma_stage<T, BN>(x, w, As + t * Cfg::A_TILE, Bs + t * Cfg::B_TILE,
                       rowbase, g, n0, k_begin + t * BK, k_end, tid);
    cp_async_commit();              // empty groups keep the count aligned
  }
  const int gq = lane >> 2, t4 = lane & 3;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();    // this thread's chunks of step t
    __syncthreads();                // everyone's; step t - 1 is consumed
    const int tn = t + STAGES - 1;  // into the stage step t - 1 used
    if (tn < steps)
      mma_stage<T, BN>(x, w, As + (tn % STAGES) * Cfg::A_TILE,
                       Bs + (tn % STAGES) * Cfg::B_TILE, rowbase, g, n0,
                       k_begin + tn * BK, k_end, tid);
    cp_async_commit();
    const T* as = As + (t % STAGES) * Cfg::A_TILE + wm * MT * 16 * AS;
    const T* bs = Bs + (t % STAGES) * Cfg::B_TILE + wn * NT * 8;
    if constexpr (Cfg::BF16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)   // rows i*16 + lane%16, k lo | hi
          ldsm_x4(af[i],
                  as + (i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)   // k lo | hi of columns 16j.., +8..
          ldsm_x4_trans(bfr[j], bs + (kk + (lane & 15)) * BS + j * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[i][j], af[i], bfr[j / 2][2 * (j & 1)],
                     bfr[j / 2][2 * (j & 1) + 1]);
      }
    } else {
      // A fragment: rows g, g + 8 x depth 2 t4 (+1), 2 t4 + 8 (+1);
      // B fragment: depth 2 t4, +1, +8, +9 x column g
      const float* pa = as + gq * AS + 2 * t4;
      const float* pb = bs + 2 * t4 * BS + gq;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* p = pa + i * 16 * AS + kk;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * AS);
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * AS + 8);
          split_bf16(v0.x, v0.y, ah[i][0], al[i][0]);
          split_bf16(v1.x, v1.y, ah[i][1], al[i][1]);
          split_bf16(v2.x, v2.y, ah[i][2], al[i][2]);
          split_bf16(v3.x, v3.y, ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* q = pb + kk * BS + j * 8;
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16(q[0], q[BS], bh0, bl0);
          split_bf16(q[8 * BS], q[9 * BS], bh1, bl1);
#pragma unroll
          for (int i = 0; i < MT; ++i) {   // the small terms first
            mma_bf16(acc[i][j], al[i], bh0, bh1);
            mma_bf16(acc[i][j], ah[i], bl0, bl1);
            mma_bf16(acc[i][j], ah[i], bh0, bh1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // thread holds rows g, g + 8 and columns 2 t4, 2 t4 + 1 of each 16 x 8 tile
  if (gridDim.z > 1) {   // f32 partial sums, straight to the workspace
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + (wn * NT + j) * 8 + 2 * t4;
        if (col >= g.K) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + (wm * MT + i) * 16 + gq + 8 * h;
          if (row < g.M)
            store2(ws + ((size_t)blockIdx.z * g.M + row) * g.K + col,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
    return;
  }
  // rounded to T into an output tile in the ring's memory, then written
  // out in 16-byte chunks, a warp's lanes along a row (whole sectors)
  __syncthreads();   // every warp is done with the ring
  T* Cs = As;        // [BM][CS]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(Cs + ((wm * MT + i) * 16 + gq + 8 * h) * CS +
                   (wn * NT + j) * 8 + 2 * t4,
               acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  constexpr int CH = Cfg::CH, ROW_CH = BN / CH;   // chunks a row
#pragma unroll 4
  for (int c = tid; c < BM * ROW_CH; c += Cfg::THREADS) {
    const int r = c / ROW_CH, col = (c % ROW_CH) * CH;
    if (m0 + r < g.M && n0 + col < g.K)
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * g.K + n0 + col) =
          *reinterpret_cast<const uint4*>(Cs + r * CS + col);
  }
}

template <typename T, int BN>
cudaError_t launch_mma(const T* x, const T* w, T* y, float* ws, const Geom& g,
                       int splits, int rows, cudaStream_t s) {
  using Cfg = MmaCfg<T, BN>;
  if (splits > 1 && rows % Cfg::BK != 0) return cudaErrorInvalidValue;
  const long long ctas = (long long)((g.M + Cfg::BM - 1) / Cfg::BM) *
                         ((g.K + BN - 1) / BN);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  static bool attrs_set = false;   // above 48 KB needs an opt-in, once
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_mma<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::SMEM);
    if (e == cudaSuccess)   // all of the SM's 228 KB as shared memory
      e = cudaFuncSetAttribute(conv_mma<T, BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  const dim3 grid((unsigned)ctas, 1, splits);
  conv_mma<T, BN><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(x, w, y, ws, g, rows);
  return cudaSuccess;
}

// -- warpgroup tensor cores (conv_wgmma) ----------------------------------
// A 128 x BN output tile per CTA: two consumer warpgroups of 64 rows each
// issuing wgmma.mma_async and a producer, one thread of which keeps TMA
// loads in flight through a ring of stages paced by mbarrier full / empty
// pairs.  BN 256 and f32 at 128: one CTA an SM, 384 threads, the producer
// a warpgroup (setmaxnreg 40, the consumers 232), 4 stages, f32 at 128
// walking tiles persistently (PERSIST); BN 64 and bf16 at 128: two CTAs an
// SM (the second's loads and epilogue overlap the first's products), 288
// threads, the producer one warp, as many stages (3-4) as fit in half the
// SM.  A depth step is one 128-byte line of channels of one tap (i, j):
// 64 bf16 or 32 f32 depth rows.  A stage holds A, the 128 pixels' lines
// as TMA's im2col mode lays them (K-major, 128-byte swizzle), then B: BN /
// 64 atoms of 64 weight columns x the step's depth rows (MN-major, read in
// place through wgmma's transpose bit), twice in f32 (the hi, then the lo
// bf16 halves of the weights).
namespace wg {

constexpr int BM = 128;
constexpr int LINE = 128;        // bytes of channels a pixel gives a step
constexpr int SMEM_MAX = 232448;   // shared memory a CTA may use (227 KB)

template <typename T, int BN>
struct WgCfg {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  // CTAs an SM: two where the accumulators leave registers for it (at
  // 288 threads, 112 a thread: f32 at BN 128 spills there)
  static constexpr int CTAS = BN == 64 || (BN == 128 && BF16) ? 2 : 1;
  // consumers 0-255, then the producer: a warpgroup, or one warp
  static constexpr int THREADS = CTAS == 1 ? 384 : 288;
  static constexpr int BK = LINE / (int)sizeof(T);      // depth rows a step
  static constexpr int A_BYTES = BM * LINE;              // 16 KB
  static constexpr int B_ATOM = BK * 128;                // 64 bf16 columns
  static constexpr int B_HALF = BN / 64 * B_ATOM;
  static constexpr int B_BYTES = (BF16 ? 1 : 2) * B_HALF;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ACC = BN / 2;                     // f32 a thread
  static constexpr int LD = BN * (int)sizeof(T) + 16;    // a staged row
  static constexpr int OUT = 2 * 64 * LD;                // the staged tile
  // persistent (one CTA an SM walking tiles): the output tile is staged
  // past the ring, which the producer fills with the next tile's steps
  // meanwhile, where that leaves 4 stages (f32 at BN 128; bf16 at 256
  // ran 8-15 % slower on 3); else it is staged in the ring once every
  // product is done, one tile a CTA
  static constexpr int FIT_P = (SMEM_MAX - 1024 - 64 - OUT) / STAGE;
  static constexpr bool PERSIST = CTAS == 1 && FIT_P >= 4;
  // stages in the CTA's share of the SM, less the alignment and barriers
  static constexpr int FIT =
      PERSIST ? FIT_P : (SMEM_MAX / CTAS - 1024 - 64) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // the ring, 1024-byte aligned (the swizzle's period), the staged tile
  // when persistent, then the barriers
  static constexpr int BARS = STAGES * STAGE + (PERSIST ? OUT : 0);
  static constexpr size_t SMEM =
      1024 + (size_t)BARS + 2 * STAGES * sizeof(uint64_t);
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN");
  static_assert(STAGES >= 3, "ring");
  static_assert(STAGE % 1024 == 0 && B_ATOM % 1024 == 0, "alignment");
  static_assert(PERSIST || OUT <= STAGES * STAGE, "output tile in the ring");
};

template <int BN, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<0, TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128<0, TB>(d, da, db);
  else
    wgmma_n64<0, TB>(d, da, db);
}
template <int BN, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_rs_n256<TB>(d, a, db);
  else if constexpr (BN == 128)
    wgmma_rs_n128<TB>(d, a, db);
  else
    wgmma_rs_n64<TB>(d, a, db);
}

// f32 A, k16 slice kk of a step: this thread's fragment (rows g, g + 8 of
// its warp's 16 x depth 2 t4 (+1), 2 t4 + 8 (+1)) read from the swizzled
// tile at `rows` (the warp's first row, 1024-aligned lines of 128 bytes)
// and split into bf16 hi and lo pairs
__device__ __forceinline__ void frag_f32(const unsigned char* rows, int lane,
                                         int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // (row, column) g / +8, 2 t4 / +8
    const int r = gq + 8 * (q & 1);
    const int byte = 64 * kk + 32 * (q >> 1) + 8 * t4;
    const float2 v = *reinterpret_cast<const float2*>(
        rows + r * LINE + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15));
    split_bf16(v.x, v.y, hi[q], lo[q]);
  }
}

// grid (CTAs, 1, splits): the output tiles, column tiles fastest, one a
// CTA, or walked by min(tiles, SMs) persistent CTAs (WgCfg::PERSIST), CTA
// b taking tiles b, b + gridDim.x, ...; split z owns depth rows [z * rows,
// min(R, (z + 1) * rows)), rows a multiple of BK (and R, C % BK == 0, so
// every step is whole).  tx: x's im2col map, or with `flat` (a 1x1 conv
// at stride 1: A is x's (M, C) matrix) its 2-d tiled map of BK-column x
// 128-row boxes, which lays a box out as the im2col load does; tw: the
// (R, K) bf16 weights (f32: the (2 R, K) hi / lo halves) as a 2-d map of
// 64-column x BK-row boxes.
template <typename T, int BN>
__global__ void __launch_bounds__(WgCfg<T, BN>::THREADS, WgCfg<T, BN>::CTAS)
conv_wgmma(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw, T* __restrict__ y,
           float* __restrict__ ws, Geom g, int rows, int flat) {
  using Cfg = WgCfg<T, BN>;
  constexpr int BK = Cfg::BK, STAGES = Cfg::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* const ring = smem_raw + (base - smem_addr(smem_raw));
  unsigned char* const out = ring + (Cfg::PERSIST ? STAGES * Cfg::STAGE : 0);
  const uint32_t bars = base + Cfg::BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto stage_a = [&](int s) { return base + (uint32_t)(s * Cfg::STAGE); };
  auto stage_b = [&](int s) { return stage_a(s) + Cfg::A_BYTES; };

  const int col_tiles = (g.K + BN - 1) / BN;
  const int tiles = (g.M + BM - 1) / BM * col_tiles;
  const int k_begin = blockIdx.z * rows;
  const int steps = (min(g.R, k_begin + rows) - k_begin) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);    // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the ring's steps are counted over the CTA's tiles: step q in stage q %
  // STAGES, its phase (q / STAGES) & 1
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- the producer: one thread keeps the ring's loads in flight ----------
    if constexpr (Cfg::CTAS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int q = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
        // the im2col walk starts at the tile's first output pixel's corner
        const int n = m0 / g.HoWo, rem = m0 - n * g.HoWo;
        const int ho = rem / g.Wo, wo = rem - ho * g.Wo;
        const int h0 = ho * g.stride, w0 = wo * g.stride;
        for (int t = 0; t < steps; ++t, ++q) {
          const int s = q % STAGES;
          mbar_wait(empty(s), ((q / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), Cfg::STAGE);
          const int r = k_begin + t * BK;     // the step's first depth row
          const int tap = r / g.C, c = r - tap * g.C;
          const int i = tap / g.kw, j = tap - i * g.kw;
          if (flat)
            tma_load(stage_a(s), &tx, full(s), c, m0);
          else
            tma_load_im2col(stage_a(s), &tx, full(s), c, w0, h0, n,
                            (uint16_t)j, (uint16_t)i);
#pragma unroll
          for (int k = 0; k < BN / 64; ++k) {
            tma_load(stage_b(s) + k * Cfg::B_ATOM, &tw, full(s), n0 + 64 * k,
                     r);
            if constexpr (!Cfg::BF16)
              tma_load(stage_b(s) + Cfg::B_HALF + k * Cfg::B_ATOM, &tw,
                       full(s), n0 + 64 * k, g.R + r);
          }
        }
      }
    }
  } else {
    // -- two consumers: rows [64 wg, 64 wg + 64) of each tile ---------------
    if constexpr (Cfg::CTAS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // thread holds rows r0, r0 + 8 and columns 8 j + 2 (lane % 4) + {0, 1}
    const int r0 = warp * 16 + lane / 4;
    auto release = [&](int q) {   // step q's products are done: its stage
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(q % STAGES));
    };
    auto wg_sync = [&] {          // this warpgroup's 128 threads
      if (wg == 0)
        named_sync<2, 128>();
      else
        named_sync<3, 128>();
    };
    int q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
      float acc[Cfg::ACC];
#pragma unroll
      for (int i = 0; i < Cfg::ACC; ++i) acc[i] = 0.f;
      for (int t = 0; t < steps; ++t, ++q) {
        const int s = q % STAGES;
        mbar_wait(full(s), (q / STAGES) & 1);
        // the warpgroup's 64 pixels: 64 lines of A; a k16 slice is 32
        // bytes along a bf16 line (16 lines of an MN-major B atom)
        const uint32_t a0 = stage_a(s) + wg * 64 * LINE, b0 = stage_b(s);
        if constexpr (Cfg::BF16) {
          fence_acc(acc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss<BN, 1>(acc, smem_desc(a0 + kk * 32, 16),
                            smem_desc(b0 + kk * 2048, Cfg::B_ATOM));
          wg_commit();
          wg_wait<1>();              // step q - 1's products are done ...
          fence_acc(acc);
          if (t > 0) release(q - 1);   // ... its stage is free
        } else {
          // three bf16 passes, the small terms first: a_lo b_hi + a_hi b_lo
          // + a_hi b_hi, A's halves split in registers from the f32 tile
          uint32_t ah[BK / 16][4], al[BK / 16][4];
          const unsigned char* rows_a =
              ring + (a0 - base) + warp * 16 * LINE;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            frag_f32(rows_a, lane, kk, ah[kk], al[kk]);
          fence_acc(acc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t dh = smem_desc(b0 + kk * 2048, Cfg::B_ATOM);
            const uint64_t dl =
                smem_desc(b0 + Cfg::B_HALF + kk * 2048, Cfg::B_ATOM);
            wgmma_rs<BN, 1>(acc, al[kk], dh);
            wgmma_rs<BN, 1>(acc, ah[kk], dl);
            wgmma_rs<BN, 1>(acc, ah[kk], dh);
          }
          wg_commit();
          wg_wait<0>();              // the fragments' registers are free
          fence_acc(acc);
          release(q);
        }
      }
      wg_wait<0>();
      fence_acc(acc);
      if (Cfg::BF16 && steps > 0) release(q - 1);

      if (gridDim.z == 1) {
        // rounded to T through shared memory, stored as whole 16-byte
        // chunks: each warpgroup stages its 64 x BN outputs in rows padded
        // by 16 bytes, then writes them out, a row's chunks on adjacent
        // lanes.  In the ring: once both consumers are past their last
        // wgmma; past it: once this warpgroup has stored its last tile
        constexpr int LD = Cfg::LD, CH = 16 / (int)sizeof(T);
        constexpr int CPR = BN / CH, RPP = 128 / CPR;   // chunks a row,
                                                        // rows a pass
        if constexpr (Cfg::PERSIST)
          wg_sync();
        else
          named_sync<1, 256>();
        unsigned char* tile_out = out + wg * 64 * LD;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(reinterpret_cast<T*>(tile_out + (r0 + 8 * h) * LD) +
                       8 * j + 2 * (lane % 4),
                   acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        wg_sync();
        const int t = threadIdx.x % 128, col = n0 + CH * (t % CPR);
        if (col < g.K)
          for (int r = t / CPR; r < 64; r += RPP) {
            const int row = m0 + wg * 64 + r;
            if (row < g.M)
              *reinterpret_cast<uint4*>(y + (size_t)row * g.K + col) =
                  *reinterpret_cast<const uint4*>(tile_out + r * LD +
                                                  16 * (t % CPR));
          }
      } else {
        // f32 partial sums of this split into the workspace (K % 8 == 0:
        // a pair is in or out, 8-byte aligned)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= g.K) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wg * 64 + r0 + 8 * h;
            if (row < g.M)
              store2(ws + ((size_t)blockIdx.z * g.M + row) * g.K + col,
                     acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// the f32 weights' bf16 halves, hi = bf16(w) then lo = bf16(w - hi), as
// conv_mma splits them in registers: out[0 .. n) hi, out[n .. 2 n) lo
__global__ void split_weights(const float4* __restrict__ w,
                              uint2* __restrict__ out, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = w[i];
    uint2 hi, lo;
    split_bf16(v.x, v.y, hi.x, lo.x);
    split_bf16(v.z, v.w, hi.y, lo.y);
    out[i] = hi;
    out[n4 + i] = lo;
  }
}

// x's im2col map: (C, Wp, Hp, N), pixels walked over the window corners
// [0, Wp - kw] x [0, Hp - kh] at the conv's stride, 128 of them a load,
// one 128-byte line of channels each; zeros past the last image
bool encode_x(CUtensorMap* map, const void* x, bool is_bf16, int N, int Hp,
              const Geom& g, int kh) {
  const EncodeIm2col enc = im2col_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)g.C, (cuuint64_t)g.Wp,
                              (cuuint64_t)Hp, (cuuint64_t)N};
  const cuuint64_t strides[3] = {g.C * e, (cuuint64_t)g.Wp * g.C * e,
                                 (cuuint64_t)Hp * g.Wp * g.C * e};
  const int lower[2] = {0, 0};                    // (W, H)
  const int upper[2] = {1 - g.kw, 1 - kh};
  const cuuint32_t unit[4] = {1u, (cuuint32_t)g.stride, (cuuint32_t)g.stride,
                              1u};
  return enc(map,
             is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(x), dims, strides, lower, upper,
             (cuuint32_t)(LINE / e), (cuuint32_t)BM, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 1x1 stride-1 conv's x as the (M, C) matrix: boxes of one 128-byte line
// of channels x 128 rows (pixels), zeros past M
bool encode_x_flat(CUtensorMap* map, const void* x, bool is_bf16,
                   const Geom& g) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = is_bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)g.C, (cuuint64_t)g.M};
  const cuuint64_t strides[1] = {g.C * e};
  const cuuint32_t boxes[2] = {(cuuint32_t)(LINE / e), (cuuint32_t)BM};
  const cuuint32_t unit[2] = {1u, 1u};
  return enc(map,
             is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(x), dims, strides, boxes, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 weights as `rows` lines of K: boxes of 64 columns x `box` rows
bool encode_w(CUtensorMap* map, const void* w, int K, int rows, int box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t boxes[2] = {64u, (cuuint32_t)box};
  const cuuint32_t unit[2] = {1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// which convs the kernel takes: whole 128-byte channel lines, 16-byte rows
// of w and y, TMA's traversal stride (<= 8) and im2col corner range
template <typename T>
bool legal(const void* x, const void* w, const void* y, const Geom& g,
           int kh) {
  return g.C % WgCfg<T, 128>::BK == 0 && g.K % 8 == 0 && g.stride <= 8 &&
         kh <= 129 && g.kw <= 129 && cc::aligned16(x) && cc::aligned16(w) &&
         cc::aligned16(y);
}

template <typename T, int BN>
cudaError_t launch(const T* x, const T* w, T* y, float* ws, const Geom& g,
                   int N, int Hp, int kh, int splits, int rows,
                   cudaStream_t s) {
  using Cfg = WgCfg<T, BN>;
  if (rows % Cfg::BK || !legal<T>(x, w, y, g, kh))
    return cudaErrorInvalidValue;
  const long long ctas = (long long)((g.M + BM - 1) / BM) *
                         ((g.K + BN - 1) / BN);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  // f32: the weights' bf16 halves after the split's partial sums
  const void* wb = w;
  if constexpr (!Cfg::BF16) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    bf16* halves = reinterpret_cast<bf16*>(
        ws + (splits > 1 ? (size_t)splits * g.M * g.K : 0));
    const size_t n4 = (size_t)g.R * g.K / 4;
    split_weights<<<(int)std::min<size_t>((n4 + 255) / 256, 1024), 256, 0,
                    s>>>(reinterpret_cast<const float4*>(w),
                         reinterpret_cast<uint2*>(halves), n4);
    wb = halves;
  }
  // a 1x1 conv at stride 1 reads x as the (M, C) matrix it is
  const bool flat = kh == 1 && g.kw == 1 && g.stride == 1;
  CUtensorMap tx, tw;
  if (!(flat ? encode_x_flat(&tx, x, Cfg::BF16, g)
             : encode_x(&tx, x, Cfg::BF16, N, Hp, g, kh)) ||
      !encode_w(&tw, wb, g.K, (Cfg::BF16 ? 1 : 2) * g.R, Cfg::BK))
    return cudaErrorInvalidValue;
  static bool attrs_set = false;   // above 48 KB needs an opt-in, once
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::SMEM);
    if (e == cudaSuccess)   // all of the SM's 228 KB as shared memory
      e = cudaFuncSetAttribute(conv_wgmma<T, BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  long long grid_x = ctas;
  if constexpr (Cfg::PERSIST) {   // one CTA an SM walks the tiles
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    grid_x = std::min<long long>(ctas, sms);
  }
  const dim3 grid((unsigned)grid_x, 1, splits);
  conv_wgmma<T, BN><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(tx, tw, y, ws, g,
                                                          rows, flat);
  return cudaSuccess;
}

// one im2col load into shared memory, copied out as it lies there (the
// swizzled 128 x 128-byte box): the card's check of the walk's model
__global__ void im2col_probe(const __grid_constant__ CUtensorMap tx,
                             uint4* __restrict__ out, int c, int w, int h,
                             int n, int i, int j) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + BM * LINE;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, BM * LINE);
    tma_load_im2col(base, &tx, bar, c, w, h, n, (uint16_t)j, (uint16_t)i);
  }
  mbar_wait(bar, 0);
  const uint4* box =
      reinterpret_cast<const uint4*>(smem_raw + (base - smem_addr(smem_raw)));
  for (int q = threadIdx.x; q < BM * LINE / 16; q += blockDim.x)
    out[q] = box[q];
}

}  // namespace wg

enum { ROUTE_MMA = 0, ROUTE_CUDA_CORE = 1, ROUTE_WGMMA = 2 };

template <typename T>
cudaError_t launch(const void* xv, const void* wv, void* yv, float* ws,
                   const Geom& g, int N, int Hp, int kh, int route, int bm,
                   int bn, int splits, int rows, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  if (route == ROUTE_CUDA_CORE) {
    if (splits != 1 || bm != cc::BM || bn != cc::BN ||
        (g.K + cc::BN - 1) / cc::BN > 65535)
      return cudaErrorInvalidValue;
    cc::launch<T>(xv, wv, yv, g, s);
    return cudaSuccess;
  }
  if ((route != ROUTE_MMA && route != ROUTE_WGMMA) || bm != 128)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (route == ROUTE_WGMMA) {
    if (bn == 256)
      e = wg::launch<T, 256>(x, w, y, ws, g, N, Hp, kh, splits, rows, s);
    else if (bn == 128)
      e = wg::launch<T, 128>(x, w, y, ws, g, N, Hp, kh, splits, rows, s);
    else if (bn == 64)
      e = wg::launch<T, 64>(x, w, y, ws, g, N, Hp, kh, splits, rows, s);
    else
      return cudaErrorInvalidValue;
  } else {
    constexpr int CH = 16 / (int)sizeof(T);
    if (g.C % CH || g.K % 8 || !cc::aligned16(xv) || !cc::aligned16(wv) ||
        !cc::aligned16(yv))
      return cudaErrorInvalidValue;
    if (bn == 128)
      e = launch_mma<T, 128>(x, w, y, ws, g, splits, rows, s);
    else if (bn == 64)
      e = launch_mma<T, 64>(x, w, y, ws, g, splits, rows, s);
    else
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  if (splits > 1) launch_split_reduce<T>(ws, y, splits, (size_t)g.M * g.K, s);
  return cudaSuccess;
}

}  // namespace

// y (N, Ho, Wo, K) = VALID conv of x (N, Hp, Wp, C) with w (kh, kw, C, K)
// at `stride` on `stream`, Ho = (Hp - kh) / stride + 1 (likewise Wo), by
// the wrapper's plan (kernels/conv2d/plan.py): route 0 mma (bm 128, bn 64
// or 128), 1 cuda_core (bm 128, bn 64, splits 1), 2 wgmma (bm 128, bn 64,
// 128 or 256); depth R = kh*kw*C split into `splits` ranges of `rows` rows
// (the last may be shorter, none empty); ws: f32 scratch, (splits, M, K)
// partial sums when splits > 1, then on route 2 in f32 R * K more for the
// weights' bf16 hi / lo halves; dtype DT_F32 or DT_BF16 for all three
// tensors.  A plan the kernels cannot take returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int conv_run(const void* x, const void* w, void* y, void* ws,
                        int N, int Hp, int Wp, int C, int K, int kh, int kw,
                        int stride, int Ho, int Wo, int route, int bm, int bn,
                        int splits, int rows, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo, R = (long long)kh * kw * C;
  if (N < 1 || C < 1 || K < 1 || kh < 1 || kw < 1 || stride < 1 || Ho < 1 ||
      Wo < 1 || (Ho - 1) * stride + kh > Hp || (Wo - 1) * stride + kw > Wp ||
      M > 0x7fffffffLL || R > 0x7fffffffLL || splits < 1 || splits > 65535 ||
      rows < 1 || (long long)rows * splits < R ||
      (long long)rows * (splits - 1) >= R ||
      ((splits > 1 || (route == ROUTE_WGMMA && dtype == DT_F32)) &&
       ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.M = (int)M;
  g.K = K;
  g.R = (int)R;
  g.Wp = Wp;
  g.C = C;
  g.kw = kw;
  g.stride = stride;
  g.HoWo = Ho * Wo;
  g.Wo = Wo;
  g.img = (long long)Hp * Wp * C;
  float* wsf = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch<float>(x, w, y, wsf, g, N, Hp, kh, route, bm, bn, splits,
                      rows, s);
  else if (dtype == DT_BF16)
    e = launch<bf16>(x, w, y, wsf, g, N, Hp, kh, route, bm, bn, splits,
                     rows, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the card's check of the im2col walk: one load of x (N, Hp, Wp, C)'s
// im2col map for a kh x kw conv at `stride` (the map conv_wgmma reads),
// from the window corner (w, h) of image n, channels from c, tap (i, j),
// copied to out (16 KB) as it lies in shared memory, swizzled
extern "C" int conv_im2col_probe(const void* x, void* out, int N, int Hp,
                                 int Wp, int C, int kh, int kw, int stride,
                                 int c, int w, int h, int n, int i, int j,
                                 int dtype, void* stream) {
  if ((dtype != DT_F32 && dtype != DT_BF16) || N < 1 || C < 1 || kh < 1 ||
      kw < 1 || kh > Hp || kw > Wp || stride < 1 || stride > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{};
  g.Wp = Wp;
  g.C = C;
  g.kw = kw;
  g.stride = stride;
  CUtensorMap tx;
  if (!wg::encode_x(&tx, x, dtype == DT_BF16, N, Hp, g, kh))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::im2col_probe<<<1, 128, wg::BM * wg::LINE + 1024 + 8,
                     static_cast<cudaStream_t>(stream)>>>(
      tx, static_cast<uint4*>(out), c, w, h, n, i, j);
  return static_cast<int>(cudaGetLastError());
}

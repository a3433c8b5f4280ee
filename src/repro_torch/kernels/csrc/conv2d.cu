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
// What bounds it on an H100: operations.  The paper's CNNs run fp32, and
// at batch 64 the 3x3 / 5x5 / 7x7 convs and the wide 1x1s do 60-600 FLOPs
// per byte they must move, above the ~20 FLOP/byte at which the 67 TFLOP/s
// fp32 CUDA cores, not HBM, become the limit (only narrow 1x1s such as
// ResNet-50's 64 -> 64 sit below it).  So the kernel must keep the FMA
// pipes fed from registers and shared memory.
//
// What the design does about it (the Pallas kernel staged a whole image in
// VMEM and unrolled kh*kw dots; a CTA here holds a 128 x 64 output tile):
//  * 128 threads, each owning an 8 x 8 register micro-tile (two 4-row and
//    two 4-column strips), so one k step reads 4 float4 from shared memory
//    for 64 FMAs.
//  * R is walked in chunks of 16.  Each thread gathers one row of the A
//    chunk (its output pixel's base offset in x is computed once) and an
//    8-wide piece of the B chunk into registers while the CTA computes on
//    the previous chunk; the two shared-memory buffers alternate, one
//    barrier per chunk.  bf16 is widened to f32 as it is staged.
//  * Where C is a multiple of 16 (every conv of the three nets but the
//    C = 3 stem and GoogLeNet's two C = 24 5x5 convs) a chunk is one tap
//    (i, j) and 16 contiguous channels: 16-byte vector loads.  Otherwise a
//    scalar gather walks (i, j, c) incrementally.  Where K is a multiple of
//    8, B rows load and C rows store as vectors.
//  * M (up to 3.2 M rows at batch 64) is on gridDim.x; offsets into x and
//    y are 64-bit (VGG-16's first activations at batch 64 are 822 MB).
//  * Ragged edges (M, K, R not tile multiples) are masked: loads past an
//    edge read zero, stores past an edge are dropped.
// The FMAs run on the CUDA cores in f32; tensor cores (mma.sync / wgmma),
// TMA and a deeper cp.async pipeline are later work.
#include "common.cuh"

namespace {

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

}  // namespace

// y (N, Ho, Wo, K) = VALID conv of x (N, Hp, Wp, C) with w (kh, kw, C, K)
// at `stride` on `stream`, Ho = (Hp - kh) / stride + 1 (likewise Wo);
// dtype is DT_F32 or DT_BF16 for all three tensors.
extern "C" int conv_launch(const void* x, const void* w, void* y, int N,
                           int Hp, int Wp, int C, int K, int kh, int kw,
                           int stride, int Ho, int Wo, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo, R = (long long)kh * kw * C;
  if (N < 1 || C < 1 || K < 1 || kh < 1 || kw < 1 || stride < 1 || Ho < 1 ||
      Wo < 1 || (Ho - 1) * stride + kh > Hp || (Wo - 1) * stride + kw > Wp ||
      M > 0x7fffffffLL || R > 0x7fffffffLL || (K + BN - 1) / BN > 65535)
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
  if (dtype == DT_F32) {
    launch<float>(x, w, y, g, s);
  } else if (dtype == DT_BF16) {
    launch<__nv_bfloat16>(x, w, y, g, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

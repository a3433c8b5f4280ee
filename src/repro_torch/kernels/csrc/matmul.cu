// Blocked matrix product C = A @ B with an f32 accumulator, output in the
// input dtype (bf16 or f32), row-major A (M, K), B (K, N), C (M, N).
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul_pallas (_mm_kernel).
//
// What bounds it on an H100: bytes.  On the serving path B is a weight
// matrix and M is small: M = slots (4) at decode, slots x prompt (<= 128)
// in a prefill wave.  2*M FLOPs per B element read stays far below the
// ~295 FLOP/byte at which the card's bf16 tensor cores, not HBM, would be
// the limit, so the weights must stream from HBM once per call, with
// enough loads in flight on every SM to fill the memory pipe.
//
// What the design does about it:
//  * M <= 16 (decode): mm_skinny.  A CTA owns a 256-column stripe of B for
//    every row of A; each lane owns 8 columns and reads them as one or two
//    16-byte vectors per row of B (scalar loads where N or the pointer is
//    not 16-byte aligned), four rows ahead, so every element of B is read
//    once, by one lane, in 512-byte warp rows.  The 4 warps split the CTA's
//    K range and are summed through shared memory.
//  * M > 16 (prefill): mm_tiled, a 128 x 64 output tile per CTA with a
//    16-deep K step staged in shared memory, 8 x 4 outputs per thread.  The
//    row tile of 128 covers a whole smoke-sized prefill wave, so B is read
//    once there too.  The FMAs run on the CUDA cores in f32; the tensor
//    cores (mma.sync / wgmma) and TMA staging are later work.
//  * Split K: where N / stripe gives too few CTAs to keep ~4 per SM busy
//    (every projection but the LM head), the K range is split over
//    gridDim.z CTAs that write f32 partial sums to a workspace the caller
//    allocates; mm_reduce adds the splits in a fixed order (deterministic)
//    and rounds once to the output dtype.
// Ragged edges (M, N, K not multiples of the tiles) are masked, never
// asserted: loads past an edge read zero, stores past an edge are dropped.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int CTAS_PER_SM = 4;        // split-K target occupancy

// -- skinny (M <= 16) ---------------------------------------------------------
constexpr int SK_WARPS = 4;
constexpr int SK_COLS = 8;            // columns per lane
constexpr int SK_STRIPE = 32 * SK_COLS;   // 256 columns per CTA
constexpr int SK_AHEAD = 4;           // rows of B in flight per lane
constexpr int SK_MAXM = 16;
constexpr int SK_MIN_ROWS = 64;       // fewest K rows a split may own

// 8 consecutive elements of B at p (16-byte aligned), as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// column of lane's v-th value: contiguous 8 per lane when vectorized,
// lane-interleaved (coalesced scalar loads) otherwise
template <bool VEC>
__device__ __forceinline__ int sk_col(int lane, int v) {
  return VEC ? lane * SK_COLS + v : lane + 32 * v;
}

template <typename T, int MT, bool VEC>
__device__ __forceinline__ void sk_row(const T* __restrict__ A,
                                       const T* __restrict__ B, int N, int K,
                                       int M, int k, int n0, int lane,
                                       float (&acc)[MT][SK_COLS]) {
  float b[SK_COLS];
  if (VEC) {
    if (n0 + lane * SK_COLS < N) {
      load8(B + (size_t)k * N + n0 + lane * SK_COLS, b);
    } else {
#pragma unroll
      for (int v = 0; v < SK_COLS; ++v) b[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) {
      const int n = n0 + sk_col<false>(lane, v);
      b[v] = n < N ? to_f<T>(B[(size_t)k * N + n]) : 0.f;
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float a = to_f<T>(A[(size_t)m * K + k]);
#pragma unroll
      for (int v = 0; v < SK_COLS; ++v) acc[m][v] += a * b[v];
    }
  }
}

template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(SK_WARPS * 32)
mm_skinny(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
          float* __restrict__ ws, int M, int N, int K, int rows_per_split) {
  __shared__ float red[SK_WARPS][SK_COLS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * SK_STRIPE;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  float acc[MT][SK_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) acc[m][v] = 0.f;

  int k = k_begin + warp;
  for (; k + (SK_AHEAD - 1) * SK_WARPS < k_end; k += SK_AHEAD * SK_WARPS) {
#pragma unroll
    for (int u = 0; u < SK_AHEAD; ++u)
      sk_row<T, MT, VEC>(A, B, N, K, M, k + u * SK_WARPS, n0, lane, acc);
  }
  for (; k < k_end; k += SK_WARPS)
    sk_row<T, MT, VEC>(A, B, N, K, M, k, n0, lane, acc);

  // sum the warps' partials row by row; one f32 result per (m, column)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) red[warp][v][lane] = acc[m][v];
    __syncthreads();
    for (int i = threadIdx.x; i < SK_STRIPE; i += blockDim.x) {
      const int v = i / 32, l = i % 32;
      const int n = n0 + sk_col<VEC>(l, v);
      if (n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < SK_WARPS; ++w) s += red[w][v][l];
        if (gridDim.z == 1)
          C[(size_t)m * N + n] = from_f<T>(s);
        else
          ws[((size_t)blockIdx.z * M + m) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// -- tiled (M > 16) -----------------------------------------------------------
constexpr int TM = 128, TN = 64, TK = 16;   // CTA tile
constexpr int TR = 8, TC = 4;               // outputs per thread (rows, cols)
constexpr int T_THREADS = (TM / TR) * (TN / TC);  // 256
constexpr int T_MIN_ROWS = 256;             // fewest K rows a split may own

template <typename T>
__global__ void __launch_bounds__(T_THREADS)
mm_tiled(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
         float* __restrict__ ws, int M, int N, int K, int rows_per_split) {
  __shared__ float As[TK][TM + 4];   // A tile, transposed (k-major)
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % (TN / TC);    // 16 column lanes: cols tx + 16 * j
  const int ty = tid / (TN / TC);    // 16 row lanes:    rows ty + 16 * i
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    for (int i = tid; i < TM * TK; i += T_THREADS) {
      const int r = i / TK, c = i % TK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end) ? to_f<T>(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < TK * TN; i += T_THREADS) {
      const int r = i / TN, c = i % TN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < k_end && gn < N) ? to_f<T>(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        if (gridDim.z == 1)
          C[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
        else
          ws[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      }
    }
  }
}

// -- split-K reduction --------------------------------------------------------
template <typename T>
__global__ void mm_reduce(const float* __restrict__ ws, T* __restrict__ C,
                          int splits, size_t MN) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * MN + i];
    C[i] = from_f<T>(s);
  }
}

int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

int splits_for(int M, int N, int K, int n_sm) {
  long tiles;
  int min_rows;
  if (M <= SK_MAXM) {
    tiles = ceil_div(N, SK_STRIPE);
    min_rows = SK_MIN_ROWS;
  } else {
    tiles = (long)ceil_div(N, TN) * ceil_div(M, TM);
    min_rows = T_MIN_ROWS;
  }
  const int want = ceil_div((long)CTAS_PER_SM * n_sm, tiles);
  return std::max(1, std::min(want, K / min_rows));
}

template <typename T, int MT>
void launch_skinny(const T* A, const T* B, T* C, float* ws, int M, int N,
                   int K, int splits, int rows, cudaStream_t s) {
  dim3 grid(ceil_div(N, SK_STRIPE), 1, splits);
  const bool vec = N % SK_COLS == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if (vec)
    mm_skinny<T, MT, true><<<grid, SK_WARPS * 32, 0, s>>>(A, B, C, ws, M, N, K, rows);
  else
    mm_skinny<T, MT, false><<<grid, SK_WARPS * 32, 0, s>>>(A, B, C, ws, M, N, K, rows);
}

template <typename T>
void launch(const void* a, const void* b, void* c, float* ws, int M, int N,
            int K, int splits, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  const int rows = ceil_div(K, splits);
  if (M <= 1)
    launch_skinny<T, 1>(A, B, C, ws, M, N, K, splits, rows, s);
  else if (M <= 2)
    launch_skinny<T, 2>(A, B, C, ws, M, N, K, splits, rows, s);
  else if (M <= 4)
    launch_skinny<T, 4>(A, B, C, ws, M, N, K, splits, rows, s);
  else if (M <= 8)
    launch_skinny<T, 8>(A, B, C, ws, M, N, K, splits, rows, s);
  else if (M <= SK_MAXM)
    launch_skinny<T, SK_MAXM>(A, B, C, ws, M, N, K, splits, rows, s);
  else {
    dim3 grid(ceil_div(N, TN), ceil_div(M, TM), splits);
    mm_tiled<T><<<grid, T_THREADS, 0, s>>>(A, B, C, ws, M, N, K, rows);
  }
  if (splits > 1) {
    const size_t MN = (size_t)M * N;
    const int blocks = (int)std::min<size_t>((MN + 255) / 256, (size_t)4096);
    mm_reduce<T><<<blocks, 256, 0, s>>>(ws, C, splits, MN);
  }
}

}  // namespace

// K splits the launch will use for this shape on a card with n_sm SMs; the
// caller allocates a (splits, M, N) f32 workspace when it is above 1.
extern "C" int mm_splits(int M, int N, int K, int n_sm) {
  return splits_for(M, N, K, n_sm);
}

// C = A @ B on `stream`; dtype is DT_F32 or DT_BF16 for all three matrices;
// ws: (splits, M, N) f32 scratch, unused when splits == 1.
extern "C" int mm_launch(const void* a, const void* b, void* c, void* ws,
                         int M, int N, int K, int splits, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  if (dtype == DT_F32) {
    launch<float>(a, b, c, w, M, N, K, splits, s);
  } else if (dtype == DT_BF16) {
    launch<__nv_bfloat16>(a, b, c, w, M, N, K, splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

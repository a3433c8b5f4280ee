// Shared helpers of the port's CUDA kernels: element conversion to and from
// the f32 the kernels accumulate in, warp reductions, the PTX wrappers of
// cp.async, ldmatrix and the bf16 mma.sync, the fixed-order sum of a split
// launch's partials, the C error hook.
#pragma once

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

// dtype codes shared with the Python wrappers (kernels/<name>/<name>.py)
enum { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and jax cast
}

// x rounded to T and back: the reference rounds the softmax weights to the
// value dtype before the p @ v product (p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; full == false reads nothing and
// writes zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The second pass of a split launch (matmul's split K, conv2d's split R):
// C[i] = sum over z in order of ws[z][i], rounded once to T, so the result
// does not depend on which CTA of the first pass ended first.  VEC: 4
// elements a thread by 16-byte loads (MN % 4 == 0), the same sums in the
// same order.
template <typename T, bool VEC>
__global__ void split_reduce(const float* __restrict__ ws, T* __restrict__ C,
                             int splits, size_t MN) {
  constexpr int V = VEC ? 4 : 1;
  for (size_t i = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * V; i < MN;
       i += (size_t)gridDim.x * blockDim.x * V) {
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float* p = ws + z * MN + i;
      if constexpr (VEC) {
        const float4 w = *reinterpret_cast<const float4*>(p);
        s[0] += w.x;
        s[1] += w.y;
        s[2] += w.z;
        s[3] += w.w;
      } else {
        s[0] += *p;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) C[i + v] = from_f<T>(s[v]);
  }
}

// split_reduce over the MN outputs of a (splits, MN) workspace, on s
template <typename T>
inline void launch_split_reduce(const float* ws, T* C, int splits, size_t MN,
                                cudaStream_t s) {
  const bool vec = MN % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const size_t per = vec ? 4 * 256 : 256;
  const int blocks = (int)std::min<size_t>((MN + per - 1) / per, (size_t)4096);
  if (vec)
    split_reduce<T, true><<<blocks, 256, 0, s>>>(ws, C, splits, MN);
  else
    split_reduce<T, false><<<blocks, 256, 0, s>>>(ws, C, splits, MN);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The pieces flash attention's warpgroup kernels share (the forward's
// fa_wgmma_kernel in flash_attention.cu, the backward's *_wgmma kernels in
// flash_attention_bwd.cu): the CTA's shape (two consumer warpgroups and a
// producer warp), the TMA box of a (B, S, H, D) bf16 tensor seen as (D, H,
// S, B) and its tensor map, the visibility of a (query, key) pair and of a
// tile of 64 rows (causal, the one-sided window, ragged Sq and Skv), and
// the opt-in to more than 48 KB of dynamic shared memory.  sm_90a only.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int WG = 128;              // threads of a warpgroup
constexpr int FB_THREADS = 2 * WG + 32;   // consumers 0-255, the producer
                                          // warp 256-287
constexpr int BOX = 64 * 128;        // bytes of a TMA box: 64 rows of 64 bf16
                                     // (one 128-byte swizzle line a row)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv,
                                        int window, int causal) {
  return qi < Sq && kj < Skv && (!causal || qi >= kj) &&
         (window <= 0 || qi - kj < window);
}

// every (query, key) of the tiles [q0, q0 + 64) x [k0, k0 + nk) visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int Sq, int Skv,
                                          int window, int causal,
                                          int nk = 64) {
  return q0 + 64 <= Sq && k0 + nk <= Skv &&
         (!causal || q0 >= k0 + nk - 1) &&
         (window <= 0 || q0 + 63 - k0 < window);
}

// some (query, key) of rows [r0, r0 + 64) x keys [k0, k0 + nk) visible (the
// differences q - k of the two ranges form one interval)
__device__ __forceinline__ bool tile_any(int r0, int k0, int Sq, int Skv,
                                         int window, int causal,
                                         int nk = 64) {
  if (r0 >= Sq || k0 >= Skv) return false;
  const int r1 = min(r0 + 63, Sq - 1), k1 = min(k0 + nk - 1, Skv - 1);
  return (!causal || r1 >= k0) && (window <= 0 || r0 - k1 < window);
}

// above 48 KB of dynamic shared memory needs an opt-in, once per kernel
template <typename K>
int allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

// the map of a (B, S, H, D) bf16 tensor as (D, H, S, B), boxes of 64
// columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle (a box is
// `rows` lines of 128 bytes); columns past D and rows past S read as zeros
bool encode_bshd(CUtensorMap* map, const void* p, int B, int S, int H,
                 int D, int rows = 64) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  constexpr cuuint64_t E = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * E, (cuuint64_t)H * D * E,
                                 (cuuint64_t)S * H * D * E};
  const cuuint32_t box[4] = {64u, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

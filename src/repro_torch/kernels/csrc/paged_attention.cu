// Paged decode attention: one query token per slot against its chain of KV
// blocks in a shared pool, through a block table.  q (B, Hq, D), pages
// (N, bs, Hkv, D), tables (B, T) int32, cur_pos (B,) int32, out (B, Hq, D);
// bf16 or f32 compute, f32 scores / softmax state / accumulator.  The
// kernel itself is the decode template of decode_attention.cuh (design and
// bound there); this file holds its three paged entry points:
//
//   pa_launch         float pages.  Replaces src/repro/kernels/
//                     paged_attention/paged_attention.py::paged_decode_pallas.
//                     The new token's K/V row must already be in the pool.
//   pa_sparse_launch  float pages plus a (B, Hkv, T) keep mask from
//                     block_keep_mask.  Replaces paged_decode_sparse_pallas.
//                     A dropped block is skipped with no read (the Pallas
//                     kernel redirected its DMA to null block 0 and masked
//                     it): the block contributes 0 mass and 0 bytes.
//   pa_quant_launch   packed int8 or e4m3 pages with (N, Hkv) f32 scales,
//                     dequantized while staging each tile in shared memory,
//                     optional keep mask.  Replaces
//                     paged_decode_quant_pallas.  HBM moves packed bytes
//                     only.  At cur_pos the optional k_row / v_row (B, Hkv,
//                     D) stand in for the pool: the caller requantizes the
//                     slot's current block after attention.
//
// Inactive slots (cur_pos 0, null tables) read null block 0; their output
// is ignored but stays finite.
#include "decode_attention.cuh"

namespace {

// page dtype codes shared with the Python wrappers (_build.PAGE_CODES)
enum { PG_INT8 = 0, PG_E4M3 = 1 };

template <typename T, bool KEEP>
int float_pages(const decode::Args& a, int B, cudaStream_t s) {
  return decode::launch<T, T, false, KEEP, false>(a, B, s);
}

template <typename T>
int quant_pages(const decode::Args& a, int B, int page_dtype, bool keep,
                cudaStream_t s) {
  if (page_dtype == PG_INT8)
    return keep ? decode::launch<T, int8_t, true, true, false>(a, B, s)
                : decode::launch<T, int8_t, true, false, false>(a, B, s);
  if (page_dtype == PG_E4M3)
    return keep ? decode::launch<T, __nv_fp8_e4m3, true, true, false>(a, B, s)
                : decode::launch<T, __nv_fp8_e4m3, true, false, false>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

decode::Args paged_args(const void* q, const void* kp, const void* vp,
                        const void* tables, const void* cur_pos, void* o,
                        void* ws, int B, int Hq, int Hkv, int D, int bs,
                        int T_, int window, int splits) {
  decode::Args a{};
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.tables = static_cast<const int*>(tables);
  a.cur = static_cast<const int*>(cur_pos);
  a.cur_stride = 1;
  a.o = o;
  a.ws = static_cast<float*>(ws);
  a.splits = splits;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.bs = bs;
  a.T = T_;
  a.window = window;
  a.scale = 1.f / sqrtf((float)D);
  return a;
}

}  // namespace

// window <= 0 means no window.  ws: the (splits, B, Hq, D + 2) f32
// workspace of a split launch, null iff splits == 1.  Limits (also checked
// by the wrappers): D <= 128, Hq % Hkv == 0, Hq / Hkv <= 32.
extern "C" int pa_launch(const void* q, const void* kp, const void* vp,
                         const void* tables, const void* cur_pos, void* o,
                         void* ws, int B, int Hq, int Hkv, int D, int bs,
                         int T_, int window, int dtype, int splits,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || T_ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const decode::Args a =
      paged_args(q, kp, vp, tables, cur_pos, o, ws, B, Hq, Hkv, D, bs, T_,
                 window, splits);
  if (dtype == DT_F32) return float_pages<float, false>(a, B, s);
  if (dtype == DT_BF16) return float_pages<__nv_bfloat16, false>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// keep: (B, Hkv, T) int32, nonzero = read the block.
extern "C" int pa_sparse_launch(const void* q, const void* kp, const void* vp,
                                const void* tables, const void* cur_pos,
                                const void* keep, void* o, void* ws, int B,
                                int Hq, int Hkv, int D, int bs, int T_,
                                int window, int dtype, int splits,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || T_ < 1 || keep == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  decode::Args a =
      paged_args(q, kp, vp, tables, cur_pos, o, ws, B, Hq, Hkv, D, bs, T_,
                 window, splits);
  a.keep = static_cast<const int*>(keep);
  if (dtype == DT_F32) return float_pages<float, true>(a, B, s);
  if (dtype == DT_BF16) return float_pages<__nv_bfloat16, true>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// k_scales / v_scales: (N, Hkv) f32.  k_row / v_row: (B, Hkv, D) of the
// compute dtype, or both null.  keep: (B, Hkv, T) int32, or null.
extern "C" int pa_quant_launch(const void* q, const void* kp, const void* vp,
                               const void* k_scales, const void* v_scales,
                               const void* k_row, const void* v_row,
                               const void* tables, const void* cur_pos,
                               const void* keep, void* o, void* ws, int B,
                               int Hq, int Hkv, int D, int bs, int T_,
                               int window, int dtype, int page_dtype,
                               int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || T_ < 1 || (k_row == nullptr) != (v_row == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  decode::Args a =
      paged_args(q, kp, vp, tables, cur_pos, o, ws, B, Hq, Hkv, D, bs, T_,
                 window, splits);
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.k_row = k_row;
  a.v_row = v_row;
  a.keep = static_cast<const int*>(keep);
  const bool has_keep = keep != nullptr;
  if (dtype == DT_F32) return quant_pages<float>(a, B, page_dtype, has_keep, s);
  if (dtype == DT_BF16)
    return quant_pages<__nv_bfloat16>(a, B, page_dtype, has_keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash decode: one query token per slot against a dense KV cache.
// q (B, Hq, D), caches (B, S, Hkv, D), cur_pos a scalar or (B,) int32
// (positions [0, cur_pos[b]] of slot b are valid), out (B, Hq, D); bf16 or
// f32, f32 scores / softmax state / accumulator.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py::
// flash_decode_pallas (_fd_kernel).  The Pallas kernel streams (bk = 512)-
// row tiles of a (B * Hkv, S, D) transposed copy of the cache through VMEM
// with the kv axis sequential; here the decode template of
// decode_attention.cuh (design and bound there) reads the (B, S, Hkv, D)
// cache in place, `splits` CTAs per (slot, kv head) each walking one slice
// of the positions up to cur_pos[b] (and from the first the window
// reaches), so a partially filled slab costs the bytes of its live rows,
// not of S.  S needs no tile multiple.
#include "decode_attention.cuh"

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

// Device helpers shared by the port's lerp-shift kernels (rot3.cu, shear.cu).
//
// Every lerp rounds each product and the sum on its own (no FMA contraction),
// so a kernel's output is bit-identical to the plain PyTorch version, which
// runs the same f32 operations as separate element-wise kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// (1 - f) * a + f * b, each product and the sum rounded on its own.
__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), a), __fmul_rn(f, b));
}

// i in [0, 2P) -> i mod P; i in [-P, P) -> i mod P.
__device__ __forceinline__ int wrap_up(int i, int P) { return i >= P ? i - P : i; }
__device__ __forceinline__ int wrap_down(int i, int P) { return i < 0 ? i + P : i; }

// Sum over the warp in a fixed shuffle tree: the same result on every run.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// k = floor(d) mod P and f = d - floor(d) (exact: the fraction of a float is one).
__device__ __forceinline__ void split_shift(float d, int P, int* k, float* f) {
  const float fl = floorf(d);
  const int m = static_cast<int>(fl) % P;
  *k = m < 0 ? m + P : m;
  *f = __fsub_rn(d, fl);
}

}  // namespace

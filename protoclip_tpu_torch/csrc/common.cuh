// Shared helpers for the port's Hopper kernels.
//
// Every kernel is built into one shared library with a plain C interface
// (see protoclip_tpu_torch/ops/_build.py) and launched through ctypes from
// protoclip_tpu_torch/ops/kernels.py.  Each C entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Activation dtype codes; must match _DTYPES in ops/kernels.py.
enum { PCK_F32 = 0, PCK_BF16 = 1 };

namespace pck {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to T and widen it again: the `.astype(dtype)` cast points
// of the TPU kernel, kept in float registers.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// QuickGELU op by op in T, each op rounded, as JAX evaluates
// hb * (1.0 / (1.0 + jnp.exp(-(hb * 1.702)))) on a T array: the weak-typed
// constant is T(1.702).  hb is already a value of T; the result is not
// rounded.
template <typename T>
__device__ __forceinline__ float quick_gelu_rounded(float hb) {
  float t = round_to<T>(__fmul_rn(hb, round_to<T>(1.702f)));
  t = round_to<T>(expf(-t));
  t = round_to<T>(__fadd_rn(1.f, t));
  t = round_to<T>(__fdiv_rn(1.f, t));
  return __fmul_rn(hb, t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace pck

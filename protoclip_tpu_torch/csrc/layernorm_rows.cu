// layernorm_rows: LayerNorm over the last axis of a (rows, D) activation.
//
// Replaces: the `ln` step inside protoclip_tpu/ops/pallas_kernels.py
// ::_block_kernel (:263-272), run twice per block (LN1, LN2).  Cast points
// as there: fp32 mean and variance, x_hat = (x - mean) * rsqrt(var + eps),
// fp32 affine, one rounding to the activation dtype.
//
// Bound on the H100: bytes.  It reads D values and writes D values per row
// and does ~8 flops per value, far below the ~295 flop/byte ridge.
//
// Design: one warp per row, 8 rows per 256-thread block.  The warp reads
// the row three times (sum, centred sum of squares, write); a row of
// ViT-L width is 2 KB in bf16, so the second and third reads hit L1.
// Statistics are reduced with warp shuffles, no shared memory.
#include "common.cuh"

namespace {

constexpr int LN_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;

  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += pck::to_f(xr[i]);
  const float mean = pck::warp_sum(s) / d;

  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = pck::to_f(xr[i]) - mean;
    v += c * c;
  }
  const float rstd = rsqrtf(pck::warp_sum(v) / d + eps);

  T* orow = out + row * d;
  for (int i = lane; i < d; i += 32) {
    const float normed = (pck::to_f(xr[i]) - mean) * rstd;
    orow[i] = pck::from_f<T>(normed * scale[i] + bias[i]);
  }
}

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* out,
            int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  layernorm_rows_kernel<T><<<blocks, LN_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, d, eps);
}

}  // namespace

extern "C" int layernorm_rows(int dtype, const void* x, const void* scale,
                              const void* bias, void* out, int rows, int d,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PCK_BF16)
    launch<__nv_bfloat16>(x, scale, bias, out, rows, d, eps, s);
  else if (dtype == PCK_F32)
    launch<float>(x, scale, bias, out, rows, d, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* protoclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

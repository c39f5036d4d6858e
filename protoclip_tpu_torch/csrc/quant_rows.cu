// quant_rows: per-row symmetric int8 quantization of a (rows, W) tensor,
// optionally of its LayerNorm.
//
// Replaces: protoclip_tpu/ops/pallas_kernels.py::_quant_rows (:500) at the
// four activation quantization points of ::_block_kernel_int8 (K3):
//   mode (a), ln_scale != NULL: the fp32 LayerNorm output (:527-534, :576):
//     fp32 mean and variance, ((x - mean) * rsqrt(var + eps)) * scale +
//     bias in fp32, never rounded to the activation dtype, then quantized;
//   mode (b), ln_scale == NULL: the row itself (the bf16/fp32 attention
//     output at :568, the fp32 QuickGELU hidden at :579).
// Per row: scale = max(amax, 1e-6) / 127, q = clip(rint(v / scale), +-127),
// with IEEE division and round half to even, as jnp.round does.  Every
// product, sum and quotient of the quantizer is written with the _rn
// intrinsics, which nvcc never contracts into an FMA, so mode (b) is
// bit-exact against the plain PyTorch version (max is order-free).  Mode
// (a) sums its statistics in another order than the plain version.
//
// Bound on the H100: bytes.  A row is read and written once, ~10 flops per
// value, far below the ~295 flop/byte ridge.
//
// Design (simple first): one warp per row, 8 rows per 256-thread block,
// rows on gridDim.x (up to 79k rows at the text encode batch).  The warp
// reads the row for the statistics, once for the absolute maximum and once
// to quantize, recomputing the LayerNorm value each time (the same
// instructions, so the same bits); a 4096-wide fp32 row is 16 KB and the
// re-reads hit L1.  The scale is written by lane 0.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int QR_WARPS = 8;

template <typename T, bool LN>
__global__ void __launch_bounds__(QR_WARPS * 32)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, int8_t* __restrict__ q,
                  float* __restrict__ scales, int rows, int w, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * QR_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * w;

  float mean = 0.f, rstd = 0.f;
  if (LN) {
    float s = 0.f;
    for (int i = lane; i < w; i += 32) s += pck::to_f(xr[i]);
    mean = pck::warp_sum(s) / w;
    float v = 0.f;
    for (int i = lane; i < w; i += 32) {
      const float c = __fsub_rn(pck::to_f(xr[i]), mean);
      v = __fadd_rn(v, __fmul_rn(c, c));
    }
    rstd = rsqrtf(pck::warp_sum(v) / w + eps);
  }
  auto value = [&](int i) {
    const float v = pck::to_f(xr[i]);
    if (!LN) return v;
    const float normed = __fmul_rn(__fsub_rn(v, mean), rstd);
    return __fadd_rn(__fmul_rn(normed, ln_scale[i]), ln_bias[i]);
  };

  float amax = 0.f;
  for (int i = lane; i < w; i += 32) amax = fmaxf(amax, fabsf(value(i)));
  amax = pck::warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);

  int8_t* qr = q + row * w;
  for (int i = lane; i < w; i += 32) {
    const float r = rintf(__fdiv_rn(value(i), scale));
    qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
void launch(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
            int rows, int w, float eps, cudaStream_t stream) {
  const int blocks = (rows + QR_WARPS - 1) / QR_WARPS;
  const T* xt = static_cast<const T*>(x);
  if (ln_scale != nullptr)
    quant_rows_kernel<T, true><<<blocks, QR_WARPS * 32, 0, stream>>>(
        xt, ln_scale, ln_bias, q, s, rows, w, eps);
  else
    quant_rows_kernel<T, false><<<blocks, QR_WARPS * 32, 0, stream>>>(
        xt, nullptr, nullptr, q, s, rows, w, eps);
}

}  // namespace

extern "C" int quant_rows(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                          void* q, void* scales, int rows, int w, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if ((ls == nullptr) != (lb == nullptr) || rows < 0 || w < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (dtype == PCK_BF16)
    launch<__nv_bfloat16>(x, ls, lb, qo, so, rows, w, eps, st);
  else if (dtype == PCK_F32)
    launch<float>(x, ls, lb, qo, so, rows, w, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

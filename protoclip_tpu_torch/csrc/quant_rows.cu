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
// Modes of the block-variant bench (scripts/bench_block_variants.py,
// make_kernel_int8 :769), chosen by `qmode` and `ln_bf16`:
//   QR_RECIP   _quant_rows_recip (:758-766): amax = max(amax, 1e-6),
//              r = 127 / amax (true division), q = clip(rint(v * r)),
//              scale = amax * f32(1/127)
//   QR_STATIC  (:777-781): q = clip(rint(v * 32)), scale 1/32, no amax pass
//   QR_CAST    (:788-791): q = v * 32 truncated toward zero and saturated to
//              [-128, 127], NaN -> 0 (XLA's f32 -> s8 convert), scale 1/32
//   ln_bf16    int8lnb's LayerNorm (:798-807): mean = T(sum / W), c = T(v -
//              mean), var = T(sum(T(c * c)) / W) in the input dtype T, then
//              c * rsqrt(var + eps) * scale + bias in fp32
// Every mode writes a scale per row, so the int8 GEMM dequantizes the same
// way for all of them.
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
enum { QR_DYN = 0, QR_RECIP = 1, QR_STATIC = 2, QR_CAST = 3 };
enum { LN_NONE = 0, LN_F32 = 1, LN_BF16_STATS = 2 };

__device__ __forceinline__ int8_t clip127(float r) {
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// LNM: no LayerNorm, fp32 statistics, or statistics in T; QMODE: the
// quantizer.  Both are template parameters: a runtime switch in the row
// loops costs registers and time in the production modes.
template <typename T, int LNM, int QMODE>
__global__ void __launch_bounds__(QR_WARPS * 32)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, int8_t* __restrict__ q,
                  float* __restrict__ scales, int rows, int w, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * QR_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * w;

  float mean = 0.f, rstd = 0.f;
  if constexpr (LNM != LN_NONE) {
    float s = 0.f;
    for (int i = lane; i < w; i += 32) s += pck::to_f(xr[i]);
    if constexpr (LNM == LN_BF16_STATS) {
      mean = pck::round_to<T>(__fdiv_rn(pck::warp_sum(s), (float)w));
      float v = 0.f;
      for (int i = lane; i < w; i += 32) {
        const float c = pck::round_to<T>(__fsub_rn(pck::to_f(xr[i]), mean));
        v = __fadd_rn(v, pck::round_to<T>(__fmul_rn(c, c)));
      }
      rstd = rsqrtf(__fadd_rn(pck::round_to<T>(__fdiv_rn(pck::warp_sum(v), (float)w)), eps));
    } else {
      mean = pck::warp_sum(s) / w;
      float v = 0.f;
      for (int i = lane; i < w; i += 32) {
        const float c = __fsub_rn(pck::to_f(xr[i]), mean);
        v = __fadd_rn(v, __fmul_rn(c, c));
      }
      rstd = rsqrtf(pck::warp_sum(v) / w + eps);
    }
  }
  auto value = [&](int i) {
    const float v = pck::to_f(xr[i]);
    if constexpr (LNM == LN_NONE) {
      return v;
    } else {
      const float c = LNM == LN_BF16_STATS ? pck::round_to<T>(__fsub_rn(v, mean))
                                           : __fsub_rn(v, mean);
      const float normed = __fmul_rn(c, rstd);
      return __fadd_rn(__fmul_rn(normed, ln_scale[i]), ln_bias[i]);
    }
  };

  if constexpr (QMODE == QR_STATIC || QMODE == QR_CAST) {
    int8_t* qr = q + row * w;
    for (int i = lane; i < w; i += 32) {
      const float t = __fmul_rn(value(i), 32.f);
      qr[i] = QMODE == QR_STATIC
                  ? clip127(rintf(t))
                  : static_cast<int8_t>(isnan(t) ? 0.f : fminf(fmaxf(truncf(t), -128.f), 127.f));
    }
    if (lane == 0) scales[row] = 1.f / 32.f;
  } else {
    float amax = 0.f;
    for (int i = lane; i < w; i += 32) amax = fmaxf(amax, fabsf(value(i)));
    amax = pck::warp_max(amax);
    if constexpr (QMODE == QR_RECIP) {
      amax = fmaxf(amax, 1e-6f);
      const float r = __fdiv_rn(127.f, amax);
      int8_t* qr = q + row * w;
      for (int i = lane; i < w; i += 32) qr[i] = clip127(rintf(__fmul_rn(value(i), r)));
      if (lane == 0) scales[row] = __fmul_rn(amax, 1.f / 127.f);
    } else {
      const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
      int8_t* qr = q + row * w;
      for (int i = lane; i < w; i += 32) {
        const float r = rintf(__fdiv_rn(value(i), scale));
        qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
      }
      if (lane == 0) scales[row] = scale;
    }
  }
}

template <typename T, int LNM, int QMODE>
void launch_mode(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
                 int rows, int w, float eps, cudaStream_t stream) {
  const int blocks = (rows + QR_WARPS - 1) / QR_WARPS;
  quant_rows_kernel<T, LNM, QMODE><<<blocks, QR_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, q, s, rows, w, eps);
}

template <typename T, int LNM>
void launch_ln(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
               int rows, int w, float eps, int qmode, cudaStream_t st) {
  switch (qmode) {
    case QR_DYN: return launch_mode<T, LNM, QR_DYN>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
    case QR_RECIP:
      return launch_mode<T, LNM, QR_RECIP>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
    case QR_STATIC:
      return launch_mode<T, LNM, QR_STATIC>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
    default: return launch_mode<T, LNM, QR_CAST>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
  }
}

template <typename T>
void launch(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
            int rows, int w, float eps, int qmode, int ln_bf16, cudaStream_t st) {
  if (ln_scale == nullptr)
    launch_ln<T, LN_NONE>(x, nullptr, nullptr, q, s, rows, w, eps, qmode, st);
  else if (ln_bf16)
    launch_ln<T, LN_BF16_STATS>(x, ln_scale, ln_bias, q, s, rows, w, eps, qmode, st);
  else
    launch_ln<T, LN_F32>(x, ln_scale, ln_bias, q, s, rows, w, eps, qmode, st);
}

}  // namespace

// qmode: QR_DYN, QR_RECIP, QR_STATIC or QR_CAST; ln_bf16 (with ln_scale):
// the LayerNorm statistics in the input dtype.
extern "C" int quant_rows(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                          void* q, void* scales, int rows, int w, float eps, int qmode,
                          int ln_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if ((ls == nullptr) != (lb == nullptr) || rows < 0 || w < 1 || qmode < QR_DYN ||
      qmode > QR_CAST || (ln_bf16 && ls == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (dtype == PCK_BF16)
    launch<__nv_bfloat16>(x, ls, lb, qo, so, rows, w, eps, qmode, ln_bf16, st);
  else if (dtype == PCK_F32)
    launch<float>(x, ls, lb, qo, so, rows, w, eps, qmode, ln_bf16, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

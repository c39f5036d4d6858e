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
//
// layernorm_sub_rows: the same LayerNorm over the first `width` values of
// rows `stride` apart, with the lanes from width to stride written as 0 and
// kept out of the statistics.  It replaces no TPU kernel: it is the EVA02
// block's sub-LN over the SwiGLU hidden (ops/kernels.py::fused_eva_block),
// whose width (2730 in EVA02-L) is padded to a multiple of 8 for the GEMMs'
// 16-byte rows; the block's other sub-LN, over the attention output, has
// no padded lanes and runs on layernorm_rows.  Bound
// by bytes, as above; a warp reads its row in 16-byte pieces, three times
// (sum, centred sum of squares, write; the second and third from L1), and
// writes the row's whole stride.  A kernel of its own, so that a trace tells
// the hidden's sub-LN from the LayerNorms.
//
// layernorm_residual_rows: out = T(x + T(LN(a))) a row, the residual step of
// EVA-CLIP's post-norm block (eva_vit_model.py::Block with postnorm: x +
// norm1(attn(x)), then x + norm2(mlp(x)); ops/kernels.py::
// fused_eva_postnorm_block), which normalises the branch's output and not
// the block's input.  It replaces no TPU kernel.  Cast points: fp32 mean and
// centred variance of a, fp32 affine, the LayerNorm rounded to T, the sum
// with x in fp32, rounded to T once more.  Bound by bytes: a and x read
// once, out written once, ~10 flops a value.  Design: one warp a row; the
// warp copies its row of a into shared memory in 16-byte pieces as it sums
// it, takes the centred sum of squares from there, and writes out from
// shared memory and one read of x, so each byte of a and x leaves DRAM once
// whatever the width (a multiple of 8, up to 232,448 bytes a row).  Each
// lane reads back only the pieces it wrote, so no barrier is needed.  Up to
// 8 warps a block, as many rows as fit 48 KB (8 at d = 1792 in bf16: 28 KB).
#include <algorithm>
#include <cstdint>

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
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_sub_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int rows, int width, int stride, float eps) {
  constexpr int V = 16 / sizeof(T);  // values in a 16-byte piece
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * stride;

  float s = 0.f;
  for (int p = lane * V; p < width; p += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (p + e < width) s += pck::to_f(v[e]);
  }
  const float mean = pck::warp_sum(s) / width;

  float var = 0.f;
  for (int p = lane * V; p < width; p += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (p + e < width) {
        const float c = pck::to_f(v[e]) - mean;
        var += c * c;
      }
  }
  const float rstd = rsqrtf(pck::warp_sum(var) / width + eps);

  T* orow = out + row * stride;
  for (int p = lane * V; p < stride; p += 32 * V) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (p < width) raw = *reinterpret_cast<const uint4*>(xr + p);
    const T* v = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = p + e;
      o[e] = pck::from_f<T>(i < width ? (pck::to_f(v[e]) - mean) * rstd * scale[i] + bias[i]
                                      : 0.f);
    }
    *reinterpret_cast<uint4*>(orow + p) = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_residual_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                               const float* __restrict__ scale, const float* __restrict__ bias,
                               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // values in a 16-byte piece
  extern __shared__ __align__(16) unsigned char ln_res_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const T* ar = a + row * d;
  T* sa = reinterpret_cast<T*>(ln_res_smem) + (size_t)warp * d;

  float s = 0.f;
#pragma unroll 4
  for (int p = lane * V; p < d; p += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(ar + p);
    *reinterpret_cast<uint4*>(sa + p) = raw;
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) s += pck::to_f(v[e]);
  }
  const float mean = pck::warp_sum(s) / d;

  float var = 0.f;
  for (int p = lane * V; p < d; p += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sa + p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float c = pck::to_f(v[e]) - mean;
      var += c * c;
    }
  }
  const float rstd = rsqrtf(pck::warp_sum(var) / d + eps);

  const T* xr = x + row * d;
  T* orow = out + row * d;
#pragma unroll 4
  for (int p = lane * V; p < d; p += 32 * V) {
    const uint4 ra = *reinterpret_cast<const uint4*>(sa + p);
    const uint4 rx = *reinterpret_cast<const uint4*>(xr + p);
    const T* va = reinterpret_cast<const T*>(&ra);
    const T* vx = reinterpret_cast<const T*>(&rx);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = p + e;
      const T ln = pck::from_f<T>((pck::to_f(va[e]) - mean) * rstd * scale[i] + bias[i]);
      o[e] = pck::from_f<T>(pck::to_f(vx[e]) + pck::to_f(ln));
    }
    *reinterpret_cast<uint4*>(orow + p) = res;
  }
}

constexpr size_t LN_RES_BLOCK_SMEM = 48 * 1024;  // rows of a a block hold at most
constexpr size_t LN_RES_MAX_SMEM = 232448;       // opt-in shared memory of an H100 block

template <typename T>
int launch_residual(const void* a, const void* x, const void* scale, const void* bias, void* out,
                    int rows, int d, float eps, cudaStream_t stream) {
  const size_t row_bytes = (size_t)d * sizeof(T);
  const int warps = (int)std::min<size_t>(LN_WARPS, std::max<size_t>(1, LN_RES_BLOCK_SMEM / row_bytes));
  const size_t smem = warps * row_bytes;
  if (smem > LN_RES_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > LN_RES_BLOCK_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(layernorm_residual_rows_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rows + warps - 1) / warps;
  layernorm_residual_rows_kernel<T><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, d, eps);
  return (int)cudaGetLastError();
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

extern "C" int layernorm_sub_rows(int dtype, const void* x, const void* scale,
                                  const void* bias, void* out, int rows, int width, int stride,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width < 1 || width > stride || stride % 8 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (dtype == PCK_BF16)
    layernorm_sub_rows_kernel<__nv_bfloat16><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), rows, width, stride,
        eps);
  else if (dtype == PCK_F32)
    layernorm_sub_rows_kernel<float><<<blocks, LN_WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out), rows, width, stride, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int layernorm_residual_rows(int dtype, const void* a, const void* x,
                                       const void* scale, const void* bias, void* out, int rows,
                                       int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d % 8 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (dtype == PCK_BF16)
    return launch_residual<__nv_bfloat16>(a, x, scale, bias, out, rows, d, eps, s);
  if (dtype == PCK_F32)
    return launch_residual<float>(a, x, scale, bias, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* protoclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

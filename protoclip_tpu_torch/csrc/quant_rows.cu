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
// Design: each row is read from device memory once and held in registers.
// A group of TPR threads (a warp, or the whole 128-thread block) owns a
// row; each thread loads VPT pieces of 16 bytes (8 bf16 or 4 fp32 values),
// piece t + i * TPR of the row, so a warp's loads are contiguous.  The
// LayerNorm statistics, the LayerNorm value (once per element), the amax
// and the codes all come from those registers; the codes of a piece go out
// in one 8- or 4-byte store.  Group sums and maxima are warp shuffles, plus
// four shared-memory slots across the warps of a 128-thread group.
// (TPR, VPT) is a template parameter per width class, so the row stays in
// registers: up to 512 bytes a row a warp (bf16 W <= 512 at VPT 2, W <=
// 1024 at VPT 4, fp32 half of that), then a block a row (up to 2048 bytes:
// bf16 W <= 4096, fp32 W <= 2048 at VPT 4; fp32 W <= 4096 at VPT 8, e.g.
// the 3072-wide fp32 hidden at 24 values a thread).  W is a multiple of 8 up
// to 4096 and the tensors start on 16 bytes; the wrapper raises otherwise.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int QR_THREADS = 128;
constexpr int QR_MAX_WIDTH = 4096;
enum { QR_DYN = 0, QR_RECIP = 1, QR_STATIC = 2, QR_CAST = 3 };
enum { LN_NONE = 0, LN_F32 = 1, LN_BF16_STATS = 2 };

__device__ __forceinline__ int8_t clip127(float r) {
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// One 16-byte piece of x, widened to fp32 (exact).
__device__ __forceinline__ void load_piece(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x, v[2 * e + 1] = f.y;
  }
}

// The codes of one piece in one 4- or 8-byte store.
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[4]) {
  *reinterpret_cast<uint32_t*>(p) = (uint32_t)(uint8_t)c[0] | (uint32_t)(uint8_t)c[1] << 8 |
                                    (uint32_t)(uint8_t)c[2] << 16 | (uint32_t)(uint8_t)c[3] << 24;
}
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[8]) {
  uint2 u;
  u.x = (uint32_t)(uint8_t)c[0] | (uint32_t)(uint8_t)c[1] << 8 | (uint32_t)(uint8_t)c[2] << 16 |
        (uint32_t)(uint8_t)c[3] << 24;
  u.y = (uint32_t)(uint8_t)c[4] | (uint32_t)(uint8_t)c[5] << 8 | (uint32_t)(uint8_t)c[6] << 16 |
        (uint32_t)(uint8_t)c[7] << 24;
  *reinterpret_cast<uint2*>(p) = u;
}

// The sum (MAX false) or maximum of `v` over the row's group, the same
// value in every thread.  A 128-thread group meets in `red`.
template <int TPR, bool MAX>
__device__ __forceinline__ float group_reduce(float v, float* red) {
  v = MAX ? pck::warp_max(v) : pck::warp_sum(v);
  if constexpr (TPR == 32) {
    return v;
  } else {
    __syncthreads();  // the slots' last readers are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    return MAX ? fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]))
               : (red[0] + red[1]) + (red[2] + red[3]);
  }
}

// LNM: no LayerNorm, fp32 statistics, or statistics in T; QMODE: the
// quantizer; TPR threads a row, VPT 16-byte pieces a thread.  All are
// template parameters: a runtime switch in the row loops costs registers
// and time in the production modes, and a runtime VPT would put the row in
// local memory.
template <typename T, int LNM, int QMODE, int TPR, int VPT>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, int8_t* __restrict__ q,
                  float* __restrict__ scales, int rows, int w, float eps) {
  constexpr int E = 16 / sizeof(T);  // values a piece
  __shared__ float red[QR_THREADS / 32];
  const int t = threadIdx.x % TPR;
  const long row = (long)blockIdx.x * (QR_THREADS / TPR) + threadIdx.x / TPR;
  if (row >= rows) return;  // a whole warp: only a warp-sized group ends early
  const int pieces = w / E;
  const T* xr = x + row * w;

  float v[VPT][E];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (t + i * TPR < pieces) {
      load_piece(xr + (t + i * TPR) * E, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = 0.f;
    }
  }

  if constexpr (LNM != LN_NONE) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[i][e];  // the pieces past W hold zeros
    const float sum = group_reduce<TPR, false>(s, red);
    const float mean = LNM == LN_BF16_STATS ? pck::round_to<T>(__fdiv_rn(sum, (float)w))
                                            : __fdiv_rn(sum, (float)w);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (t + i * TPR < pieces) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (LNM == LN_BF16_STATS) {
            const float c = pck::round_to<T>(__fsub_rn(v[i][e], mean));
            ss = __fadd_rn(ss, pck::round_to<T>(__fmul_rn(c, c)));
          } else {
            const float c = __fsub_rn(v[i][e], mean);
            ss = __fadd_rn(ss, __fmul_rn(c, c));
          }
        }
      }
    }
    float var = __fdiv_rn(group_reduce<TPR, false>(ss, red), (float)w);
    if constexpr (LNM == LN_BF16_STATS) var = pck::round_to<T>(var);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    // the LayerNorm value, once per element, in place of the input
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int p = t + i * TPR;
      if (p < pieces) {
        float sc[E], bi[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 s4 = *reinterpret_cast<const float4*>(ln_scale + p * E + e);
          const float4 b4 = *reinterpret_cast<const float4*>(ln_bias + p * E + e);
          sc[e] = s4.x, sc[e + 1] = s4.y, sc[e + 2] = s4.z, sc[e + 3] = s4.w;
          bi[e] = b4.x, bi[e + 1] = b4.y, bi[e + 2] = b4.z, bi[e + 3] = b4.w;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c = LNM == LN_BF16_STATS ? pck::round_to<T>(__fsub_rn(v[i][e], mean))
                                               : __fsub_rn(v[i][e], mean);
          v[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(c, rstd), sc[e]), bi[e]);
        }
      }
    }
  }

  // the codes of every element from its value, one multiplier for the row
  float scale, mul = 0.f;
  if constexpr (QMODE == QR_STATIC || QMODE == QR_CAST) {
    scale = 1.f / 32.f;
  } else {
    float amax = 0.f;  // the pieces past W hold zeros
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
    amax = group_reduce<TPR, true>(amax, red);
    if constexpr (QMODE == QR_RECIP) {
      amax = fmaxf(amax, 1e-6f);
      mul = __fdiv_rn(127.f, amax);
      scale = __fmul_rn(amax, 1.f / 127.f);
    } else {
      scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
    }
  }
  int8_t* qr = q + row * w;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int p = t + i * TPR;
    if (p < pieces) {
      int8_t c[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if constexpr (QMODE == QR_DYN) {
          c[e] = clip127(rintf(__fdiv_rn(v[i][e], scale)));
        } else if constexpr (QMODE == QR_RECIP) {
          c[e] = clip127(rintf(__fmul_rn(v[i][e], mul)));
        } else {
          const float t32 = __fmul_rn(v[i][e], 32.f);
          c[e] = QMODE == QR_STATIC
                     ? clip127(rintf(t32))
                     : static_cast<int8_t>(isnan(t32) ? 0.f
                                                      : fminf(fmaxf(truncf(t32), -128.f), 127.f));
        }
      }
      store_codes(qr + p * E, c);
    }
  }
  if (t == 0) scales[row] = scale;
}

template <typename T, int LNM, int QMODE, int TPR, int VPT>
void launch_class(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
                  int rows, int w, float eps, cudaStream_t stream) {
  constexpr int per_block = QR_THREADS / TPR;
  const int blocks = (rows + per_block - 1) / per_block;
  quant_rows_kernel<T, LNM, QMODE, TPR, VPT><<<blocks, QR_THREADS, 0, stream>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, q, s, rows, w, eps);
}

// The width class: the fewest registers that hold the row.
template <typename T, int LNM, int QMODE>
void launch_mode(const void* x, const float* ln_scale, const float* ln_bias, int8_t* q, float* s,
                 int rows, int w, float eps, cudaStream_t st) {
  const int pieces = w / (16 / (int)sizeof(T));
  if (pieces <= 32 * 2)
    launch_class<T, LNM, QMODE, 32, 2>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
  else if (pieces <= 32 * 4)
    launch_class<T, LNM, QMODE, 32, 4>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
  else if (sizeof(T) == 2 || pieces <= 128 * 4)  // bf16 W <= 4096 is 512 pieces
    launch_class<T, LNM, QMODE, 128, 4>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
  else if constexpr (sizeof(T) == 4)
    launch_class<T, LNM, QMODE, 128, 8>(x, ln_scale, ln_bias, q, s, rows, w, eps, st);
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
// the LayerNorm statistics in the input dtype.  w: a multiple of 8 up to
// 4096; x, ln_scale and ln_bias start on 16 bytes.
extern "C" int quant_rows(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                          void* q, void* scales, int rows, int w, float eps, int qmode,
                          int ln_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if ((ls == nullptr) != (lb == nullptr) || rows < 0 || w < 8 || w % 8 || w > QR_MAX_WIDTH ||
      qmode < QR_DYN || qmode > QR_CAST || (ln_bf16 && ls == nullptr))
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

// gemm_bias_epilogue: out = epilogue(A (M,K) . W (K,N)), W in the JAX
// (in, out) layout, fp32 accumulation.
//
// Replaces: the four matrix products inside protoclip_tpu/ops/
// pallas_kernels.py::_block_kernel, each with the cast points of that
// kernel:
//   EPI_BIAS           QKV (:275-281):       T(T(acc) + b)
//   EPI_BIAS_RESIDUAL  out-proj (:311-318),  T(res + T(T(acc) + b))
//                      proj (:329-336)
//   EPI_BIAS_GELU      fc (:321-328):        T(h * sigmoid(1.702 h)),
//                                            h = acc + f32(b) in fp32
// The fc bias arrives already rounded to the activation dtype (the TPU
// wrapper casts it, :426) and is widened to fp32 here.
// Two more epilogues serve the block-variant bench
// (scripts/bench_block_variants.py):
//   EPI_BIAS_GELU_BF16    fc of v2/v3/v4 (:272-274), mlp_pallas (:452-454):
//                         hb = T(acc + f32(b)), then hb * (1 / (1 + exp(
//                         -(hb * T(1.702))))) with every op rounded to T
//                         (bf16 on the bench), as JAX evaluates it
//   EPI_BIAS32_RESIDUAL   int8h's bf16 down-projection (:893-901):
//                         T(res + T(acc + b)) with an fp32 bias
//
// Bound on the H100: operations.  At ViT-B/16 widths a product does
// 2*M*K*N flops over (M*K + K*N + M*N) values, hundreds of flops per byte
// for M in the tens of thousands, above the ~295 flop/byte bf16 ridge.
//
// Design (simple first): bf16 runs on the tensor cores through WMMA
// 16x16x16 fragments with fp32 accumulators.  A 256-thread block owns a
// 128x128 output tile; each of its 8 warps owns 64x32 (4x2 fragments).
// K advances in steps of 32 through padded shared-memory tiles, loaded with
// 16-byte vectors where the rows allow it and element by element at ragged
// edges (masked with zeros).  No cp.async pipeline, no wgmma, no TMA yet.
// fp32 runs a plain SIMT tile (64x64, 4x4 outputs a thread) in exact fp32:
// the tensor cores would round its operands to TF32.  The epilogue stages
// each accumulator fragment through shared memory and writes element-wise
// with the masks for ragged M and N.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

enum { EPI_BIAS = 0, EPI_BIAS_RESIDUAL = 1, EPI_BIAS_GELU = 2, EPI_BIAS_GELU_BF16 = 3,
       EPI_BIAS32_RESIDUAL = 4 };
// The block's three epilogues share one kernel and pick theirs at run time,
// as before the bench's were added; the bench's two are instantiations of
// their own.
constexpr int EPI_BLOCK = -1;

// The bias is T, or fp32 for EPI_BIAS32_RESIDUAL.
template <typename T, int EPI>
using bias_t = std::conditional_t<EPI == EPI_BIAS32_RESIDUAL, float, T>;

// EPI: EPI_BLOCK (then `epi` picks EPI_BIAS, EPI_BIAS_RESIDUAL or
// EPI_BIAS_GELU), EPI_BIAS_GELU_BF16 or EPI_BIAS32_RESIDUAL.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue_store(float acc, int epi,
                                               const bias_t<T, EPI>* __restrict__ bias,
                                               const T* __restrict__ resid, T* __restrict__ out,
                                               long m, int n, int N) {
  const long idx = m * N + n;
  if constexpr (EPI == EPI_BIAS32_RESIDUAL) {
    const float y = pck::round_to<T>(__fadd_rn(acc, bias[n]));
    out[idx] = pck::from_f<T>(__fadd_rn(pck::to_f(resid[idx]), y));
  } else if constexpr (EPI == EPI_BIAS_GELU_BF16) {
    out[idx] = pck::from_f<T>(
        pck::quick_gelu_rounded<T>(pck::round_to<T>(__fadd_rn(acc, pck::to_f(bias[n])))));
  } else {
    if (epi == EPI_BIAS_GELU) {
      const float h = acc + pck::to_f(bias[n]);
      out[idx] = pck::from_f<T>(h * (1.f / (1.f + expf(-1.702f * h))));
      return;
    }
    float y = pck::round_to<T>(pck::round_to<T>(acc) + pck::to_f(bias[n]));
    if (epi == EPI_BIAS_RESIDUAL) y = pck::to_f(resid[idx]) + y;
    out[idx] = pck::from_f<T>(y);
  }
}

// -- bf16: WMMA tensor-core tile ---------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;  // padded row strides (elements), 16-byte multiples
constexpr int B_LD = BN + 8;
constexpr int WMMA_THREADS = 256;

template <int EPI>
__global__ void __launch_bounds__(WMMA_THREADS)
gemm_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const bias_t<bf16, EPI>* __restrict__ bias, const bf16* __restrict__ resid,
               bf16* __restrict__ out, int M, int N, int K, int epi, int vec_a, int vec_b) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[WMMA_THREADS / 32][16 * 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bf16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK, in 8-element chunks
    for (int c = threadIdx.x; c < BM * BK / 8; c += WMMA_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const long gm = m0 + r;
      const int gk = k0 + kc;
      bf16* dst = As + r * A_LD + kc;
      if (vec_a && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(A + gm * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? A[gm * K + gk + e] : zero;
      }
    }
    // W tile: BK x BN
    for (int c = threadIdx.x; c < BK * BN / 8; c += WMMA_THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      bf16* dst = Bs + r * B_LD + nc;
      if (vec_b && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(W + (long)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? W[(long)gk * N + gn + e] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long gm = m0 + wm * 64 + i * 16 + (e >> 4);
        const int gn = n0 + wn * 32 + j * 16 + (e & 15);
        if (gm < M && gn < N) epilogue_store<bf16, EPI>(cs[e], epi, bias, resid, out, gm, gn, N);
      }
      __syncwarp();
    }
  }
}

// -- fp32: SIMT tile -------------------------------------------------------------

constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T, int EPI>
__global__ void __launch_bounds__(256)
gemm_simt(const T* __restrict__ A, const T* __restrict__ W,
          const bias_t<T, EPI>* __restrict__ bias,
          const T* __restrict__ resid, T* __restrict__ out, int M, int N, int K, int epi) {
  __shared__ float As[SBK][SBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[SBK][SBN + 4];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long m0 = (long)blockIdx.y * SBM;
  const int n0 = blockIdx.x * SBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int c = threadIdx.x; c < SBM * SBK; c += 256) {
      const int r = c / SBK, kk = c % SBK;
      const long gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? pck::to_f(A[gm * K + gk]) : 0.f;
    }
    for (int c = threadIdx.x; c < SBK * SBN; c += 256) {
      const int kk = c / SBN, nn = c % SBN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? pck::to_f(W[(long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) epilogue_store<T, EPI>(acc[i][j], epi, bias, resid, out, gm, gn, N);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int EPI>
void launch(int dtype, const void* a, const void* w, const void* bias, const void* resid,
            void* out, int M, int N, int K, int epi, cudaStream_t s) {
  if (dtype == PCK_BF16) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const int vec_a = (K % 8 == 0) && aligned16(a);
    const int vec_b = (N % 8 == 0) && aligned16(w);
    gemm_bf16_wmma<EPI><<<grid, WMMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w),
        static_cast<const bias_t<bf16, EPI>*>(bias), static_cast<const bf16*>(resid),
        static_cast<bf16*>(out), M, N, K, epi, vec_a, vec_b);
  } else {
    const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
    gemm_simt<float, EPI><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(resid),
        static_cast<float*>(out), M, N, K, epi);
  }
}

}  // namespace

extern "C" int gemm_bias_epilogue(int dtype, const void* a, const void* w, const void* bias,
                                  const void* resid, void* out, int M, int N, int K, int epi,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != PCK_BF16 && dtype != PCK_F32) return (int)cudaErrorInvalidValue;
  if (epi == EPI_BIAS_GELU_BF16)
    launch<EPI_BIAS_GELU_BF16>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  else if (epi == EPI_BIAS32_RESIDUAL)
    launch<EPI_BIAS32_RESIDUAL>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  else if (epi >= EPI_BIAS && epi <= EPI_BIAS_GELU)
    launch<EPI_BLOCK>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

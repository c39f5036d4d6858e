// gemm_int8_epilogue: out = epilogue(dequant(A (M,K) int8 . W^T)), with W
// stored (N, K) int8 (each output column's K values contiguous), int32
// accumulation on the tensor cores.
//
// Replaces: protoclip_tpu/ops/pallas_kernels.py::_int8_matmul (:508) and
// the four products of ::_block_kernel_int8 (K3), each with its cast points:
//   y = (f32(acc) * row_scale) * col_scale + bias          (:513, fp32)
//   DQ_BIAS           QKV (:535-539):               T(y)
//   DQ_BIAS_RESIDUAL  out-proj (:569-574),          T(f32(res) + f32(T(y)))
//                     proj (:580-585)
//   DQ_BIAS_GELU      fc (:577-578):                y * sigmoid(1.702 y), fp32 out
// and three more for the block-variant bench (scripts/bench_block_variants.py):
//   DQ_BIAS_GELU_BF16   int8gb (:880-884), micro:int8mlp (:521-523):
//                       hb = T(y), then QuickGELU op by op in T, T out
//   DQ_BIAS_F32         micro:int8mlp_nogelu (:516-518):  y, fp32 out
//   DQ_BIAS_GELU_ROUND  int8h (:886, :894): T(y * sigmoid(1.702 y)), the
//                       fp32 QuickGELU rounded to T for the bf16 down-projection
// T rounds to the activation dtype.  One rounding for QKV, unlike K2's
// T(T(acc) + b).  The epilogue is written with the _rn intrinsics (never
// contracted into an FMA) and sigmoid as 1 / (1 + expf(-(1.702 y))), the
// way PyTorch evaluates it on the card; int32 accumulation is exact and
// order-free, so the kernel is bit-exact against its plain version.
//
// Bound on the H100: operations for QKV and proj, bytes for out-proj and
// fc.  A product does 2*M*K*N int8 operations over M*K + N*K bytes in and
// 2-4 bytes per output (plus 2 per residual); the int8 ridge is ~590
// operations per byte.  At ViT-B/16 widths QKV (K=768, N=2304) and proj
// (K=3072) are above it; out-proj (N=768, bf16 residual in and out) and
// fc (4 bytes per fp32 output) are below.
//
// Design (simple first): mma.sync m16n8k32 s8 x s8 -> s32.  A 256-thread
// block owns a 128x128 output tile, each of its 8 warps 64x32 (4 x 4 MMA
// tiles, 64 int32 accumulators a thread).  K advances 64 bytes at a time
// through shared-memory tiles of 80-byte rows: 16-byte aligned for the
// vector loads, and the fragment reads of a warp (8 rows x 4 words) land
// on 32 distinct banks.  A and W are both K-major, so A's fragments are the
// PTX "row" layout and W's the "col" layout with no transpose.  Ragged M,
// N and K are zero-filled on load and masked on store.  Rows on gridDim.x.
// No cp.async pipeline, no wgmma, no TMA yet.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum { DQ_BIAS = 0, DQ_BIAS_RESIDUAL = 1, DQ_BIAS_GELU = 2, DQ_BIAS_GELU_BF16 = 3, DQ_BIAS_F32 = 4,
       DQ_BIAS_GELU_ROUND = 5 };

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int THREADS = 256;
static_assert(BM == BN, "load_tile moves BM rows for both operands");

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One (rows x BK) int8 tile of a K-major matrix into shared memory.
__device__ __forceinline__ void load_tile(int8_t* __restrict__ dst, const int8_t* __restrict__ src,
                                          long r0, long nrows, int k0, int K, int vec) {
  for (int c = threadIdx.x; c < BM * (BK / 16); c += THREADS) {
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    const long gr = r0 + r;
    const int gk = k0 + kc;
    int8_t* d = dst + r * LDS + kc;
    if (vec && gr < nrows && gk + 16 <= K) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + gr * K + gk);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) d[e] = (gr < nrows && gk + e < K) ? src[gr * K + gk + e] : 0;
    }
  }
}

template <typename T, int EPI>
__device__ __forceinline__ void dq_store(int acc, float rs, float cs, float b,
                                         const T* __restrict__ resid, void* __restrict__ out,
                                         long idx) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), b);
  if constexpr (EPI == DQ_BIAS_F32) {
    static_cast<float*>(out)[idx] = y;
  } else if constexpr (EPI == DQ_BIAS_GELU || EPI == DQ_BIAS_GELU_ROUND) {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, y))));
    if constexpr (EPI == DQ_BIAS_GELU)
      static_cast<float*>(out)[idx] = __fmul_rn(y, sig);
    else
      static_cast<T*>(out)[idx] = pck::from_f<T>(__fmul_rn(y, sig));
  } else if constexpr (EPI == DQ_BIAS_GELU_BF16) {
    static_cast<T*>(out)[idx] = pck::from_f<T>(pck::quick_gelu_rounded<T>(pck::round_to<T>(y)));
  } else if constexpr (EPI == DQ_BIAS_RESIDUAL) {
    static_cast<T*>(out)[idx] = pck::from_f<T>(__fadd_rn(pck::to_f(resid[idx]), pck::round_to<T>(y)));
  } else {
    static_cast<T*>(out)[idx] = pck::from_f<T>(y);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const float* __restrict__ row_scale,
               const int8_t* __restrict__ W, const float* __restrict__ col_scale,
               const float* __restrict__ bias, const T* __restrict__ resid,
               void* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const int g = lane >> 2, tig = lane & 3;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(As, A, m0, M, k0, K, vec);
    load_tile(Bs, W, n0, N, k0, K, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm * 64 + i * 16 + g) * LDS + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn * 32 + j * 8 + g) * LDS + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator e of an m16n8 tile: row g (+8 for e >= 2), column 2*tig + (e & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long gm = m0 + wm * 64 + i * 16 + g + h * 8;
      if (gm >= M) continue;
      const float rs = row_scale[gm];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (gn < N)
            dq_store<T, EPI>(acc[i][j][h * 2 + e], rs, col_scale[gn], bias[gn], resid, out,
                        gm * N + gn);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int EPI>
void launch_epi(const void* a, const void* rs, const void* w, const void* cs, const void* bias,
                const void* resid, void* out, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const int vec = (K % 16 == 0) && aligned16(a) && aligned16(w);
  gemm_s8_kernel<T, EPI><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(rs),
      static_cast<const int8_t*>(w), static_cast<const float*>(cs),
      static_cast<const float*>(bias), static_cast<const T*>(resid), out, M, N, K, vec);
}

// One instantiation per epilogue: a runtime switch in the store loop costs
// registers and time in every product.
template <typename T>
void launch(const void* a, const void* rs, const void* w, const void* cs, const void* bias,
            const void* resid, void* out, int M, int N, int K, int epi, cudaStream_t s) {
  switch (epi) {
    case DQ_BIAS: return launch_epi<T, DQ_BIAS>(a, rs, w, cs, bias, resid, out, M, N, K, s);
    case DQ_BIAS_RESIDUAL:
      return launch_epi<T, DQ_BIAS_RESIDUAL>(a, rs, w, cs, bias, resid, out, M, N, K, s);
    case DQ_BIAS_GELU:
      return launch_epi<T, DQ_BIAS_GELU>(a, rs, w, cs, bias, resid, out, M, N, K, s);
    case DQ_BIAS_GELU_BF16:
      return launch_epi<T, DQ_BIAS_GELU_BF16>(a, rs, w, cs, bias, resid, out, M, N, K, s);
    case DQ_BIAS_F32:
      return launch_epi<T, DQ_BIAS_F32>(a, rs, w, cs, bias, resid, out, M, N, K, s);
    default:
      return launch_epi<T, DQ_BIAS_GELU_ROUND>(a, rs, w, cs, bias, resid, out, M, N, K, s);
  }
}

}  // namespace

// dtype: the activation dtype of the residual and of the DQ_BIAS,
// DQ_BIAS_RESIDUAL, DQ_BIAS_GELU_BF16 and DQ_BIAS_GELU_ROUND outputs; the
// DQ_BIAS_GELU and DQ_BIAS_F32 outputs are fp32 whatever it is.
extern "C" int gemm_int8_epilogue(int dtype, const void* a, const void* row_scale, const void* w,
                                  const void* col_scale, const void* bias, const void* resid,
                                  void* out, int M, int N, int K, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi < DQ_BIAS || epi > DQ_BIAS_GELU_ROUND || M < 0 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  if ((resid == nullptr) != (epi != DQ_BIAS_RESIDUAL)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (dtype == PCK_BF16)
    launch<bf16>(a, row_scale, w, col_scale, bias, resid, out, M, N, K, epi, s);
  else if (dtype == PCK_F32)
    launch<float>(a, row_scale, w, col_scale, bias, resid, out, M, N, K, epi, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

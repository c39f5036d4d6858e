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
// order-free (|acc| <= 4096 * 127^2 < 2^31, so no .satfinite), so the kernel
// is bit-exact against its plain version.
//
// Bound on the H100: operations for QKV and proj, bytes for out-proj and
// fc.  A product does 2*M*K*N int8 operations over M*K + N*K bytes in and
// 2-4 bytes per output (plus 2 per residual); the int8 ridge is ~590
// operations per byte.  At ViT-B/16 widths QKV (K=768, N=2304) and proj
// (K=3072) are above it; out-proj (N=768, bf16 residual in and out) and
// fc (4 bytes per fp32 output) are below.
//
// Design: s8 wgmma fed by TMA through an mbarrier ring, the ring of
// gemm_bias_epilogue.cu (csrc/hopper.cuh).  A block owns a 128x128 output
// tile on a 1-D grid, N tiles fastest.  One producer warp issues the TMA
// loads of a 3-stage ring: A 128 rows x 128 K bytes and W 128 rows x 128 K
// bytes, both K-major (W as stored), 128-byte swizzle, 32 KB a stage, so
// two blocks fit an SM and one's epilogue overlaps the other's products.
// Two consumer warpgroups each run wgmma.m64n128k32.s32.s8.s8 over 64 rows
// into 64 int32 registers a thread.  Both descriptors are K-major (SBO 1024
// B: eight 128-byte rows) and a K step of 32 advances both by 32 bytes
// inside the swizzle atom; the integer form takes no transpose and no
// immediate scales, only scale-d.  TMA zero-fills reads beyond M, N and K,
// so ragged edges add zeros to the sums.  The activation dtype only changes
// the epilogue, so bf16 and fp32 run the same kernel.
// Epilogue, over the idle ring: (1) each accumulator (warp w of a
// warpgroup holds rows 16w + lane/4 (+8), columns 8j + 2(lane%4) (+1)) is
// dequantized with its row scale (read once a row) and its column scale and
// bias (read once a column pair), and its output value goes into a staging
// tile padded by 8 elements a row (the pair writes of a warp then fall on
// distinct banks); (2) whole rows go out in 16-byte pieces, the residual
// read in the same pieces, masked at the M and N edges.  fp32 outputs need
// 128 x 136 x 4 = 68 KB of the 96 KB ring.
// TMA needs 16-byte aligned bases and row strides, and the pieces need
// N * 2 bytes in multiples of 16: the wrapper admits K in multiples of 16,
// N in multiples of 8 and aligned tensors.  The tensor maps are encoded per
// call (PyTorch's allocator reuses addresses).
//
// Built with -DGEMM_MAIN_LOOP_ONLY (scripts/gemm_int8_split.py), the kernel
// stops after its products: the split of its time into main loop and
// epilogue.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

enum { DQ_BIAS = 0, DQ_BIAS_RESIDUAL = 1, DQ_BIAS_GELU = 2, DQ_BIAS_GELU_BF16 = 3, DQ_BIAS_F32 = 4,
       DQ_BIAS_GELU_ROUND = 5 };

// The output type: fp32 for the fc epilogue and the bench's fp32 one, T else.
template <typename T, int EPI>
using out_t = std::conditional_t<EPI == DQ_BIAS_GELU || EPI == DQ_BIAS_F32, float, T>;

constexpr int BM = 128, BN = 128, BK = 128, STAGES = 3;  // BK in int8: one 128-byte swizzle row
constexpr int CONSUMERS = 2;                              // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;             // + one producer warp
constexpr int A_BYTES = BM * BK;                          // 16 KB
constexpr int W_BYTES = BN * BK;                          // 16 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1024
constexpr int OUT_LD = BN + 8;                      // staging row, in output elements
static_assert(BM * OUT_LD * 4 <= STAGES * STAGE_BYTES, "fp32 staging fits the ring");

// d += A (64x32, K-major) . W (32x128, K-major)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_w, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_w), "r"(scale_d));
}

// The output value of accumulator `acc` before its rounding to the output
// type; DQ_BIAS_RESIDUAL adds its residual in the second step.
template <typename T, int EPI>
__device__ __forceinline__ float dq_value(int acc, float rs, float cs, float b) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), b);
  if constexpr (EPI == DQ_BIAS_GELU || EPI == DQ_BIAS_GELU_ROUND) {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, y))));
    return __fmul_rn(y, sig);
  } else if constexpr (EPI == DQ_BIAS_GELU_BF16) {
    return pck::quick_gelu_rounded<T>(pck::round_to<T>(y));
  } else {
    return y;
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// y = T(res + y) over one 16-byte piece of each
__device__ __forceinline__ void add_residual(uint4& y, const uint4& res, float) {
  float* yp = reinterpret_cast<float*>(&y);
  const float* rp = reinterpret_cast<const float*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) yp[e] = __fadd_rn(rp[e], yp[e]);
}
__device__ __forceinline__ void add_residual(uint4& y, const uint4& res, bf16) {
  __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&y);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 yf = __bfloat1622float2(yp[e]), rf = __bfloat1622float2(rp[e]);
    yp[e] = __floats2bfloat162_rn(__fadd_rn(rf.x, yf.x), __fadd_rn(rf.y, yf.y));
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
gemm_s8_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ row_scale, const float* __restrict__ col_scale,
              const float* __restrict__ bias, const T* __restrict__ resid,
              out_t<T, EPI>* __restrict__ out, int M, int N, int K, int n_tiles) {
  using O = out_t<T, EPI>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the swizzle pattern repeats every 1024 bytes: stage buffers start on it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t stage = base + s * STAGE_BYTES, bar = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(stage, &tm_a, bar, kt * BK, m0);
        tma_load_2d(stage + A_BYTES, &tm_w, bar, kt * BK, n0);
      }
    }
    return;
  }

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t a_s = base + s * STAGE_BYTES + wg * (64 * BK);  // this warpgroup's rows
    const uint32_t w_s = base + s * STAGE_BYTES + A_BYTES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n128k32_s8(d, smem_desc(a_s + kk * 32, 16, 1024), smem_desc(w_s + kk * 32, 16, 1024),
                          1);
    wgmma_commit();
    // keep this step's products in flight; the previous step's are done, so
    // its stage goes back to the producer
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
#ifdef GEMM_MAIN_LOOP_ONLY
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum ^= d[i];
  if (sum == 0x1234567) reinterpret_cast<int*>(out)[threadIdx.x] = sum;
  return;
#endif

  // Epilogue, 1: dequantize from the accumulator layout into the staging
  // tile.  Every load has landed and both warpgroups' products are done
  // once they meet here.
  consumers_sync<CONSUMERS * 128>();
  O* stage_out = reinterpret_cast<O*>(smem_raw + (base - smem_u32(smem_raw)));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int srow = wg * 64 + warp * 16 + (lane >> 2);
  const float rs0 = m0 + srow < M ? row_scale[m0 + srow] : 0.f;
  const float rs1 = m0 + srow + 8 < M ? row_scale[m0 + srow + 8] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (n0 + c < N) {  // N is even: the pair's second column is in too
      const float2 cs = *reinterpret_cast<const float2*>(col_scale + n0 + c);
      const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + c);
      store_pair(stage_out + srow * OUT_LD + c, dq_value<T, EPI>(d[4 * j], rs0, cs.x, bb.x),
                 dq_value<T, EPI>(d[4 * j + 1], rs0, cs.y, bb.y));
      store_pair(stage_out + (srow + 8) * OUT_LD + c, dq_value<T, EPI>(d[4 * j + 2], rs1, cs.x, bb.x),
                 dq_value<T, EPI>(d[4 * j + 3], rs1, cs.y, bb.y));
    }
  }
  consumers_sync<CONSUMERS * 128>();
  // 2: 16-byte pieces, whole rows to neighbouring threads, with the
  // residual read in the same pieces; rows past M and pieces past N skipped
  constexpr int PIECE = 16 / sizeof(O), PIECES = BN / PIECE;
  for (int idx = threadIdx.x; idx < BM * PIECES; idx += CONSUMERS * 128) {
    const int r = idx / PIECES, c = (idx % PIECES) * PIECE;
    const long gr = (long)m0 + r;
    if (gr < M && n0 + c < N) {
      uint4 y = *reinterpret_cast<const uint4*>(stage_out + r * OUT_LD + c);
      const long g = gr * N + n0 + c;
      if constexpr (EPI == DQ_BIAS_RESIDUAL)
        add_residual(y, *reinterpret_cast<const uint4*>(resid + g), T());
      *reinterpret_cast<uint4*>(out + g) = y;
    }
  }
}

template <typename T, int EPI>
int launch_epi(const void* a, const void* rs, const void* w, const void* cs, const void* bias,
               const void* resid, void* out, int M, int N, int K, cudaStream_t s) {
  CUtensorMap tm_a, tm_w;
  if (!make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, K, M, BM) ||
      !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, BN))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + BN - 1) / BN;
  const long long tiles = n_tiles * ((M + BM - 1) / BM);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_wgmma<T, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_s8_wgmma<T, EPI><<<(unsigned)tiles, THREADS, SMEM, s>>>(
      tm_a, tm_w, static_cast<const float*>(rs), static_cast<const float*>(cs),
      static_cast<const float*>(bias), static_cast<const T*>(resid),
      static_cast<out_t<T, EPI>*>(out), M, N, K, (int)n_tiles);
  return (int)cudaGetLastError();
}

// One instantiation per epilogue: a runtime switch in the epilogue costs
// registers and time in every product.
template <typename T>
int launch(const void* a, const void* rs, const void* w, const void* cs, const void* bias,
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
// DQ_BIAS_GELU and DQ_BIAS_F32 outputs are fp32 whatever it is.  K is a
// multiple of 16 and N of 8, and every tensor starts on 16 bytes.
extern "C" int gemm_int8_epilogue(int dtype, const void* a, const void* row_scale, const void* w,
                                  const void* col_scale, const void* bias, const void* resid,
                                  void* out, int M, int N, int K, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi < DQ_BIAS || epi > DQ_BIAS_GELU_ROUND || M < 0 || N < 1 || K < 1 || N % 8 || K % 16)
    return (int)cudaErrorInvalidValue;
  if ((resid == nullptr) != (epi != DQ_BIAS_RESIDUAL)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (dtype == PCK_BF16)
    return launch<bf16>(a, row_scale, w, col_scale, bias, resid, out, M, N, K, epi, s);
  if (dtype == PCK_F32)
    return launch<float>(a, row_scale, w, col_scale, bias, resid, out, M, N, K, epi, s);
  return (int)cudaErrorInvalidValue;
}

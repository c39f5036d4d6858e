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
// Three more replace no TPU kernel: the EVA02 image block and the exact-GELU
// text MLP of the EVA02-CLIP backbones (ops/kernels.py::fused_eva_block),
// which the JAX package does not have:
//   EPI_BIAS_GELU_ERF     text fc:      T(h * 0.5 * (1 + erf(h / sqrt 2))),
//                                       h = acc + f32(b) in fp32
//   EPI_BIAS_ROPE         EVA QKV:      y = T(acc + b); for a token other
//                         than its sequence's first (row % tokens != 0) and
//                         a column below rot_cols (q and k), each
//                         interleaved pair (y0, y1) of a head's channels
//                         2i, 2i+1 becomes T(y0 c0 - y1 s0), T(y1 c1 + y0 s1)
//                         in fp32 with the token's fp32 RoPE table
//   EPI_BIAS_SWIGLU       EVA fc:       W holds w1 and w2 interleaved by
//                         column (2i: w1's column i, 2i+1: w2's), so a
//                         thread's accumulator pair is one hidden unit's
//                         gate g and value v; out (M, N/2) = T(silu(g + b)
//                         * (v + b')) in fp32
// The first is an instantiation of the block kernel; the last two run
// gemm_bf16_eva, the same ring and products with an epilogue that takes
// the RoPE tables (bf16 only: the EVA02 path runs in bf16 on the card).
// Each instantiation is its own kernel name in a trace.
//
// Bound on the H100: operations.  At ViT-B/16 widths a product does
// 2*M*K*N flops over (M*K + K*N + M*N) values, hundreds of flops per byte
// for M in the tens of thousands, above the ~295 flop/byte bf16 ridge.
//
// bf16 design: wgmma fed by TMA through an mbarrier ring.  A block owns a
// 128x128 output tile; the grid is 1-D, N tiles fastest, so the blocks in
// flight share their A rows in L2 and M is bounded by int only.  One
// producer warp issues the TMA loads of a 3-stage ring (A 128x64 K-major,
// W 64x128 as two 64x64 boxes, N-major; 128-byte swizzle; 32 KB a stage,
// so two blocks fit an SM and one's epilogue overlaps the other's
// products); full barriers count the bytes, empty barriers the 256
// consumer threads.  Two consumer warpgroups each run wgmma.m64n128k16
// over 64 rows into 64 fp32 registers a thread, one K step's products in
// flight while the next is issued.  A is K-major (descriptor LBO unused,
// SBO 1024 B: eight 128-byte rows); W is read N-major through the
// descriptor's transpose bit, so it needs no copy (LBO 8192 B between the
// two 64-column boxes, SBO 1024 B between groups of eight K rows); a K step
// of 16 advances A by 32 bytes inside its swizzle atom and W by 16 rows.
// TMA zero-fills reads beyond M, N and K, so ragged edges need no masking
// before the products.  The epilogue runs in two steps over the idle ring:
// each value from the accumulator's own layout (warp w of a warpgroup holds
// rows 16w + lane/4 (+8), columns 8j + 2(lane%4) (+1)) takes its bias (read
// once a column pair) and is rounded to bf16 into a padded staging tile;
// then 16-byte pieces go out row by row, with the residual read in the
// same pieces, masked at the M and N edges.  (Straight from the
// accumulator layout, each warp store would write 4 bytes a thread over
// eight rows: half of each 32-byte sector.)
// The tensor maps are encoded on every call (a cache keyed by pointer
// would be wrong under PyTorch's allocator, which reuses addresses) and
// passed as __grid_constant__ parameters; cuTensorMapEncodeTiled comes from
// the runtime's driver entry point, so nothing links against libcuda.
// TMA needs 16-byte aligned bases and row strides: the wrapper admits K
// and N that are multiples of 8 and aligned tensors.
//
// fp32 design: exact fp32 on the CUDA cores (fmaf; the tensor cores would
// round its operands to TF32), bound by operations (67 TFLOP/s).  The same
// ring as bf16: a block owns a 128x128 output tile, one producer warp
// issues the TMA loads of a 4-stage ring (A 128 rows x 32 k, 128-byte
// swizzled: a K step of 32 fp32 values is one swizzle row; W 32 k x 128
// columns as four unswizzled 32-column boxes, read as stored, N-contiguous;
// 32 KB a stage), full barriers count the bytes, empty barriers the 256
// consumer threads.  Each consumer thread holds an 8x8 patch of outputs in
// registers (rows 4ty + i and 64 + 4ty + i, columns 4tx + j and 64 + 4tx +
// j) and reads its fragments as float4s at a base pointer plus an immediate
// offset: for each 4 k, eight A pieces (one a row, shared by a half warp),
// and for each k two W pieces (eight consecutive 16-byte pieces of a k row
// a quarter warp): 64 fmaf for 2 loads, no bank conflict.  One block an SM
// (registers); a persistent grid and two blocks an SM with no producer warp
// both measured slower.  Each output's sum over k runs ascending from 0,
// one fmaf a step (TMA zero-fills K past its end): the plain SIMT order,
// so the bits do not depend on the tiling.  The epilogue writes 16-byte
// pieces straight from the registers.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

enum { EPI_BIAS = 0, EPI_BIAS_RESIDUAL = 1, EPI_BIAS_GELU = 2, EPI_BIAS_GELU_BF16 = 3,
       EPI_BIAS32_RESIDUAL = 4, EPI_BIAS_ROPE = 5, EPI_BIAS_SWIGLU = 6, EPI_BIAS_GELU_ERF = 7 };
// The block's three epilogues share one kernel and pick theirs at run time,
// as before the bench's were added; the bench's two are instantiations of
// their own.
constexpr int EPI_BLOCK = -1;

// The bias is T, or fp32 for EPI_BIAS32_RESIDUAL.
template <typename T, int EPI>
using bias_t = std::conditional_t<EPI == EPI_BIAS32_RESIDUAL, float, T>;

template <int EPI>
__device__ __forceinline__ bool has_residual(int epi) {
  return EPI == EPI_BIAS32_RESIDUAL || (EPI == EPI_BLOCK && epi == EPI_BIAS_RESIDUAL);
}

// The output value of the fp32 accumulator `acc` with the bias `b`
// (widened to fp32), before its rounding to T; for the two residual
// epilogues, y = T(...) before the residual is added (add_residual).
// EPI: EPI_BLOCK (then `epi` picks EPI_BIAS, EPI_BIAS_RESIDUAL or
// EPI_BIAS_GELU), EPI_BIAS_GELU_BF16 or EPI_BIAS32_RESIDUAL.
template <typename T, int EPI>
__device__ __forceinline__ float epilogue_value(float acc, int epi, float b) {
  if constexpr (EPI == EPI_BIAS32_RESIDUAL) {
    return pck::round_to<T>(__fadd_rn(acc, b));
  } else if constexpr (EPI == EPI_BIAS_GELU_BF16) {
    return pck::quick_gelu_rounded<T>(pck::round_to<T>(__fadd_rn(acc, b)));
  } else if constexpr (EPI == EPI_BIAS_GELU_ERF) {
    const float h = acc + b;
    return h * 0.5f * (1.f + erff(h * 0.70710678118654752f));
  } else {
    if (epi == EPI_BIAS_GELU) {
      const float h = acc + b;
      return h * (1.f / (1.f + expf(-1.702f * h)));
    }
    return pck::round_to<T>(pck::round_to<T>(acc) + b);
  }
}

// res + y in fp32, rounded by the caller: the residual epilogues' last op
__device__ __forceinline__ float add_residual(float res, float y) { return __fadd_rn(res, y); }

// -- bf16: wgmma fed by TMA ----------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int CONSUMERS = 2;                      // warpgroups, 64 rows each
constexpr int WGMMA_THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int B_HALF_BYTES = BK * 64 * 2;         // one 64-column box: 64 K rows x 128 B
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF_BYTES;
constexpr int WGMMA_SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1024

// d += A (64x16, K-major) . B (16x128, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Output staging for the epilogue, in the stage buffers once the products
// are done: 128 rows of 128 bf16 values, each padded by 16 bytes so that the
// accumulator layout's 4-byte writes hit 32 distinct banks.
constexpr int OUT_LD = BN + 8;
static_assert(BM * OUT_LD * 2 <= STAGES * STAGE_BYTES, "staging fits the ring");

// The ring's barriers: full[s] counts the bytes that landed in stage s,
// empty[s] the consumer threads done with it.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The products of one 128x128 tile over the ring.  The producer warp issues
// every load and returns false; each consumer thread returns true with its
// warpgroup's 64 rows in d (the accumulator layout of wgmma.m64n128k16).
__device__ __forceinline__ bool ring_products(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                              uint32_t base, uint64_t* full, uint64_t* empty,
                                              int m0, int n0, int k_tiles, float (&d)[64]) {
  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t stage = base + s * STAGE_BYTES, bar = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(stage, tm_a, bar, kt * BK, m0);
        tma_load_2d(stage + A_BYTES, tm_w, bar, n0, kt * BK);
        tma_load_2d(stage + A_BYTES + B_HALF_BYTES, tm_w, bar, n0 + 64, kt * BK);
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t a_s = base + s * STAGE_BYTES + wg * (64 * 128);  // this warpgroup's rows
    const uint32_t b_s = base + s * STAGE_BYTES + A_BYTES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, smem_desc(a_s + kk * 32, 16, 1024),
                       smem_desc(b_s + kk * 16 * 128, B_HALF_BYTES, 1024), 1);
    wgmma_commit();
    // keep this step's products in flight; the previous step's are done, so
    // its stage goes back to the producer
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
  return true;
}

template <int EPI>
__global__ void __launch_bounds__(WGMMA_THREADS, 2)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                const bias_t<bf16, EPI>* __restrict__ bias, const bf16* __restrict__ resid,
                bf16* __restrict__ out, int M, int N, int K, int epi, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the swizzle pattern repeats every 1024 bytes: stage buffers start on it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int k_tiles = (K + BK - 1) / BK;

  ring_init(full, empty);
  float d[64];
  if (!ring_products(&tm_a, &tm_w, base, full, empty, m0, n0, k_tiles, d)) return;
  const int wg = threadIdx.x >> 7;

  // Epilogue, 1: each value from the accumulator's layout (rows 16w +
  // lane/4 (+8) of the warpgroup, columns 8j + 2(lane%4) (+1)) with its
  // bias, rounded to bf16 into the staging tile.  Every load has landed and
  // both warpgroups' products are done once they meet here.
  consumers_sync<CONSUMERS * 128>();
  bf16* stage_out = reinterpret_cast<bf16*>(smem_raw + (base - smem_u32(smem_raw)));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int srow = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (n0 + c < N) {  // N is even: the pair's second column is in too
      float b0, b1;
      if constexpr (EPI == EPI_BIAS32_RESIDUAL) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + c);
        b0 = bb.x, b1 = bb.y;
      } else {
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c));
        b0 = bb.x, b1 = bb.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(stage_out + (srow + 8 * h) * OUT_LD + c) =
            __floats2bfloat162_rn(epilogue_value<bf16, EPI>(d[4 * j + 2 * h], epi, b0),
                                  epilogue_value<bf16, EPI>(d[4 * j + 2 * h + 1], epi, b1));
    }
  }
  consumers_sync<CONSUMERS * 128>();
  // 2: 16-byte pieces, whole rows to neighbouring threads, with the
  // residual read in the same pieces; rows past M and pieces past N skipped
  const bool res_on = has_residual<EPI>(epi);
  constexpr int PIECES = BN / 8;
  for (int idx = threadIdx.x; idx < BM * PIECES; idx += CONSUMERS * 128) {
    const int r = idx / PIECES, c = (idx % PIECES) * 8;
    const long gr = (long)m0 + r;
    if (gr < M && n0 + c < N) {
      uint4 y = *reinterpret_cast<const uint4*>(stage_out + r * OUT_LD + c);
      const long g = gr * N + n0 + c;
      if (res_on) {
        const uint4 rv = *reinterpret_cast<const uint4*>(resid + g);
        __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&y);
        const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 yf = __bfloat1622float2(yp[e]), rf = __bfloat1622float2(rp[e]);
          yp[e] = __floats2bfloat162_rn(add_residual(rf.x, yf.x), add_residual(rf.y, yf.y));
        }
      }
      *reinterpret_cast<uint4*>(out + g) = y;
    }
  }
}

template <int EPI>
int launch_wgmma(const void* a, const void* w, const void* bias, const void* resid, void* out,
                 int M, int N, int K, int epi, cudaStream_t s) {
  CUtensorMap tm_a, tm_w;
  if (!make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, K, M, BM) ||
      !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, N, K, BK))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + BN - 1) / BN;
  const long long tiles = n_tiles * ((M + BM - 1) / BM);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_wgmma<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_bf16_wgmma<EPI><<<(unsigned)tiles, WGMMA_THREADS, WGMMA_SMEM, s>>>(
      tm_a, tm_w, static_cast<const bias_t<bf16, EPI>*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(out), M, N, K, epi, (int)n_tiles);
  return (int)cudaGetLastError();
}

// -- bf16, the EVA02 block's epilogues -----------------------------------------

// The RoPE tables of EPI_BIAS_ROPE: row t - 1 of cos and sin (fp32, `dh`
// values a row) turns token t of every sequence of `tokens` rows; output
// columns below rot_cols turn with table column c % dh.
struct RopeArgs {
  const float* cos;
  const float* sin;
  int tokens, rot_cols, dh;
};

// EPI_BIAS_ROPE (out N columns) or EPI_BIAS_SWIGLU (out N / 2 columns) on
// the block kernel's ring and products.
template <int EPI>
__global__ void __launch_bounds__(WGMMA_THREADS, 2)
gemm_bf16_eva(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K,
              int n_tiles, RopeArgs rope) {
  static_assert(EPI == EPI_BIAS_ROPE || EPI == EPI_BIAS_SWIGLU, "an EVA02 epilogue");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;

  ring_init(full, empty);
  float d[64];
  if (!ring_products(&tm_a, &tm_w, base, full, empty, m0, n0, (K + BK - 1) / BK, d)) return;
  const int wg = threadIdx.x >> 7;

  // 1: as the block kernel's, into the staging tile; SwiGLU's pair gives
  // one value, in column c / 2 of the tile's 64
  consumers_sync<CONSUMERS * 128>();
  bf16* stage_out = reinterpret_cast<bf16*>(smem_raw + (base - smem_u32(smem_raw)));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int srow = wg * 64 + warp * 16 + (lane >> 2);
  // the tokens of the thread's two rows, once (a 64-bit remainder is dear)
  int token[2] = {0, 0};
  if constexpr (EPI == EPI_BIAS_ROPE) {
#pragma unroll
    for (int h = 0; h < 2; ++h) token[h] = (int)(((long)m0 + srow + 8 * h) % rope.tokens);
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (n0 + c < N) {  // N is even: the pair's second column is in too
      const float2 bb =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = d[4 * j + 2 * h], a1 = d[4 * j + 2 * h + 1];
        const int r = srow + 8 * h;
        if constexpr (EPI == EPI_BIAS_SWIGLU) {
          const float g = a0 + bb.x, v = a1 + bb.y;
          stage_out[r * OUT_LD + (c >> 1)] = __float2bfloat16_rn(g / (1.f + expf(-g)) * v);
        } else {
          float y0 = pck::round_to<bf16>(a0 + bb.x), y1 = pck::round_to<bf16>(a1 + bb.y);
          const int t = token[h], col = n0 + c;
          if (t > 0 && col < rope.rot_cols) {
            const long at = (long)(t - 1) * rope.dh + col % rope.dh;
            const float2 cs = *reinterpret_cast<const float2*>(rope.cos + at);
            const float2 sn = *reinterpret_cast<const float2*>(rope.sin + at);
            const float t0 = __fadd_rn(__fmul_rn(y0, cs.x), -__fmul_rn(y1, sn.x));
            y1 = __fadd_rn(__fmul_rn(y1, cs.y), __fmul_rn(y0, sn.y));
            y0 = t0;
          }
          *reinterpret_cast<__nv_bfloat162*>(stage_out + r * OUT_LD + c) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
  consumers_sync<CONSUMERS * 128>();
  // 2: 16-byte pieces of the tile's output columns, masked at M and N
  constexpr int COLS = EPI == EPI_BIAS_SWIGLU ? BN / 2 : BN, PIECES = COLS / 8;
  const int out_n = EPI == EPI_BIAS_SWIGLU ? N / 2 : N;
  const int o0 = EPI == EPI_BIAS_SWIGLU ? n0 / 2 : n0;
  for (int idx = threadIdx.x; idx < BM * PIECES; idx += CONSUMERS * 128) {
    const int r = idx / PIECES, c = (idx % PIECES) * 8;
    const long gr = (long)m0 + r;
    if (gr < M && o0 + c < out_n)
      *reinterpret_cast<uint4*>(out + gr * out_n + o0 + c) =
          *reinterpret_cast<const uint4*>(stage_out + r * OUT_LD + c);
  }
}

template <int EPI>
int launch_eva(const void* a, const void* w, const void* bias, void* out, int M, int N, int K,
               RopeArgs rope, cudaStream_t s) {
  CUtensorMap tm_a, tm_w;
  if (!make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, K, M, BM) ||
      !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, N, K, BK))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + BN - 1) / BN;
  const long long tiles = n_tiles * ((M + BM - 1) / BM);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_eva<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_bf16_eva<EPI><<<(unsigned)tiles, WGMMA_THREADS, WGMMA_SMEM, s>>>(
      tm_a, tm_w, static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K,
      (int)n_tiles, rope);
  return (int)cudaGetLastError();
}

// -- fp32: CUDA-core tiles fed by TMA ------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 32, F_STAGES = 4;
constexpr int F_CONSUMERS = 256;                     // 16 x 16 threads, 8 x 8 outputs each
constexpr int F_THREADS = F_CONSUMERS + 32;          // + one producer warp
constexpr int FA_BYTES = FBM * FBK * 4;              // 128 rows of 32 k: one 128-byte row each
constexpr int FW_BOX_BYTES = FBK * 32 * 4;           // one 32-column W box: 32 k rows x 128 B
constexpr int F_STAGE_BYTES = FA_BYTES + 4 * FW_BOX_BYTES;  // 32 KB
constexpr int F_SMEM = F_STAGES * F_STAGE_BYTES + 1024;     // + slack to align to 1024

__device__ __forceinline__ float4 lds4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int EPI>
__global__ void __launch_bounds__(F_THREADS, 1)
gemm_f32_ring(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ bias, const float* __restrict__ resid,
              float* __restrict__ out, int M, int N, int K, int epi, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* ring = smem_raw + (base - smem_u32(smem_raw));
  const int n0 = (blockIdx.x % n_tiles) * FBN;
  const int m0 = (blockIdx.x / n_tiles) * FBM;
  const int k_tiles = (K + FBK - 1) / FBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), F_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F_CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == F_CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % F_STAGES;
        const uint32_t stage = base + s * F_STAGE_BYTES, bar = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((kt / F_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, F_STAGE_BYTES);
        tma_load_2d(stage, &tm_a, bar, kt * FBK, m0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(stage + FA_BYTES + j * FW_BOX_BYTES, &tm_w, bar, n0 + 32 * j, kt * FBK);
      }
    }
    return;
  }

  // Thread (ty, tx) owns rows 4ty + i and 64 + 4ty + i, columns 4tx + j and
  // 64 + 4tx + j (i, j < 4).  A lands 128-byte swizzled: piece c of row r
  // at piece c ^ (r % 8).  For the thread's rows r % 8 = 4 (ty % 2) + i % 4,
  // so piece c sits at (c ^ i % 4) ^ 4 (ty % 2): a compile-time piece moved
  // by +-64 bytes on odd ty, one of two base pointers a stage plus an
  // immediate offset.  A half warp reads one A piece a row (a broadcast);
  // rows r and r + 4 of its two halves fall on distinct banks.  W lands
  // unswizzled, k row after k row of each 32-column box, and a quarter warp
  // reads 8 consecutive pieces of one row: no bank conflict either.
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int a_row = 512 * ty, a_flip = 64 * (ty & 1);
  const int w_col = (tx >> 3) * FW_BOX_BYTES + (tx & 7) * 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % F_STAGES;
    const unsigned char* As = ring + s * F_STAGE_BYTES;
    const unsigned char* a_up = As + a_row + a_flip;    // pieces 0-3 land here on odd ty
    const unsigned char* a_down = As + a_row - a_flip;  // pieces 4-7
    const unsigned char* Ws = As + FA_BYTES + w_col;
    mbar_wait(smem_u32(&full[s]), (kt / F_STAGES) & 1);
#pragma unroll
    for (int c = 0; c < FBK / 4; ++c) {  // 4 k at a time: one A piece a row
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int piece = c ^ (i & 3);
        const int offset = ((i >> 2) * 64 + (i & 3)) * 128 + piece * 16;
        a[i] = lds4((piece < 4 ? a_up : a_down) + offset);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * c + kk;
        const float4 b0 = lds4(Ws + k * 128);
        const float4 b1 = lds4(Ws + 2 * FW_BOX_BYTES + k * 128);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        // each output's sum over k ascending, one fmaf a step
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = lane_of(a[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
        }
      }
    }
    mbar_arrive(smem_u32(&empty[s]));
  }

  // Epilogue: 16-byte pieces straight from the registers; a half warp
  // writes two 256-byte row segments.  N is a multiple of 8, so a piece of
  // 4 columns is wholly in or out.
  const bool res_on = has_residual<EPI>(epi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long gm = (long)m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 64 * h + 4 * tx;
      if (gn >= N) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bias + gn);
      float4 y = make_float4(epilogue_value<float, EPI>(acc[i][4 * h], epi, bb.x),
                             epilogue_value<float, EPI>(acc[i][4 * h + 1], epi, bb.y),
                             epilogue_value<float, EPI>(acc[i][4 * h + 2], epi, bb.z),
                             epilogue_value<float, EPI>(acc[i][4 * h + 3], epi, bb.w));
      const long g = gm * N + gn;
      if (res_on) {
        const float4 rv = *reinterpret_cast<const float4*>(resid + g);
        y = make_float4(add_residual(rv.x, y.x), add_residual(rv.y, y.y),
                        add_residual(rv.z, y.z), add_residual(rv.w, y.w));
      }
      *reinterpret_cast<float4*>(out + g) = y;
    }
  }
}

template <int EPI>
int launch_f32(const void* a, const void* w, const void* bias, const void* resid, void* out,
               int M, int N, int K, int epi, cudaStream_t s) {
  CUtensorMap tm_a, tm_w;
  if (!make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, K, M, FBM) ||
      !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, N, K, FBK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + FBN - 1) / FBN;
  const long long tiles = n_tiles * ((M + FBM - 1) / FBM);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_f32_ring<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_f32_ring<EPI><<<(unsigned)tiles, F_THREADS, F_SMEM, s>>>(
      tm_a, tm_w, static_cast<const float*>(bias), static_cast<const float*>(resid),
      static_cast<float*>(out), M, N, K, epi, (int)n_tiles);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch(int dtype, const void* a, const void* w, const void* bias, const void* resid,
           void* out, int M, int N, int K, int epi, cudaStream_t s) {
  return dtype == PCK_BF16 ? launch_wgmma<EPI>(a, w, bias, resid, out, M, N, K, epi, s)
                           : launch_f32<EPI>(a, w, bias, resid, out, M, N, K, epi, s);
}

}  // namespace

extern "C" int gemm_bias_epilogue(int dtype, const void* a, const void* w, const void* bias,
                                  const void* resid, void* out, int M, int N, int K, int epi,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != PCK_BF16 && dtype != PCK_F32) || M < 0 || N < 1 || K < 1 || N % 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (epi == EPI_BIAS_GELU_BF16)
    return launch<EPI_BIAS_GELU_BF16>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  if (epi == EPI_BIAS32_RESIDUAL)
    return launch<EPI_BIAS32_RESIDUAL>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  if (epi == EPI_BIAS_GELU_ERF)
    return launch<EPI_BIAS_GELU_ERF>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  if (epi >= EPI_BIAS && epi <= EPI_BIAS_GELU)
    return launch<EPI_BLOCK>(dtype, a, w, bias, resid, out, M, N, K, epi, s);
  return (int)cudaErrorInvalidValue;
}

// The EVA02 epilogues, bf16 only: EPI_BIAS_ROPE with its tables (cos, sin:
// (tokens - 1, dh) fp32), EPI_BIAS_SWIGLU into (M, N / 2), N a multiple of 16.
extern "C" int gemm_bias_eva(int dtype, const void* a, const void* w, const void* bias,
                             const void* cos, const void* sin, void* out, int M, int N, int K,
                             int epi, int tokens, int rot_cols, int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != PCK_BF16 || M < 0 || N < 1 || K < 1 || N % 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const RopeArgs rope{static_cast<const float*>(cos), static_cast<const float*>(sin), tokens,
                      rot_cols, dh};
  if (epi == EPI_BIAS_ROPE) {
    if (tokens < 1 || dh < 2 || dh % 2 || rot_cols < 0 || rot_cols % dh)
      return (int)cudaErrorInvalidValue;
    return launch_eva<EPI_BIAS_ROPE>(a, w, bias, out, M, N, K, rope, s);
  }
  if (epi == EPI_BIAS_SWIGLU) {
    if (N % 16) return (int)cudaErrorInvalidValue;
    return launch_eva<EPI_BIAS_SWIGLU>(a, w, bias, out, M, N, K, rope, s);
  }
  return (int)cudaErrorInvalidValue;
}

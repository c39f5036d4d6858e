// attention_packed: multi-head attention over strided (B, H, L, dh) views.
//
// Replaces: protoclip_tpu/ops/pallas_kernels.py::_attention_kernel_packed
// (:145, K1), the per-head attention loops of ::_block_kernel (:283-309,
// K2) and ::_block_kernel_int8 (:547-566, K3), and the head-major
// ::_attention_kernel (:65, K4).  Numerics as there: fp32 scores of (q * dh^-0.5) . k^T, keys with
// col >= length (and col > row when causal) masked to -1e30, softmax over
// the whole row in fp32 (max, exp, divide by the sum), weights rounded to
// v's dtype, PV accumulated in fp32 and rounded once.
//
// Bound on the H100: the exps.  Per (batch, head) it reads 3*L*dh values
// and writes L*dh, for 4*L^2*dh flops: ~300 flops per byte at L = 577,
// dh = 64, about the ~295 flop/byte bf16 ridge; ~100 at L = 197.  But the
// whole-row softmax below takes two exps a score, and at dh = 64 the
// card's ~3.9 T exp/s (16 a clock an SM) bound it before its three
// products do: 2 L^2 exps against 6 L^2 dh flops at 989 TFLOP/s.
//
// bf16 design (wgmma fed by a TMA ring; the GEMM's shape, hopper.cuh).
// Grid (ceil(L/64) query tiles, heads, batch); a block is one consumer
// warpgroup, which owns a 64-row query tile of one (batch, head), and one
// producer warp, whose one thread loads the Q tile once and then streams
// 64-key tiles through a 4-stage mbarrier ring: K's for the statistics
// pass, then K's and V's in turn for the weights pass (full barriers count
// the bytes, empty barriers the consumer threads), at every L.  One 4-D
// tensor map a tensor, (dh, rows, heads, batch) with rows and heads in the
// order of their strides, covers K1's packed tensors, K2/K3/EVA02's fused
// (B, L, 3D) QKV slices and K4's head-major layout; boxes are 64 columns
// x 64 rows with the 128-byte swizzle (two boxes at dh = 128), and TMA
// zero-fills the columns past dh and the rows past L.  Shared memory does
// not grow with L: five 8 KB tiles (16 KB at dh = 128) and the alignment
// slack, 41,984 bytes at dh = 64; registers (under 96 a thread) let four
// blocks share an SM, so one block's softmax runs while another's products
// do.  Scores are wgmma.m64n64k16 with Q from shared memory as A and the
// key tile as the K-major B operand.  The
// softmax is over the whole row and not online, because the weights are
// rounded to bf16 after their normalisation, as in the TPU kernel: pass 1
// runs the scores of each key tile for the row max and the sum of exp(s -
// max) (the running sum rescaled when the max grows, which changes it by
// fp32 ulps only); pass 2 runs the scores again, forms exp(s - max) * (1 /
// sum) in fp32, rounds it to bf16, and runs PV as wgmma.m64nDHk16 with P
// from registers (the score accumulator's layout, packed to bf16, is the A
// fragment) and V's tile as B through the transpose bit.  Flash
// attention's single pass, with unnormalised bf16 weights and one division
// at the end, rounds the weights at another point: a different result, so
// it was not taken.  The scale is applied in the exp: exp(scale * (acc -
// max)) is ex2.approx of one FMA with scale * log2(e) folded in (within
// ~1e-6 relative of expf, far below the bf16 rounding of the weights), the
// sum divided once a row and the weights multiplied by its reciprocal.  The
// last key tile's softmax and PV take only the 16, 32 or 64 keys that
// cover what is left (L = 577, 257 and 197 end one to five keys past a
// multiple of 64); its score product stays 64 keys wide, as a second wgmma
// shape in the kernel made ptxas serialize every wgmma.  Only the key
// tiles that reach past length or (causal) past the tile's first row are
// masked; causal key tiles wholly above the tile's last row are neither
// loaded nor computed.  The output is staged in the Q tile, in its swizzled
// layout, and written in 16-byte pieces.  Registers: chip_smoke.py's build
// phase reports ptxas's count for each instantiation (PERF.md).
//
// fp32 design (exact, on the CUDA cores: tensor cores would round its
// operands to TF32).  Bound by operations: at L=197, dh=64 a (batch, head)
// is 4*L^2*dh flops over 16*L*dh bytes, ~200 flops a byte against the ~20
// flop/byte fp32 ridge.  Grid (query tiles, heads, batch); a block of 8
// warps takes 64 query rows, warp w rows 8w .. 8w + 7 (a warp past the
// last tile's rows idles).  Q, scaled by dh^-0.5 in fp32, comes by
// cp.async into shared memory; K, then V, stream through two 64-key chunk
// buffers by 16-byte cp.async, the next chunk landing while the current
// one is used.  Scores are a register-tiled product: each thread holds 4
// rows x 4 keys (keys kg + 16j) of the 64 x 64 chunk, reads float4s (row
// stride dh_padded + 4 floats: rows r and r + 4 of Q, and keys kg and
// kg + 8, fall on distinct banks), writes them into a shared rows x L fp32
// score tile and keeps each row's running max over its keys (reduced over
// the half warp that holds the row's keys at the end).  Each warp then
// takes its own 8 rows side by side: expf(s - max), the sum (lane j over
// keys j, j + 32, ..., then a butterfly) and the IEEE division by it.  P.V
// is a second register-tiled product, each thread holding 4 rows x
// dh_padded/16 columns of the output.  Causal: a warp stops at the keys
// past its last row, a tile at the keys past its own.  Each score's sum
// over d and each output's sum over keys run ascending, one fmaf a step,
// and the row sum in a one-warp-a-row kernel's order, so the bits do not
// depend on the tiling; keys past a row's last key carry weight 0 and
// zeroed V rows, so they add nothing.  Shared memory no longer
// grows with the whole head: ((rows + 128) * (dh_p + 4) + rows * (L_8 + 4))
// * 4 bytes, 169,984 at L=264, dh=128 (f32_smem_bytes).
//
// q, k, v share one (batch, head, row) stride triple and the output has its
// own, so one kernel serves K1's three packed (B, L, D) tensors (strides
// L*D, dh, D), the column slices of K2's and K3's fused (B, L, 3D) QKV
// buffer (L*3D, dh, 3D) and K4's head-major (B, H, L, dh) tensors (H*L*dh,
// L*dh, dh).  K4 is not padded: the TPU wrapper pads L to 8 for the
// sublanes only, and this kernel masks by length.  The wrapper admits
// strides and dh that are multiples of 8 elements and 16-byte aligned
// bases, so every row is whole 16-byte pieces (TMA's stride rule too).
//
// Two more modes serve the block-variant bench (scripts/bench_block_variants.py,
// make_kernel :60 and bench_micro :610-685), whose bf16 variants scale q in
// the activation dtype:
//   ATT_Q_ROUND     q is T(q * T(scale)), rounded to the activation dtype
//                   before the fp32 score dot (`qkv[...] * scale` on a bf16
//                   slice, :212, :657, :850: the Python scale is cast to bf16);
//                   in bf16 the Q tile is scaled in shared memory
//   ATT_NO_SOFTMAX  as ATT_Q_ROUND, then weights T(s * 0.005) over all L keys
//                   with no mask and no softmax (attn_nosm, :664-665); it
//                   ignores length and causal, and runs pass 2 only.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int ATT_MAX_DH = 128;
enum { ATT_SOFTMAX = 0, ATT_Q_ROUND = 1, ATT_NO_SOFTMAX = 2 };

inline int padded_dh(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// T(q * T(scale)) on a packed pair of bf16 values: the product of two bf16
// values is exact in fp32 and is rounded once.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float scale_t) {
  __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&v);
  return pack_bf16(__fmul_rn(__low2float(p), scale_t), __fmul_rn(__high2float(p), scale_t));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- bf16: wgmma fed by a TMA ring ---------------------------------------------

constexpr int TILE = 64;               // query rows a block; keys a ring tile
constexpr int RING = 4;                // ring stages
constexpr int BOX_BYTES = TILE * 128;  // a 64-row x 64-column box: 8 KB
constexpr int THREADS = 128 + 32;      // the consumer warpgroup and the producer warp

inline int wgmma_dh(int dh) { return dh <= 64 ? 64 : 128; }

// The Q tile and the ring, + slack to align to 1024 (the swizzle pattern
// repeats every 1024 bytes: tiles start on it)
size_t wgmma_smem_bytes(int dh) {
  return (size_t)(1 + RING) * (wgmma_dh(dh) / 64) * BOX_BYTES + 1024;
}

// d (+)= Q (64x16) . K^T (64 keys), both K-major: K's rows as stored, no transpose
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += P (64x16, bf16 registers) . V (16x64, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += P (64x16, bf16 registers) . V (16x128, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DHP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DHP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DHP == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// The ring of K and V tiles.  The block's i-th tile lies in stage i %
// RING; `full` counts its bytes, `empty` the consumer threads done with it.
// Pass 1 reads K's tiles 0 .. nk - 1 and pass 2 K's and V's in turn.
struct Ring {
  uint32_t base;
  uint64_t* full;
  uint64_t* empty;
  int tile_bytes;
  __device__ __forceinline__ uint32_t acquire(int i) const {
    mbar_wait(smem_u32(&full[i % RING]), (i / RING) & 1);
    return base + (i % RING) * tile_bytes;
  }
  __device__ __forceinline__ void release(int i) const {
    mbar_arrive(smem_u32(&empty[i % RING]));
  }
};

// s = Q . K^T over a whole 64-key tile, in K steps of 16 columns: the
// 64-column boxes lie BOX_BYTES apart, and a step advances 32 bytes inside
// a box's 128-byte swizzled rows (descriptor SBO 1024: eight rows).
// Columns past dh are zero (TMA's fill).  Every score product has this one
// shape: a narrower last tile (m64n16, m64n32) in the same kernel made
// ptxas serialize all of its wgmma, which cost more than the keys it saved.
template <int DHP>
__device__ __forceinline__ void tile_scores(float (&s)[32], uint32_t qt, uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_scores(s, smem_desc(qt + off, 16, 1024), smem_desc(kt + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// What a consumer thread needs of a key tile besides the ring.
struct TileArgs {
  uint32_t qt;  // the Q tile
  int col;      // the thread's first key of the tile
  int row0;     // the thread's rows: row0, row0 + 8
  int kend;
  bool causal;
  bool edge;    // does the tile need the mask?
  float coef;   // exp(scale * x) = 2^(x * coef)
};

// -1e30 for the tile's first N keys that lie at or past kend or, when
// causal, above the thread's rows (the accumulator layout: s[4j + e] is row
// row0 + 8 (e / 2), key col + 8j + e % 2).
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[32], const TileArgs& t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = t.col + 8 * j + (e & 1), r = t.row0 + (e < 2 ? 0 : 8);
      if (c >= t.kend || (t.causal && c > r)) s[4 * j + e] = -1e30f;
    }
}

// Pass 1 on one key tile, whose first N keys (16, 32 or 64) hold all it
// attends: the scores, then the row max and the running sum of exp(s -
// max) over those keys, each row's max shared by the four threads that
// hold it.
template <int N, int DHP>
__device__ __forceinline__ void stats_step(const Ring& ring, int ki, const TileArgs& t,
                                           float (&m)[2], float (&l)[2]) {
  float s[32];
  tile_scores<DHP>(s, t.qt, ring.acquire(ki));
  ring.release(ki);
  if (t.edge) mask_scores<N>(s, t);
  float c[2] = {-1e30f, -1e30f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    c[0] = fmaxf(c[0], fmaxf(s[4 * j], s[4 * j + 1]));
    c[1] = fmaxf(c[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) c[h] = fmaxf(c[h], __shfl_xor_sync(0xffffffffu, c[h], o));
    const float n = fmaxf(m[h], c[h]);
    l[h] *= ex2((m[h] - n) * t.coef);
    m[h] = n;
    nm[h] = -n * t.coef;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    l[0] += ex2(fmaf(s[4 * j], t.coef, nm[0])) + ex2(fmaf(s[4 * j + 1], t.coef, nm[0]));
    l[1] += ex2(fmaf(s[4 * j + 2], t.coef, nm[1])) + ex2(fmaf(s[4 * j + 3], t.coef, nm[1]));
  }
}

// Pass 2 on one key tile: the scores again, the weights of its first N keys
// exp(s - max) * (1 / sum) in fp32 rounded to bf16 (no_softmax: T(s *
// 0.005)), packed straight from the accumulator layout into the A
// fragments of N / 16 steps of 16 keys, then o += P . V over those steps
// with V's tile read through the transpose bit (descriptor LBO BOX_BYTES
// between 64-column boxes, SBO 1024 between eight key rows; a step
// advances 16 rows of 128 bytes).  K's tile is ring tile ki, V's ki + 1.
template <int N, int DHP, int MODE>
__device__ __forceinline__ void pv_step(const Ring& ring, int ki, const TileArgs& t,
                                        float (&o)[DHP / 2], const float (&nm)[2],
                                        const float (&rl)[2]) {
  float s[32];
  tile_scores<DHP>(s, t.qt, ring.acquire(ki));
  ring.release(ki);
  if (MODE != ATT_NO_SOFTMAX && t.edge) mask_scores<N>(s, t);
  uint32_t a[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = s + 8 * kk + 4 * h;
      if (MODE == ATT_NO_SOFTMAX) {
        a[kk][2 * h] = pack_bf16(__fmul_rn(x[0], 0.005f), __fmul_rn(x[1], 0.005f));
        a[kk][2 * h + 1] = pack_bf16(__fmul_rn(x[2], 0.005f), __fmul_rn(x[3], 0.005f));
      } else {
        a[kk][2 * h] = pack_bf16(ex2(fmaf(x[0], t.coef, nm[0])) * rl[0],
                                 ex2(fmaf(x[1], t.coef, nm[0])) * rl[0]);
        a[kk][2 * h + 1] = pack_bf16(ex2(fmaf(x[2], t.coef, nm[1])) * rl[1],
                                     ex2(fmaf(x[3], t.coef, nm[1])) * rl[1]);
      }
    }
  const uint32_t vt = ring.acquire(ki + 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<DHP>(o, a[kk], smem_desc(vt + kk * 16 * 128, BOX_BYTES, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  ring.release(ki + 1);
}

// The keys of a tile with `keys` keys left that the softmax and P . V take:
// 16, 32 or 64.
__device__ __forceinline__ int tile_width(int keys) { return keys > 32 ? 64 : keys > 16 ? 32 : 16; }

template <int DHP, int MODE>
__global__ void __launch_bounds__(THREADS, DHP == 64 ? 3 : 2)
attention_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                     long long osb, long long osh, long long osr, int L, int dh, int length,
                     int causal, int rows_first, float scale) {
  constexpr int TB = DHP / 64 * BOX_BYTES;  // the Q tile or a ring stage
  constexpr bool NO_SM = MODE == ATT_NO_SOFTMAX;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[RING], empty[RING], q_full;
  const uint32_t qt = (smem_u32(smem_raw) + 1023) & ~1023u;  // the Q tile, then the ring
  unsigned char* qtile = smem_raw + (qt - smem_u32(smem_raw));
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;  // the block's first row
  const bool causal_on = causal && !NO_SM;
  const int kend = NO_SM ? L : min(L, length);
  // keys the block attends (the causal diagonal bounds them by its last
  // row), in nk tiles, the last n_last keys wide
  const int kend_b = causal_on ? min(kend, q0 + TILE) : kend;
  const int nk = (kend_b + TILE - 1) / TILE;
  const int n_last = tile_width(kend_b - TILE * (nk - 1));
  const int pass2 = NO_SM ? 0 : nk;  // the ring index of pass 2's first tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128);
    }
    mbar_init(smem_u32(&q_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const Ring ring{qt + TB, full, empty, TB};
  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128) {
      // rows `row` .. row + 63 of this (batch, head), every 64-column box
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int row) {
#pragma unroll
        for (int bx = 0; bx < DHP / 64; ++bx)
          tma_load_4d(dst + bx * BOX_BYTES, map, bar, 64 * bx, rows_first ? row : h,
                      rows_first ? h : row, b);
      };
      mbar_arrive_expect_tx(smem_u32(&q_full), TB);
      load(qt, &tm_q, smem_u32(&q_full), q0);
      // ring index i: K's or V's tile j
      auto stage = [&](int i, const CUtensorMap* map, int j) {
        const int s = i % RING;
        mbar_wait(smem_u32(&empty[s]), ((i / RING) & 1) ^ 1);
        mbar_arrive_expect_tx(smem_u32(&full[s]), TB);
        load(ring.base + s * TB, map, smem_u32(&full[s]), TILE * j);
      };
      for (int i = 0; i < pass2; ++i) stage(i, &tm_k, i);
      for (int j = 0; j < nk; ++j) {
        stage(pass2 + 2 * j, &tm_k, j);
        stage(pass2 + 2 * j + 1, &tm_v, j);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TileArgs t{qt, 0, q0 + 16 * warp + (lane >> 2), kend, causal_on, false,
             (MODE == ATT_SOFTMAX ? scale : 1.f) * 1.4426950408889634f};
  // key tile j: its width, and does it reach past kend or, when causal,
  // past the block's first row?
  auto at_tile = [&](int j) {
    const int kb = TILE * j, n = j + 1 < nk ? TILE : n_last;
    t.col = kb + 2 * (lane & 3);
    t.edge = kb + n > kend || (causal_on && kb + n - 1 > q0);
    return n;
  };

  mbar_wait(smem_u32(&q_full), 0);
  if (MODE != ATT_SOFTMAX) {  // Q scaled and rounded in place
    const float scale_t = pck::round_to<bf16>(scale);
    for (int i = threadIdx.x; i < TB / 16; i += 128) {
      uint4* p = reinterpret_cast<uint4*>(qtile + 16 * i);
      uint4 x = *p;
      x.x = scale_pair(x.x, scale_t);
      x.y = scale_pair(x.y, scale_t);
      x.z = scale_pair(x.z, scale_t);
      x.w = scale_pair(x.w, scale_t);
      *p = x;
    }
    fence_proxy_async();
    consumers_sync<128>();
  }

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  if (!NO_SM) {  // pass 1: the row max and the sum of exp(s - max)
    for (int j = 0; j < nk; ++j) {
      const int n = at_tile(j);
      if (n == 64)
        stats_step<64, DHP>(ring, j, t, m, l);
      else if (n == 32)
        stats_step<32, DHP>(ring, j, t, m, l);
      else
        stats_step<16, DHP>(ring, j, t, m, l);
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], o);
  }

  // pass 2: the scores again, the weights, P . V
  const float nm[2] = {-m[0] * t.coef, -m[1] * t.coef}, rl[2] = {1.f / l[0], 1.f / l[1]};
  float o[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int ki = pass2 + 2 * j;  // the ring index of K's tile j
    const int n = at_tile(j);
    if (n == 64)
      pv_step<64, DHP, MODE>(ring, ki, t, o, nm, rl);
    else if (n == 32)
      pv_step<32, DHP, MODE>(ring, ki, t, o, nm, rl);
    else
      pv_step<16, DHP, MODE>(ring, ki, t, o, nm, rl);
  }

  // The output in the Q tile, in its swizzled layout (16-byte piece p of
  // row r at p ^ (r % 8)), then 16-byte stores of whole rows.
  consumers_sync<128>();  // every warp's products, which read Q, are done
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + (lane >> 2) + 8 * hh;
      const int byte = (j >> 3) * BOX_BYTES + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3);
      *reinterpret_cast<uint32_t*>(qtile + byte) =
          pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
    }
  consumers_sync<128>();
  const long long obase = b * osb + h * osh;
  for (int i = threadIdx.x; i < TILE * (DHP / 8); i += 128) {
    const int r = i / (DHP / 8), p = i % (DHP / 8);
    if (q0 + r < L && 8 * p < dh)
      *reinterpret_cast<uint4*>(out + obase + (long long)(q0 + r) * osr + 8 * p) =
          *reinterpret_cast<const uint4*>(qtile + (p >> 3) * BOX_BYTES + r * 128 +
                                          (((p & 7) ^ (r & 7)) << 4));
  }
}

// A 4-D tensor map over one of q, k, v: (dh, rows, heads, batch), with rows
// and heads in the order of their strides (`rows_first` when the row stride
// is the smaller), read in boxes of 64 columns x 64 rows of one (batch,
// head) with the 128-byte swizzle.  Reads past dh and past L are zero-filled.
bool head_map(CUtensorMap* map, const void* ptr, const long long* st, int B, int L, int H,
              int dh, bool rows_first) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)(rows_first ? L : H),
                              (cuuint64_t)(rows_first ? H : L), (cuuint64_t)B};
  const cuuint64_t strides[3] = {2 * (cuuint64_t)(rows_first ? st[2] : st[1]),
                                 2 * (cuuint64_t)(rows_first ? st[1] : st[2]),
                                 2 * (cuuint64_t)st[0]};
  const cuuint32_t box[4] = {64, rows_first ? 64u : 1u, rows_first ? 1u : 64u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP, int MODE>
int launch_wgmma(const void* q, const void* k, const void* v, const long long* st, void* out,
                 const long long* ost, int B, int L, int H, int dh, int length, int causal,
                 float scale, cudaStream_t stream) {
  const bool rows_first = st[2] <= st[1];
  CUtensorMap tm_q, tm_k, tm_v;
  if (!head_map(&tm_q, q, st, B, L, H, dh, rows_first) ||
      !head_map(&tm_k, k, st, B, L, H, dh, rows_first) ||
      !head_map(&tm_v, v, st, B, L, H, dh, rows_first))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_wgmma<DHP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TILE - 1) / TILE, H, B);
  attention_bf16_wgmma<DHP, MODE><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), ost[0], ost[1], ost[2], L, dh, length, causal,
      rows_first, scale);
  return (int)cudaGetLastError();
}

template <int DHP>
int launch_wgmma_mode(int mode, const void* q, const void* k, const void* v, const long long* st,
                      void* out, const long long* ost, int B, int L, int H, int dh, int length,
                      int causal, float scale, cudaStream_t s) {
  if (mode == ATT_Q_ROUND)
    return launch_wgmma<DHP, ATT_Q_ROUND>(q, k, v, st, out, ost, B, L, H, dh, length, causal,
                                          scale, s);
  if (mode == ATT_NO_SOFTMAX)
    return launch_wgmma<DHP, ATT_NO_SOFTMAX>(q, k, v, st, out, ost, B, L, H, dh, length, causal,
                                             scale, s);
  return launch_wgmma<DHP, ATT_SOFTMAX>(q, k, v, st, out, ost, B, L, H, dh, length, causal,
                                        scale, s);
}

// -- fp32: exact tiled kernel on the CUDA cores -------------------------------------

constexpr int F_CHUNK = 64;      // keys a K or V chunk
constexpr int F_WARPS = 8;       // warp w owns the tile's query rows 8w .. 8w + 7
constexpr int F_ROWS = 8 * F_WARPS;  // query rows a block

// Row stride (floats) of the score tile: 4 mod 8, so rows r and r + 4 sit
// 16 banks apart, and every row starts on 16 bytes.
__host__ __device__ inline int f32_score_stride(int L) { return ((L + 7) & ~7) + 4; }

// The scaled Q tile, two 64-key chunk buffers (row stride the padded head
// width + 4 floats) and the tile's score rows.
size_t f32_smem_bytes(int L, int dh) {
  const size_t qs = padded_dh(dh) + 4;
  return ((F_ROWS + 2 * F_CHUNK) * qs + F_ROWS * (size_t)f32_score_stride(L)) * sizeof(float);
}

// acc[i][c] += p[i] * v[c] over the thread's CW output columns of V row
// `vr`: columns 4 dg (+ 64) when CW >= 4, 2 dg when CW = 2.
template <int CW>
__device__ __forceinline__ void pv_row(float (&acc)[4][CW], const float (&p)[4], const float* vr,
                                       int dg) {
  float vv[CW];
  if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(vr + 2 * dg);
    vv[0] = t.x, vv[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < CW / 4; ++h) {
      const float4 t = *reinterpret_cast<const float4*>(vr + 64 * h + 4 * dg);
      vv[4 * h] = t.x, vv[4 * h + 1] = t.y, vv[4 * h + 2] = t.z, vv[4 * h + 3] = t.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
}

// s[i][j] = (row r0 + i of Q) . (key kg + 16j of chunk C) for j < nj
// (FULL: nj = 4, with no branch in the loop), each a sum over d
// ascending, one fmaf a step.  Rows r and r + 4 of Q, and keys kg and
// kg + 8 of C, fall on distinct banks (row stride DHP + 4 floats).
template <int DHP, bool FULL>
__device__ __forceinline__ void chunk_scores_f32(float (&s)[4][4], const float* Qs, const float* C,
                                                 int r0, int kg, int nj) {
  constexpr int QS = DHP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DHP; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * QS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (FULL || j < nj) {
        const float4 kv = *reinterpret_cast<const float4*>(C + (kg + 16 * j) * QS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(F_WARPS * 32, 2)
attention_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, long long sb, long long sh, long long sr,
                    float* __restrict__ out, long long osb, long long osh, long long osr, int L,
                    int dh, int length, int causal, int mode, float scale) {
  constexpr int QS = DHP + 4;    // row stride (floats) of Q and of a K/V chunk
  constexpr int CW = DHP / 16;   // output columns a thread holds in P.V
  extern __shared__ __align__(16) float fsm[];
  const int LS = f32_score_stride(L);
  constexpr int qt = F_ROWS;          // the tile's query rows: 8 a warp
  float* Qs = fsm;                    // [qt][QS]: q * scale
  float* KV = Qs + qt * QS;           // two [64][QS] chunk buffers: K chunks, then V chunks
  float* S = KV + 2 * F_CHUNK * QS;   // [qt][LS]: scores, then weights

  const long long base = blockIdx.z * sb + blockIdx.y * sh;  // this (batch, head)
  const long long obase = blockIdx.z * osb + blockIdx.y * osh;
  const int q0 = blockIdx.x * qt;
  const int nrows = min(qt, L - q0);
  const bool no_softmax = mode == ATT_NO_SOFTMAX;
  const bool causal_on = causal && !no_softmax;
  const int kend = no_softmax ? L : min(L, length);
  const int kend_tile = causal_on ? min(kend, q0 + nrows) : kend;  // keys any row attends
  const int nc = (kend_tile + F_CHUNK - 1) / F_CHUNK;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // Q rows of the tile by cp.async, in the first chunk's group; each thread
  // scales the pieces it brought once they land.  Rows past the tile and
  // columns past dh are zero, as are the chunk buffers' columns past dh,
  // which cp.async never writes.
  for (int idx = threadIdx.x; idx < qt * (DHP / 4); idx += blockDim.x) {
    const int r = idx / (DHP / 4), c = (idx - r * (DHP / 4)) * 4;
    if (r < nrows && c < dh)
      cp_async16(Qs + r * QS + c, q + base + (long long)(q0 + r) * sr + c);
    else
      *reinterpret_cast<float4*>(Qs + r * QS + c) = zero4;
  }
  if (dh < DHP) {
    const int padp = (DHP - dh) >> 2;
    for (int idx = threadIdx.x; idx < 2 * F_CHUNK * padp; idx += blockDim.x) {
      const int r = idx / padp, c = dh + ((idx - r * padp) << 2);
      *reinterpret_cast<float4*>(KV + r * QS + c) = zero4;
    }
  }

  // Chunk t < nc is K's keys 64t.., chunk nc + t is V's, into buffer t % 2.
  // Rows below kend_tile come by cp.async; V's rows from there up to the
  // next multiple of 4 are zeroed, so a weight of 0 never meets an unread
  // value.  Each call commits one group (perhaps empty).
  auto load_chunk = [&](int t) {
    if (t < 2 * nc) {
      const bool is_v = t >= nc;
      const int kb = (is_v ? t - nc : t) * F_CHUNK;
      const float* src = (is_v ? v : k) + base;
      float* dst = KV + (t & 1) * F_CHUNK * QS;
      const int rows = min(F_CHUNK, kend_tile - kb);
      // (row, piece) over the padded width: a shift, no division; the
      // pieces past dh are skipped
      for (int idx = threadIdx.x; idx < rows * (DHP / 4); idx += blockDim.x) {
        const int j = idx / (DHP / 4), c = (idx % (DHP / 4)) << 2;
        if (c < dh) cp_async16(dst + j * QS + c, src + (long long)(kb + j) * sr + c);
      }
      if (is_v) {
        const int zrows = min(F_CHUNK, ((kend_tile + 3) & ~3) - kb) - rows;
        for (int idx = threadIdx.x; idx < zrows * (DHP / 4); idx += blockDim.x) {
          const int j = rows + idx / (DHP / 4), c = (idx % (DHP / 4)) << 2;
          if (c < dh) *reinterpret_cast<float4*>(dst + j * QS + c) = zero4;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Chunk t has landed and is visible, and every warp is done with chunk
  // t - 1, whose buffer the next load_chunk(t + 1) then overwrites: one
  // barrier a chunk.
  auto chunk_ready = [&]() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 8 * warp + 4 * (lane >> 4);  // the thread's rows r0 .. r0 + 3
  const int kg = lane & 15;                    // keys kg + 16j of a chunk; columns of dg = kg
  const bool warp_on = 8 * warp < nrows;
  // keys this warp attends: the causal diagonal bounds them by its last row
  const int kend_w = causal_on ? min(kend_tile, q0 + 8 * warp + 8) : kend_tile;
  const int jw = (kend_w + 3) & ~3;  // its weights' extent: zero past each row's last key

  load_chunk(0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // Q and chunk 0
  for (int idx = threadIdx.x; idx < nrows * (DHP / 4); idx += blockDim.x) {
    const int r = idx / (DHP / 4), c = (idx - r * (DHP / 4)) * 4;
    if (c < dh) {
      float4* p = reinterpret_cast<float4*>(Qs + r * QS + c);
      const float4 x = *p;
      // ATT_Q_ROUND / ATT_NO_SOFTMAX round q * scale to the activation
      // dtype, which is fp32 here: the same product
      *p = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }

  // 1. scores of keys kb + kg + 16j (j < nj) for rows r0 .. r0 + 3 into the
  // score tile, and each row's running max over the thread's keys, then
  // over the 16 threads of its half warp, which hold the keys of its rows
  float rmax[4] = {-1e30f, -1e30f, -1e30f, -1e30f};
  for (int t = 0; t < nc; ++t) {
    chunk_ready();
    load_chunk(t + 1);
    const float* C = KV + (t & 1) * F_CHUNK * QS;
    const int kb = t * F_CHUNK;
    if (warp_on && kb < kend_w) {
      const int nj = min(4, (kend_w - kb + 15) >> 4);
      float s[4][4];
      if (nj == 4)
        chunk_scores_f32<DHP, true>(s, Qs, C, r0, kg, 4);
      else
        chunk_scores_f32<DHP, false>(s, Qs, C, r0, kg, nj);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kb + kg + 16 * j;
        if (j < nj && key < kend_w)
#pragma unroll
          for (int i = 0; i < 4; ++i) S[(r0 + i) * LS + key] = s[i][j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jend = causal_on ? min(kend, q0 + r0 + i + 1) : kend;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj && kb + kg + 16 * j < jend) rmax[i] = fmaxf(rmax[i], s[i][j]);
      }
    }
  }
  if (warp_on)  // each row's max over the half warp that holds its keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], o));

  // 2. the warp's 8 rows side by side: expf(s - max) with the row max of
  // the scores, the sum and the IEEE division over the row in fp32, lane j
  // taking keys j, j + 32, ... (no_softmax: s * 0.005 over all L keys);
  // weights 0 from a row's last key up to jw.  The warp wrote these rows'
  // scores itself.
  if (warp_on) {
    float mx[8], sum[8];
    int jend[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      // row u's max: held by lanes 0-15 (u < 4) or 16-31 (u >= 4)
      mx[u] = __shfl_sync(0xffffffffu, rmax[u & 3], u < 4 ? 0 : 16);
      const int rl = min(8 * warp + u, nrows - 1);  // rows past the tile: a copy of the last
      jend[u] = causal_on ? min(kend, q0 + rl + 1) : kend;
      sum[u] = 0.f;
    }
    // branch-free over the 8 rows, so their loads, exps and divisions
    // interleave; a key past a row's last one reads as 0 and adds nothing
    float* Sw = S + 8 * warp * LS;
    if (!no_softmax) {
      for (int j = lane; j < jw; j += 32) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float ev = expf(Sw[u * LS + j] - mx[u]);  // past jend: unused
          e[u] = j < jend[u] ? ev : 0.f;
          sum[u] += e[u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) Sw[u * LS + j] = e[u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) sum[u] = pck::warp_sum(sum[u]);
    }
    for (int j = lane; j < jw; j += 32) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float x = j < jend[u] ? Sw[u * LS + j] : 0.f;
        w[u] = no_softmax ? __fmul_rn(x, 0.005f) : x / sum[u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) Sw[u * LS + j] = w[u];
    }
    __syncwarp();
  }

  // 3. P.V, each output's sum over keys ascending, one fmaf a step
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  for (int t = nc; t < 2 * nc; ++t) {
    chunk_ready();
    load_chunk(t + 1);
    const float* C = KV + (t & 1) * F_CHUNK * QS;
    const int kb = (t - nc) * F_CHUNK;
    if (warp_on && kb < kend_w) {
      const int jn = min(F_CHUNK, jw - kb);
#pragma unroll 2
      for (int jj = 0; jj < jn; jj += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(S + (r0 + i) * LS + kb + jj);
        const float p0[4] = {pv[0].x, pv[1].x, pv[2].x, pv[3].x};
        const float p1[4] = {pv[0].y, pv[1].y, pv[2].y, pv[3].y};
        const float p2[4] = {pv[0].z, pv[1].z, pv[2].z, pv[3].z};
        const float p3[4] = {pv[0].w, pv[1].w, pv[2].w, pv[3].w};
        const float* vr = C + jj * QS;
        pv_row<CW>(acc, p0, vr, kg);
        pv_row<CW>(acc, p1, vr + QS, kg);
        pv_row<CW>(acc, p2, vr + 2 * QS, kg);
        pv_row<CW>(acc, p3, vr + 3 * QS, kg);
      }
    }
  }

  if (!warp_on) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = r0 + i;
    if (rl >= nrows) continue;
    float* orow = out + obase + (long long)(q0 + rl) * osr;
    if constexpr (CW == 2) {
      if (2 * kg < dh) *reinterpret_cast<float2*>(orow + 2 * kg) = make_float2(acc[i][0], acc[i][1]);
    } else {
#pragma unroll
      for (int h = 0; h < CW / 4; ++h) {
        const int c = 64 * h + 4 * kg;
        if (c < dh)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

template <int DHP>
int launch_f32(const void* q, const void* k, const void* v, const long long* st, void* out,
               const long long* ost, int B, int L, int H, int dh, int length, int causal,
               int mode, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_f32_tiled<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F_ROWS - 1) / F_ROWS, H, B);
  attention_f32_tiled<DHP><<<grid, F_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      st[0], st[1], st[2], static_cast<float*>(out), ost[0], ost[1], ost[2], L, dh, length,
      causal, mode, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// (sb, sh, sr): the batch, head and row strides (elements) shared by q, k
// and v; (osb, osh, osr) those of the output.  Element d of head h, row r,
// batch b of q sits at q[b*sb + h*sh + r*sr + d].
extern "C" int attention_packed(int dtype, const void* q, const void* k, const void* v,
                                long long sb, long long sh, long long sr, void* out,
                                long long osb, long long osh, long long osr, int B, int L, int H,
                                int dh, int length, int causal, int mode, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > ATT_MAX_DH || dh % 8 || length < 1 || mode < ATT_SOFTMAX || mode > ATT_NO_SOFTMAX)
    return (int)cudaErrorInvalidValue;
  const long long st[3] = {sb, sh, sr}, ost[3] = {osb, osh, osr};
  if (dtype == PCK_BF16) {
    if (wgmma_dh(dh) == 64)
      return launch_wgmma_mode<64>(mode, q, k, v, st, out, ost, B, L, H, dh, length, causal,
                                   scale, s);
    return launch_wgmma_mode<128>(mode, q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
                                  s);
  }
  if (dtype == PCK_F32) {
    const int dhp = padded_dh(dh);
    if (dhp == 32)
      return launch_f32<32>(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale, s);
    if (dhp == 64)
      return launch_f32<64>(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale, s);
    return launch_f32<128>(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_packed_smem_bytes(int dtype, int L, int dh) {
  return dtype == PCK_BF16 ? wgmma_smem_bytes(dh) : f32_smem_bytes(L, dh);
}

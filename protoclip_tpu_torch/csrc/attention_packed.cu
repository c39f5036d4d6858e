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
// Bound on the H100: bytes at CLIP's short sequences.  Per (batch, head)
// it reads 3*L*dh values and writes L*dh, for 4*L^2*dh flops: at L=197,
// dh=64 that is ~100 flops per byte, below the ~295 flop/byte bf16 ridge.
//
// bf16 design (tensor cores).  Grid (query tiles, heads, batch); a block
// takes a tile of up to 128 query rows of one (batch, head), one warp per
// 16 rows (the tile is L split evenly into ceil(L/128) parts, so no block
// idles on a ragged tail).  Q, and the head's K and V rows below kend, go
// into shared memory with 16-byte cp.async (Q and K in one group, V in a
// second that lands while the scores run); rows from kend up to the next
// multiple of 16, and columns from dh up to the padded head width DHP (32,
// 64 or 128), are zero-filled, so a masked weight of 0 never meets an
// uninitialised V value.  Rows are padded by 16 bytes, so ldmatrix reads
// eight rows on eight distinct bank groups.  Scores are mma.sync.m16n8k16
// bf16 -> fp32, A = Q by ldmatrix, B = K by ldmatrix (K's rows are the n
// dimension, no transpose).  The softmax is over the whole row and not
// online: pass 1 walks the keys in chunks of 64 for the row max and the sum
// of exp(s - max) (the running sum is rescaled when the max grows, which
// changes it by fp32 ulps only); pass 2 recomputes the chunk's scores (the
// kernel is bound by bytes, the recompute is cheap), forms the weights
// exp(s - max) * (1 / sum) normalised in fp32, rounds them to bf16 at the
// TPU kernel's cast point, and runs PV with P straight from the accumulator
// registers (the m16n8k16 C layout packed to bf16 is the A layout) and V by
// ldmatrix.trans.  Holding the whole row in registers would need 34 n8
// tiles (136 fp32 values a thread) at L=257; a chunk needs 32.  Causal:
// key chunks and 16-key tiles wholly above a warp's last row are skipped,
// the diagonal tile is masked.  The output is staged in the warp's own Q
// rows and written with 16-byte stores.  The scale 1/sqrt(dh) is applied to
// the fp32 accumulator: at dh = 64 (every backbone) 0.125 is exact, so this
// equals (q * scale) . k up to the order of the sum; at dh = 32 (a test
// geometry) it may differ by an fp32 ulp.  Per score the softmax costs a few
// instructions, as in flash attention: exp(scale * (acc - max)) is
// ex2.approx of one FMA with scale * log2(e) folded in (within ~1e-6
// relative of expf, far below the bf16 rounding of the weights), the sum is
// divided once a row and the weights are multiplied by its reciprocal, and
// only the 16-key tiles that reach past length or the diagonal are masked.
// Registers: chip_smoke.py's build phase reports ptxas's count for each
// instantiation (PERF.md); none spills.
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
// bases, so every row is whole 16-byte pieces.
//
// Two more modes serve the block-variant bench (scripts/bench_block_variants.py,
// make_kernel :60 and bench_micro :610-685), whose bf16 variants scale q in
// the activation dtype:
//   ATT_Q_ROUND     q is T(q * T(scale)), rounded to the activation dtype
//                   before the fp32 score dot (`qkv[...] * scale` on a bf16
//                   slice, :212, :657, :850: the Python scale is cast to bf16)
//   ATT_NO_SOFTMAX  as ATT_Q_ROUND, then weights T(s * 0.005) over all L keys
//                   with no mask and no softmax (attn_nosm, :664-665); it
//                   ignores length and causal.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ATT_MAX_DH = 128;
enum { ATT_SOFTMAX = 0, ATT_Q_ROUND = 1, ATT_NO_SOFTMAX = 2 };

// -- bf16: mma.sync tensor-core kernel ----------------------------------------

constexpr int MMA_MAX_WARPS = 8;  // 128 query rows a block
constexpr int KEY_CHUNK = 64;     // keys per score chunk: 8 n8 tiles, 32 fp32 a thread

// Query tiles and warps a block for L: ceil(L/128) tiles of equal size.
__host__ __device__ inline int mma_tiles(int L) {
  return (L + 16 * MMA_MAX_WARPS - 1) / (16 * MMA_MAX_WARPS);
}
__host__ __device__ inline int mma_warps(int L) {
  const int rows = (L + mma_tiles(L) - 1) / mma_tiles(L);
  return (rows + 15) / 16;
}
inline int padded_dh(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

size_t mma_smem_bytes(int L, int dh) {
  const size_t rows = 16 * (size_t)mma_warps(L) + 2 * (((size_t)L + 15) & ~(size_t)15);
  return rows * (padded_dh(dh) + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// s[j] (j < 2*n16) = Q rows . K rows kb + 8j .. kb + 8j + 7
template <int DHP>
__device__ __forceinline__ void chunk_scores(float (&s)[KEY_CHUNK / 8][4],
                                             const uint32_t (&qa)[DHP / 16][4], const bf16* Ks,
                                             int kb, int n16, int lane) {
  constexpr int SR = DHP + 8;
  const int key_off = (lane & 7) + ((lane >> 4) << 3);
  const int d_off = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int t = 0; t < KEY_CHUNK / 16; ++t) {
    if (t < n16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * t][e] = s[2 * t + 1][e] = 0.f;
      const bf16* kp = Ks + (kb + 16 * t + key_off) * SR + d_off;
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kp + kk * 16);
        mma_bf16(s[2 * t], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * t + 1], qa[kk], b[2], b[3]);
      }
    }
  }
}

// -1e30 for the masked keys of the 16-key tile t of a chunk (s[2t],
// s[2t+1]): col >= kend, and col > row when causal.  `col` is the thread's
// first column of the tile, `row` its first row (the other is row + 8).
__device__ __forceinline__ void mask_tile(float (&s)[KEY_CHUNK / 8][4], int t, int col, int row,
                                          int kend, int causal) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + 8 * h + (e & 1), r = row + (e < 2 ? 0 : 8);
      if (c >= kend || (causal && c > r)) s[2 * t + h][e] = -1e30f;
    }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DHP, int MODE>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
attention_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, long long sb, long long sh, long long sr,
                   bf16* __restrict__ out, long long osb, long long osh, long long osr, int L,
                   int dh, int length, int causal, float scale) {
  constexpr int SR = DHP + 8;  // smem row stride (elements): 16 bytes of padding
  constexpr int NT = KEY_CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nwarps = blockDim.x >> 5, qrows = 16 * nwarps;
  const int kend = MODE == ATT_NO_SOFTMAX ? L : min(L, length);
  const int kend16 = (kend + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + qrows * SR;
  bf16* Vs = Ks + kend16 * SR;

  const long long base = blockIdx.z * sb + blockIdx.y * sh;  // this (batch, head)
  const long long obase = blockIdx.z * osb + blockIdx.y * osh;
  const int q0 = blockIdx.x * qrows;
  const int pieces = dh >> 3;  // 16-byte pieces a row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int idx = threadIdx.x; idx < qrows * pieces; idx += blockDim.x) {
    const int r = idx / pieces, c = (idx - r * pieces) << 3;
    bf16* dst = Qs + r * SR + c;
    if (q0 + r < L)
      cp_async16(dst, q + base + (q0 + r) * sr + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  for (int idx = threadIdx.x; idx < kend16 * pieces; idx += blockDim.x) {
    const int j = idx / pieces, c = (idx - j * pieces) << 3;
    bf16* dst = Ks + j * SR + c;
    if (j < kend)
      cp_async16(dst, k + base + j * sr + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int idx = threadIdx.x; idx < kend16 * pieces; idx += blockDim.x) {
    const int j = idx / pieces, c = (idx - j * pieces) << 3;
    bf16* dst = Vs + j * SR + c;
    if (j < kend)
      cp_async16(dst, v + base + j * sr + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (dh < DHP) {  // zero the columns dh..DHP of every Q, K and V row
    const int padp = (DHP - dh) >> 3;
    for (int idx = threadIdx.x; idx < (qrows + 2 * kend16) * padp; idx += blockDim.x) {
      const int r = idx / padp, c = dh + ((idx - r * padp) << 3);
      *reinterpret_cast<uint4*>(Qs + r * SR + c) = zero;
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // Q and K
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int w0 = q0 + 16 * warp;  // the warp's first row
  const bool active = w0 < L;
  const int row0 = w0 + g;
  // keys this warp can attend: the causal diagonal bounds them by its last row
  const int kend_w = (causal && MODE != ATT_NO_SOFTMAX) ? min(kend, min(L, w0 + 16)) : kend;
  const int kend16_w = (kend_w + 15) & ~15;

  uint32_t qa[DHP / 16][4];
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  float s[NT][4];
  // exp(scale * (acc - max)) = 2^(acc * coef - max * coef): the scale (the
  // softmax mode; the others scaled q) and log2(e) folded into one FMA
  const float coef = (MODE == ATT_SOFTMAX ? scale : 1.f) * 1.4426950408889634f;
  // Does the 16-key tile at `key` need the mask: does it reach past kend,
  // or (causal) past the warp's first row?
  auto edge = [&](int key) { return key + 16 > kend || (causal && key + 15 > w0); };

  if (active) {
    const bf16* qp = Qs + (16 * warp + (lane & 15)) * SR + ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      ldsm_x4(qa[kk], qp + kk * 16);
      if (MODE != ATT_SOFTMAX) {
        const float scale_t = pck::round_to<bf16>(scale);
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = scale_pair(qa[kk][e], scale_t);
      }
    }
    if (MODE != ATT_NO_SOFTMAX) {
      // pass 1: the row max, and the sum of exp(s - max)
      for (int kb = 0; kb < kend16_w; kb += KEY_CHUNK) {
        const int n16 = min(KEY_CHUNK, kend16_w - kb) >> 4;
        chunk_scores<DHP>(s, qa, Ks, kb, n16, lane);
        float c0 = -1e30f, c1 = -1e30f;
#pragma unroll
        for (int t = 0; t < KEY_CHUNK / 16; ++t) {
          if (t < n16) {
            if (edge(kb + 16 * t)) mask_tile(s, t, kb + 16 * t + 2 * tig, row0, kend, causal);
#pragma unroll
            for (int j = 2 * t; j < 2 * t + 2; ++j) {
              c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
              c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
          c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
        }
        const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
        l0 *= ex2((m0 - n0) * coef);
        l1 *= ex2((m1 - n1) * coef);
        m0 = n0;
        m1 = n1;
        const float nm0 = -m0 * coef, nm1 = -m1 * coef;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < 2 * n16) {
            l0 += ex2(fmaf(s[j][0], coef, nm0)) + ex2(fmaf(s[j][1], coef, nm0));
            l1 += ex2(fmaf(s[j][2], coef, nm1)) + ex2(fmaf(s[j][3], coef, nm1));
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // V
  __syncthreads();
  if (!active) return;

  // pass 2: normalised weights rounded to bf16, then PV
  float o[DHP / 8][4];
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const float nm0 = -m0 * coef, nm1 = -m1 * coef, r0 = 1.f / l0, r1 = 1.f / l1;
  const int vkey_off = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vd_off = (lane >> 4) << 3;
  for (int kb = 0; kb < kend16_w; kb += KEY_CHUNK) {
    const int n16 = min(KEY_CHUNK, kend16_w - kb) >> 4;
    chunk_scores<DHP>(s, qa, Ks, kb, n16, lane);
#pragma unroll
    for (int t = 0; t < KEY_CHUNK / 16; ++t) {
      if (t < n16) {
        // no_softmax needs no mask: keys from L on are zero rows, so s = 0
        if (MODE != ATT_NO_SOFTMAX && edge(kb + 16 * t))
          mask_tile(s, t, kb + 16 * t + 2 * tig, row0, kend, causal);
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sj = s[2 * t + h];
          if (MODE == ATT_NO_SOFTMAX) {
            a[2 * h] = pack_bf16(__fmul_rn(sj[0], 0.005f), __fmul_rn(sj[1], 0.005f));
            a[2 * h + 1] = pack_bf16(__fmul_rn(sj[2], 0.005f), __fmul_rn(sj[3], 0.005f));
          } else {
            a[2 * h] = pack_bf16(ex2(fmaf(sj[0], coef, nm0)) * r0, ex2(fmaf(sj[1], coef, nm0)) * r0);
            a[2 * h + 1] =
                pack_bf16(ex2(fmaf(sj[2], coef, nm1)) * r1, ex2(fmaf(sj[3], coef, nm1)) * r1);
          }
        }
        const bf16* vp = Vs + (kb + 16 * t + vkey_off) * SR + vd_off;
#pragma unroll
        for (int dn = 0; dn < DHP / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_trans(b, vp + dn * 16);
          mma_bf16(o[2 * dn], a, b[0], b[1]);
          mma_bf16(o[2 * dn + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // stage the warp's 16 output rows in its own Q rows, then 16-byte stores
  bf16* os = Qs + 16 * warp * SR;
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(os + g * SR + 8 * j + 2 * tig) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * SR + 8 * j + 2 * tig) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * pieces; idx += 32) {
    const int r = idx / pieces, c = (idx - r * pieces) << 3;
    if (w0 + r < L)
      *reinterpret_cast<uint4*>(out + obase + (w0 + r) * osr + c) =
          *reinterpret_cast<const uint4*>(os + r * SR + c);
  }
}

template <int DHP, int MODE>
int launch_mma(const void* q, const void* k, const void* v, const long long* st, void* out,
               const long long* ost, int B, int L, int H, int dh, int length, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_mma<DHP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(mma_tiles(L), H, B);
  attention_bf16_mma<DHP, MODE><<<grid, 32 * mma_warps(L), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      st[0], st[1], st[2], static_cast<bf16*>(out), ost[0], ost[1], ost[2], L, dh, length, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DHP>
int launch_mma_mode(int mode, const void* q, const void* k, const void* v, const long long* st,
                    void* out, const long long* ost, int B, int L, int H, int dh, int length,
                    int causal, float scale, cudaStream_t s) {
  if (mode == ATT_Q_ROUND)
    return launch_mma<DHP, ATT_Q_ROUND>(q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
                                        s);
  if (mode == ATT_NO_SOFTMAX)
    return launch_mma<DHP, ATT_NO_SOFTMAX>(q, k, v, st, out, ost, B, L, H, dh, length, causal,
                                           scale, s);
  return launch_mma<DHP, ATT_SOFTMAX>(q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
                                      s);
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
    const int dhp = padded_dh(dh);
    if (dhp == 32)
      return launch_mma_mode<32>(mode, q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
                                 s);
    if (dhp == 64)
      return launch_mma_mode<64>(mode, q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
                                 s);
    return launch_mma_mode<128>(mode, q, k, v, st, out, ost, B, L, H, dh, length, causal, scale,
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
  return dtype == PCK_BF16 ? mma_smem_bytes(L, dh) : f32_smem_bytes(L, dh);
}

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
// fp32 keeps the exact SIMT kernel: tensor cores would round its operands
// to TF32.  Grid (query tiles of 64 rows, heads, batch); K and V rows below
// length in shared memory with odd-word row strides; each of 8 warps takes
// one query row at a time (lane j scores keys j, j+32, ...; the row max
// and sum are warp shuffles; each lane accumulates dh/32 output columns).
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

// -- fp32: exact SIMT kernel ------------------------------------------------------

constexpr int ATT_WARPS = 8;    // warps per block, one query row each at a time
constexpr int ATT_QTILE = 64;   // query rows per block
constexpr int KV_PAD = 1;       // makes a K/V row an odd number of 4-byte words

size_t simt_smem_bytes(int L, int dh) {
  const size_t kv = (2 * (size_t)L * (dh + KV_PAD) * sizeof(float) + 15) & ~(size_t)15;
  const size_t lpad = ((size_t)L + 31) & ~(size_t)31;
  return kv + (size_t)ATT_WARPS * (dh + lpad) * sizeof(float);
}

__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_f32_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, long long sb, long long sh, long long sr,
                   float* __restrict__ out, long long osb, long long osh, long long osr, int L,
                   int dh, int length, int causal, int mode, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = dh + KV_PAD;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)L * ks;
  const size_t kv_bytes = (2 * (size_t)L * ks * sizeof(float) + 15) & ~(size_t)15;
  const int lpad = (L + 31) & ~31;
  float* qbuf = reinterpret_cast<float*>(smem + kv_bytes);  // [ATT_WARPS][dh]
  float* pbuf = qbuf + ATT_WARPS * dh;                       // [ATT_WARPS][lpad]

  const long long base = blockIdx.z * sb + blockIdx.y * sh;  // this (batch, head)
  const long long obase = blockIdx.z * osb + blockIdx.y * osh;
  const bool no_softmax = mode == ATT_NO_SOFTMAX;
  const int kend = no_softmax ? L : min(L, length);

  for (int idx = threadIdx.x; idx < kend * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    const long long g = base + j * sr + d;
    Ks[j * ks + d] = k[g];
    Vs[j * ks + d] = v[g];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qbuf + warp * dh;
  float* pw = pbuf + warp * lpad;
  const int r_end = min(L, (int)(blockIdx.x + 1) * ATT_QTILE);

  for (int r = blockIdx.x * ATT_QTILE + warp; r < r_end; r += ATT_WARPS) {
    const float* qrow = q + base + r * sr;
    // ATT_Q_ROUND / ATT_NO_SOFTMAX round q * scale to the activation dtype,
    // which is fp32 here: the same product
    for (int d = lane; d < dh; d += 32) qw[d] = qrow[d] * scale;
    __syncwarp();

    const int jend = (causal && !no_softmax) ? min(kend, r + 1) : kend;
    float mx = -1e30f;
    for (int j = lane; j < jend; j += 32) {
      const float* kr = Ks + j * ks;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qw[d], kr[d], s);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    if (no_softmax) {
      for (int j = lane; j < jend; j += 32) pw[j] = __fmul_rn(pw[j], 0.005f);
    } else {
      mx = pck::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < jend; j += 32) {
        const float e = expf(pw[j] - mx);
        pw[j] = e;
        sum += e;
      }
      sum = pck::warp_sum(sum);
      for (int j = lane; j < jend; j += 32) pw[j] = pw[j] / sum;
    }
    __syncwarp();

    float acc[ATT_MAX_DH / 32];
#pragma unroll
    for (int t = 0; t < ATT_MAX_DH / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < jend; ++j) {
      const float p = pw[j];
      const float* vr = Vs + j * ks;
#pragma unroll
      for (int t = 0; t < ATT_MAX_DH / 32; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) acc[t] = fmaf(p, vr[d], acc[t]);
      }
    }
    float* orow = out + obase + r * osr;
#pragma unroll
    for (int t = 0; t < ATT_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < dh) orow[d] = acc[t];
    }
    __syncwarp();
  }
}

int launch_simt(const void* q, const void* k, const void* v, const long long* st, void* out,
                const long long* ost, int B, int L, int H, int dh, int length, int causal,
                int mode, float scale, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_f32_simt,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + ATT_QTILE - 1) / ATT_QTILE, H, B);
  attention_f32_simt<<<grid, ATT_WARPS * 32, smem, stream>>>(
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
  if (dtype == PCK_F32)
    return launch_simt(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_packed_smem_bytes(int dtype, int L, int dh) {
  return dtype == PCK_BF16 ? mma_smem_bytes(L, dh) : simt_smem_bytes(L, dh);
}

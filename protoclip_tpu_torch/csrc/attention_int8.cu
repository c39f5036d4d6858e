// attention_int8: multi-head attention with an int8 core, over strided
// (B, H, L, dh) views of q, k and v.
//
// Replaces: the head loop of scripts/bench_block_variants.py::
// make_kernel_int8s (:1023-1054), the `int8s` variants.  Per head, as there:
//   q, k: per-row int8 over the dh lanes, amax = max(max|row|, 1e-6),
//         code = clip(rint(x * (127 / amax)), +-127) with a true division;
//   s     = ((f32(q_q . k_q) * (q_amax * f32(scale/127))) * (k_amax * f32(1/127)))
//         from an s8 x s8 -> s32 dot;
//   keys with col >= length masked to -1e30, softmax in fp32 with a true
//   division, w_q = rint(w * 127) with no clip;
//   v:    one amax per head over the TPU grid block, i.e. over `group`
//         consecutive batch elements x all L rows (padded rows included) x
//         dh, code = clip(rint(v * (127 / v_amax)), +-127);
//   o     = T(f32(w_q . v_q) * (v_amax / 16129)) from an s8 x s8 -> s32 dot.
// The group is the Pallas grid's batch block g: it changes v_amax, so it is
// part of the function, not a schedule.  Every product of the scalar chain is
// written with the _rn intrinsics (no FMA contraction); the int32 dots are
// exact, so the kernel differs from its plain version only through expf and
// the order of the softmax sums.
//
// Bound on the H100: bytes.  Per (batch, head) it reads 3*L*dh values and
// writes L*dh for 4*L^2*dh int8 operations: ~100 operations per byte at
// L=200, dh=64, far below the ~590 op/byte int8 ridge.
//
// Design: two launches, both reading rows in 16-byte pieces (the wrapper
// admits dh, the row stride and the bases in whole 16-byte pieces).
// v_amax_kernel reduces |v| per (group, head) into a scratch vector (max is
// order-free, so the split is exact); a thread keeps one 8-value chunk
// column and walks the group's rows four at a time, with no division per
// value.  The attention kernel runs one block per (head, batch), so each
// head's K and V are read and quantized once (a grid of 128-row query tiles,
// as attention_packed has, would quantize them twice at L=200): the block
// quantizes the head's Q rows, its K rows below `length` (per-row codes,
// rows padded by 16 bytes so ldmatrix reads eight rows on eight bank
// groups, dh zero-padded to DHP, a multiple of 32) and V's codes transposed
// (Vt[d][key], keys contiguous: the PV product needs V K-major over keys,
// and ldmatrix.trans moves 16-bit elements, so it cannot transpose int8)
// into shared memory, each load issued several rows ahead of its use.
// Then each warp takes 16 query rows at a time (the ceil(L/16) row groups
// spread evenly over at most 8 warps: 7 at L=200, 6 at L=264); both
// products run on mma.sync.m16n8k32.s8.s8.s32 tensor cores, for bf16 and
// fp32 inputs alike (the codes are int8 whatever the input type):
//   scores  A = Q codes by ldmatrix, B = K codes (K's rows are the n
//           dimension, already K-major);
//   PV      A = w_q straight from the score registers, B = Vt by ldmatrix.
// The s32 accumulator layout (a thread holds keys 2t, 2t+1 of each 8-key
// tile) is not the s8 A layout (keys 4t..4t+3 and 16+4t..16+4t+3 of a
// 32-key step), so K's rows are stored permuted within each 32-key chunk:
// score tile i, column 2t+e holds key 4t + e + 2(i&1) + 16(i>>1).  A
// thread's four tiles of a chunk then hold exactly the keys its PV A
// fragment needs, in order, and w_q is packed into A with no shuffle and
// no staging (the five index bits of a key in its chunk are reordered
// (4,3,2,1,0) -> (4,1,3,2,0)).  Zero codes in the dh padding add nothing to
// an int32 dot, and keys from length to the next multiple of 32 get weight
// code 0, so the padding keeps the kernel exact.
// Softmax over the whole row, three passes over 32-key chunks that
// recompute the int32 scores (bit-identical each time, so this is exact):
// the row max, the sum of expf(s - max), then w_q = rint(f32(e / sum) *
// 127) and the PV product.  A warp's whole row in registers would need 132
// s32 a thread at L=264, a 64-row tile's fp32 scores ~70 KB of shared
// memory; a 32-key chunk needs 16 registers, and an s8 score product of a
// chunk is 4 (dh=64: 8) mma instructions.
// What bounds it in practice is instructions, not bytes: per score, three
// int -> float conversions, two expf, one IEEE division, one rint.  The
// conversions and the rint run on the FMA pipe (int_float, rint_int: the
// conversion instructions run at an eighth of its rate), and the cast
// point's expf, division and rint are estimated with one ex2.approx and a
// product, falling back to the written expression where the estimate lies
// near a rounding boundary (weight_code_fast / _exact): the codes stay
// those of the expression, bit for bit.
// Registers: chip_smoke.py's build phase reports ptxas's count for each
// instantiation (PERF.md).
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int AI_MAX_DH = 128;
constexpr int AI_MAX_WARPS = 8;  // warps of a block, 16 query rows each at a time
constexpr int AI_AMAX_THREADS = 512;
constexpr int KEY_CHUNK = 32;  // keys of one s8 k-step of the PV product

// Warps of a block for L: the ceil(L/16) row groups in as few rounds of at
// most 8 warps as will do, spread evenly (13 groups: 7 warps, 17: 6).
inline int ai_warps(int L) {
  const int groups = (L + 15) / 16, rounds = (groups + AI_MAX_WARPS - 1) / AI_MAX_WARPS;
  return (groups + rounds - 1) / rounds;
}
__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Shared memory of a block (bytes), in this order: kfac [L32] and qfac
// [L16] floats, Q codes [L16][DHP + 16], K codes [L32][DHP + 16], V codes
// transposed [DHP][L32 + 16].  Every part is a multiple of 16 bytes.
struct Layout {
  int l16, l32, dhp, qk_stride, v_stride;
  size_t kfac, qfac, q, k, v, total;
  __host__ __device__ Layout(int L, int dh) {
    l16 = (L + 15) & ~15;
    l32 = round32(L);
    dhp = round32(dh);
    qk_stride = dhp + 16;
    v_stride = l32 + 16;
    kfac = 0;
    qfac = kfac + (size_t)l32 * sizeof(float);
    q = qfac + (size_t)l16 * sizeof(float);
    k = q + (size_t)l16 * qk_stride;
    v = k + (size_t)l32 * qk_stride;
    total = v + (size_t)dhp * v_stride;
  }
};

size_t smem_bytes(int L, int dh) { return Layout(L, dh).total; }

// Integer <-> float on the FMA pipe (the conversion instructions run at an
// eighth of its rate): x + RND lands in [2^23, 2^24), where floats are the
// integers, so the add rounds x to an integer, ties to even, as rintf does,
// and the integer is RND's mantissa; exact for |x| < 2^22.
constexpr float RND = 12582912.f;  // 1.5 * 2^23
constexpr int RND_BITS = 0x4B400000;

__device__ __forceinline__ int rint_int(float x) {
  return __float_as_int(__fadd_rn(x, RND)) - RND_BITS;
}
// f32(s), exact for |s| < 2^22: every score, |s| <= 127^2 * 128
__device__ __forceinline__ float int_float(int s) {
  return __fsub_rn(__int_as_float(s + RND_BITS), RND);
}

// clip(rint(x * r), +-127) as the byte of an int8 code
__device__ __forceinline__ uint32_t code127(float x, float r) {
  return (uint32_t)(uint8_t)max(-127, min(127, rint_int(__fmul_rn(x, r))));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The weight code at the cast point, w_q = rint(f32(expf(x) / sum) * 127),
// for x = s - max <= 0 (so e <= 1 <= sum), with c = f32(127 / sum).  It is
// first estimated as y = ex2(x * log2 e) * c: ex2.approx, the rounded
// argument and expf's own error put the estimate within ~1e-6 relative of
// expf(x) (e^x |x| * 6e-8 for the argument, at most 0.37 * 6e-8), and the
// product with c in place of the quotient adds 4 ulps of 127, so y lies
// within 1.1e-4 of f32(expf(x) / sum) * 127.  Where y is more than 5e-4 from
// a half, both round to the same integer (weight_code_fast); otherwise
// (about one score in three thousand) the caller takes weight_code_exact,
// the expression as written.  Bit for bit the plain version's codes, at one
// MUFU and no division a score.
__device__ __forceinline__ uint32_t weight_code_fast(float x, float c, bool& near_half) {
  const float y = __fmul_rn(ex2(__fmul_rn(x, 1.44269504088896341f)), c);
  const float t = __fadd_rn(y, RND);
  near_half = fabsf(__fsub_rn(y, __fsub_rn(t, RND))) > 0.5f - 5e-4f;
  return __float_as_int(t) - RND_BITS;
}
__device__ __forceinline__ uint32_t weight_code_exact(float x, float sum) {
  return rint_int(__fmul_rn(__fdiv_rn(expf(x), sum), 127.f));
}

// Eight values from a 16-byte aligned address, widened to fp32 (exact).
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x, x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b, m16n8k32, s8 inputs, s32 accumulator (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared-memory row of key j: within its 32-key chunk, index bits
// (4,3,2,1,0) -> (4,1,3,2,0), so score tile i, column 2t+e holds key
// 4t + e + 2(i&1) + 16(i>>1) (see the header).
__device__ __forceinline__ int k_row(int j) {
  return (j & ~15) | ((j & 2) << 2) | ((j & 12) >> 1) | (j & 1);
}

// vamax[grp * H + h] = max(max |v| over batch grp*group .. +group, all L rows, dh, 1e-6).
// A thread keeps one 8-value chunk column and walks rows r0, r0 + rstep, ...
// of the group's group*L rows, four loads in flight.
template <typename T>
__global__ void __launch_bounds__(AI_AMAX_THREADS)
v_amax_kernel(const T* __restrict__ v, long long sb, long long sh, long long sr, int L, int dh,
              int group, float* __restrict__ vamax) {
  __shared__ float red[AI_AMAX_THREADS / 32];
  const int h = blockIdx.x, grp = blockIdx.y, H = gridDim.x;
  const int nc = dh >> 3, rstep = AI_AMAX_THREADS / nc;
  const int c = threadIdx.x % nc, r0 = threadIdx.x / nc;
  const T* vh = v + (long long)grp * group * sb + h * sh + 8 * c;
  const int rows = group * L;
  float m = 0.f;
  int bb = 0, r = r0;  // row r0 of the group as (batch, row)
  while (r >= L) r -= L, ++bb;
  for (int i = r0; r0 < rstep && i < rows; i += 4 * rstep) {
    float x[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u * rstep < rows) {
        load8(vh + bb * sb + r * sr, x[u]);
        for (r += rstep; r >= L; r -= L) ++bb;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[u][e]));
  }
  m = pck::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < AI_AMAX_THREADS / 32; ++w) m = fmaxf(m, red[w]);
    vamax[grp * H + h] = fmaxf(fmaxf(m, red[0]), 1e-6f);
  }
}

// Per-row codes of rows [0, nrows) of a head (row j at src + j*sr) into
// dst's row row_of(j) (stride `stride` bytes), and fac[j] = amax * mul;
// rows from `valid` on get zero codes and factor 0.  A row is dh/8 chunks of
// 8 values, one lane each, in an aligned group of LPR lanes (LPR >= DHP/8),
// so the row's amax is a shuffle inside the group; lanes from dh/8 to DHP/8
// write the zero padding.  A warp takes RPW rows a step and issues the loads
// of UNROLL steps before it uses them; every lane of a warp runs the same
// steps.
template <int DHP, typename T, typename RowOf>
__device__ __forceinline__ void quant_rows_smem(const T* __restrict__ src, long long sr,
                                                int nrows, int valid, int dh, int8_t* dst,
                                                int stride, float* fac, float mul,
                                                RowOf row_of) {
  constexpr int LPR = DHP <= 32 ? 4 : DHP <= 64 ? 8 : 16;
  constexpr int RPW = 32 / LPR;  // rows a warp per step
  constexpr int UNROLL = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int c = lane & (LPR - 1), step = nwarps * RPW;
  const bool loads = 8 * c < dh, writes = 8 * c < DHP;
  for (int base = warp * RPW + lane / LPR; base - lane / LPR < nrows; base += UNROLL * step) {
    float x[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * step;
      if (j < valid && loads) {
        load8(src + j * sr + 8 * c, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * step;
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[u][e]));
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float amax = fmaxf(m, 1e-6f);
      const float r = __fdiv_rn(127.f, amax);
      if (j < nrows && writes) {
        const bool live = j < valid;
        uint2 w = make_uint2(0, 0);
        if (live) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            w.x |= code127(x[u][e], r) << (8 * e);
            w.y |= code127(x[u][e + 4], r) << (8 * e);
          }
        }
        *reinterpret_cast<uint2*>(dst + row_of(j) * stride + 8 * c) = w;
        if (c == 0) fac[j] = live ? __fmul_rn(amax, mul) : 0.f;
      }
    }
  }
}

// V's codes at the group's scale, transposed: Vt[d][j], keys contiguous.  A
// thread takes four keys of one 8-value chunk (four loads in flight) and
// writes eight 4-byte words, one per dimension; keys from kend to the next
// multiple of 4 are zero.
template <typename T>
__device__ __forceinline__ void quant_v_transposed(const T* __restrict__ src, long long sr,
                                                   int kend, int dh, float v_r, int8_t* Vt,
                                                   int stride) {
  const int nq = (kend + 3) >> 2, items = nq * (dh >> 3);
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int c = idx / nq, jq = idx - c * nq;
    float x[4][8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * jq + e < kend) {
        load8(src + (4 * jq + e) * sr + 8 * c, x[e]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[e][i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) w |= code127(x[e][i], v_r) << (8 * e);
      *reinterpret_cast<uint32_t*>(Vt + (8 * c + i) * stride + 4 * jq) = w;
    }
  }
}

// The int32 scores of the warp's 16 rows against the 32 keys of the chunk
// whose first K row (in the permuted order) the lane's pointer `kp` names.
template <int DHP>
__device__ __forceinline__ void chunk_scores(int (&s)[4][4], const uint32_t (&qa)[DHP / 32][4],
                                             const int8_t* kp, int stride) {
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < DHP / 32; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kp + 16 * p * stride + 32 * kk);
      mma_s8(s[2 * p], qa[kk], b[0], b[1]);
      mma_s8(s[2 * p + 1], qa[kk], b[2], b[3]);
    }
}

// fp32 scores of a chunk: ((f32(s) * row factor) * key factor), -1e30 for
// keys >= kend.  Element e of tile i is row g (e < 2) or g + 8, key
// kb + 4t + (e & 1) + 2(i & 1) + 16(i >> 1); kf[i >> 1] holds the factors
// of keys kb + 16(i >> 1) + 4t .. +3.
__device__ __forceinline__ void chunk_floats(float (&f)[4][4], const int (&s)[4][4], float rf0,
                                             float rf1, const float4 (&kf)[2], int kb, int tig,
                                             int kend) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 k4 = kf[i >> 1];
    const float ka = (i & 1) ? k4.z : k4.x, kb1 = (i & 1) ? k4.w : k4.y;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float rf = e < 2 ? rf0 : rf1, kfe = (e & 1) ? kb1 : ka;
      f[i][e] = __fmul_rn(__fmul_rn(int_float(s[i][e]), rf), kfe);
    }
  }
  if (kb + KEY_CHUNK > kend) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kb + 4 * tig + (e & 1) + 2 * (i & 1) + 16 * (i >> 1) >= kend) f[i][e] = -1e30f;
  }
}

// The fp32 scores of the chunk at key kb (chunk_scores, then chunk_floats).
template <int DHP>
__device__ __forceinline__ void chunk(float (&f)[4][4], const uint32_t (&qa)[DHP / 32][4],
                                      const int8_t* kp, int stride, const float* kfac, int kb,
                                      float rf0, float rf1, int tig, int kend) {
  int s[4][4];
  chunk_scores<DHP>(s, qa, kp + kb * stride, stride);
  const float4 kf[2] = {*reinterpret_cast<const float4*>(kfac + kb + 4 * tig),
                        *reinterpret_cast<const float4*>(kfac + kb + 16 + 4 * tig)};
  chunk_floats(f, s, rf0, rf1, kf, kb, tig, kend);
}

// One warp's 16 query rows (row group rg) against the head's K and V codes:
// the three passes of the softmax and the PV product, then the output.
template <typename T, int DHP>
__device__ __forceinline__ void attend_rows(int rg, const int8_t* Qs, const float* qfac,
                                            const int8_t* Ks, const float* kfac, const int8_t* Vt,
                                            int QKS, int VS, int kend, T* out, int L, int dh,
                                            long long osr, float o_fac) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int kend32 = round32(kend);
  uint32_t qa[DHP / 32][4];
  const int8_t* qp = Qs + (16 * rg + (lane & 15)) * QKS + ((lane >> 4) << 4);
#pragma unroll
  for (int kk = 0; kk < DHP / 32; ++kk) ldsm_x4(qa[kk], qp + 32 * kk);
  const float rf0 = qfac[16 * rg + g], rf1 = qfac[16 * rg + g + 8];
  // ldmatrix rows of a chunk: lanes 0-7 tile 2p bytes 0-15, 8-15 tile 2p
  // bytes 16-31, 16-23 and 24-31 tile 2p+1 (K rows are already permuted)
  const int8_t* kp = Ks + ((lane & 7) + ((lane >> 4) << 3)) * QKS + (((lane >> 3) & 1) << 4);
  float f[4][4];

  // pass 1: the row max
  float m0 = -1e30f, m1 = -1e30f;
  for (int kb = 0; kb < kend32; kb += KEY_CHUNK) {
    chunk<DHP>(f, qa, kp, QKS, kfac, kb, rf0, rf1, tig, kend);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m0 = fmaxf(m0, fmaxf(f[i][0], f[i][1]));
      m1 = fmaxf(m1, fmaxf(f[i][2], f[i][3]));
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  // pass 2: the sum of expf(s - max); a masked key adds expf(-1e30) = 0
  float l0 = 0.f, l1 = 0.f;
  for (int kb = 0; kb < kend32; kb += KEY_CHUNK) {
    chunk<DHP>(f, qa, kp, QKS, kfac, kb, rf0, rf1, tig, kend);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l0 = __fadd_rn(l0, expf(__fsub_rn(f[i][0], m0)));
      l0 = __fadd_rn(l0, expf(__fsub_rn(f[i][1], m0)));
      l1 = __fadd_rn(l1, expf(__fsub_rn(f[i][2], m1)));
      l1 = __fadd_rn(l1, expf(__fsub_rn(f[i][3], m1)));
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o));
  }

  // pass 3: w_q = rint((e / sum) * 127) packed into the A fragment, then PV
  int o[DHP / 8][4];
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0;
  // ldmatrix rows of Vt: lanes 0-7 dims 0-7 keys 0-15, 8-15 dims 0-7 keys
  // 16-31, 16-23 and 24-31 dims 8-15
  const int8_t* vp = Vt + ((lane & 7) + ((lane >> 4) << 3)) * VS + (((lane >> 3) & 1) << 4);
  const float c0 = __fdiv_rn(127.f, l0), c1 = __fdiv_rn(127.f, l1);
  for (int kb = 0; kb < kend32; kb += KEY_CHUNK) {
    chunk<DHP>(f, qa, kp, QKS, kfac, kb, rf0, rf1, tig, kend);
    uint32_t wq[4][4];
    unsigned near = 0;  // bit 4i+e: that code's estimate lies near a half
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool nh;
        wq[i][e] = weight_code_fast(__fsub_rn(f[i][e], e < 2 ? m0 : m1), e < 2 ? c0 : c1, nh);
        near |= (unsigned)nh << (4 * i + e);
      }
    if (__any_sync(0xffffffffu, near != 0)) {  // rare: one branch for the warp
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (near >> (4 * i + e) & 1)
            wq[i][e] = weight_code_exact(__fsub_rn(f[i][e], e < 2 ? m0 : m1), e < 2 ? l0 : l1);
    }
    uint32_t a[4];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {  // keys 4t.. (tiles 0, 1) and 16+4t.. (tiles 2, 3)
      const uint32_t(&x)[4] = wq[2 * hi];
      const uint32_t(&y)[4] = wq[2 * hi + 1];
      a[2 * hi] = x[0] | x[1] << 8 | y[0] << 16 | y[1] << 24;
      a[2 * hi + 1] = x[2] | x[3] << 8 | y[2] << 16 | y[3] << 24;
    }
#pragma unroll
    for (int dn = 0; dn < DHP / 16; ++dn) {
      uint32_t bv[4];
      ldsm_x4(bv, vp + 16 * dn * VS + kb);
      mma_s8(o[2 * dn], a, bv[0], bv[1]);
      mma_s8(o[2 * dn + 1], a, bv[2], bv[3]);
    }
  }

  // T(f32(o) * (v_amax / 16129)), rows g and g + 8, columns 8j + 2t, +1
  const int row0 = 16 * rg + g, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    if (8 * j >= dh) break;
    const int col = 8 * j + 2 * tig;
    const float y0 = __fmul_rn(__int2float_rn(o[j][0]), o_fac);
    const float y1 = __fmul_rn(__int2float_rn(o[j][1]), o_fac);
    const float y2 = __fmul_rn(__int2float_rn(o[j][2]), o_fac);
    const float y3 = __fmul_rn(__int2float_rn(o[j][3]), o_fac);
    if constexpr (sizeof(T) == 2) {
      if (row0 < L)
        *reinterpret_cast<__nv_bfloat162*>(out + row0 * osr + col) = __floats2bfloat162_rn(y0, y1);
      if (row1 < L)
        *reinterpret_cast<__nv_bfloat162*>(out + row1 * osr + col) = __floats2bfloat162_rn(y2, y3);
    } else {
      if (row0 < L) *reinterpret_cast<float2*>(out + row0 * osr + col) = make_float2(y0, y1);
      if (row1 < L) *reinterpret_cast<float2*>(out + row1 * osr + col) = make_float2(y2, y3);
    }
  }
}

// One block per (head, batch): the head's Q, K and V quantized into shared
// memory once, then each warp takes row groups warp, warp + nwarps, ...
template <typename T, int DHP>
__global__ void __launch_bounds__(AI_MAX_WARPS * 32)
attention_s8_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 long long sb, long long sh, long long sr, T* __restrict__ out, long long osb,
                 long long osh, long long osr, int L, int dh, int length, int group,
                 const float* __restrict__ vamax, float score_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(L, dh);
  float* kfac = reinterpret_cast<float*>(smem + lay.kfac);
  float* qfac = reinterpret_cast<float*>(smem + lay.qfac);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + lay.q);
  int8_t* Ks = reinterpret_cast<int8_t*>(smem + lay.k);
  int8_t* Vt = reinterpret_cast<int8_t*>(smem + lay.v);

  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y;
  const long long base = b * sb + h * sh;
  const int kend = min(L, length);
  const float v_amax = vamax[(b / group) * H + h];

  quant_rows_smem<DHP>(k + base, sr, round32(kend), kend, dh, Ks, lay.qk_stride, kfac,
                       1.f / 127.f, [](int j) { return k_row(j); });
  quant_v_transposed(v + base, sr, kend, dh, __fdiv_rn(127.f, v_amax), Vt, lay.v_stride);
  quant_rows_smem<DHP>(q + base, sr, lay.l16, L, dh, Qs, lay.qk_stride, qfac, score_c,
                       [](int j) { return j; });
  __syncthreads();

  const float o_fac = __fdiv_rn(v_amax, 16129.f);
  for (int rg = threadIdx.x >> 5; rg < lay.l16 / 16; rg += blockDim.x >> 5)
    attend_rows<T, DHP>(rg, Qs, qfac, Ks, kfac, Vt, lay.qk_stride, lay.v_stride, kend,
                        out + b * osb + h * osh, L, dh, osr, o_fac);
}

template <typename T, int DHP>
int launch_core(const T* q, const T* k, const T* v, const long long* st, T* out,
                const long long* ost, int B, int L, int H, int dh, int length, int group,
                const float* vamax, float score_c, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_s8_mma<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_s8_mma<T, DHP><<<dim3(H, B), 32 * ai_warps(L), smem, stream>>>(
      q, k, v, st[0], st[1], st[2], out, ost[0], ost[1], ost[2], L, dh, length, group, vamax,
      score_c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, const long long* st, void* outv,
           const long long* ost, int B, int L, int H, int dh, int length, int group,
           float* vamax, float score_c, cudaStream_t stream) {
  const T *q = static_cast<const T*>(qv), *k = static_cast<const T*>(kv),
          *v = static_cast<const T*>(vv);
  T* out = static_cast<T*>(outv);
  v_amax_kernel<T><<<dim3(H, B / group), AI_AMAX_THREADS, 0, stream>>>(v, st[0], st[1], st[2], L,
                                                                       dh, group, vamax);
  const cudaError_t err = cudaGetLastError();
#ifdef ATTENTION_INT8_AMAX_ONLY  // the v-amax pass alone: scripts/attention_int8_split.py
  return (int)err;
#endif
  if (err != cudaSuccess) return (int)err;
  switch (round32(dh)) {  // dh zero-padded to a 32-byte k-step
    case 32:
      return launch_core<T, 32>(q, k, v, st, out, ost, B, L, H, dh, length, group, vamax, score_c,
                                stream);
    case 64:
      return launch_core<T, 64>(q, k, v, st, out, ost, B, L, H, dh, length, group, vamax, score_c,
                                stream);
    case 96:
      return launch_core<T, 96>(q, k, v, st, out, ost, B, L, H, dh, length, group, vamax, score_c,
                                stream);
    default:
      return launch_core<T, 128>(q, k, v, st, out, ost, B, L, H, dh, length, group, vamax,
                                 score_c, stream);
  }
}

}  // namespace

// Strides as attention_packed: element d of head h, row r, batch b of q sits
// at q[b*sb + h*sh + r*sr + d]; the output has its own (osb, osh, osr).
// dh, the strides and the bases are whole 16-byte pieces (dh % 8 == 0).
// vamax: fp32 scratch of (B / group) * H values.  score_c: f32(dh^-0.5 / 127),
// the factor of q_amax in the score rescale.
extern "C" int attention_int8(int dtype, const void* q, const void* k, const void* v,
                              long long sb, long long sh, long long sr, void* out, long long osb,
                              long long osh, long long osr, int B, int L, int H, int dh,
                              int length, int group, void* vamax, float score_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || dh < 8 || dh > AI_MAX_DH || dh % 8 || length < 1 || group < 1 || B % group)
    return (int)cudaErrorInvalidValue;
  const long long st[3] = {sb, sh, sr}, ost[3] = {osb, osh, osr};
  float* va = static_cast<float*>(vamax);
  if (dtype == PCK_BF16)
    return launch<bf16>(q, k, v, st, out, ost, B, L, H, dh, length, group, va, score_c, s);
  if (dtype == PCK_F32)
    return launch<float>(q, k, v, st, out, ost, B, L, H, dh, length, group, va, score_c, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_int8_smem_bytes(int L, int dh) { return smem_bytes(L, dh); }

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
// Design (simple first): two launches.  v_amax_kernel reduces |v| per
// (group, head) into a scratch vector (max is order-free).  The attention
// kernel's grid is (query tiles of 64 rows, heads, batch) as in
// attention_packed: a block quantizes its head's K and V rows (only the
// rows that can be attended, col < length) into shared memory with int8 rows
// padded to an odd number of 4-byte words; each of 8 warps takes one query
// row at a time, quantizes it into a per-warp buffer, lane j scores keys j,
// j+32, ... with __dp4a over the dh/4 words, and each lane accumulates dh/32
// output columns in int32.  Tensor cores (mma.sync s8) are for a later change.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int AI_WARPS = 8;
constexpr int AI_QTILE = 64;
constexpr int AI_MAX_DH = 128;
constexpr int AI_AMAX_THREADS = 256;

__device__ __forceinline__ int8_t code127(float x, float r) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(x, r)), -127.f), 127.f));
}

// vamax[grp * H + h] = max(max |v| over batch grp*group .. +group, all L rows, dh, 1e-6)
template <typename T>
__global__ void __launch_bounds__(AI_AMAX_THREADS)
v_amax_kernel(const T* __restrict__ v, long long sb, long long sh, long long sr, int L, int dh,
              int group, float* __restrict__ vamax) {
  __shared__ float red[AI_AMAX_THREADS / 32];
  const int h = blockIdx.x, grp = blockIdx.y, H = gridDim.x;
  const long long n = (long long)group * L * dh;
  float m = 0.f;
  for (long long i = threadIdx.x; i < n; i += AI_AMAX_THREADS) {
    const int d = (int)(i % dh);
    const long long rest = i / dh;
    const int r = (int)(rest % L), bb = (int)(rest / L);
    m = fmaxf(m, fabsf(pck::to_f(v[((long long)grp * group + bb) * sb + h * sh + r * sr + d])));
  }
  m = pck::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < AI_AMAX_THREADS / 32; ++w) m = fmaxf(m, red[w]);
    vamax[grp * H + h] = fmaxf(fmaxf(m, red[0]), 1e-6f);
  }
}

size_t smem_bytes(int L, int dh) {
  const size_t row = dh + 4;  // bytes: dh/4 + 1 words, odd for dh % 8 == 0
  const size_t kv = (2 * (size_t)L * row + 15) & ~(size_t)15;
  const size_t lpad = ((size_t)L + 31) & ~(size_t)31;
  return kv + (size_t)L * sizeof(float) + (size_t)AI_WARPS * (dh + lpad * sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(AI_WARPS * 32)
attention_int8_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      long long sb, long long sh, long long sr, T* __restrict__ out,
                      long long osb, long long osh, long long osr, int L, int dh, int length,
                      int group, const float* __restrict__ vamax, float score_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_b = dh + 4;
  int8_t* Kq = reinterpret_cast<int8_t*>(smem);
  int8_t* Vq = Kq + (size_t)L * row_b;
  const size_t kv_bytes = (2 * (size_t)L * row_b + 15) & ~(size_t)15;
  float* kfac = reinterpret_cast<float*>(smem + kv_bytes);        // [L]
  const int lpad = (L + 31) & ~31;
  float* pbuf = kfac + L;                                          // [AI_WARPS][lpad]
  int8_t* qbuf = reinterpret_cast<int8_t*>(pbuf + AI_WARPS * lpad);  // [AI_WARPS][dh]

  const int H = gridDim.y;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long base = b * sb + h * sh;
  const long long obase = b * osb + h * osh;
  const int kend = min(L, length);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nd = (dh + 31) / 32;  // values per lane in a row
  const float v_amax = vamax[(b / group) * H + h];
  const float v_r = __fdiv_rn(127.f, v_amax);
  const float o_fac = __fdiv_rn(v_amax, 16129.f);

  // K rows: per-row codes and rescale factor k_amax * f32(1/127); V rows:
  // codes at the group's scale
  for (int j = warp; j < kend; j += AI_WARPS) {
    const T* kr = k + base + j * sr;
    const T* vr = v + base + j * sr;
    float kx[AI_MAX_DH / 32];
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      kx[t] = (t < nd && d < dh) ? pck::to_f(kr[d]) : 0.f;
      m = fmaxf(m, fabsf(kx[t]));
    }
    const float k_amax = fmaxf(pck::warp_max(m), 1e-6f);
    const float k_r = __fdiv_rn(127.f, k_amax);
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (t < nd && d < dh) {
        Kq[j * row_b + d] = code127(kx[t], k_r);
        Vq[j * row_b + d] = code127(pck::to_f(vr[d]), v_r);
      }
    }
    if (lane == 0) kfac[j] = __fmul_rn(k_amax, 1.f / 127.f);
  }
  __syncthreads();

  float* pw = pbuf + warp * lpad;
  int* pwi = reinterpret_cast<int*>(pw);
  int8_t* qw = qbuf + warp * dh;
  const int r_end = min(L, (int)(blockIdx.x + 1) * AI_QTILE);
  const int words = dh / 4;

  for (int r = blockIdx.x * AI_QTILE + warp; r < r_end; r += AI_WARPS) {
    const T* qr = q + base + r * sr;
    float qx[AI_MAX_DH / 32];
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      qx[t] = (t < nd && d < dh) ? pck::to_f(qr[d]) : 0.f;
      m = fmaxf(m, fabsf(qx[t]));
    }
    const float q_amax = fmaxf(pck::warp_max(m), 1e-6f);
    const float q_r = __fdiv_rn(127.f, q_amax);
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (t < nd && d < dh) qw[d] = code127(qx[t], q_r);
    }
    const float row_fac = __fmul_rn(q_amax, score_c);
    __syncwarp();

    const int* qword = reinterpret_cast<const int*>(qw);
    float mx = -1e30f;
    for (int j = lane; j < kend; j += 32) {
      const int* kword = reinterpret_cast<const int*>(Kq + j * row_b);
      int acc = 0;
      for (int i = 0; i < words; ++i) acc = __dp4a(qword[i], kword[i], acc);
      const float s = __fmul_rn(__fmul_rn(__int2float_rn(acc), row_fac), kfac[j]);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = pck::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kend; j += 32) {
      const float e = expf(__fsub_rn(pw[j], mx));
      pw[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = pck::warp_sum(sum);
    for (int j = lane; j < kend; j += 32)
      pwi[j] = (int)rintf(__fmul_rn(__fdiv_rn(pw[j], sum), 127.f));
    __syncwarp();

    int acc[AI_MAX_DH / 32];
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) acc[t] = 0;
    for (int j = 0; j < kend; ++j) {
      const int w = pwi[j];
      const int8_t* vrow = Vq + j * row_b;
#pragma unroll
      for (int t = 0; t < AI_MAX_DH / 32; ++t) {
        const int d = lane + 32 * t;
        if (t < nd && d < dh) acc[t] += w * (int)vrow[d];
      }
    }
    T* orow = out + obase + r * osr;
#pragma unroll
    for (int t = 0; t < AI_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (t < nd && d < dh) orow[d] = pck::from_f<T>(__fmul_rn(__int2float_rn(acc[t]), o_fac));
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const long long* st, void* out,
           const long long* ost, int B, int L, int H, int dh, int length, int group,
           float* vamax, float score_c, cudaStream_t stream) {
  v_amax_kernel<T><<<dim3(H, B / group), AI_AMAX_THREADS, 0, stream>>>(
      static_cast<const T*>(v), st[0], st[1], st[2], L, dh, group, vamax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(L, dh);
  err = cudaFuncSetAttribute(attention_int8_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + AI_QTILE - 1) / AI_QTILE, H, B);
  attention_int8_kernel<T><<<grid, AI_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st[0], st[1],
      st[2], static_cast<T*>(out), ost[0], ost[1], ost[2], L, dh, length, group, vamax, score_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides as attention_packed: element d of head h, row r, batch b of q sits
// at q[b*sb + h*sh + r*sr + d]; the output has its own (osb, osh, osr).
// vamax: fp32 scratch of (B / group) * H values.  score_c: f32(dh^-0.5 / 127),
// the factor of q_amax in the score rescale.
extern "C" int attention_int8(int dtype, const void* q, const void* k, const void* v,
                              long long sb, long long sh, long long sr, void* out, long long osb,
                              long long osh, long long osr, int B, int L, int H, int dh,
                              int length, int group, void* vamax, float score_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > AI_MAX_DH || dh % 4 || length < 1 || group < 1 || B % group)
    return (int)cudaErrorInvalidValue;
  const long long st[3] = {sb, sh, sr}, ost[3] = {osb, osh, osr};
  float* va = static_cast<float*>(vamax);
  if (dtype == PCK_BF16)
    return launch<__nv_bfloat16>(q, k, v, st, out, ost, B, L, H, dh, length, group, va, score_c,
                                 s);
  if (dtype == PCK_F32)
    return launch<float>(q, k, v, st, out, ost, B, L, H, dh, length, group, va, score_c, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_int8_smem_bytes(int L, int dh) { return smem_bytes(L, dh); }

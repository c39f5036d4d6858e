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
// Design (simple first): grid (query tiles of 64 rows, heads, batch).  A
// block loads its head's K and V rows (only the rows that can be attended:
// col < length) into dynamic shared memory with odd-word row strides, so
// the lanes of a warp, each on its own key row, hit distinct banks.  Each
// of the 8 warps takes one query row at a time: lane j scores keys j,
// j+32, ..., the row max and sum are warp shuffles, the normalised weights
// go to a per-warp fp32 buffer, and each lane accumulates dh/32 output
// columns over the keys.  Keys past the causal diagonal are skipped: their
// weight is exactly 0 in the TPU kernel too.  Online softmax and tensor
// cores are for a later change.  q, k, v share one (batch, head, row)
// stride triple and the output has its own, so one kernel serves K1's three
// packed (B, L, D) tensors (strides L*D, dh, D), the column slices of K2's
// and K3's fused (B, L, 3D) QKV buffer (L*3D, dh, 3D) and K4's head-major
// (B, H, L, dh) tensors (H*L*dh, L*dh, dh).  K4 is not padded: the TPU
// wrapper pads L to 8 for the sublanes only, and this kernel masks by
// length.
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
#include "common.cuh"

namespace {

constexpr int ATT_WARPS = 8;    // warps per block, one query row each at a time
constexpr int ATT_QTILE = 64;   // query rows per block
constexpr int ATT_MAX_DH = 128;
enum { ATT_SOFTMAX = 0, ATT_Q_ROUND = 1, ATT_NO_SOFTMAX = 2 };

// Row padding (elements) that makes a K/V row an odd number of 4-byte words.
template <typename T>
__host__ __device__ constexpr int kv_pad();
template <>
__host__ __device__ constexpr int kv_pad<float>() { return 1; }
template <>
__host__ __device__ constexpr int kv_pad<__nv_bfloat16>() { return 2; }

template <typename T>
size_t smem_bytes(int L, int dh) {
  const size_t kv = (2 * (size_t)L * (dh + kv_pad<T>()) * sizeof(T) + 15) & ~(size_t)15;
  const size_t lpad = ((size_t)L + 31) & ~(size_t)31;
  return kv + (size_t)ATT_WARPS * (dh + lpad) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long sb, long long sh, long long sr,
                        T* __restrict__ out, long long osb, long long osh, long long osr,
                        int L, int dh, int length, int causal, int mode, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = dh + kv_pad<T>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)L * ks;
  const size_t kv_bytes = (2 * (size_t)L * ks * sizeof(T) + 15) & ~(size_t)15;
  const int lpad = (L + 31) & ~31;
  float* qbuf = reinterpret_cast<float*>(smem + kv_bytes);  // [ATT_WARPS][dh]
  float* pbuf = qbuf + ATT_WARPS * dh;                       // [ATT_WARPS][lpad]

  const long long base = blockIdx.z * sb + blockIdx.y * sh;  // this (batch, head)
  const long long obase = blockIdx.z * osb + blockIdx.y * osh;
  const bool no_softmax = mode == ATT_NO_SOFTMAX;
  const int kend = no_softmax ? L : min(L, length);
  // ATT_Q_ROUND / ATT_NO_SOFTMAX: the scale rounded to T, the product too
  const float scale_t = pck::round_to<T>(scale);

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
    const T* qrow = q + base + r * sr;
    for (int d = lane; d < dh; d += 32)
      qw[d] = mode == ATT_SOFTMAX ? pck::to_f(qrow[d]) * scale
                                  : pck::round_to<T>(__fmul_rn(pck::to_f(qrow[d]), scale_t));
    __syncwarp();

    const int jend = (causal && !no_softmax) ? min(kend, r + 1) : kend;
    float mx = -1e30f;
    for (int j = lane; j < jend; j += 32) {
      const T* kr = Ks + j * ks;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qw[d], pck::to_f(kr[d]), s);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    if (no_softmax) {
      for (int j = lane; j < jend; j += 32) pw[j] = pck::round_to<T>(__fmul_rn(pw[j], 0.005f));
    } else {
      mx = pck::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < jend; j += 32) {
        const float e = expf(pw[j] - mx);
        pw[j] = e;
        sum += e;
      }
      sum = pck::warp_sum(sum);
      for (int j = lane; j < jend; j += 32) pw[j] = pck::round_to<T>(pw[j] / sum);
    }
    __syncwarp();

    float acc[ATT_MAX_DH / 32];
#pragma unroll
    for (int t = 0; t < ATT_MAX_DH / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < jend; ++j) {
      const float p = pw[j];
      const T* vr = Vs + j * ks;
#pragma unroll
      for (int t = 0; t < ATT_MAX_DH / 32; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) acc[t] = fmaf(p, pck::to_f(vr[d]), acc[t]);
      }
    }
    T* orow = out + obase + r * osr;
#pragma unroll
    for (int t = 0; t < ATT_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < dh) orow[d] = pck::from_f<T>(acc[t]);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const long long* st, void* out,
           const long long* ost, int B, int L, int H, int dh, int length, int causal,
           int mode, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_packed_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + ATT_QTILE - 1) / ATT_QTILE, H, B);
  attention_packed_kernel<T><<<grid, ATT_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st[0], st[1],
      st[2], static_cast<T*>(out), ost[0], ost[1], ost[2], L, dh, length, causal, mode, scale);
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
  if (dh > ATT_MAX_DH || length < 1 || mode < ATT_SOFTMAX || mode > ATT_NO_SOFTMAX)
    return (int)cudaErrorInvalidValue;
  const long long st[3] = {sb, sh, sr}, ost[3] = {osb, osh, osr};
  if (dtype == PCK_BF16)
    return launch<__nv_bfloat16>(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale,
                                 s);
  if (dtype == PCK_F32)
    return launch<float>(q, k, v, st, out, ost, B, L, H, dh, length, causal, mode, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_packed_smem_bytes(int dtype, int L, int dh) {
  return dtype == PCK_BF16 ? smem_bytes<__nv_bfloat16>(L, dh) : smem_bytes<float>(L, dh);
}

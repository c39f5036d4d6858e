// attention_packed: multi-head attention over packed (B, L, D) q, k, v.
//
// Replaces: protoclip_tpu/ops/pallas_kernels.py::_attention_kernel_packed
// (:145, K1) and the per-head attention loop of ::_block_kernel (:283-309,
// K2).  Numerics as there: fp32 scores of (q * dh^-0.5) . k^T, keys with
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
// cores are for a later change.  q, k, v are read through (pointer, row
// stride), so the same kernel serves K1's three tensors and the column
// slices of K2's fused (B, L, 3D) QKV buffer.
#include "common.cuh"

namespace {

constexpr int ATT_WARPS = 8;    // warps per block, one query row each at a time
constexpr int ATT_QTILE = 64;   // query rows per block
constexpr int ATT_MAX_DH = 128;

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
                        const T* __restrict__ v, int ld, T* __restrict__ out, int ldo,
                        int L, int dh, int length, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = dh + kv_pad<T>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)L * ks;
  const size_t kv_bytes = (2 * (size_t)L * ks * sizeof(T) + 15) & ~(size_t)15;
  const int lpad = (L + 31) & ~31;
  float* qbuf = reinterpret_cast<float*>(smem + kv_bytes);  // [ATT_WARPS][dh]
  float* pbuf = qbuf + ATT_WARPS * dh;                       // [ATT_WARPS][lpad]

  const int h = blockIdx.y;
  const long base = (long)blockIdx.z * L;  // first row of this batch item
  const int col0 = h * dh;
  const int kend = min(L, length);

  for (int idx = threadIdx.x; idx < kend * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    const long g = (base + j) * ld + col0 + d;
    Ks[j * ks + d] = k[g];
    Vs[j * ks + d] = v[g];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qbuf + warp * dh;
  float* pw = pbuf + warp * lpad;
  const int r_end = min(L, (int)(blockIdx.x + 1) * ATT_QTILE);

  for (int r = blockIdx.x * ATT_QTILE + warp; r < r_end; r += ATT_WARPS) {
    const T* qrow = q + (base + r) * ld + col0;
    for (int d = lane; d < dh; d += 32) qw[d] = pck::to_f(qrow[d]) * scale;
    __syncwarp();

    const int jend = causal ? min(kend, r + 1) : kend;
    float mx = -1e30f;
    for (int j = lane; j < jend; j += 32) {
      const T* kr = Ks + j * ks;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qw[d], pck::to_f(kr[d]), s);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = pck::warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < jend; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = pck::warp_sum(sum);
    for (int j = lane; j < jend; j += 32) pw[j] = pck::round_to<T>(pw[j] / sum);
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
    T* orow = out + (base + r) * ldo + col0;
#pragma unroll
    for (int t = 0; t < ATT_MAX_DH / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < dh) orow[d] = pck::from_f<T>(acc[t]);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int ld, void* out, int ldo, int B,
           int L, int H, int dh, int length, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(L, dh);
  cudaError_t err = cudaFuncSetAttribute(attention_packed_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + ATT_QTILE - 1) / ATT_QTILE, H, B);
  attention_packed_kernel<T><<<grid, ATT_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ld,
      static_cast<T*>(out), ldo, L, dh, length, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_packed(int dtype, const void* q, const void* k, const void* v, int ld,
                                void* out, int ldo, int B, int L, int H, int dh, int length,
                                int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > ATT_MAX_DH || length < 1) return (int)cudaErrorInvalidValue;
  if (dtype == PCK_BF16)
    return launch<__nv_bfloat16>(q, k, v, ld, out, ldo, B, L, H, dh, length, causal, scale, s);
  if (dtype == PCK_F32)
    return launch<float>(q, k, v, ld, out, ldo, B, L, H, dh, length, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t attention_packed_smem_bytes(int dtype, int L, int dh) {
  return dtype == PCK_BF16 ? smem_bytes<__nv_bfloat16>(L, dh) : smem_bytes<float>(L, dh);
}

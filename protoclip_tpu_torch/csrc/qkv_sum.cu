// qkv_sum: out = T(T(q + k) + v) over the three column slices of a fused
// (rows, 3D) QKV buffer.
//
// Replaces: the attention stand-in of scripts/bench_block_variants.py, which
// sums q + k + v in place of attention so that no projection is dropped:
// micro:attn_noqkv (:645), micro:int8qkv (:583) and int8noattn (:828).  Two
// adds in the activation dtype T, left to right, each rounded, as JAX
// evaluates `qkv[:, :, :d] + qkv[:, :, d:2d] + qkv[:, :, 2d:]` on bf16
// slices; bit-exact against the plain PyTorch version.
//
// Bound on the H100: bytes (3 values read and 1 written per output, 2 adds).
//
// Design: one thread per output element, rows on gridDim.x (over 10^5 at
// the bench's batch), columns on gridDim.y in blocks of 256 threads;
// neighbouring threads read neighbouring columns of each slice.
#include "common.cuh"

namespace {

constexpr int QS_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QS_THREADS)
qkv_sum_kernel(const T* __restrict__ qkv, T* __restrict__ out, int D) {
  const int d = blockIdx.y * QS_THREADS + threadIdx.x;
  if (d >= D) return;
  const long row = blockIdx.x;
  const T* r = qkv + row * 3 * D;
  const float qk = pck::round_to<T>(__fadd_rn(pck::to_f(r[d]), pck::to_f(r[D + d])));
  out[row * D + d] = pck::from_f<T>(__fadd_rn(qk, pck::to_f(r[2 * D + d])));
}

}  // namespace

extern "C" int qkv_sum(int dtype, const void* qkv, void* out, int rows, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const dim3 grid(rows, (D + QS_THREADS - 1) / QS_THREADS);
  if (dtype == PCK_BF16)
    qkv_sum_kernel<__nv_bfloat16><<<grid, QS_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), D);
  else if (dtype == PCK_F32)
    qkv_sum_kernel<float><<<grid, QS_THREADS, 0, s>>>(static_cast<const float*>(qkv),
                                                      static_cast<float*>(out), D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

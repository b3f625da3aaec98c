// B11: the low-rank transport's error-feedback residual of one (M, n)
// leaf, given the reconstruction the receiver sees:
//   new_err = m*(pending - payload) + (1 - m)*err
//
// Replaces the TPU kernel src/repro/kernels/lowrank_ef.py:residual_ef_batched.
//
// Bound: bytes. It reads pending, payload and err (3*M*n elements) and
// writes new_err (M*n); an f32 leaf at M=4, n=163,597,056 moves 10.47 GB
// and needs at least 3.13 ms at an H100 SXM's 3.35 TB/s. Its 5 flops an
// element are far below the f32 rate.
//
// Design: one read of each input and one write, in one grid-stride pass;
// each thread owns a column and walks the workers, so every row access is
// coalesced across the warp. The blend is the arithmetic form of
// opt/transport.py:_ef_blend, each operation a correctly rounded
// intrinsic, so the result equals the plain version bit for bit. The
// PowerSGD factor products stay in plain PyTorch matmuls, as the JAX
// package leaves them to XLA.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_ef_kernel(const T* __restrict__ p, const T* __restrict__ q, const T* __restrict__ e,
                   const float* __restrict__ mask, T* __restrict__ new_e, int64_t m, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T mk = (T)mask[w];
      new_e[o] = add(mul(mk, sub(p[o], q[o])), mul(sub(T(1), mk), e[o]));
    }
  }
}

template <typename T>
static int launch_residual_ef(const void* p, const void* q, const void* e, const void* mask,
                              void* new_e, int64_t m, int64_t n, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  residual_ef_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)e, (const float*)mask, (T*)new_e, m, n);
  return (int)cudaGetLastError();
}

extern "C" {

int residual_ef_batched_f32(int device, const void* p, const void* q, const void* e,
                            const void* mask, void* new_e, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef<float>(p, q, e, mask, new_e, m, n, stream);
}

int residual_ef_batched_f64(int device, const void* p, const void* q, const void* e,
                            const void* mask, void* new_e, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef<double>(p, q, e, mask, new_e, m, n, stream);
}

}  // extern "C"

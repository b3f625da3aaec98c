// B10: the top-k transport's select/pack and error-feedback sweep of one
// (M, n) leaf, given the 0/1 keep masks:
//   payload  = keep != 0 ? pending : +0.0
//   new_err  = m*(pending - payload) + (1 - m)*err
//
// Replaces the TPU kernel src/repro/kernels/topk_pack.py:select_pack_ef_batched.
//
// Bound: bytes. It reads pending, err and keep (3*M*n elements) and writes
// payload and new_err (2*M*n); an f32 leaf at M=4, n=163,597,056 moves
// 13.09 GB and needs at least 3.91 ms at an H100 SXM's 3.35 TB/s. Its 5
// flops an element are far below the f32 rate.
//
// Design: one read of each input and one write of each output, in one
// grid-stride pass; each thread owns a column and walks the workers, so
// every row access is coalesced across the warp. The payload is a select,
// not a multiply by the keep mask, so a kept -0.0 stays -0.0 and a dropped
// entry is +0.0, bit for bit as in kernels/ref.py. Every payload entry is
// pending or +0.0, so payload + new_err == pending exactly after a
// transmit. The EF blend is the arithmetic form of the int8 kernel (B6),
// each operation a correctly rounded intrinsic. The keep masks themselves
// are an exact selection in plain PyTorch (opt/transport.py), as the JAX
// package computes them outside Pallas.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_pack_ef_kernel(const T* __restrict__ p, const T* __restrict__ e,
                      const T* __restrict__ keep, const float* __restrict__ mask,
                      T* __restrict__ payload, T* __restrict__ new_e, int64_t m, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T pv = p[o];
      const T q = keep[o] != T(0) ? pv : T(0);
      payload[o] = q;
      const T mk = (T)mask[w];
      new_e[o] = add(mul(mk, sub(pv, q)), mul(sub(T(1), mk), e[o]));
    }
  }
}

template <typename T>
static int launch_select_pack_ef(const void* p, const void* e, const void* keep,
                                 const void* mask, void* payload, void* new_e, int64_t m,
                                 int64_t n, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  select_pack_ef_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)e, (const T*)keep, (const float*)mask, (T*)payload, (T*)new_e,
      m, n);
  return (int)cudaGetLastError();
}

extern "C" {

int select_pack_ef_batched_f32(int device, const void* p, const void* e, const void* keep,
                               const void* mask, void* payload, void* new_e, int64_t m,
                               int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_select_pack_ef<float>(p, e, keep, mask, payload, new_e, m, n, stream);
}

int select_pack_ef_batched_f64(int device, const void* p, const void* e, const void* keep,
                               const void* mask, void* payload, void* new_e, int64_t m,
                               int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_select_pack_ef<double>(p, e, keep, mask, payload, new_e, m, n, stream);
}

}  // extern "C"

// B3: the eq.-(4) heavy-ball update of one parameter leaf,
//   theta' = (theta - alpha*nabla) + beta*(theta - theta_prev).
//
// Replaces the TPU kernel src/repro/kernels/hb_update.py:hb_update.
//
// Bound: bytes. It reads 3n elements and writes n; an f32 leaf of
// n=163,597,056 (2.62 GB) needs at least 0.78 ms at an H100 SXM's
// 3.35 TB/s. Its 5 flops an element are far below the f32 rate.
//
// Design: the TPU kernel tiles (rows, 128) lane blocks and reads alpha and
// beta from SMEM. Here the leaf stays flat: one grid-stride pass, one
// element per thread per turn, loads and stores coalesced across the warp.
// alpha and beta are runtime arguments, never template parameters, so one
// build serves a whole hyperparameter grid. Each operation is a correctly
// rounded intrinsic in the parameter dtype (f32 and f64 are their own
// compute dtype), in the order of kernels/ref.py:hb_update and
// opt/server.py:HeavyBall.apply, so the result equals both bit for bit.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
hb_update_kernel(const T* __restrict__ theta, const T* __restrict__ nabla,
                 const T* __restrict__ prev, T* __restrict__ out, int64_t n, T alpha, T beta) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    const T t = theta[j];
    out[j] = add(sub(t, mul(alpha, nabla[j])), mul(beta, sub(t, prev[j])));
  }
}

template <typename T>
static int launch_hb_update(const void* theta, const void* nabla, const void* prev, void* out,
                            int64_t n, double alpha, double beta, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hb_update_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)nabla, (const T*)prev, (T*)out, n, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

extern "C" {

int hb_update_f32(int device, const void* theta, const void* nabla, const void* prev, void* out,
                  int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_hb_update<float>(theta, nabla, prev, out, n, alpha, beta, stream);
}

int hb_update_f64(int device, const void* theta, const void* nabla, const void* prev, void* out,
                  int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_hb_update<double>(theta, nabla, prev, out, n, alpha, beta, stream);
}

}  // extern "C"

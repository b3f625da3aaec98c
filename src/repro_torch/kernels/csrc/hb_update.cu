// B3: the eq.-(4) heavy-ball update of one parameter leaf,
//   theta' = (theta - alpha*nabla) + beta*(theta - theta_prev).
//
// Replaces the TPU kernel src/repro/kernels/hb_update.py:hb_update.
//
// Bound: bytes. It reads 3n elements and writes n; an f32 leaf of
// n=163,597,056 (2.62 GB) needs at least 0.78 ms at an H100 SXM's
// 3.35 TB/s. Its 5 flops an element are far below the f32 rate. A bf16
// leaf (8 bytes an element) 1.31 GB, >= 0.39 ms; an f32 leaf with a bf16
// worker sum (14 bytes) 2.29 GB, >= 0.68 ms.
//
// Design: the TPU kernel tiles (rows, 128) lane blocks and reads alpha and
// beta from SMEM. Here the leaf stays flat: one grid-stride pass, one
// element per thread per turn, loads and stores coalesced across the warp.
// alpha and beta are runtime arguments, never template parameters, so one
// build serves a whole hyperparameter grid. Each operation is a correctly
// rounded intrinsic in the compute dtype calc_t<P> (f32 and f64 are their
// own; bf16 params compute in f32), in the order of kernels/ref.py:hb_update,
// and the result is cast once to the params' dtype P: it equals
// ref.hb_update bit for bit, and opt/server.py:HeavyBall.apply (which
// rounds each operation to P) where P is f32 or f64. The
// worker sum nabla has the bank dtype H, which may be bf16 under f32 params
// (_f32_bf16: a bf16 bank of f32 params), cast exactly to calc_t<P>, as
// the JAX kernel's astype(acc) (hb_update.py:31-38).
#include "reduce.cuh"

using namespace repro;

template <typename P, typename H>
__global__ void __launch_bounds__(kThreads)
hb_update_kernel(const P* __restrict__ theta, const H* __restrict__ nabla,
                 const P* __restrict__ prev, P* __restrict__ out, int64_t n, calc_t<P> alpha,
                 calc_t<P> beta) {
  using C = calc_t<P>;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    const C t = Cast<C>::of(theta[j]);
    out[j] = Cast<P>::of(add(sub(t, mul(alpha, Cast<C>::of(nabla[j]))),
                             mul(beta, sub(t, Cast<C>::of(prev[j])))));
  }
}

// P the params' dtype (theta, theta_prev, out), H the worker sum's
template <typename P, typename H = P>
static int launch_hb_update(const void* theta, const void* nabla, const void* prev, void* out,
                            int64_t n, double alpha, double beta, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hb_update_kernel<P, H><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const P*)theta, (const H*)nabla, (const P*)prev, (P*)out, n, (calc_t<P>)alpha,
      (calc_t<P>)beta);
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

// bf16 params with a bf16 worker sum, and f32 params with one (_f32_bf16)
int hb_update_bf16(int device, const void* theta, const void* nabla, const void* prev, void* out,
                   int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_hb_update<bf16, bf16>(theta, nabla, prev, out, n, alpha, beta, stream);
}

int hb_update_f32_bf16(int device, const void* theta, const void* nabla, const void* prev,
                       void* out, int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_hb_update<float, bf16>(theta, nabla, prev, out, n, alpha, beta, stream);
}

}  // extern "C"

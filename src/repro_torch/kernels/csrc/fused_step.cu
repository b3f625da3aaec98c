// The fused CHB step on Hopper: everything after the censor decision in
// one pass over the (M, n) bank, plus the int8 statistics pass before it.
//
//   B2 fused_dense_step   replaces src/repro/kernels/fused_step.py:fused_dense_step
//   B5 int8_stats_batched replaces src/repro/kernels/fused_step.py:int8_stats_batched
//   B6 fused_int8_step    replaces src/repro/kernels/fused_step.py:fused_int8_step
//
// Bound: bytes, for all three (a handful of flops an element). At M=4,
// n=163,597,056 in f32 on an H100 SXM (3.35 TB/s):
//   B2 reads (2M+2)*n and writes (M+2)*n elements: 10.47 GB, >= 3.13 ms;
//   B5 reads 3*M*n elements and writes 2*M scalars:  7.85 GB, >= 2.34 ms;
//   B6 reads (3M+2)*n and writes (2M+2)*n elements: 15.71 GB, >= 4.69 ms.
//
// Design: the TPU kernels tile (rows, 128) lane blocks and keep the whole
// worker axis in one VMEM block. Here the arrays stay flat: in B2 and B6
// each thread owns one column j and walks the M workers in index order, so
// every load and store of a worker row is coalesced across the warp, the
// worker sum is a left fold from ghat'_0 (the fold of core.util's
// tree_sum_leading), and the eq.-(4) epilogue runs on the register-held
// sum. The int8 pending delta (g - ghat) + e and its dequantized payload
// live only in registers. alpha and beta are runtime arguments, so one
// build serves any hyperparameters. B5 is a two-pass reduction shaped like
// B1 (censor.cu): fixed order, no atomics, the M=1 call bitwise equal to a
// batched slice, any M (its blocks walk the workers with a stride of
// gridDim.y, reduce.cuh). Offsets are 64-bit: M*n passes 2^31 one model
// size up.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dense_step_kernel(const T* __restrict__ g, const T* __restrict__ h,
                        const T* __restrict__ theta, const T* __restrict__ prev,
                        const float* __restrict__ mask, T* __restrict__ new_h,
                        T* __restrict__ agg_out, T* __restrict__ theta_out,
                        int64_t m, int64_t n, T alpha, T beta) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    T agg = T(0);
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T hv = h[o];
      // bank advance in the arithmetic mask form ghat + mk * (g - ghat)
      const T ng = add(hv, mul((T)mask[w], sub(g[o], hv)));
      new_h[o] = ng;
      agg = w == 0 ? ng : add(agg, ng);
    }
    agg_out[j] = agg;
    const T t = theta[j];
    theta_out[j] = add(sub(t, mul(alpha, agg)), mul(beta, sub(t, prev[j])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_stats_partials(const T* __restrict__ g, const T* __restrict__ h,
                    const T* __restrict__ e, float* __restrict__ sq_part,
                    T* __restrict__ am_part, int64_t m, int64_t n, int64_t nchunks) {
  __shared__ float sq_scratch[kThreads / 32];
  __shared__ T am_scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kChunk + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's two block_reduces are done with their scratch
    if (w != blockIdx.y) __syncthreads();
    const int64_t off = w * n;
    float acc = 0.0f;
    T am = T(0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      if (j < n) {
        const T p = add(sub(g[off + j], h[off + j]), e[off + j]);
        const float x = (float)p;
        acc = add(acc, mul(x, x));
        am = maxval(am, absval(p));
      }
    }
    acc = block_reduce(acc, 0.0f, SumOp(), sq_scratch);
    am = block_reduce(am, T(0), MaxOp(), am_scratch);
    if (threadIdx.x == 0) {
      sq_part[w * nchunks + c] = acc;
      am_part[w * nchunks + c] = am;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_int8_step_kernel(const T* __restrict__ g, const T* __restrict__ h,
                       const T* __restrict__ e, const T* __restrict__ theta,
                       const T* __restrict__ prev, const float* __restrict__ mask,
                       const float* __restrict__ scale, T* __restrict__ new_h,
                       T* __restrict__ new_e, T* __restrict__ agg_out,
                       T* __restrict__ theta_out, int64_t m, int64_t n, T alpha, T beta) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    T agg = T(0);
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T hv = h[o];
      const T ev = e[o];
      const T pending = add(sub(g[o], hv), ev);
      // int8 round trip in f32: rintf rounds half to even, like torch.round
      const float sc = scale[w];
      const float q = clampval(rintf(__fdiv_rn((float)pending, sc)), -127.0f, 127.0f);
      const T payload = (T)__fmul_rn(q, sc);
      const T mk = (T)mask[w];
      new_e[o] = add(mul(mk, sub(pending, payload)), mul(sub(T(1), mk), ev));
      const T ng = add(hv, mul(mk, payload));
      new_h[o] = ng;
      agg = w == 0 ? ng : add(agg, ng);
    }
    agg_out[j] = agg;
    const T t = theta[j];
    theta_out[j] = add(sub(t, mul(alpha, agg)), mul(beta, sub(t, prev[j])));
  }
}

template <typename T>
static int launch_fused_dense(const void* g, const void* h, const void* theta,
                              const void* prev, const void* mask, void* new_h,
                              void* agg, void* theta_out, int64_t m, int64_t n,
                              double alpha, double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  fused_dense_step_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)h, (const T*)theta, (const T*)prev, (const float*)mask,
      (T*)new_h, (T*)agg, (T*)theta_out, m, n, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_int8_stats(const void* g, const void* h, const void* e, void* sq_part,
                             void* am_part, void* sq, void* am, int64_t m, int64_t n,
                             int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int8_stats_partials<T><<<dim3((unsigned)nchunks, worker_blocks(m)), kThreads, 0, s>>>(
      (const T*)g, (const T*)h, (const T*)e, (float*)sq_part, (T*)am_part, m, n, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_partials<float, SumOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const float*)sq_part, (float*)sq, nchunks, 0.0f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_partials<T, MaxOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const T*)am_part, (T*)am, nchunks, T(0));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_fused_int8(const void* g, const void* h, const void* e, const void* theta,
                             const void* prev, const void* mask, const void* scale,
                             void* new_h, void* new_e, void* agg, void* theta_out,
                             int64_t m, int64_t n, double alpha, double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  fused_int8_step_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)h, (const T*)e, (const T*)theta, (const T*)prev,
      (const float*)mask, (const float*)scale, (T*)new_h, (T*)new_e, (T*)agg,
      (T*)theta_out, m, n, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_dense_step_f32(int device, const void* g, const void* h, const void* theta, const void* prev,
                         const void* mask, void* new_h, void* agg, void* theta_out,
                         int64_t m, int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense<float>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                   alpha, beta, stream);
}

int fused_dense_step_f64(int device, const void* g, const void* h, const void* theta, const void* prev,
                         const void* mask, void* new_h, void* agg, void* theta_out,
                         int64_t m, int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense<double>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                    alpha, beta, stream);
}

int int8_stats_batched_f32(int device, const void* g, const void* h, const void* e, void* sq_part,
                           void* am_part, void* sq, void* am, int64_t m, int64_t n,
                           int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_int8_stats<float>(g, h, e, sq_part, am_part, sq, am, m, n, nchunks, stream);
}

int int8_stats_batched_f64(int device, const void* g, const void* h, const void* e, void* sq_part,
                           void* am_part, void* sq, void* am, int64_t m, int64_t n,
                           int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_int8_stats<double>(g, h, e, sq_part, am_part, sq, am, m, n, nchunks, stream);
}

int fused_int8_step_f32(int device, const void* g, const void* h, const void* e, const void* theta,
                        const void* prev, const void* mask, const void* scale, void* new_h,
                        void* new_e, void* agg, void* theta_out, int64_t m, int64_t n,
                        double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8<float>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                  theta_out, m, n, alpha, beta, stream);
}

int fused_int8_step_f64(int device, const void* g, const void* h, const void* e, const void* theta,
                        const void* prev, const void* mask, const void* scale, void* new_h,
                        void* new_e, void* agg, void* theta_out, int64_t m, int64_t n,
                        double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8<double>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                   theta_out, m, n, alpha, beta, stream);
}

}  // extern "C"

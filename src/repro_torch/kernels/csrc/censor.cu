// B1: per-worker eq.-(8) norms sum_j (g[m,j] - ghat[m,j])^2 of one (M, n)
// bank leaf. The subtraction runs in the bank dtype, the square-sum in f32.
//
// Replaces the TPU kernel src/repro/kernels/censor.py:censor_delta_sqnorm_batched.
//
// Bound: bytes. It reads 2*M*n elements once and writes M floats; an f32
// leaf at M=4, n=163,597,056 (5.23 GB) needs at least 1.56 ms at an H100
// SXM's 3.35 TB/s. The 3 flops an element are far below the f32 rate.
//
// Design: pass 1 gives each (chunk, worker) block kChunk contiguous
// elements with coalesced loads (neighbouring threads on neighbouring
// addresses, kItems independent loads in flight per thread) and writes one
// f32 partial in a fixed tree order; pass 2 (finish_partials) folds each
// worker's partials in a fixed order. No atomics: the same input gives the
// same bits on every launch, and since a worker's chunks depend only on n,
// the M=1 call on one worker equals that worker's slice of a batched call.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_sqnorm_partials(const T* __restrict__ g, const T* __restrict__ h,
                      float* __restrict__ part, int64_t n, int64_t nchunks) {
  __shared__ float scratch[kThreads / 32];
  const int64_t w = blockIdx.y;
  const int64_t c = blockIdx.x;
  const T* gw = g + w * n;
  const T* hw = h + w * n;
  const int64_t base = c * kChunk + threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    if (j < n) {
      const float d = (float)sub(gw[j], hw[j]);
      acc = add(acc, mul(d, d));
    }
  }
  acc = block_reduce(acc, 0.0f, SumOp(), scratch);
  if (threadIdx.x == 0) part[w * nchunks + c] = acc;
}

template <typename T>
static int launch_delta_sqnorm(const void* g, const void* h, void* part, void* out,
                               int64_t m, int64_t n, int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  delta_sqnorm_partials<T><<<dim3((unsigned)nchunks, (unsigned)m), kThreads, 0, s>>>(
      (const T*)g, (const T*)h, (float*)part, n, nchunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_partials<float, SumOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const float*)part, (float*)out, nchunks, 0.0f);
  return (int)cudaGetLastError();
}

extern "C" {

int censor_delta_sqnorm_batched_f32(int device, const void* g, const void* h, void* part, void* out,
                                    int64_t m, int64_t n, int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm<float>(g, h, part, out, m, n, nchunks, stream);
}

int censor_delta_sqnorm_batched_f64(int device, const void* g, const void* h, void* part, void* out,
                                    int64_t m, int64_t n, int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm<double>(g, h, part, out, m, n, nchunks, stream);
}

}  // extern "C"

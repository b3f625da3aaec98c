// One thread's M - 1 dependent adds from registers: the floor of an exact
// left fold over M workers, which B2 and B6 run per column on a tall bank
// (csrc/fused_step.cu). Each add waits for the one before it, so the time
// is M - 1 add latencies whatever the card's width; no design of a fold
// that keeps its bits can beat it. Benchmark-only: built and timed by
// benchmarks_torch/chain_floor.py, with the port's nvcc flags and
// reduce.cuh's correctly rounded adds.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void chain_add_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t m) {
  T v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = x[k];
  T acc = v[0];
  int64_t i = 1;
  for (; i + 8 <= m; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = add(acc, v[k]);
  }
  for (; i < m; ++i) acc = add(acc, v[1]);
  out[0] = acc;
}

template <typename T>
static int launch_chain(const void* x, void* out, int64_t m, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  chain_add_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>((const T*)x, (T*)out, m);
  return (int)cudaGetLastError();
}

extern "C" {

int chain_add_f32(int device, const void* x, void* out, int64_t m, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_chain<float>(x, out, m, stream);
}

int chain_add_f64(int device, const void* x, void* out, int64_t m, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_chain<double>(x, out, m, stream);
}

}  // extern "C"

// Device helpers shared by the repro_torch CUDA kernels.
//
// Every arithmetic step goes through a correctly rounded intrinsic, so no
// expression is contracted into an FMA and each one rounds exactly like
// the matching PyTorch eager op of the plain versions in kernels/ref.py
// (the build also passes -fmad=false). Block reductions run in a fixed
// order: a shuffle tree inside each warp, then the warp results in warp
// order. Nothing here uses atomics, so a launch is deterministic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;                         // threads per block
constexpr int kItems = 8;                             // elements per thread per chunk
constexpr int64_t kChunk = (int64_t)kThreads * kItems;  // elements per reduction block

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }
// max that keeps a NaN, as torch.amax and jnp.max do (fmaxf/fmax drop it)
template <typename T>
__device__ __forceinline__ T maxval(T a, T b) { return (a > b || isnan(a)) ? a : b; }
// clip(x, lo, hi) with NaN in, NaN out, as torch.clamp and jnp.clip do
// (fminf/fmaxf would turn a NaN into a bound)
__device__ __forceinline__ float clampval(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return add(a, b); }
};
struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return maxval(a, b); }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Reduce one value per thread over the block; the result is valid in
// thread 0. `scratch` is a __shared__ array of kThreads / 32 elements.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T identity, Op op, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v, op);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = identity;
  if (warp == 0) {
    r = lane < kThreads / 32 ? scratch[lane] : identity;
    r = warp_reduce(r, op);
  }
  return r;
}

// Pass 2 of the reductions: one block per worker folds that worker's
// pass-1 partials in a fixed order (a strided walk, then block_reduce).
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
finish_partials(const T* __restrict__ part, T* __restrict__ out, int64_t nchunks, T identity) {
  __shared__ T scratch[kThreads / 32];
  const T* p = part + (int64_t)blockIdx.x * nchunks;
  const Op op{};
  T acc = identity;
  for (int64_t i = threadIdx.x; i < nchunks; i += kThreads) acc = op(acc, p[i]);
  acc = block_reduce(acc, identity, op, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

inline int64_t num_chunks(int64_t n) { return (n + kChunk - 1) / kChunk; }

// The grid of a reduction: x walks the chunks, y the workers.
inline bool reduction_shape_ok(int64_t m, int64_t n, int64_t nchunks) {
  return m >= 1 && m <= 65535 && n >= 1 && nchunks == num_chunks(n) && nchunks <= 0x7fffffff;
}

// Blocks of an elementwise pass: one thread per column, capped so the
// grid stays inside gridDim.x (the kernels walk on with a grid stride).
inline unsigned elementwise_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 0x7fffffff ? b : 0x7fffffff);
}

// Elements of one worker row that one thread of a row-tiled elementwise
// pass owns: it issues all their loads before it computes, so several
// loads are in flight per thread.
constexpr int kRowItems = 4;
constexpr int64_t kRowTile = (int64_t)kThreads * kRowItems;

// The grid of a row-tiled pass: x walks the tiles of a row, y the workers.
inline bool row_tiles_ok(int64_t m, int64_t n) {
  return m >= 1 && m <= 65535 && n >= 1 && (n + kRowTile - 1) / kRowTile <= 0x7fffffff;
}
inline dim3 row_tiles(int64_t m, int64_t n) {
  return dim3((unsigned)((n + kRowTile - 1) / kRowTile), (unsigned)m);
}

}  // namespace repro

// Every library exports this, so a launcher's error code reads as text.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Device helpers shared by the repro_torch CUDA kernels.
//
// Every arithmetic step goes through a correctly rounded intrinsic, so no
// expression is contracted into an FMA and each one rounds exactly like
// the matching PyTorch eager op of the plain versions in kernels/ref.py
// (the build also passes -fmad=false). Block reductions run in a fixed
// order: a shuffle tree inside each warp, then the warp results in warp
// order. Nothing here uses atomics, so a launch is deterministic.
//
// Workers: the per-worker kernels put the worker on grid y, which holds at
// most 65535 blocks. Their grid y is min(M, 65535) (worker_blocks), and a
// block walks the workers w = blockIdx.y, blockIdx.y + gridDim.y, ...: a
// worker's output comes from the same elements in the same order at any
// M, so the bits do not depend on M, and any M runs. A reduction block
// passes a barrier before its second worker (block_reduce's scratch is
// reused), never after its last: a block that has one worker, as every
// block has for M <= 65535, runs what it ran before the walk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;                         // threads per block
constexpr int kWarps = kThreads / 32;                 // warps per block
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

constexpr int64_t kMaxGridX = 0x7fffffff;  // blocks of grid x
constexpr int64_t kMaxGridY = 65535;       // blocks of grid y

// Grid y of a per-worker kernel: its blocks walk the workers with a stride
// of gridDim.y.
inline unsigned worker_blocks(int64_t m) { return (unsigned)(m < kMaxGridY ? m : kMaxGridY); }

// The grid of a reduction: x walks the chunks, y the workers; pass 2
// (finish_partials) runs one block per worker on grid x.
inline bool reduction_shape_ok(int64_t m, int64_t n, int64_t nchunks) {
  return m >= 1 && m <= kMaxGridX && n >= 1 && nchunks == num_chunks(n) && nchunks <= kMaxGridX;
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// 16 bytes of one bank dtype, B9's arithmetic on each element of it, and
// B7a's fold of their magnitudes
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ __forceinline__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ __forceinline__ static float4 advance(float4 h, float mk, float4 q) {
    return make_float4(add(h.x, mul(mk, q.x)), add(h.y, mul(mk, q.y)), add(h.z, mul(mk, q.z)),
                       add(h.w, mul(mk, q.w)));
  }
  __device__ __forceinline__ static float absmax(float am, float4 v) {
    am = maxval(am, absval(v.x));
    am = maxval(am, absval(v.y));
    am = maxval(am, absval(v.z));
    return maxval(am, absval(v.w));
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ __forceinline__ static double2 zero() { return make_double2(0.0, 0.0); }
  __device__ __forceinline__ static double2 advance(double2 h, double mk, double2 q) {
    return make_double2(add(h.x, mul(mk, q.x)), add(h.y, mul(mk, q.y)));
  }
  __device__ __forceinline__ static double absmax(double am, double2 v) {
    return maxval(maxval(am, absval(v.x)), absval(v.y));
  }
};

// Blocks of an elementwise pass: one thread per column, capped so the
// grid stays inside gridDim.x (the kernels walk on with a grid stride).
inline unsigned elementwise_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxGridX ? b : kMaxGridX);
}

// Elements of one worker row that one thread of a row-tiled elementwise
// pass owns: it issues all their loads before it computes, so several
// loads are in flight per thread.
constexpr int kRowItems = 4;
constexpr int64_t kRowTile = (int64_t)kThreads * kRowItems;

// The grid of a row-tiled pass: x walks the tiles of a row, y the workers
// (with a stride of gridDim.y).
inline bool row_tiles_ok(int64_t m, int64_t n) {
  return m >= 1 && n >= 1 && (n + kRowTile - 1) / kRowTile <= kMaxGridX;
}
inline dim3 row_tiles(int64_t m, int64_t n) {
  return dim3((unsigned)((n + kRowTile - 1) / kRowTile), worker_blocks(m));
}

// The tiling of an elementwise pass over a tall bank (B2/B6's pass 1, B10):
// a block covers 2^shift columns, the power of two >= min(n, kThreads), and
// kThreads >> shift rows a sweep, kRowItems sweeps, so a warp reads whole
// rows of a narrow bank and no thread divides by n to find its worker.
// The least shift with 2^shift >= min(n, cap), cap a power of two:
inline int pow2_shift(int64_t n, int cap) {
  int s = 0;
  while ((int64_t(1) << s) < n && (1 << s) < cap) ++s;
  return s;
}
// the grid: x the column tiles, y the row tiles (walked with a stride past
// grid y's limit)
inline bool tall_grid_ok(int64_t m, int64_t n) {
  return m >= 1 && n >= 1 && (n + kThreads - 1) / kThreads <= kMaxGridX;
}
inline dim3 tall_grid(int64_t m, int64_t n, int shift) {
  const int64_t tile = (int64_t)(kThreads >> shift) * kRowItems;
  const int64_t y = (m + tile - 1) / tile;
  return dim3((unsigned)((n + (1 << shift) - 1) >> shift),
              (unsigned)(y < kMaxGridY ? y : kMaxGridY));
}

}  // namespace repro

// Every library exports this, so a launcher's error code reads as text.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

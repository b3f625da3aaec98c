// The staged int8 + error-feedback kernels of one (M, n) pending leaf, on
// Hopper.
//
//   B7a absmax_batched      replaces src/repro/kernels/quantize_ef.py:absmax_batched
//   B7b quantize_ef_batched replaces src/repro/kernels/quantize_ef.py:quantize_ef_batched
//
// B7a gives the per-worker max |pending_m| in the pending dtype, from which
// the caller derives the (M,) f32 scales (core.quantize.int8_scale). B7b
// then emits, from one read of pending and err, the dequantized payload
// q = clip(rint(f32(p) / s), -127, 127) * s cast to the pending dtype, and
// the next error-feedback leaf e' = mk*(p - q) + (1 - mk)*e. The quotient
// is taken in f32 for both bank dtypes, as the reference does; e' is
// computed in the pending dtype.
//
// Bound: bytes, for both (a handful of flops an element). At M=4,
// n=163,597,056 in f32 on an H100 SXM (3.35 TB/s):
//   B7a reads M*n elements and writes M values:    2.62 GB, >= 0.78 ms;
//   B7b reads 2*M*n elements and writes 2*M*n:    10.47 GB, >= 3.13 ms.
//
// Design: B7a is the two-pass reduction of B1/B5 (reduce.cuh): one partial
// per (chunk, worker), folded in a fixed order, no atomics. Its max keeps
// a NaN (maxval), so it equals torch.amax and B5's abs-max on the same
// pending, NaN rows included. A thread loads its kItems elements before
// it folds any, so they are all in flight at once: folded one by one as
// they came, each waited on the last (see PERF.md). B7b is B6's int8
// round trip and EF blend (fused_step.cu) without the bank advance, tiled
// per worker row (grid y = worker): a thread loads kRowItems elements of
// pending and err before it computes, for the same reason. It uses the
// same intrinsics in the same order and a clip that keeps a NaN
// (clampval), so its err' equals B6's bit for bit.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_partials(const T* __restrict__ x, T* __restrict__ part, int64_t n, int64_t nchunks) {
  __shared__ T scratch[kThreads / 32];
  const int64_t w = blockIdx.y;
  const int64_t c = blockIdx.x;
  const T* xw = x + w * n;
  const int64_t base = c * kChunk + threadIdx.x;
  T v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    v[k] = j < n ? absval(xw[j]) : T(0);
  }
  T am = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) am = maxval(am, v[k]);
  am = block_reduce(am, T(0), MaxOp(), scratch);
  if (threadIdx.x == 0) part[w * nchunks + c] = am;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_ef_kernel(const T* __restrict__ p, const T* __restrict__ e,
                   const float* __restrict__ mask, const float* __restrict__ scale,
                   T* __restrict__ payload, T* __restrict__ new_e, int64_t n) {
  const int64_t w = blockIdx.y;
  const float sc = scale[w];
  const T mk = (T)mask[w];
  const T keep = sub(T(1), mk);
  const int64_t off = w * n;
  const int64_t base = (int64_t)blockIdx.x * kRowTile + threadIdx.x;
  T pv[kRowItems], ev[kRowItems];
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    pv[k] = j < n ? p[off + j] : T(0);
    ev[k] = j < n ? e[off + j] : T(0);
  }
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    if (j >= n) continue;
    // int8 round trip in f32: rintf rounds half to even, like torch.round
    const float q = clampval(rintf(__fdiv_rn((float)pv[k], sc)), -127.0f, 127.0f);
    const T pay = (T)__fmul_rn(q, sc);
    payload[off + j] = pay;
    new_e[off + j] = add(mul(mk, sub(pv[k], pay)), mul(keep, ev[k]));
  }
}

template <typename T>
static int launch_absmax(const void* x, void* part, void* out, int64_t m, int64_t n,
                         int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  absmax_partials<T><<<dim3((unsigned)nchunks, (unsigned)m), kThreads, 0, s>>>(
      (const T*)x, (T*)part, n, nchunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_partials<T, MaxOp><<<(unsigned)m, kThreads, 0, s>>>((const T*)part, (T*)out, nchunks,
                                                             T(0));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_quantize_ef(const void* p, const void* e, const void* mask, const void* scale,
                              void* payload, void* new_e, int64_t m, int64_t n, void* stream) {
  if (!row_tiles_ok(m, n)) return (int)cudaErrorInvalidValue;
  quantize_ef_kernel<T><<<row_tiles(m, n), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)p, (const T*)e, (const float*)mask, (const float*)scale, (T*)payload,
          (T*)new_e, n);
  return (int)cudaGetLastError();
}

extern "C" {

int absmax_batched_f32(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                       int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax<float>(x, part, out, m, n, nchunks, stream);
}

int absmax_batched_f64(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                       int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax<double>(x, part, out, m, n, nchunks, stream);
}

int quantize_ef_batched_f32(int device, const void* p, const void* e, const void* mask,
                            const void* scale, void* payload, void* new_e, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_quantize_ef<float>(p, e, mask, scale, payload, new_e, m, n, stream);
}

int quantize_ef_batched_f64(int device, const void* p, const void* e, const void* mask,
                            const void* scale, void* payload, void* new_e, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_quantize_ef<double>(p, e, mask, scale, payload, new_e, m, n, stream);
}

}  // extern "C"

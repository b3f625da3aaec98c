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
// Design: one read of each input and one write of each output, tiled as
// reduce.cuh's tall_grid says (B2/B6's pass 1): a block covers 2^shift
// columns, the power of two >= min(n, 256), and 256 >> shift rows a sweep,
// kRowItems sweeps, so a warp reads whole rows of a narrow bank (n = 16:
// two rows a warp, 64 a block) and every access of a wide one is coalesced
// across the warp (n >= 256: a block covers 256 columns of 4 rows). A
// thread issues the loads of all its rows before it computes any. No
// thread walks the workers one after another (there is no worker sum to
// keep in order), so a tall bank (M = 10^5 workers of 16 columns) runs on
// the whole card. The payload is a select, not a multiply by the keep
// mask, so a kept -0.0 stays -0.0 and a dropped entry is +0.0, bit for bit
// as in kernels/ref.py. Every payload entry is pending or +0.0, so
// payload + new_err == pending exactly after a transmit. The EF blend is
// the arithmetic form of the int8 kernel (B6), each operation a correctly
// rounded intrinsic. The keep masks themselves are an exact selection in
// plain PyTorch (opt/transport.py), as the JAX package computes them
// outside Pallas.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_pack_ef_kernel(const T* __restrict__ p, const T* __restrict__ e,
                      const T* __restrict__ keep, const float* __restrict__ mask,
                      T* __restrict__ payload, T* __restrict__ new_e, int64_t m, int64_t n,
                      int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= n) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRowItems;      // rows a block covers
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    T pv[kRowItems], ev[kRowItems], kv[kRowItems], mk[kRowItems];
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const int64_t o = w * n + j;
        pv[k] = p[o];
        ev[k] = e[o];
        kv[k] = keep[o];
        mk[k] = (T)mask[w];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const int64_t o = w * n + j;
        const T q = kv[k] != T(0) ? pv[k] : T(0);
        payload[o] = q;
        new_e[o] = add(mul(mk[k], sub(pv[k], q)), mul(sub(T(1), mk[k]), ev[k]));
      }
    }
  }
}

template <typename T>
static int launch_select_pack_ef(const void* p, const void* e, const void* keep,
                                 const void* mask, void* payload, void* new_e, int64_t m,
                                 int64_t n, void* stream) {
  if (!tall_grid_ok(m, n)) return (int)cudaErrorInvalidValue;
  const int shift = pow2_shift(n, kThreads);
  select_pack_ef_kernel<T><<<tall_grid(m, n, shift), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)e, (const T*)keep, (const float*)mask, (T*)payload, (T*)new_e,
      m, n, shift);
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

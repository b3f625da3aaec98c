// B11: the low-rank transport's error-feedback residual of one (M, n)
// leaf, given the reconstruction the receiver sees:
//   new_err = m*(pending - payload) + (1 - m)*err
//
// Replaces the TPU kernel src/repro/kernels/lowrank_ef.py:residual_ef_batched.
//
// Bound: bytes. It reads pending, payload and err (3*M*n elements) and
// writes new_err (M*n); an f32 leaf at M=4, n=163,597,056 moves 10.47 GB
// and needs at least 3.13 ms at an H100 SXM's 3.35 TB/s. Its 5 flops an
// element are far below the f32 rate.
//
// Design: one read of each input and one write, in one grid-stride pass;
// each thread owns a column and walks the workers, so every row access is
// coalesced across the warp. The blend is the arithmetic form of
// opt/transport.py:_ef_blend, each operation a correctly rounded
// intrinsic, so the result equals the plain version bit for bit. The
// PowerSGD factor products stay in plain PyTorch matmuls, as the JAX
// package leaves them to XLA.
//
// A bf16 pending leaf (kernels/common.py:EF_DTYPES) takes the payload and
// err each in bf16 or f32: the payload of a bf16 leaf of f32 params is
// f32 (its factor products run in f32, as jnp.matmul promotes them), err
// is f32 before the first step of f32 params (transport.init). Both are
// cast to bf16 first and each operation rounds to bf16 (reduce.cuh), as
// src/repro/kernels/lowrank_ef.py:36-40 states it; new_err is bf16. That
// build runs on the tall tiling of B7b (reduce.cuh's tall_grid), two rows
// a thread, on 16-byte tiles of 8 elements where n is a multiple of 8 and
// every operand is 16-byte aligned (Tile16: an f32 operand's 8 in two
// 16-byte loads), elements otherwise. Bound on a bf16 leaf at the shape
// above: 8, 10 or 12 bytes an element (no, one or two f32 operands),
// 5.24, 6.54 or 7.85 GB, >= 1.56, 1.95 or 2.34 ms.
#include "reduce.cuh"

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_ef_kernel(const T* __restrict__ p, const T* __restrict__ q, const T* __restrict__ e,
                   const float* __restrict__ mask, T* __restrict__ new_e, int64_t m, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T mk = (T)mask[w];
      new_e[o] = add(mul(mk, sub(p[o], q[o])), mul(sub(T(1), mk), e[o]));
    }
  }
}

template <typename T>
static int launch_residual_ef(const void* p, const void* q, const void* e, const void* mask,
                              void* new_e, int64_t m, int64_t n, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  residual_ef_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)q, (const T*)e, (const float*)mask, (T*)new_e, m, n);
  return (int)cudaGetLastError();
}

// One element of B11 on a bf16 leaf: mk*(p - q) + om*e, q and e cast to
// the pending dtype T first, om = 1 - mk; on a tile of 8, each element.
template <typename T, typename TQ, typename TE>
__device__ __forceinline__ T residual(T p, TQ q, TE e, T mk, T om) {
  return add(mul(mk, sub(p, Cast<T>::of(q))), mul(om, Cast<T>::of(e)));
}
template <typename TQ, typename TE>
__device__ __forceinline__ Pack<bf16, 8> residual(const Pack<bf16, 8>& p, const Pack<TQ, 8>& q,
                                                  const Pack<TE, 8>& e, bf16 mk, bf16 om) {
  Pack<bf16, 8> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = residual(p.v[i], q.v[i], e.v[i], mk, om);
  return r;
}

// B11's bf16 build on the tall tiling (B7b's): EP the items of pending
// and new_e, EQ the payload's, EE err's (elements or Tile16's tiles)
template <typename T, typename EP, typename EQ, typename EE, int kRows>
__global__ void __launch_bounds__(kThreads)
tall_residual_kernel(const EP* __restrict__ p, const EQ* __restrict__ q,
                     const EE* __restrict__ e, const float* __restrict__ mask,
                     EP* __restrict__ new_e, int64_t m, int64_t ncols, int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= ncols) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRows;          // rows a block covers
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    EP pv[kRows];
    EQ qv[kRows];
    EE ev[kRows];
    float mk[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const int64_t o = w * ncols + j;
        pv[k] = p[o];
        qv[k] = q[o];
        ev[k] = e[o];
        mk[k] = mask[w];
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const T mkw = Cast<T>::of(mk[k]);
        new_e[w * ncols + j] = residual(pv[k], qv[k], ev[k], mkw,
                                        sub(Cast<T>::of(1.0f), mkw));
      }
    }
  }
}

// a bf16 pending leaf, the payload in TQ and err in TE (bf16 or f32)
template <typename TQ, typename TE>
static int launch_residual_ef_bf16(const void* p, const void* q, const void* e,
                                   const void* mask, void* new_e, int64_t m, int64_t n,
                                   void* stream) {
  if (!tall_grid_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 8 == 0 && aligned16(p) && aligned16(q) && aligned16(e) && aligned16(new_e)) {
    using VP = Pack<bf16, 8>;
    using VQ = typename Tile16<bf16, TQ>::B;
    using VE = typename Tile16<bf16, TE>::B;
    const int64_t nv = n / 8;
    const int shift = pow2_shift(nv, kThreads);
    tall_residual_kernel<bf16, VP, VQ, VE, kAdvanceRows>
        <<<tall_grid(m, nv, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const VP*)p, (const VQ*)q, (const VE*)e, (const float*)mask, (VP*)new_e, m, nv,
            shift);
  } else {
    const int shift = pow2_shift(n, kThreads);
    tall_residual_kernel<bf16, bf16, TQ, TE, kAdvanceRows>
        <<<tall_grid(m, n, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const bf16*)p, (const TQ*)q, (const TE*)e, (const float*)mask, (bf16*)new_e, m,
            n, shift);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int residual_ef_batched_f32(int device, const void* p, const void* q, const void* e,
                            const void* mask, void* new_e, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef<float>(p, q, e, mask, new_e, m, n, stream);
}

int residual_ef_batched_f64(int device, const void* p, const void* q, const void* e,
                            const void* mask, void* new_e, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef<double>(p, q, e, mask, new_e, m, n, stream);
}

// a bf16 pending leaf; the payload, then err, in f32 where the suffix
// names it (_bf16_<payload>_<err>)
int residual_ef_batched_bf16(int device, const void* p, const void* q, const void* e,
                             const void* mask, void* new_e, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef_bf16<bf16, bf16>(p, q, e, mask, new_e, m, n, stream);
}

int residual_ef_batched_bf16_f32_bf16(int device, const void* p, const void* q, const void* e,
                                      const void* mask, void* new_e, int64_t m, int64_t n,
                                      void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef_bf16<float, bf16>(p, q, e, mask, new_e, m, n, stream);
}

int residual_ef_batched_bf16_bf16_f32(int device, const void* p, const void* q, const void* e,
                                      const void* mask, void* new_e, int64_t m, int64_t n,
                                      void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef_bf16<bf16, float>(p, q, e, mask, new_e, m, n, stream);
}

int residual_ef_batched_bf16_f32_f32(int device, const void* p, const void* q, const void* e,
                                     const void* mask, void* new_e, int64_t m, int64_t n,
                                     void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_residual_ef_bf16<float, float>(p, q, e, mask, new_e, m, n, stream);
}

}  // extern "C"

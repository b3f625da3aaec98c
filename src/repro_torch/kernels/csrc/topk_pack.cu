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
//
// A bf16 pending leaf (kernels/common.py:EF_DTYPES; keep in bf16 too)
// takes err in bf16 or in f32 (the err transport.init makes for f32
// params), cast to bf16 first as src/repro/kernels/topk_pack.py:42-44
// does; each operation of the blend rounds to bf16 (reduce.cuh). It moves
// 8 elements a load where n is a multiple of 8 and every operand is
// 16-byte aligned (reduce.cuh's Tile16: err's 8 in f32 in two 16-byte
// loads), two rows a thread as B4's and B9's tiles; elements otherwise.
// Bound on a bf16 leaf at the shape above: 6.54 GB, >= 1.95 ms (with an
// f32 err 7.85 GB, >= 2.34 ms).
#include "reduce.cuh"

using namespace repro;

// One element of B10: q = keep != 0 ? p : +0.0 (a select), and
// e' = mk*(p - q) + (1 - mk)*e with e cast to the pending dtype T first;
// om = 1 - mk. On a tile of 8 bf16 elements, the same on each.
template <typename T, typename TE>
__device__ __forceinline__ void select_ef(T p, TE e, T kv, T mk, T om, T& q, T& ne) {
  q = widen(kv) != calc_t<T>(0) ? p : Cast<T>::of(0.0f);
  ne = add(mul(mk, sub(p, q)), mul(om, Cast<T>::of(e)));
}
template <typename TE>
__device__ __forceinline__ void select_ef(const Pack<bf16, 8>& p, const Pack<TE, 8>& e,
                                          const Pack<bf16, 8>& kv, bf16 mk, bf16 om,
                                          Pack<bf16, 8>& q, Pack<bf16, 8>& ne) {
#pragma unroll
  for (int i = 0; i < 8; ++i) select_ef(p.v[i], e.v[i], kv.v[i], mk, om, q.v[i], ne.v[i]);
}

// T the pending dtype; EP the items of pending, keep, payload and new_e
// (elements, or Tile16's bf16 tiles), EE err's; kRows sweeps a block
template <typename T, typename EP, typename EE, int kRows>
__global__ void __launch_bounds__(kThreads)
select_pack_ef_kernel(const EP* __restrict__ p, const EE* __restrict__ e,
                      const EP* __restrict__ keep, const float* __restrict__ mask,
                      EP* __restrict__ payload, EP* __restrict__ new_e, int64_t m, int64_t n,
                      int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= n) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRows;          // rows a block covers
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    EP pv[kRows], kv[kRows];
    EE ev[kRows];
    T mk[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const int64_t o = w * n + j;
        pv[k] = p[o];
        ev[k] = e[o];
        kv[k] = keep[o];
        mk[k] = Cast<T>::of(mask[w]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const int64_t o = w * n + j;
        EP q, ne;
        select_ef(pv[k], ev[k], kv[k], mk[k], sub(Cast<T>::of(1.0f), mk[k]), q, ne);
        payload[o] = q;
        new_e[o] = ne;
      }
    }
  }
}

// T the pending dtype, TE err's: a bf16 leaf on 16-byte tiles where it
// can, every other launch element by element, kRowItems rows a thread
template <typename T, typename TE = T>
static int launch_select_pack_ef(const void* p, const void* e, const void* keep,
                                 const void* mask, void* payload, void* new_e, int64_t m,
                                 int64_t n, void* stream) {
  if (!tall_grid_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 2) {
    constexpr int64_t per_vec = 16 / sizeof(T);
    if (n % per_vec == 0 && aligned16(p) && aligned16(e) && aligned16(keep) &&
        aligned16(payload) && aligned16(new_e)) {
      using VP = typename Tile16<T, TE>::A;
      using VE = typename Tile16<T, TE>::B;
      const int64_t nv = n / per_vec;
      const int shift = pow2_shift(nv, kThreads);
      select_pack_ef_kernel<T, VP, VE, kAdvanceRows>
          <<<tall_grid(m, nv, shift, kAdvanceRows), kThreads, 0, s>>>(
              (const VP*)p, (const VE*)e, (const VP*)keep, (const float*)mask, (VP*)payload,
              (VP*)new_e, m, nv, shift);
      return (int)cudaGetLastError();
    }
  }
  const int shift = pow2_shift(n, kThreads);
  select_pack_ef_kernel<T, T, TE, kRowItems><<<tall_grid(m, n, shift), kThreads, 0, s>>>(
      (const T*)p, (const TE*)e, (const T*)keep, (const float*)mask, (T*)payload, (T*)new_e,
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

// a bf16 pending leaf and keep, err in bf16, and in f32 (_bf16_f32)
int select_pack_ef_batched_bf16(int device, const void* p, const void* e, const void* keep,
                                const void* mask, void* payload, void* new_e, int64_t m,
                                int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_select_pack_ef<bf16>(p, e, keep, mask, payload, new_e, m, n, stream);
}

int select_pack_ef_batched_bf16_f32(int device, const void* p, const void* e, const void* keep,
                                    const void* mask, void* payload, void* new_e, int64_t m,
                                    int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_select_pack_ef<bf16, float>(p, e, keep, mask, payload, new_e, m, n, stream);
}

}  // extern "C"

// The censor kernels of one (M, n) bank leaf, on Hopper.
//
//   B1 censor_delta_sqnorm_batched replaces src/repro/kernels/censor.py:censor_delta_sqnorm_batched
//   B8 sqnorm_batched              replaces src/repro/kernels/censor.py:sqnorm_batched
//   B9 bank_advance                replaces src/repro/kernels/censor.py:bank_advance
//   B4 censor_bank_advance         replaces src/repro/kernels/censor.py:censor_bank_advance
//   B12a censor_delta_sqnorm       replaces src/repro/kernels/censor.py:censor_delta_sqnorm
//   B12b censor_select             replaces src/repro/kernels/censor.py:censor_select
//
// B1 gives the per-worker eq.-(8) norms sum_j (g[m,j] - ghat[m,j])^2, the
// subtraction in the bank dtype and the square-sum in f32. Its banks are
// f32, f64 and bf16; a bf16 bank takes bf16 or f32 gradients, cast to
// bf16 before the subtraction, which rounds to bf16 (reduce.cuh), as the
// JAX kernel's g.astype(h.dtype) - h (censor.py:127-130) and ref.py state. B8 gives the
// same sum of a pending delta already in memory (the stateful transports'
// staged step), B9 advances the bank by an encoded payload,
// ghat + m*payload, and B4 by the raw gradient, ghat + m*(g - ghat) (the
// staged dense step and shard_step).
//
// B8, B9 and B4 take bf16 banks too: B8 a bf16 pending tree (each element
// cast to f32 and squared there, the chunks and trees of the f32 build),
// B9 and B4 a bf16 bank with a bf16 or an f32 payload or gradient, cast to
// bf16 first; each element operation of the advance rounds to bf16
// (reduce.cuh), as the JAX kernels' bodies (censor.py:195-200, :240-246)
// and ref.py state them.
//
// Bound: bytes, for all four (a handful of flops an element). At M=4,
// n=163,597,056 in f32 on an H100 SXM (3.35 TB/s):
//   B1 reads 2*M*n elements and writes M floats:   5.23 GB, >= 1.56 ms;
//   B8 reads M*n elements and writes M floats:     2.62 GB, >= 0.78 ms;
//   B9 reads 2*M*n elements and writes M*n:        7.85 GB, >= 2.34 ms;
//   B4 reads 2*M*n elements and writes M*n:        7.85 GB, >= 2.34 ms.
// On a bf16 bank: B8 1.31 GB, >= 0.39 ms; B9 and B4 with a bf16 operand
// 3.93 GB, >= 1.17 ms, with an f32 one 5.24 GB, >= 1.56 ms.
// and for one f32 tensor of n elements:
//   B12a reads 2*n elements and writes one float:  1.31 GB, >= 0.39 ms;
//   B12b reads n elements (the selected side only) and writes n:
//                                                   1.31 GB, >= 0.39 ms.
//
// Design: pass 1 of B1 and B8 gives each (chunk, worker) block kChunk
// contiguous elements with coalesced loads (neighbouring threads on
// neighbouring addresses, kItems independent loads in flight per thread)
// and writes one f32 partial in a fixed tree order; pass 2
// (finish_partials) folds each worker's partials in a fixed order. No
// atomics: the same input gives the same bits on every launch, and since a
// worker's chunks depend only on n, the M=1 call on one worker equals that
// worker's slice of a batched call. B8 squares (float)x where B1 squares
// (float)(g - ghat) with the same chunks and tree, so B8 on g - ghat equals
// B1 on (g, ghat) bit for bit. B1 and B8 put the worker on grid y and
// walk any M with a stride of gridDim.y (reduce.cuh), so a worker's output
// does not depend on M.
// B1 and B8 have a second design for rows of one chunk (n <= kChunk) on
// many workers (the fed mesh: M = 10^5 rows of 16), which the wrapper
// picks by shape (kernels/common.py:sqnorm_path): a warp a worker, one
// launch, no partials. There the two-pass design runs a 256-thread block a
// row (240 threads idle at n = 16) and a second launch of M blocks that
// each add one partial. Its lanes replay the two-pass design's threads,
// shuffle trees and cross-warp tree in their order (reduce.cuh's
// warp_row_reduce, shared with B5), so the two designs give the same bits,
// and B8 on g - ghat still equals B1 on either.
// B4 advances in the arithmetic mask form of B2, so its output equals B2's
// ghat' bit for bit (a select would not: h + (g - h) != g in floating
// point). B9 computes ghat + (T)mask * payload with the same rounding
// intrinsics. Both run one design for every shape: B10's tall tiling
// (tall_pair_kernel below, one body, the element operation a template
// argument: reduce.cuh's AdvanceOp for B9, CensorAdvanceOp for B4). A
// block of it holds 32 of the fed mesh's rows of 8 double2s a sweep (f64,
// n = 16), where a block a row would leave 248 of its 256 threads idle,
// and at full width it covers 256 columns of 2 rows. Where n is a
// multiple of the elements in 16 bytes and ghat, the other operand and
// out are 16-byte aligned (every row then is), it tiles the row's float4s
// (f32) or double2s (f64): 16-byte loads and stores, two rows of each
// operand in flight a thread; a bf16 bank tiles 8 elements (Pack<bf16, 8>,
// its f32 operand's 8 in two 16-byte loads). Otherwise (an odd n misaligns every row
// after the first, or a view starts off alignment) it tiles elements. The
// launcher decides. Its grid walks any M (reduce.cuh's tall_grid).
//
// B12a and B12b are the single-tensor entry points of one (g, ghat) pair
// whose dtypes may differ (f32, f64 or bf16 each). B12a casts both to f32
// *before* it subtracts, as the JAX kernel does (B1 subtracts in the bank
// dtype, so at f64 or for a mixed pair the two differ); it then runs B1's
// chunks, tree and fixed-order pass 2 at M=1. B12b is a select, not a mask
// multiply: with the transmit flag a runtime int, it copies g cast to
// ghat's dtype, or ghat, so -0.0 and NaN on either side come through as
// jnp.where passes them. It reads only the side it selects, on the row
// tiles of reduce.cuh (kRowItems loads in flight a thread).
#include <cuda_bf16.h>

#include "reduce.cuh"

using namespace repro;

// TG the gradients' dtype, TH the bank's: g is cast to TH before the
// subtraction (reduce.cuh's Cast, exact for TG = TH)
template <typename TG, typename TH>
__global__ void __launch_bounds__(kThreads)
delta_sqnorm_partials(const TG* __restrict__ g, const TH* __restrict__ h,
                      float* __restrict__ part, int64_t m, int64_t n, int64_t nchunks) {
  __shared__ float scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kChunk + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's block_reduce is done with scratch
    if (w != blockIdx.y) __syncthreads();
    const TG* gw = g + w * n;
    const TH* hw = h + w * n;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      if (j < n) {
        const float d = to_f32(sub(Cast<TH>::of(gw[j]), hw[j]));
        acc = add(acc, mul(d, d));
      }
    }
    acc = block_reduce(acc, 0.0f, SumOp(), scratch);
    if (threadIdx.x == 0) part[w * nchunks + c] = acc;
  }
}

template <typename TG, typename TH = TG>
static int launch_delta_sqnorm(const void* g, const void* h, void* part, void* out,
                               int64_t m, int64_t n, int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  delta_sqnorm_partials<TG, TH><<<dim3((unsigned)nchunks, worker_blocks(m)), kThreads, 0, s>>>(
      (const TG*)g, (const TH*)h, (float*)part, m, n, nchunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_partials<float, SumOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const float*)part, (float*)out, nchunks, 0.0f);
  return (int)cudaGetLastError();
}

// B1 and B8 on rows of one chunk (n <= kChunk), a warp a worker, the
// workers on grid x (kWarps a block): reduce.cuh's warp_row_reduce, which
// gives the two-pass design's bits.
template <typename TG, typename TH, int kN>
__global__ void __launch_bounds__(kThreads)
delta_sqnorm_warp_rows(const TG* __restrict__ g, const TH* __restrict__ h,
                       float* __restrict__ out, int64_t m, int64_t n) {
  const int64_t w = warp_row();
  if (w >= m) return;
  float sq;
  warp_row_reduce<DeltaRow<TG, TH>, false, kN>(DeltaRow<TG, TH>{g, h}, w, n, &sq, nullptr);
  if ((threadIdx.x & 31) == 0) out[w] = sq;
}

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
sqnorm_warp_rows(const T* __restrict__ x, float* __restrict__ out, int64_t m, int64_t n) {
  const int64_t w = warp_row();
  if (w >= m) return;
  float sq;
  warp_row_reduce<PlainRow<T>, false, kN>(PlainRow<T>{x}, w, n, &sq, nullptr);
  if ((threadIdx.x & 31) == 0) out[w] = sq;
}

template <typename TG, typename TH = TG>
static int launch_delta_sqnorm_warp(const void* g, const void* h, void* out, int64_t m,
                                    int64_t n, void* stream) {
  if (!warp_rows_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (warp_rows_one_item(n))
    delta_sqnorm_warp_rows<TG, TH, 1><<<warp_row_blocks(m), kThreads, 0, s>>>(
        (const TG*)g, (const TH*)h, (float*)out, m, n);
  else
    delta_sqnorm_warp_rows<TG, TH, kItems><<<warp_row_blocks(m), kThreads, 0, s>>>(
        (const TG*)g, (const TH*)h, (float*)out, m, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_sqnorm_warp(const void* x, void* out, int64_t m, int64_t n, void* stream) {
  if (!warp_rows_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (warp_rows_one_item(n))
    sqnorm_warp_rows<T, 1><<<warp_row_blocks(m), kThreads, 0, s>>>((const T*)x, (float*)out, m, n);
  else
    sqnorm_warp_rows<T, kItems><<<warp_row_blocks(m), kThreads, 0, s>>>((const T*)x, (float*)out,
                                                                         m, n);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sqnorm_partials(const T* __restrict__ x, float* __restrict__ part, int64_t m, int64_t n,
                int64_t nchunks) {
  __shared__ float scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kChunk + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's block_reduce is done with scratch
    if (w != blockIdx.y) __syncthreads();
    const T* xw = x + w * n;
    // all kItems loads in flight before the first add (in the walk the
    // compiler no longer hoists them itself); the adds keep their order
    T v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      v[k] = j < n ? xw[j] : T{};
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + (int64_t)k * kThreads < n) {
        const float d = to_f32(v[k]);
        acc = add(acc, mul(d, d));
      }
    }
    acc = block_reduce(acc, 0.0f, SumOp(), scratch);
    if (threadIdx.x == 0) part[w * nchunks + c] = acc;
  }
}

// The tall tiling of a two-operand elementwise pass out = op(a, mk, b)
// over an (M, ncols) bank of EA, b of EB: elements (EA = T) or 16-byte
// vectors of them (Vec16<T>::type; on a bf16 bank Pack<T, 8>, b then the
// Pack of its 8 elements, bf16 or f32). As B10's (topk_pack.cu) and B2/B6's pass 1,
// reduce.cuh's tall_grid: a block covers 2^shift columns, the power of
// two >= min(ncols, kThreads), and kThreads >> shift rows a sweep, kRows
// sweeps; a thread issues the loads of all its rows, and reads mask[w]
// once a row, before it computes any. B9 runs it with AdvanceOp, B4 with
// CensorAdvanceOp; nothing in it is either's but the operation. Its
// launcher takes kRows = kAdvanceRows (reduce.cuh gives the reason).
template <typename T, typename EA, typename EB, typename Op, int kRows>
__global__ void __launch_bounds__(kThreads)
tall_pair_kernel(const EA* __restrict__ a, const EB* __restrict__ b,
                 const float* __restrict__ mask, EA* __restrict__ out, int64_t m, int64_t ncols,
                 int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= ncols) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRows;          // rows a block covers
  const Op op{};
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    EA av[kRows];
    EB bv[kRows];
    float mk[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        av[k] = a[w * ncols + j];
        bv[k] = b[w * ncols + j];
        mk[k] = mask[w];
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) out[w * ncols + j] = apply_op(op, av[k], Cast<T>::of(mk[k]), bv[k]);
    }
  }
}

template <typename T>
static int launch_sqnorm(const void* x, void* part, void* out, int64_t m, int64_t n,
                         int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  sqnorm_partials<T><<<dim3((unsigned)nchunks, worker_blocks(m)), kThreads, 0, s>>>(
      (const T*)x, (float*)part, m, n, nchunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_partials<float, SumOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const float*)part, (float*)out, nchunks, 0.0f);
  return (int)cudaGetLastError();
}

// B9 (Op = AdvanceOp, b = payload) and B4 (CensorAdvanceOp, b = g) on the
// tall tiling, a = ghat in T, b in TB (T, or f32 on a bf16 bank): 16-byte
// tiles where n is a multiple of their elements and a, b and out start on
// 16-byte boundaries (every row then does), elements otherwise.
template <typename T, typename Op, typename TB = T>
static int launch_tall_pair(const void* a, const void* b, const void* mask, void* out,
                            int64_t m, int64_t n, void* stream) {
  if (!tall_grid_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int64_t per_vec = 16 / sizeof(T);
  if (n % per_vec == 0 && aligned16(a) && aligned16(b) && aligned16(out)) {
    using A = typename Tile16<T, TB>::A;
    using B = typename Tile16<T, TB>::B;
    const int64_t nv = n / per_vec;
    const int shift = pow2_shift(nv, kThreads);
    tall_pair_kernel<T, A, B, Op, kAdvanceRows>
        <<<tall_grid(m, nv, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const A*)a, (const B*)b, (const float*)mask, (A*)out, m, nv, shift);
  } else {
    const int shift = pow2_shift(n, kThreads);
    tall_pair_kernel<T, T, TB, Op, kAdvanceRows>
        <<<tall_grid(m, n, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const T*)a, (const TB*)b, (const float*)mask, (T*)out, m, n, shift);
  }
  return (int)cudaGetLastError();
}

template <typename TG, typename TH>
__global__ void __launch_bounds__(kThreads)
delta_sqnorm_f32_partials(const TG* __restrict__ g, const TH* __restrict__ h,
                          float* __restrict__ part, int64_t n) {
  __shared__ float scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kChunk + threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    if (j < n) {
      const float d = sub(to_f32(g[j]), to_f32(h[j]));
      acc = add(acc, mul(d, d));
    }
  }
  acc = block_reduce(acc, 0.0f, SumOp(), scratch);
  if (threadIdx.x == 0) part[c] = acc;
}

template <typename TG, typename TH>
static int launch_delta_sqnorm_f32(const void* g, const void* h, void* part, void* out,
                                   int64_t m, int64_t n, int64_t nchunks, void* stream) {
  if (m != 1 || !reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  delta_sqnorm_f32_partials<TG, TH><<<(unsigned)nchunks, kThreads, 0, s>>>(
      (const TG*)g, (const TH*)h, (float*)part, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_partials<float, SumOp><<<1, kThreads, 0, s>>>((const float*)part, (float*)out, nchunks,
                                                      0.0f);
  return (int)cudaGetLastError();
}

template <typename TG, typename TH>
__global__ void __launch_bounds__(kThreads)
censor_select_kernel(const TG* __restrict__ g, const TH* __restrict__ h, TH* __restrict__ out,
                     int64_t n, int transmit) {
  const int64_t base = (int64_t)blockIdx.x * kRowTile + threadIdx.x;
  TH x[kRowItems];
  if (transmit) {
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      if (j < n) x[k] = Cast<TH>::of(g[j]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      if (j < n) x[k] = h[j];
    }
  }
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    const int64_t j = base + (int64_t)k * kThreads;
    if (j < n) out[j] = x[k];
  }
}

template <typename TG, typename TH>
static int launch_censor_select(const void* g, const void* h, void* out, int64_t n,
                                int transmit, void* stream) {
  if (!row_tiles_ok(1, n)) return (int)cudaErrorInvalidValue;
  censor_select_kernel<TG, TH><<<row_tiles(1, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const TG*)g, (const TH*)h, (TH*)out, n, transmit);
  return (int)cudaGetLastError();
}

extern "C" {

// B12a and B12b for every (g dtype, ghat dtype) pair of f32, f64 and bf16
#define REPRO_SINGLE_TENSOR(SG, TG, SH, TH)                                                     \
  int censor_delta_sqnorm_##SG##_##SH(int device, const void* g, const void* h, void* part,     \
                                      void* out, int64_t m, int64_t n, int64_t nchunks,         \
                                      void* stream) {                                           \
    const cudaError_t sel = cudaSetDevice(device);                                             \
    if (sel != cudaSuccess) return (int)sel;                                                   \
    return launch_delta_sqnorm_f32<TG, TH>(g, h, part, out, m, n, nchunks, stream);            \
  }                                                                                            \
  int censor_select_##SG##_##SH(int device, const void* g, const void* h, void* out, int64_t n, \
                                int transmit, void* stream) {                                  \
    const cudaError_t sel = cudaSetDevice(device);                                             \
    if (sel != cudaSuccess) return (int)sel;                                                   \
    return launch_censor_select<TG, TH>(g, h, out, n, transmit, stream);                       \
  }
#define REPRO_SINGLE_TENSOR_G(SG, TG)                \
  REPRO_SINGLE_TENSOR(SG, TG, f32, float)            \
  REPRO_SINGLE_TENSOR(SG, TG, f64, double)           \
  REPRO_SINGLE_TENSOR(SG, TG, bf16, __nv_bfloat16)
REPRO_SINGLE_TENSOR_G(f32, float)
REPRO_SINGLE_TENSOR_G(f64, double)
REPRO_SINGLE_TENSOR_G(bf16, __nv_bfloat16)
#undef REPRO_SINGLE_TENSOR_G
#undef REPRO_SINGLE_TENSOR

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

int censor_delta_sqnorm_batched_warp_f32(int device, const void* g, const void* h, void* out,
                                         int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm_warp<float>(g, h, out, m, n, stream);
}

int censor_delta_sqnorm_batched_warp_f64(int device, const void* g, const void* h, void* out,
                                         int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm_warp<double>(g, h, out, m, n, stream);
}

// B1 on a bf16 bank: of bf16 gradients, and of f32 ones (cast to bf16 first)
int censor_delta_sqnorm_batched_bf16(int device, const void* g, const void* h, void* part,
                                     void* out, int64_t m, int64_t n, int64_t nchunks,
                                     void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm<bf16>(g, h, part, out, m, n, nchunks, stream);
}

int censor_delta_sqnorm_batched_f32_bf16(int device, const void* g, const void* h, void* part,
                                         void* out, int64_t m, int64_t n, int64_t nchunks,
                                         void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm<float, bf16>(g, h, part, out, m, n, nchunks, stream);
}

int censor_delta_sqnorm_batched_warp_bf16(int device, const void* g, const void* h, void* out,
                                          int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm_warp<bf16>(g, h, out, m, n, stream);
}

int censor_delta_sqnorm_batched_warp_f32_bf16(int device, const void* g, const void* h,
                                              void* out, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_delta_sqnorm_warp<float, bf16>(g, h, out, m, n, stream);
}

int sqnorm_batched_f32(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                       int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm<float>(x, part, out, m, n, nchunks, stream);
}

int sqnorm_batched_f64(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                       int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm<double>(x, part, out, m, n, nchunks, stream);
}

int sqnorm_batched_warp_f32(int device, const void* x, void* out, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm_warp<float>(x, out, m, n, stream);
}

int sqnorm_batched_warp_f64(int device, const void* x, void* out, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm_warp<double>(x, out, m, n, stream);
}

int bank_advance_f32(int device, const void* h, const void* q, const void* mask, void* out,
                     int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<float, AdvanceOp>(h, q, mask, out, m, n, stream);
}

int bank_advance_f64(int device, const void* h, const void* q, const void* mask, void* out,
                     int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<double, AdvanceOp>(h, q, mask, out, m, n, stream);
}

int censor_bank_advance_f32(int device, const void* g, const void* h, const void* mask, void* out,
                            int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<float, CensorAdvanceOp>(h, g, mask, out, m, n, stream);
}

int censor_bank_advance_f64(int device, const void* g, const void* h, const void* mask, void* out,
                            int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<double, CensorAdvanceOp>(h, g, mask, out, m, n, stream);
}

// B8 on a bf16 pending tree (the sum in f32, the chunks and trees of f32's)
int sqnorm_batched_bf16(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                        int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm<bf16>(x, part, out, m, n, nchunks, stream);
}

int sqnorm_batched_warp_bf16(int device, const void* x, void* out, int64_t m, int64_t n,
                             void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_sqnorm_warp<bf16>(x, out, m, n, stream);
}

// B9 and B4 on a bf16 bank: of a bf16 payload or gradient, and of an f32
// one (_f32_bf16), cast to bf16 first
int bank_advance_bf16(int device, const void* h, const void* q, const void* mask, void* out,
                      int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<bf16, AdvanceOp>(h, q, mask, out, m, n, stream);
}

int bank_advance_f32_bf16(int device, const void* h, const void* q, const void* mask, void* out,
                          int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<bf16, AdvanceOp, float>(h, q, mask, out, m, n, stream);
}

int censor_bank_advance_bf16(int device, const void* g, const void* h, const void* mask,
                             void* out, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<bf16, CensorAdvanceOp>(h, g, mask, out, m, n, stream);
}

int censor_bank_advance_f32_bf16(int device, const void* g, const void* h, const void* mask,
                                 void* out, int64_t m, int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_tall_pair<bf16, CensorAdvanceOp, float>(h, g, mask, out, m, n, stream);
}

}  // extern "C"

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
// is taken in f32 for every pending dtype, as the reference does; e' is
// computed in the pending dtype.
//
// Both also take a bf16 pending leaf (kernels/common.py:STAGED_DTYPES,
// EF_DTYPES): B7a takes its max in f32 (exact) and stores the partials
// and the result in bf16, as the JAX kernel's are in x.dtype; B7b reads
// err in bf16 or in f32 (the err transport.init makes for f32 params),
// casts it to bf16, and rounds the payload and each operation of the blend
// to bf16 (reduce.cuh), as src/repro/kernels/quantize_ef.py:70-76 and
// kernels/ref.py state them. The f32 scale is read as given: the caller's
// core.quantize.int8_scale of a bf16 abs-max is a bf16 value.
//
// Bound: bytes, for both (a handful of flops an element). At M=4,
// n=163,597,056 in f32 on an H100 SXM (3.35 TB/s):
//   B7a reads M*n elements and writes M values:    2.62 GB, >= 0.78 ms;
//   B7b reads 2*M*n elements and writes 2*M*n:    10.47 GB, >= 3.13 ms;
// on a bf16 leaf B7a 1.31 GB, >= 0.39 ms; B7b 5.24 GB, >= 1.56 ms (with
// an f32 err 6.54 GB, >= 1.95 ms). B7b's bf16 build moves 16-byte tiles
// of 8 elements (Tile16: err's 8 in f32 in two 16-byte loads), as B4's
// and B9's do.
//
// Design: B7a is a two-pass reduction without atomics. Max is exact and
// does not depend on order, so unlike the sums of B1/B5/B8 its
// partitioning is free: pass 1 gives each (span, worker) block a span of
// kAbsmaxSpan = 32,768 elements (16 chunks, 128 KB at f32) and stores one
// partial, so the block reduction, its barrier and the store come once
// a span, not once per 8 KB chunk (4,993 partials a worker at
// chb-paper-lm-124m's width, not 79,882). Where n is a multiple of the
// elements in 16 bytes and x is 16-byte aligned (every row then is), a
// thread loads float4s (f32) or double2s (f64), kAbsmaxBatch of them
// before it folds any (128 bytes in flight a thread); otherwise it loads
// kAbsmaxBatch elements at a time. The launcher decides, as B9's does.
// Pass 2 runs one block a worker, each thread issuing kFinishItems loads
// before it folds, so a worker's partials are in flight at once rather
// than one a thread. Its max keeps a NaN (maxval), so it equals torch.amax
// and B5's abs-max on the same pending, NaN rows included (which NaN
// payload a NaN row returns may differ); |-0.0| is +0, and a row of zeros
// gives +0.
// B7a has a second design for rows of one chunk (n <= kChunk) on many
// workers (the fed mesh: M = 70,000-10^5 rows of 16), which the wrapper
// picks by B1's rule (kernels/common.py:sqnorm_path): one launch, no
// partials. There the two-pass design gives a row of 8 double2s a
// 256-thread block sized for a 32,768-element span (8 threads load, all
// 256 walk the guarded rounds and the barrier), then a second launch of M
// blocks that each fold one partial. The warp design (absmax_seg_rows)
// gives a row 2^shift lanes of a warp, the power of two >= min(its 16-byte
// vectors, 32), so every lane issues a 16-byte load (f64, n = 16: 8 lanes
// a row, 4 rows a warp); a lane keeps kRowItems rows' loads in flight and
// walks its row with a stride of 2^shift, then each segment folds its
// lanes with __shfl_xor_sync. Element loads where n is not a multiple of
// the vector or x is off 16-byte alignment, as in pass 1. Max is exact and
// order-free, so any partition gives the two-pass design's bits (which NaN
// payload a NaN row returns aside). The body holds a few registers at any
// n <= kChunk (kRowItems values and maxes), so it needs no item builds.
// B7b is B6's int8 round trip and EF blend (fused_step.cu) without the
// bank advance (int8_ef below), with the same intrinsics in the same order
// and a clip that keeps a NaN (clampval), so its err' equals B6's bit for
// bit. It has one design for every shape, the tall tiling of B9 and B4
// (tall_quant_kernel below): a block covers up to 256 columns of two rows
// a thread, so the fed mesh's rows of 8 double2s share a block 32 to a
// sweep, where a 256-thread block a row tile left 248 threads idle. Where
// n is a multiple of the elements in 16 bytes and pending, err, payload
// and new_e are 16-byte aligned, it moves float4s or double2s; otherwise
// elements. The launcher decides. B7a's two-pass design puts the worker on
// grid y, B7b's grid y walks the row tiles: both walk any M (reduce.cuh).
#include "reduce.cuh"

using namespace repro;

// Elements of a worker row behind one B7a partial. It depends on nothing
// but itself, so the partial count ceil(n / kAbsmaxSpan) is a function of
// the shape (build.ABSMAX_SPAN mirrors it; the launcher rejects another
// count).
constexpr int64_t kAbsmaxSpan = 16 * kChunk;
constexpr int kAbsmaxBatch = 8;    // loads a thread issues before it folds
// partials a pass-2 thread loads before it folds: 20 covers the 4,993 of
// chb-paper-lm-124m's width in one round
constexpr int kFinishItems = 20;

inline int64_t num_spans(int64_t n) { return (n + kAbsmaxSpan - 1) / kAbsmaxSpan; }

// pass 1 on rows of nv 16-byte vectors (float4 / double2 / 8 bf16),
// 16-byte aligned. The max runs in the compute dtype A (f32 for bf16:
// exact) and each partial is stored in T, as the JAX kernel's partials
// are in x.dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_vec_partials(const T* __restrict__ x, T* __restrict__ part, int64_t m, int64_t nv,
                    int64_t nspans) {
  using V = typename Vec16<T>::type;
  using A = calc_t<T>;
  constexpr int64_t kSpanV = kAbsmaxSpan / (16 / sizeof(T));
  constexpr int kRounds = (int)(kSpanV / (kThreads * kAbsmaxBatch));
  __shared__ A scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kSpanV + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's block_reduce is done with scratch
    if (w != blockIdx.y) __syncthreads();
    const V* xw = reinterpret_cast<const V*>(x) + w * nv;
    A am = A(0);
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
      V v[kAbsmaxBatch];
#pragma unroll
      for (int k = 0; k < kAbsmaxBatch; ++k) {
        const int64_t j = base + (int64_t)(r * kAbsmaxBatch + k) * kThreads;
        v[k] = j < nv ? xw[j] : Vec16<T>::zero();
      }
#pragma unroll
      for (int k = 0; k < kAbsmaxBatch; ++k) am = Vec16<T>::absmax(am, v[k]);
    }
    am = block_reduce(am, A(0), MaxOp(), scratch);
    if (threadIdx.x == 0) part[w * nspans + c] = Cast<T>::of(am);
  }
}

// pass 1 element by element (n not a multiple of the vector, or x off
// 16-byte alignment)
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_partials(const T* __restrict__ x, T* __restrict__ part, int64_t m, int64_t n,
                int64_t nspans) {
  using A = calc_t<T>;
  constexpr int kRounds = (int)(kAbsmaxSpan / (kThreads * kAbsmaxBatch));
  __shared__ A scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kAbsmaxSpan + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's block_reduce is done with scratch
    if (w != blockIdx.y) __syncthreads();
    const T* xw = x + w * n;
    A am = A(0);
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
      A v[kAbsmaxBatch];
#pragma unroll
      for (int k = 0; k < kAbsmaxBatch; ++k) {
        const int64_t j = base + (int64_t)(r * kAbsmaxBatch + k) * kThreads;
        v[k] = j < n ? widen(xw[j]) : A(0);
      }
#pragma unroll
      for (int k = 0; k < kAbsmaxBatch; ++k) am = maxval(am, absval(v[k]));
    }
    am = block_reduce(am, A(0), MaxOp(), scratch);
    if (threadIdx.x == 0) part[w * nspans + c] = Cast<T>::of(am);
  }
}

// pass 2: one block a worker (grid x) folds its nspans partials, each
// thread kFinishItems loads at a time, all issued before it folds
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_finish(const T* __restrict__ part, T* __restrict__ out, int64_t nspans) {
  using A = calc_t<T>;
  __shared__ A scratch[kThreads / 32];
  const T* p = part + (int64_t)blockIdx.x * nspans;
  A am = A(0);
  for (int64_t i0 = threadIdx.x; i0 < nspans; i0 += (int64_t)kThreads * kFinishItems) {
    A v[kFinishItems];
#pragma unroll
    for (int k = 0; k < kFinishItems; ++k) {
      const int64_t i = i0 + (int64_t)k * kThreads;
      v[k] = i < nspans ? widen(p[i]) : A(0);
    }
#pragma unroll
    for (int k = 0; k < kFinishItems; ++k) am = maxval(am, v[k]);
  }
  am = block_reduce(am, A(0), MaxOp(), scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = Cast<T>::of(am);
}

// The warp design: rows of ncols items E (elements, or 16-byte vectors of
// them) on 2^shift lanes each, kThreads >> shift rows a sweep of a block,
// kRowItems sweeps a block; grid x walks the blocks' row tiles.
inline unsigned seg_row_blocks(int64_t m, int shift) {
  const int64_t tile = (int64_t)(kThreads >> shift) * kRowItems;
  const int64_t b = (m + tile - 1) / tile;
  return (unsigned)(b < kMaxGridX ? b : kMaxGridX);
}

template <typename T, typename E>
__global__ void __launch_bounds__(kThreads)
absmax_seg_rows(const E* __restrict__ x, T* __restrict__ out, int64_t m, int64_t ncols,
                int shift) {
  using A = calc_t<T>;
  const int seg = 1 << shift;
  const int sub = threadIdx.x & (seg - 1);         // the lane's place in its row
  const int64_t sweep = kThreads >> shift;         // rows a sweep of the block covers
  const int64_t tile = sweep * kRowItems;          // rows a block covers
  const int64_t r = threadIdx.x >> shift;
  // the walk is uniform over the block, so every lane reaches the shuffles
  for (int64_t b0 = (int64_t)blockIdx.x * tile; b0 < m; b0 += (int64_t)gridDim.x * tile) {
    A am[kRowItems];
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) am[k] = A(0);
    for (int64_t j = sub; j < ncols; j += seg) {
      E v[kRowItems];
#pragma unroll
      for (int k = 0; k < kRowItems; ++k) {
        const int64_t w = b0 + r + k * sweep;
        v[k] = w < m ? x[w * ncols + j] : E{};
      }
#pragma unroll
      for (int k = 0; k < kRowItems; ++k) am[k] = fold_abs(am[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      for (int off = seg >> 1; off > 0; off >>= 1)
        am[k] = maxval(am[k], __shfl_xor_sync(0xffffffffu, am[k], off));
      const int64_t w = b0 + r + k * sweep;
      if (sub == 0 && w < m) out[w] = Cast<T>::of(am[k]);
    }
  }
}

// B7b's int8 round trip and EF blend of one element of pending p and err
// e: B6's arithmetic without the bank advance (fused_step.cu:int8_advance),
// in its order. The quotient is taken in f32 (rintf rounds half to even,
// like torch.round; clampval keeps a NaN), the payload is cast to the
// pending dtype, and e' = mk*(p - q) + keep*e with keep = 1 - mk. On a
// 16-byte vector, the same on each element.
template <typename T>
__device__ __forceinline__ void int8_ef(T p, T e, T mk, T keep, float sc, T& pay, T& ne) {
  const float q = clampval(rintf(__fdiv_rn((float)p, sc)), -127.0f, 127.0f);
  pay = (T)__fmul_rn(q, sc);
  ne = add(mul(mk, sub(p, pay)), mul(keep, e));
}
__device__ __forceinline__ void int8_ef(float4 p, float4 e, float mk, float keep, float sc,
                                        float4& pay, float4& ne) {
  int8_ef(p.x, e.x, mk, keep, sc, pay.x, ne.x);
  int8_ef(p.y, e.y, mk, keep, sc, pay.y, ne.y);
  int8_ef(p.z, e.z, mk, keep, sc, pay.z, ne.z);
  int8_ef(p.w, e.w, mk, keep, sc, pay.w, ne.w);
}
__device__ __forceinline__ void int8_ef(double2 p, double2 e, double mk, double keep, float sc,
                                        double2& pay, double2& ne) {
  int8_ef(p.x, e.x, mk, keep, sc, pay.x, ne.x);
  int8_ef(p.y, e.y, mk, keep, sc, pay.y, ne.y);
}
// a bf16 pending element, err in bf16 or f32 cast to bf16 first (the JAX
// kernel's e.astype(pending.dtype)): the quotient and the payload's
// product in f32, each operation of the blend rounded to bf16
// (reduce.cuh), as B6's bf16 build does
__device__ __forceinline__ void int8_ef(bf16 p, bf16 e, bf16 mk, bf16 keep, float sc, bf16& pay,
                                        bf16& ne) {
  const float q = clampval(rintf(__fdiv_rn(widen(p), sc)), -127.0f, 127.0f);
  pay = Cast<bf16>::of(__fmul_rn(q, sc));
  ne = add(mul(mk, sub(p, pay)), mul(keep, e));
}
__device__ __forceinline__ void int8_ef(bf16 p, float e, bf16 mk, bf16 keep, float sc, bf16& pay,
                                        bf16& ne) {
  int8_ef(p, Cast<bf16>::of(e), mk, keep, sc, pay, ne);
}
template <typename TE>
__device__ __forceinline__ void int8_ef(const Pack<bf16, 8>& p, const Pack<TE, 8>& e, bf16 mk,
                                        bf16 keep, float sc, Pack<bf16, 8>& pay,
                                        Pack<bf16, 8>& ne) {
#pragma unroll
  for (int i = 0; i < 8; ++i) int8_ef(p.v[i], e.v[i], mk, keep, sc, pay.v[i], ne.v[i]);
}

// B7b on the tall tiling of B9 and B4 (censor.cu:tall_pair_kernel) over an
// (M, ncols) leaf of EP (pending, payload, new_e) and EE (err): elements
// (EP = T, EE = T or f32 on a bf16 leaf) or 16-byte tiles of them
// (reduce.cuh's Tile16): a block covers 2^shift columns and
// kThreads >> shift rows a sweep, kRows sweeps (reduce.cuh's tall_grid); a
// thread issues the loads of pending and err of all its rows, and reads
// mask[w] and scale[w] once a row, before it computes any.
template <typename T, typename EP, typename EE, int kRows>
__global__ void __launch_bounds__(kThreads)
tall_quant_kernel(const EP* __restrict__ p, const EE* __restrict__ e,
                  const float* __restrict__ mask, const float* __restrict__ scale,
                  EP* __restrict__ payload, EP* __restrict__ new_e, int64_t m, int64_t ncols,
                  int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= ncols) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRows;          // rows a block covers
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    EP pv[kRows];
    EE ev[kRows];
    float mk[kRows], sc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        pv[k] = p[w * ncols + j];
        ev[k] = e[w * ncols + j];
        mk[k] = mask[w];
        sc[k] = scale[w];
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        const T mkw = Cast<T>::of(mk[k]);
        EP pay, ne;
        int8_ef(pv[k], ev[k], mkw, sub(Cast<T>::of(1.0f), mkw), sc[k], pay, ne);
        payload[w * ncols + j] = pay;
        new_e[w * ncols + j] = ne;
      }
    }
  }
}

template <typename T>
static int launch_absmax(const void* x, void* part, void* out, int64_t m, int64_t n,
                         int64_t nspans, void* stream) {
  if (m < 1 || m > kMaxGridX || n < 1 || nspans != num_spans(n) || nspans > kMaxGridX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)nspans, worker_blocks(m));
  constexpr int64_t per_vec = 16 / sizeof(T);
  if (n % per_vec == 0 && aligned16(x)) {
    absmax_vec_partials<T><<<grid, kThreads, 0, s>>>((const T*)x, (T*)part, m, n / per_vec,
                                                    nspans);
  } else {
    absmax_partials<T><<<grid, kThreads, 0, s>>>((const T*)x, (T*)part, m, n, nspans);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  absmax_finish<T><<<(unsigned)m, kThreads, 0, s>>>((const T*)part, (T*)out, nspans);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_absmax_warp(const void* x, void* out, int64_t m, int64_t n, void* stream) {
  if (!warp_rows_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int64_t per_vec = 16 / sizeof(T);
  if (n % per_vec == 0 && aligned16(x)) {
    using V = typename Vec16<T>::type;
    const int shift = pow2_shift(n / per_vec, 32);
    absmax_seg_rows<T, V><<<seg_row_blocks(m, shift), kThreads, 0, s>>>(
        (const V*)x, (T*)out, m, n / per_vec, shift);
  } else {
    const int shift = pow2_shift(n, 32);
    absmax_seg_rows<T, T><<<seg_row_blocks(m, shift), kThreads, 0, s>>>((const T*)x, (T*)out, m,
                                                                       n, shift);
  }
  return (int)cudaGetLastError();
}

// 16-byte tiles (float4s, double2s, or 8 bf16 elements with their 8 err
// values in bf16 or f32) where every row of pending, err, payload and
// new_e starts on a 16-byte boundary, elements otherwise. T is the pending
// dtype, TE err's.
template <typename T, typename TE = T>
static int launch_quantize_ef(const void* p, const void* e, const void* mask, const void* scale,
                              void* payload, void* new_e, int64_t m, int64_t n, void* stream) {
  if (!tall_grid_ok(m, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int64_t per_vec = 16 / sizeof(T);
  if (n % per_vec == 0 && aligned16(p) && aligned16(e) && aligned16(payload) &&
      aligned16(new_e)) {
    using VP = typename Tile16<T, TE>::A;
    using VE = typename Tile16<T, TE>::B;
    const int64_t nv = n / per_vec;
    const int shift = pow2_shift(nv, kThreads);
    tall_quant_kernel<T, VP, VE, kAdvanceRows>
        <<<tall_grid(m, nv, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const VP*)p, (const VE*)e, (const float*)mask, (const float*)scale, (VP*)payload,
            (VP*)new_e, m, nv, shift);
  } else {
    const int shift = pow2_shift(n, kThreads);
    tall_quant_kernel<T, T, TE, kAdvanceRows>
        <<<tall_grid(m, n, shift, kAdvanceRows), kThreads, 0, s>>>(
            (const T*)p, (const TE*)e, (const float*)mask, (const float*)scale, (T*)payload,
            (T*)new_e, m, n, shift);
  }
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

int absmax_batched_warp_f32(int device, const void* x, void* out, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax_warp<float>(x, out, m, n, stream);
}

int absmax_batched_warp_f64(int device, const void* x, void* out, int64_t m, int64_t n,
                            void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax_warp<double>(x, out, m, n, stream);
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

// B7a on a bf16 leaf (its max in f32, the partials and the result in
// bf16), both designs; B7b on a bf16 pending leaf with err in bf16, and
// in f32 (_bf16_f32: transport.init's err of f32 params)
int absmax_batched_bf16(int device, const void* x, void* part, void* out, int64_t m, int64_t n,
                        int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax<bf16>(x, part, out, m, n, nchunks, stream);
}

int absmax_batched_warp_bf16(int device, const void* x, void* out, int64_t m, int64_t n,
                             void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_absmax_warp<bf16>(x, out, m, n, stream);
}

int quantize_ef_batched_bf16(int device, const void* p, const void* e, const void* mask,
                             const void* scale, void* payload, void* new_e, int64_t m, int64_t n,
                             void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_quantize_ef<bf16>(p, e, mask, scale, payload, new_e, m, n, stream);
}

int quantize_ef_batched_bf16_f32(int device, const void* p, const void* e, const void* mask,
                                 const void* scale, void* payload, void* new_e, int64_t m,
                                 int64_t n, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_quantize_ef<bf16, float>(p, e, mask, scale, payload, new_e, m, n, stream);
}

}  // extern "C"

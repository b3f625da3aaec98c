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
//
// bf16 banks (B1-B11 and the worker fold): each element operation
// on bf16 operands runs in f32 and rounds to bf16 (__float2bfloat16_rn), as
// a PyTorch eager op on bf16 tensors does, never as a native bf16
// instruction (which rounds the exact result once, where PyTorch rounds it
// to f32 and then to bf16, and the two can differ). Sums, abs-maxes and
// eq. (4) (B3 too) run in the compute dtype, calc_t
// (kernels/common.py:compute_dtype): f32 for a bf16 bank, a bank's own
// dtype otherwise, so the f32 and f64 code is what it was.
#pragma once

#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

// the compute dtype of a bank dtype
template <typename T>
struct Calc {
  using type = T;
};
template <>
struct Calc<bf16> {
  using type = float;
};
template <typename T>
using calc_t = typename Calc<T>::type;

// conversions rounding as torch's .to() does (a double goes to bf16
// through float, as c10::BFloat16 converts it)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// a bank element in its compute dtype (exact)
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

template <typename TO>
struct Cast;
template <>
struct Cast<float> {
  template <typename TI>
  __device__ __forceinline__ static float of(TI x) { return to_f32(x); }
};
template <>
struct Cast<double> {
  __device__ __forceinline__ static double of(double x) { return x; }
  __device__ __forceinline__ static double of(float x) { return (double)x; }
  __device__ __forceinline__ static double of(bf16 x) { return (double)__bfloat162float(x); }
};
template <>
struct Cast<bf16> {
  __device__ __forceinline__ static bf16 of(bf16 x) { return x; }
  template <typename TI>
  __device__ __forceinline__ static bf16 of(TI x) { return __float2bfloat16_rn(to_f32(x)); }
};

// the element operations of a bf16 bank: f32, then one rounding
__device__ __forceinline__ bf16 add(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(widen(a), widen(b)));
}
__device__ __forceinline__ bf16 sub(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fsub_rn(widen(a), widen(b)));
}
__device__ __forceinline__ bf16 mul(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(widen(a), widen(b)));
}
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
// Partials of a bf16 bank (B5's abs-maxes) fold in f32 (exact for a max).
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
finish_partials(const T* __restrict__ part, T* __restrict__ out, int64_t nchunks,
                calc_t<T> identity) {
  __shared__ calc_t<T> scratch[kThreads / 32];
  const T* p = part + (int64_t)blockIdx.x * nchunks;
  const Op op{};
  calc_t<T> acc = identity;
  for (int64_t i = threadIdx.x; i < nchunks; i += kThreads) acc = op(acc, widen(p[i]));
  acc = block_reduce(acc, identity, op, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = Cast<T>::of(acc);
}

// The warp-rows design of the sum-of-squares reductions (B1, B8, B5) on
// rows of one chunk (n <= kChunk) on many workers: a warp a worker, one
// launch, no partials. `Row` loads one element's operands (`load`, an
// offset into the (M, n) operands) and gives the element in the bank
// dtype (`value`): B1 g - ghat, B8 x, B5 (g - ghat) + e. Each lane sums
// the squares of (float)value; with kAbsmax (B5) it also takes the
// abs-max of the bank dtype's values, in its compute dtype (exact).
//
// Lane l runs the two-pass design's threads l, l + 32, ..., l + 224 of the
// worker's one block ("virtual warps" 0-7): each virtual thread's fold,
// each virtual warp's shuffle tree and the tree over the eight warp
// results are block_reduce's, in its order, so the two designs give the
// same bits. Two steps of the two-pass order are left out because they
// are exact: block_reduce pads the eight warp results with the identity
// up to a warp (the steps at offsets 16 and 8 fold it into each), and
// finish_partials folds identity with the one partial. A sum of squares
// that starts from +0.0 is >= +0.0 or NaN, and x + 0.0 is x for every such
// x; an abs-max from T(0) is the same, and maxval(x, T(0)) and
// maxval(T(0), x) are x. A virtual warp that holds no element (n <= 224)
// gives the identity in both designs.
//
// kN is the items a virtual thread folds: kItems, or 1 where n <= kThreads
// (its items k >= 1 lie past the row then). The one-item build folds the
// same elements in the same order with fewer registers (f64 B5: 43
// against 92 under ptxas on sm_90a), so more warps an SM keep loads in
// flight (B5 at M = 10^5, n = 16, f64 on an H100: 0.071 -> 0.030 ms).
template <typename Row, bool kAbsmax, int kN>
__device__ __forceinline__ void warp_row_reduce(const Row& row, int64_t w, int64_t n, float* sq,
                                                typename Row::T* am) {
  using T = typename Row::T;
  using A = calc_t<T>;
  using Item = typename Row::Item;
  const int lane = threadIdx.x & 31;
  const int64_t off = w * n;
  const int held = (int)(((n < kThreads ? n : kThreads) + 31) / 32);   // virtual warps with data
  float s[kWarps];
  A a[kWarps];
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    float acc = 0.0f;
    A mx = A(0);
    if (v < held) {          // the same for every lane of the warp
      const int64_t base = (int64_t)v * 32 + lane;
      Item it[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int64_t j = base + (int64_t)k * kThreads;
        it[k] = j < n ? row.load(off + j) : Item{};
      }
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        if (base + (int64_t)k * kThreads < n) {
          const T p = row.value(it[k]);
          const float x = to_f32(p);
          acc = add(acc, mul(x, x));
          if constexpr (kAbsmax) mx = maxval(mx, absval(widen(p)));
        }
      }
      acc = warp_reduce(acc, SumOp());
      if constexpr (kAbsmax) mx = warp_reduce(mx, MaxOp());
    }
    s[v] = acc;
    a[v] = mx;
  }
  // block_reduce's tree over the warp results (warp 0's shuffles at
  // offsets 4, 2, 1)
  *sq = add(add(add(s[0], s[4]), add(s[2], s[6])), add(add(s[1], s[5]), add(s[3], s[7])));
  if constexpr (kAbsmax)
    *am = Cast<T>::of(maxval(maxval(maxval(a[0], a[4]), maxval(a[2], a[6])),
                             maxval(maxval(a[1], a[5]), maxval(a[3], a[7]))));
}

// A warp-rows kernel's worker: the warp's index over the grid; a whole
// warp is past m or none of it, so the shuffles see all 32 lanes.
__device__ __forceinline__ int64_t warp_row() {
  return (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// The rows of B1 (g cast to the bank dtype, minus ghat) and B8 (its one
// operand); B5's, (g - ghat) + e, are fused_step.cu's.
template <typename TG, typename TH = TG>
struct DeltaRow {
  using T = TH;
  struct Item { TG g; TH h; };
  const TG* __restrict__ g;
  const TH* __restrict__ h;
  __device__ __forceinline__ Item load(int64_t i) const { return {g[i], h[i]}; }
  __device__ __forceinline__ T value(const Item& x) const { return sub(Cast<TH>::of(x.g), x.h); }
};
template <typename TT>
struct PlainRow {
  using T = TT;
  struct Item { T x; };
  const T* __restrict__ x;
  __device__ __forceinline__ Item load(int64_t i) const { return {x[i]}; }
  __device__ __forceinline__ T value(const Item& v) const { return v.x; }
};

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

// The grid of a warp-rows launch: the workers on grid x, kWarps a block.
inline bool warp_rows_ok(int64_t m, int64_t n) {
  return m >= 1 && n >= 1 && n <= kChunk && (m + kWarps - 1) / kWarps <= kMaxGridX;
}
inline unsigned warp_row_blocks(int64_t m) { return (unsigned)((m + kWarps - 1) / kWarps); }
// whether a warp-rows kernel takes its one-item build (warp_row_reduce)
inline bool warp_rows_one_item(int64_t n) { return n <= kThreads; }

// 16 bytes of one bank dtype, and B7a's fold of their magnitudes
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ __forceinline__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
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
  __device__ __forceinline__ static double absmax(double am, double2 v) {
    return maxval(maxval(am, absval(v.x)), absval(v.y));
  }
};

// kV elements of T on a 16-byte boundary: the 16-byte tile of a bf16 bank
// (kV = 8), and the same kV elements of its f32 operand (32 bytes, two
// 16-byte accesses)
template <typename T, int kV>
struct __align__(16) Pack {
  T v[kV];
};

// The 16-byte tiles of a tall pass (B4, B9, B7b, B10, B11): a bank row's
// 16 bytes (A) and another operand's same elements (B): float4s,
// double2s, or on a bf16 bank 8 elements, of the operand in bf16 or f32
// (16 or 32 bytes)
template <typename T, typename TB>
struct Tile16 {
  using A = Pack<T, 16 / sizeof(T)>;
  using B = Pack<TB, 16 / sizeof(T)>;
};
template <>
struct Tile16<float, float> {
  using A = float4;
  using B = float4;
};
template <>
struct Tile16<double, double> {
  using A = double2;
  using B = double2;
};

// 16 bytes of a bf16 leaf (B7a's vector loads), its abs-max folded in f32
// (exact)
template <>
struct Vec16<bf16> {
  using type = Pack<bf16, 8>;
  __device__ __forceinline__ static type zero() { return type{}; }
  __device__ __forceinline__ static float absmax(float am, const type& v) {
#pragma unroll
    for (int i = 0; i < 8; ++i) am = maxval(am, absval(widen(v.v[i])));
    return am;
  }
};

// One operation of a pass that runs on elements (E = T) or on 16-byte
// vectors of them (E = Vec16<T>::type, or a Pack on a bf16 bank): out =
// op(a, mk, b) on each element, and the fold of |v| into a running
// abs-max. On a bf16 bank b may be in f32 (B4's g, B9's payload): it is
// cast to the bank dtype first, as the JAX kernels' astype(h.dtype).
template <typename T, typename Op>
__device__ __forceinline__ T apply_op(const Op& op, T a, T mk, T b) { return op(a, mk, b); }
template <typename T, typename TB, typename Op>
__device__ __forceinline__ T apply_op(const Op& op, T a, T mk, TB b) {
  return op(a, mk, Cast<T>::of(b));
}
template <typename Op, typename T, typename TB, int kV>
__device__ __forceinline__ Pack<T, kV> apply_op(const Op& op, const Pack<T, kV>& a, T mk,
                                                const Pack<TB, kV>& b) {
  Pack<T, kV> r;
#pragma unroll
  for (int i = 0; i < kV; ++i) r.v[i] = op(a.v[i], mk, Cast<T>::of(b.v[i]));
  return r;
}
template <typename Op>
__device__ __forceinline__ float4 apply_op(const Op& op, float4 a, float mk, float4 b) {
  return make_float4(op(a.x, mk, b.x), op(a.y, mk, b.y), op(a.z, mk, b.z), op(a.w, mk, b.w));
}
template <typename Op>
__device__ __forceinline__ double2 apply_op(const Op& op, double2 a, double mk, double2 b) {
  return make_double2(op(a.x, mk, b.x), op(a.y, mk, b.y));
}
template <typename T>
__device__ __forceinline__ T fold_abs(T am, T v) { return maxval(am, absval(v)); }
__device__ __forceinline__ float fold_abs(float am, float4 v) {
  return Vec16<float>::absmax(am, v);
}
__device__ __forceinline__ double fold_abs(double am, double2 v) {
  return Vec16<double>::absmax(am, v);
}
// a bf16 leaf's abs-max runs in f32 (exact; B7a rounds it back once)
__device__ __forceinline__ float fold_abs(float am, bf16 v) {
  return maxval(am, absval(widen(v)));
}
__device__ __forceinline__ float fold_abs(float am, const Pack<bf16, 8>& v) {
  return Vec16<bf16>::absmax(am, v);
}

// B9's bank advance of one element, the arithmetic mask form
// ghat + mk * payload (a = ghat, b = payload)
struct AdvanceOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T h, T mk, T q) const { return add(h, mul(mk, q)); }
};
// B4's, by the raw gradient: ghat + mk * (g - ghat) (a = ghat, b = g),
// B2's ghat' to the bit (fused_step.cu:dense_advance)
struct CensorAdvanceOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T h, T mk, T g) const {
    return add(h, mul(mk, sub(g, h)));
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

// The tiling of an elementwise pass over a tall bank (B2/B6's pass 1, B10,
// B9, B4, B7b): a block covers 2^shift columns, the power of two >= min(n,
// kThreads), and kThreads >> shift rows a sweep, `rows` sweeps (kRowItems,
// or B9's, B4's and B7b's two), so a warp reads whole rows of a narrow
// bank and no thread divides by n to find its worker.
// The least shift with 2^shift >= min(n, cap), cap a power of two:
inline int pow2_shift(int64_t n, int cap) {
  int s = 0;
  while ((int64_t(1) << s) < n && (1 << s) < cap) ++s;
  return s;
}
// Rows a thread of B9's, B4's and B7b's tall passes holds: on an H100 at
// M = 70,000, n = 16, f64 B10's four rows a thread took B9 91 registers
// (two blocks an SM) and 0.0078 ms, two rows 40-44 registers and 0.006 ms,
// one row 0.0063, with the same time at full width
// (benchmarks_torch/kernel_ab.py --only B9).
constexpr int kAdvanceRows = 2;
// the grid: x the column tiles, y the row tiles (walked with a stride past
// grid y's limit)
inline bool tall_grid_ok(int64_t m, int64_t n) {
  return m >= 1 && n >= 1 && (n + kThreads - 1) / kThreads <= kMaxGridX;
}
inline dim3 tall_grid(int64_t m, int64_t n, int shift, int rows = kRowItems) {
  const int64_t tile = (int64_t)(kThreads >> shift) * rows;
  const int64_t y = (m + tile - 1) / tile;
  return dim3((unsigned)((n + (1 << shift) - 1) >> shift),
              (unsigned)(y < kMaxGridY ? y : kMaxGridY));
}

}  // namespace repro

// Every library exports this, so a launcher's error code reads as text.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

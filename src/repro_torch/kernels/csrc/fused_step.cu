// The fused CHB step on Hopper: everything after the censor decision, plus
// the int8 statistics pass before it.
//
//   B2 fused_dense_step   replaces src/repro/kernels/fused_step.py:fused_dense_step
//   B5 int8_stats_batched replaces src/repro/kernels/fused_step.py:int8_stats_batched
//   B6 fused_int8_step    replaces src/repro/kernels/fused_step.py:fused_int8_step
//
// Bound: bytes, for all three (a handful of flops an element). At M=4,
// n=163,597,056 in f32 on an H100 SXM (3.35 TB/s):
//   B2 reads (2M+2)*n and writes (M+2)*n elements: 10.47 GB, >= 3.13 ms;
//   B5 reads 3*M*n elements and writes 2*M scalars:  7.85 GB, >= 2.34 ms;
//   B6 reads (3M+2)*n and writes (2M+2)*n elements: 15.71 GB, >= 4.69 ms.
// On a tall bank (M >> n) B2 and B6 have a second floor: the worker sum is
// a left fold, M - 1 dependent adds a column, whatever the card's width.
//
// Design: the TPU kernels tile (rows, 128) lane blocks and keep the whole
// worker axis in one VMEM block. Here the arrays stay flat, and B2 and B6
// have two designs, which the wrapper picks by shape
// (kernels/common.py:fold_path); both give the same bits.
//
// One pass (where the columns fill the card, or M is small): each thread
// owns one column j and walks the M workers in index order, so every load
// and store of a worker row is coalesced across the warp, the worker sum
// is a left fold from ghat'_0 (the fold of core.util's tree_sum_leading),
// and the eq.-(4) epilogue runs on the register-held sum. The int8 pending
// delta (g - ghat) + e and its dequantized payload live only in registers.
//
// Tall (M >> n, so few columns, each a long chain): the part that does not
// depend on the fold leaves the chain. Pass 1 (tall_advance_kernel) runs
// the bank advance, and for int8 the pending delta, code, payload and EF
// blend, over all M*n elements on the whole card, several rows in flight
// a thread, and writes ghat' (and e'). Pass 2 (fold_columns_kernel) folds
// ghat' per tile of up to 32 columns, one lane a column of warp 0, from a
// ring of three shared-memory stages, so the chain of adds never waits on
// a global load. One SM feeds the whole chain of a narrow bank (n <= 32),
// whose stage is one span of ghat': one thread fills it with a TMA bulk
// copy, and mbarriers hand stages between it and the folding warp. On
// wider banks warps 1-7 copy a tile's strided rows with cp.async, and a
// block barrier hands each stage over. The fold starts from -0.0, not
// from ghat'_0: -0.0 + x is x for every x (+0.0 and -0.0 included), so
// the sum has the bits of the fold from ghat'_0.
//
// Both designs share the per-element arithmetic (dense_advance,
// int8_advance) and the eq.-(4) epilogue (hb_step). alpha and beta are
// runtime arguments, so one build serves any hyperparameters. B5 is a
// two-pass reduction shaped like B1 (censor.cu): fixed order, no atomics,
// the M=1 call bitwise equal to a batched slice, any M (its blocks walk
// the workers with a stride of gridDim.y, reduce.cuh). Offsets are 64-bit:
// M*n passes 2^31 one model size up.
#include "reduce.cuh"

using namespace repro;

// ghat + mk * (g - ghat): the bank advance in the arithmetic mask form
template <typename T>
__device__ __forceinline__ T dense_advance(T g, T h, float mk) {
  return add(h, mul((T)mk, sub(g, h)));
}

// The int8 round trip and EF blend of one element; returns ghat', writes
// e'. The round trip is in f32: rintf rounds half to even, like
// torch.round, and clampval keeps a NaN.
template <typename T>
__device__ __forceinline__ T int8_advance(T g, T h, T e, float mkf, float sc, T* new_e) {
  const T pending = add(sub(g, h), e);
  const float q = clampval(rintf(__fdiv_rn((float)pending, sc)), -127.0f, 127.0f);
  const T payload = (T)__fmul_rn(q, sc);
  const T mk = (T)mkf;
  *new_e = add(mul(mk, sub(pending, payload)), mul(sub(T(1), mk), e));
  return add(h, mul(mk, payload));
}

// eq. (4): (t - alpha*agg) + beta*(t - t_prev)
template <typename T>
__device__ __forceinline__ T hb_step(T t, T prev, T agg, T alpha, T beta) {
  return add(sub(t, mul(alpha, agg)), mul(beta, sub(t, prev)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dense_step_kernel(const T* __restrict__ g, const T* __restrict__ h,
                        const T* __restrict__ theta, const T* __restrict__ prev,
                        const float* __restrict__ mask, T* __restrict__ new_h,
                        T* __restrict__ agg_out, T* __restrict__ theta_out,
                        int64_t m, int64_t n, T alpha, T beta) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    T agg = T(0);
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      const T ng = dense_advance(g[o], h[o], mask[w]);
      new_h[o] = ng;
      agg = w == 0 ? ng : add(agg, ng);
    }
    agg_out[j] = agg;
    theta_out[j] = hb_step(theta[j], prev[j], agg, alpha, beta);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_stats_partials(const T* __restrict__ g, const T* __restrict__ h,
                    const T* __restrict__ e, float* __restrict__ sq_part,
                    T* __restrict__ am_part, int64_t m, int64_t n, int64_t nchunks) {
  __shared__ float sq_scratch[kThreads / 32];
  __shared__ T am_scratch[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t base = c * kChunk + threadIdx.x;
  for (int64_t w = blockIdx.y; w < m; w += gridDim.y) {
    // the last worker's two block_reduces are done with their scratch
    if (w != blockIdx.y) __syncthreads();
    const int64_t off = w * n;
    float acc = 0.0f;
    T am = T(0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = base + (int64_t)k * kThreads;
      if (j < n) {
        const T p = add(sub(g[off + j], h[off + j]), e[off + j]);
        const float x = (float)p;
        acc = add(acc, mul(x, x));
        am = maxval(am, absval(p));
      }
    }
    acc = block_reduce(acc, 0.0f, SumOp(), sq_scratch);
    am = block_reduce(am, T(0), MaxOp(), am_scratch);
    if (threadIdx.x == 0) {
      sq_part[w * nchunks + c] = acc;
      am_part[w * nchunks + c] = am;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_int8_step_kernel(const T* __restrict__ g, const T* __restrict__ h,
                       const T* __restrict__ e, const T* __restrict__ theta,
                       const T* __restrict__ prev, const float* __restrict__ mask,
                       const float* __restrict__ scale, T* __restrict__ new_h,
                       T* __restrict__ new_e, T* __restrict__ agg_out,
                       T* __restrict__ theta_out, int64_t m, int64_t n, T alpha, T beta) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    T agg = T(0);
    for (int64_t w = 0; w < m; ++w) {
      const int64_t o = w * n + j;
      T ne;
      const T ng = int8_advance(g[o], h[o], e[o], mask[w], scale[w], &ne);
      new_e[o] = ne;
      new_h[o] = ng;
      agg = w == 0 ? ng : add(agg, ng);
    }
    agg_out[j] = agg;
    theta_out[j] = hb_step(theta[j], prev[j], agg, alpha, beta);
  }
}

// ------------------------------------------------------------ tall banks
// Pass 1: a block covers 2^shift columns (the power of two >= min(n, 256))
// and 256 >> shift rows a sweep, kRowItems sweeps: a warp reads whole rows
// of a narrow bank, and no thread divides by n to find its worker.
template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
tall_advance_kernel(const T* __restrict__ g, const T* __restrict__ h,
                    const T* __restrict__ e, const float* __restrict__ mask,
                    const float* __restrict__ scale, T* __restrict__ new_h,
                    T* __restrict__ new_e, int64_t m, int64_t n, int shift) {
  const int64_t j = ((int64_t)blockIdx.x << shift) + (threadIdx.x & ((1 << shift) - 1));
  if (j >= n) return;
  const int64_t sweep = kThreads >> shift;     // rows a sweep of the block covers
  const int64_t tile = sweep * kRowItems;      // rows a block covers
  for (int64_t w0 = (int64_t)blockIdx.y * tile + (threadIdx.x >> shift); w0 < m;
       w0 += (int64_t)gridDim.y * tile) {
    T gv[kRowItems], hv[kRowItems], ev[kRowItems];
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        gv[k] = g[w * n + j];
        hv[k] = h[w * n + j];
        if (kInt8) ev[k] = e[w * n + j];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowItems; ++k) {
      const int64_t w = w0 + k * sweep;
      if (w < m) {
        if (kInt8) {
          new_h[w * n + j] = int8_advance(gv[k], hv[k], ev[k], mask[w], scale[w], &ev[k]);
          new_e[w * n + j] = ev[k];
        } else {
          new_h[w * n + j] = dense_advance(gv[k], hv[k], mask[w]);
        }
      }
    }
  }
}

constexpr int kFoldStages = 3;                  // shared-memory ring of a fold block
// bytes of one stage: TMA-fed stages (a narrow bank, one block) are larger,
// so the chain crosses fewer stage handovers (each costs the folding warp
// a few hundred cycles); cp.async-fed ones leave room for two blocks an SM
constexpr int kBulkStageBytes = 64 * 1024;
constexpr int kCopyStageBytes = 32 * 1024;
constexpr int kFoldCols = 32;                   // columns of a tile: a lane each
constexpr int kFoldUnroll = 16;                 // rows of a chunk of the fold (fold_stage)
constexpr int kProducers = kThreads - 32;       // threads that copy (warps 1-7)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kFoldStages - 2 of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kFoldStages - 2) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1u)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// the one arrival of a phase, which also ends when `bytes` have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a TMA copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The fold's geometry: a tile of `pitch` columns (min(n, 32)) a block, and
// `rows` rows a stage (a multiple of kFoldUnroll).
struct FoldTile {
  int64_t m, n;
  int pitch, rows;
  int stage_elems;  // elements of one stage
  bool bulk;        // n <= 32 and x 16-byte aligned: a stage is one span of x
};

// Stage s of a narrow bank (one tile, pitch n): rows s*rows .. of x are
// one contiguous span, copied by one thread as one TMA bulk copy whose
// landing ends the phase of `bar`; its last few bytes past a multiple of
// 16, if any, by plain loads before the arrival (which releases them).
template <typename T>
__device__ __forceinline__ void stage_bulk(T* buf, const T* __restrict__ x, int64_t s,
                                           const FoldTile& f, uint64_t* bar) {
  const int64_t r0 = s * f.rows;
  const int64_t left = f.m - r0;
  const int64_t elems = (left < f.rows ? left : f.rows) * f.n;
  const T* src = x + r0 * f.n;
  const unsigned bytes = (unsigned)(elems * (int64_t)sizeof(T)) & ~15u;
  for (int64_t i = bytes / sizeof(T); i < elems; ++i) buf[i] = src[i];
  mbar_expect(bar, bytes);
  if (bytes) bulk_copy(buf, src, bytes, bar);
}

// Stage s of a tile whose rows are strided (n > 32): one cp.async an
// element, by the producer threads.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ x, int64_t s,
                                           const FoldTile& f, int64_t c0, int cols) {
  const int64_t r0 = s * f.rows;
  const int64_t left = f.m - r0;
  const int valid = left < f.rows ? (int)left : f.rows;
  for (int i = (int)threadIdx.x - 32; i < valid * f.pitch; i += kProducers) {
    const int r = i / f.pitch, c = i - r * f.pitch;
    if (c < cols) cp_async_elem(buf + i, x + (r0 + r) * f.n + c0 + c);
  }
}

// acc folded with rows 0 .. rows - 1 of one stage, p pointing at this
// lane's column of row 0. The rows go in chunks of kFoldUnroll between two
// register sets: one chunk's reads are issued while the other's adds run,
// so a read has a chunk of adds (128 cycles in f64) to land. The loop is
// not unrolled further: unrolled, the scheduler hoists each read only a
// few adds ahead, and shared memory's latency then stalls the chain (12.5
// cycles an f64 add where the chain needs 8, on an H100). A compile-time
// pitch (kPitch > 0) makes every read an immediate offset. The rows past
// a multiple of kFoldUnroll go one by one.
template <typename T, int kPitch>
__device__ __forceinline__ T fold_stage(T acc, const T* p, int rows, int runtime_pitch) {
  const int pitch = kPitch > 0 ? kPitch : runtime_pitch;
  const int chunks = rows / kFoldUnroll;
  if (chunks > 0) {
    T a[kFoldUnroll], b[kFoldUnroll];
#pragma unroll
    for (int k = 0; k < kFoldUnroll; ++k) a[k] = p[k * pitch];
    int c = 1;
#pragma unroll 1
    for (; c + 1 < chunks; c += 2) {
      const T* q = p + c * kFoldUnroll * pitch;
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) b[k] = q[k * pitch];
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) acc = add(acc, a[k]);
      q += kFoldUnroll * pitch;
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) a[k] = q[k * pitch];
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) acc = add(acc, b[k]);
    }
    if (c < chunks) {
      const T* q = p + c * kFoldUnroll * pitch;
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) b[k] = q[k * pitch];
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) acc = add(acc, a[k]);
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) acc = add(acc, b[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kFoldUnroll; ++k) acc = add(acc, a[k]);
    }
  }
  for (int r = chunks * kFoldUnroll; r < rows; ++r) acc = add(acc, p[r * pitch]);
  return acc;
}

// Pass 2: the left fold of x (M, n) over the workers, a tile of columns a
// block, and the eq.-(4) epilogue on it. Warp 0 folds, from a ring of
// kFoldStages stages in shared memory. On a narrow bank (f.bulk) thread 32
// fills each stage with one TMA bulk copy and two mbarriers a stage hand
// it over: `full` ends when the copy lands, `empty` when warp 0 has folded
// it, so the folding warp never waits at a block barrier. Otherwise warps
// 1-7 copy a tile's strided rows with cp.async, kFoldStages - 1 stages
// ahead, and one block barrier a stage hands it over.
template <typename T, int kPitch>
__global__ void __launch_bounds__(kThreads)
fold_columns_kernel(const T* __restrict__ x, const T* __restrict__ theta,
                    const T* __restrict__ prev, T* __restrict__ agg_out,
                    T* __restrict__ theta_out, FoldTile f, T alpha, T beta) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  __shared__ __align__(8) uint64_t full[kFoldStages], empty[kFoldStages];
  T* ring = reinterpret_cast<T*>(fold_smem);
  const int kStageElems = f.stage_elems;
  const int64_t c0 = (int64_t)blockIdx.x * f.pitch;
  const int cols = f.n - c0 < f.pitch ? (int)(f.n - c0) : f.pitch;
  const int64_t stages = (f.m + f.rows - 1) / f.rows;
  const bool folder = threadIdx.x < 32;
  // lanes past the tile's columns read (and never store) column 0
  const int lane_col = (int)threadIdx.x < cols ? (int)threadIdx.x : 0;
  T acc = T(-0.0);
  if (f.bulk) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < kFoldStages; ++b) {
        mbar_init(&full[b]);
        mbar_init(&empty[b]);
      }
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 32) {
      for (int64_t s = 0; s < stages; ++s) {
        const int b = (int)(s % kFoldStages);
        if (s >= kFoldStages) mbar_wait(&empty[b], (unsigned)((s / kFoldStages - 1) & 1));
        stage_bulk(ring + b * kStageElems, x, s, f, &full[b]);
      }
    } else if (folder) {
      for (int64_t s = 0; s < stages; ++s) {
        const int b = (int)(s % kFoldStages);
        mbar_wait(&full[b], (unsigned)((s / kFoldStages) & 1));
        const int64_t left = f.m - s * f.rows;
        acc = fold_stage<T, kPitch>(acc, ring + b * kStageElems + lane_col,
                                    left < f.rows ? (int)left : f.rows, f.pitch);
        __syncwarp();
        if (threadIdx.x == 0) mbar_arrive(&empty[b]);
      }
    }
  } else {
    if (!folder) {
      for (int s = 0; s < kFoldStages - 1; ++s) {
        if (s < stages) stage_rows(ring + s * kStageElems, x, s, f, c0, cols);
        cp_async_commit();
      }
    }
    for (int64_t s = 0; s < stages; ++s) {
      const int b = (int)(s % kFoldStages);
      if (!folder) cp_async_wait_stage();
      __syncthreads();
      if (!folder) {
        const int64_t next = s + kFoldStages - 1;
        if (next < stages)
          stage_rows(ring + (next % kFoldStages) * kStageElems, x, next, f, c0, cols);
        cp_async_commit();
      } else {
        const int64_t left = f.m - s * f.rows;
        acc = fold_stage<T, kPitch>(acc, ring + b * kStageElems + lane_col,
                                    left < f.rows ? (int)left : f.rows, f.pitch);
      }
    }
  }
  if (folder && (int)threadIdx.x < cols) {
    const int64_t j = c0 + threadIdx.x;
    agg_out[j] = acc;
    theta_out[j] = hb_step(theta[j], prev[j], acc, alpha, beta);
  }
}

// the least shift with 2^shift >= min(n, cap), cap a power of two
inline int pow2_shift(int64_t n, int cap) {
  int s = 0;
  while ((int64_t(1) << s) < n && (1 << s) < cap) ++s;
  return s;
}

template <typename T, int kPitch>
static int launch_fold_tiles(const void* x, const void* theta, const void* prev, void* agg,
                             void* theta_out, const FoldTile& f, int64_t tiles, double alpha,
                             double beta, cudaStream_t s) {
  const int smem = kFoldStages * f.stage_elems * (int)sizeof(T);
  const cudaError_t attr = cudaFuncSetAttribute(
      fold_columns_kernel<T, kPitch>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  fold_columns_kernel<T, kPitch><<<(unsigned)tiles, kThreads, smem, s>>>(
      (const T*)x, (const T*)theta, (const T*)prev, (T*)agg, (T*)theta_out, f, (T)alpha,
      (T)beta);
  return (int)cudaGetLastError();
}

// The fold of x (M, n): tiles of min(n, 32) columns; the pitch is a
// compile-time constant where it is a power of two (every bank wider than
// 32 columns, and the narrow ones of 1-32 columns by powers of two).
template <typename T>
static int launch_fold(const void* x, const void* theta, const void* prev, void* agg,
                       void* theta_out, int64_t m, int64_t n, double alpha, double beta,
                       cudaStream_t s) {
  FoldTile f;
  f.m = m;
  f.n = n;
  f.pitch = (int)(n < kFoldCols ? n : kFoldCols);
  f.bulk = n <= kFoldCols && aligned16(x);
  f.stage_elems = (f.bulk ? kBulkStageBytes : kCopyStageBytes) / (int)sizeof(T);
  f.rows = f.stage_elems / f.pitch / kFoldUnroll * kFoldUnroll;
  const int64_t tiles = (n + f.pitch - 1) / f.pitch;
  if (tiles > kMaxGridX) return (int)cudaErrorInvalidValue;
  switch (f.pitch) {
    case 32: return launch_fold_tiles<T, 32>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    case 16: return launch_fold_tiles<T, 16>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    case 8: return launch_fold_tiles<T, 8>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    case 4: return launch_fold_tiles<T, 4>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    case 2: return launch_fold_tiles<T, 2>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    case 1: return launch_fold_tiles<T, 1>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
    default: return launch_fold_tiles<T, 0>(x, theta, prev, agg, theta_out, f, tiles, alpha, beta, s);
  }
}

// Pass 1's grid: x the column tiles, y the row tiles (walked with a stride
// past grid y's limit)
inline dim3 tall_grid(int64_t m, int64_t n, int shift) {
  const int64_t tile = (int64_t)(kThreads >> shift) * kRowItems;
  const int64_t y = (m + tile - 1) / tile;
  return dim3((unsigned)((n + (1 << shift) - 1) >> shift),
              (unsigned)(y < kMaxGridY ? y : kMaxGridY));
}

template <typename T>
static int launch_fused_dense_tall(const void* g, const void* h, const void* theta,
                                   const void* prev, const void* mask, void* new_h, void* agg,
                                   void* theta_out, int64_t m, int64_t n, double alpha,
                                   double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int shift = pow2_shift(n, kThreads);
  tall_advance_kernel<T, false><<<tall_grid(m, n, shift), kThreads, 0, s>>>(
      (const T*)g, (const T*)h, nullptr, (const float*)mask, nullptr, (T*)new_h, nullptr, m, n,
      shift);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fold<T>(new_h, theta, prev, agg, theta_out, m, n, alpha, beta, s);
}

template <typename T>
static int launch_fused_int8_tall(const void* g, const void* h, const void* e,
                                  const void* theta, const void* prev, const void* mask,
                                  const void* scale, void* new_h, void* new_e, void* agg,
                                  void* theta_out, int64_t m, int64_t n, double alpha,
                                  double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int shift = pow2_shift(n, kThreads);
  tall_advance_kernel<T, true><<<tall_grid(m, n, shift), kThreads, 0, s>>>(
      (const T*)g, (const T*)h, (const T*)e, (const float*)mask, (const float*)scale,
      (T*)new_h, (T*)new_e, m, n, shift);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fold<T>(new_h, theta, prev, agg, theta_out, m, n, alpha, beta, s);
}

template <typename T>
static int launch_fused_dense(const void* g, const void* h, const void* theta,
                              const void* prev, const void* mask, void* new_h,
                              void* agg, void* theta_out, int64_t m, int64_t n,
                              double alpha, double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  fused_dense_step_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)h, (const T*)theta, (const T*)prev, (const float*)mask,
      (T*)new_h, (T*)agg, (T*)theta_out, m, n, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_int8_stats(const void* g, const void* h, const void* e, void* sq_part,
                             void* am_part, void* sq, void* am, int64_t m, int64_t n,
                             int64_t nchunks, void* stream) {
  if (!reduction_shape_ok(m, n, nchunks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int8_stats_partials<T><<<dim3((unsigned)nchunks, worker_blocks(m)), kThreads, 0, s>>>(
      (const T*)g, (const T*)h, (const T*)e, (float*)sq_part, (T*)am_part, m, n, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_partials<float, SumOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const float*)sq_part, (float*)sq, nchunks, 0.0f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_partials<T, MaxOp><<<(unsigned)m, kThreads, 0, s>>>(
      (const T*)am_part, (T*)am, nchunks, T(0));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_fused_int8(const void* g, const void* h, const void* e, const void* theta,
                             const void* prev, const void* mask, const void* scale,
                             void* new_h, void* new_e, void* agg, void* theta_out,
                             int64_t m, int64_t n, double alpha, double beta, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  fused_int8_step_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)h, (const T*)e, (const T*)theta, (const T*)prev,
      (const float*)mask, (const float*)scale, (T*)new_h, (T*)new_e, (T*)agg,
      (T*)theta_out, m, n, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_dense_step_f32(int device, const void* g, const void* h, const void* theta, const void* prev,
                         const void* mask, void* new_h, void* agg, void* theta_out,
                         int64_t m, int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense<float>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                   alpha, beta, stream);
}

int fused_dense_step_f64(int device, const void* g, const void* h, const void* theta, const void* prev,
                         const void* mask, void* new_h, void* agg, void* theta_out,
                         int64_t m, int64_t n, double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense<double>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                    alpha, beta, stream);
}

int int8_stats_batched_f32(int device, const void* g, const void* h, const void* e, void* sq_part,
                           void* am_part, void* sq, void* am, int64_t m, int64_t n,
                           int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_int8_stats<float>(g, h, e, sq_part, am_part, sq, am, m, n, nchunks, stream);
}

int int8_stats_batched_f64(int device, const void* g, const void* h, const void* e, void* sq_part,
                           void* am_part, void* sq, void* am, int64_t m, int64_t n,
                           int64_t nchunks, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_int8_stats<double>(g, h, e, sq_part, am_part, sq, am, m, n, nchunks, stream);
}

int fused_int8_step_f32(int device, const void* g, const void* h, const void* e, const void* theta,
                        const void* prev, const void* mask, const void* scale, void* new_h,
                        void* new_e, void* agg, void* theta_out, int64_t m, int64_t n,
                        double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8<float>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                  theta_out, m, n, alpha, beta, stream);
}

int fused_int8_step_f64(int device, const void* g, const void* h, const void* e, const void* theta,
                        const void* prev, const void* mask, const void* scale, void* new_h,
                        void* new_e, void* agg, void* theta_out, int64_t m, int64_t n,
                        double alpha, double beta, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8<double>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                   theta_out, m, n, alpha, beta, stream);
}

int fused_dense_step_tall_f32(int device, const void* g, const void* h, const void* theta,
                              const void* prev, const void* mask, void* new_h, void* agg,
                              void* theta_out, int64_t m, int64_t n, double alpha, double beta,
                              void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense_tall<float>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                        alpha, beta, stream);
}

int fused_dense_step_tall_f64(int device, const void* g, const void* h, const void* theta,
                              const void* prev, const void* mask, void* new_h, void* agg,
                              void* theta_out, int64_t m, int64_t n, double alpha, double beta,
                              void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_dense_tall<double>(g, h, theta, prev, mask, new_h, agg, theta_out, m, n,
                                         alpha, beta, stream);
}

int fused_int8_step_tall_f32(int device, const void* g, const void* h, const void* e,
                             const void* theta, const void* prev, const void* mask,
                             const void* scale, void* new_h, void* new_e, void* agg,
                             void* theta_out, int64_t m, int64_t n, double alpha, double beta,
                             void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8_tall<float>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                       theta_out, m, n, alpha, beta, stream);
}

int fused_int8_step_tall_f64(int device, const void* g, const void* h, const void* e,
                             const void* theta, const void* prev, const void* mask,
                             const void* scale, void* new_h, void* new_e, void* agg,
                             void* theta_out, int64_t m, int64_t n, double alpha, double beta,
                             void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_fused_int8_tall<double>(g, h, e, theta, prev, mask, scale, new_h, new_e, agg,
                                        theta_out, m, n, alpha, beta, stream);
}

}  // extern "C"

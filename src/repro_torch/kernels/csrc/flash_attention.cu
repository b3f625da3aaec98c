// B14: the flash-attention forward pass of serving prefill and training, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention_pallas.
//
//   o[b, h, i] = softmax_j(mask(q[b, h, i] . k[b, h/G, j] * scale)) v[b, h/G, j]
//
// with GQA (kv head = h / G), a causal and/or sliding-window mask on
// absolute positions (qpos = i, kpos = j: kpos <= qpos, kpos > qpos - window),
// the -1e30 mask value and JAX's online-softmax recurrence
//   m' = max(m, rowmax s); p = exp(s - m'); alpha = exp(m - m');
//   l' = l*alpha + rowsum p; acc' = acc*alpha + p v;  o = acc / max(l, 1e-37)
// in f32, whatever the input dtype (f32 or bf16). Lq != S is allowed.
// f32 runs the SIMT design below; bf16 the tensor-core design further down
// (flash_tc_kernel), with its own note.
// Given an lse pointer (training's forward) it also writes the (B, H, Lq)
// f32 log-sum-exp lse = m + log(max(l, 1e-37)) of flash.py:77-79, which the
// backward kernel (flash_backward.cu) reads. That is a second instantiation
// (kLse): with a null pointer (serving's prefill) the launcher runs the
// same code as before the log-sum-exp existed.
//
// f32. Bound: operations. Causal prefill of batch 8, 12 heads, 2048 tokens,
// head dim 64 does 2 * 2 * 8*12 * 2048*2049/2 * 64 = 51.6 GFLOP of
// products against 201 MB of q, k, v and o: 0.77 ms at an H100 SXM's
// 67 TFLOP/s of f32 outside the tensor cores, 0.06 ms at 3.35 TB/s. The
// products run as fmaf on the CUDA cores: TF32 tensor cores keep about 10
// mantissa bits and would not hold the f32 tolerance.
//
// Design: a register-tiled SIMT kernel, one block of 128 threads per
// (b, h, tile of BQ query rows), key tiles of kBK = 64. Thread
// (ty, tx) = (t / 8, t % 8) owns RM query rows ty + 16 i and the 8 keys
// tx + 8 j of each score tile, and the output columns 4 tx + 32 c4 .. +3.
// What it does about the four limits of a scalar tile kernel:
//  1. Shared-memory bandwidth. At DMAX = 64 a thread holds an 8 x 8 score
//     tile and an 8 x 8 output tile (RM = 8, BQ = 128). A QK step over 4
//     columns reads one float4 of q for each of 8 rows and one float4 of k
//     for each of 8 keys (64 floats) for 256 FMAs; a PV step over 4 keys
//     reads one float4 of p for each of 8 rows and two float4s of v for
//     each of 4 keys (64 floats) for 256 FMAs: 4 FMAs a float read, the
//     ratio an SM needs (128 FMAs, 32 shared floats a clock). Tiles are row
//     major: q and k rows padded to DMAX + 4 floats, so the float4 reads of
//     8 consecutive rows (keys tx + 8 j, rows ty + 16 i) fall on distinct
//     banks; p rows padded to kBK + 8, so each thread's scalar stores of its
//     scores are conflict-free; v unpadded (8 lanes read 8 neighbouring
//     float4s of one row). A row's max and sum reduce over the 8 lanes that
//     share it with a xor butterfly (every lane gets the same bits); m, l
//     and alpha stay in registers between the two products.
//  2. Overlap. K and V each have one buffer and ping-pong, with two
//     barriers a tile: after the first (K(t) landed, every reader of
//     V(t-1) done) the block starts copying V(t), which lands during QK(t)
//     and the softmax; after the second (V(t) landed, every reader of K(t)
//     done) it starts copying K(t+1), which lands during PV(t). The p rows
//     a warp stores are the rows it reads back, so p needs no barrier of
//     its own. The copies are 16-byte cp.async.cg (commit_group, then
//     wait_group 0 before each barrier). That path needs f32 operands with
//     unit last stride, the head dim and every other stride a multiple of
//     4 and 16-byte aligned base pointers; the wrapper checks that on the
//     host (flash_attention.async_copy_ok) and passes a flag, which the
//     launcher checks again. Otherwise (d = 33, a view off by one
//     element) the same kernel loads by strides element by element at the
//     same points. Past S and past the head dim the tiles are zero-filled.
//  3. Masks. Each key tile is classified against the block's rows: wholly
//     inside the causal/window band and before S, its scores get no
//     compare; a tile crossing an edge gets the per-score test, as int32
//     offsets in the tile against each row's band; a tile wholly outside
//     the band is skipped (see below). The test is uniform over the block
//     and picks one of two straight-line copies of the softmax
//     (softmax_tile<MASK>): a compare inside the unrolled score loop made
//     the compiler predicate every tile's softmax with it.
//  4. Order. Under causal, block x runs query tile nq - 1 - x / (B H) over
//     all (b, h): the longest blocks start first and the tail is short.
// Shared memory and residency: DMAX = 64 uses 105,472 bytes a block and
// ptxas gives it 255 registers a thread with no spill, so an SM holds 2
// blocks (8 warps); DMAX = 128 (RM = 4, BQ = 64) and 256 (RM = 2, BQ = 32)
// keep 4 x 8 and 2 x 8 score tiles, since 8 x 8 would not leave room for
// their 128 and 256 output columns, with the same 64 output registers a
// thread (254 and 168 registers, no spill), 118,784 and 174,592 bytes,
// one block (4 warps) an SM.
// Measured on an H100 (PERF.md, benchmarks_torch/kernel_ab.py --ablate):
// the products, copies and barriers alone run at 57% of the f32 rate,
// since 8 warps an SM are too few to hide the shared-memory loads and the
// barriers at this register count; the softmax and the masks take 13% of
// the kernel's time.
//
// Skipped tiles: a block visits only the key tiles that meet the
// causal/window band of its rows. A tile wholly outside the band adds
// exactly nothing under JAX's recurrence: after the row's first valid key
// its scores are -1e30 and p = exp(-1e30 - m) = 0 with alpha = 1; before
// it, whatever it added is multiplied by alpha = exp(-1e30 - m) = 0 once a
// valid key arrives. That holds only if every row of the block has a valid
// key in [0, S); a block with a row that has none (possible for Lq > S, or
// a window narrower than the gap) visits every tile, as the TPU kernel
// does, and such a row comes out as the mean of v, as in JAX. Keys past S
// in the last tile score -inf, so they add nothing in any case.
#include <cuda_bf16.h>

#include <type_traits>

#include "reduce.cuh"
#include "tc.cuh"           // the bf16 design's TMA, mbarrier and wgmma helpers

using namespace repro;

namespace {

constexpr int kBK = 64;              // keys of a tile
constexpr int kTX = 8;               // lanes that share a query row
constexpr int kTY = 16;              // row groups of a block
constexpr int kFlashThreads = kTX * kTY;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

template <int DMAX>
struct FlashTiles {
  static constexpr int RM = DMAX == 64 ? 8 : (DMAX == 128 ? 4 : 2);  // rows a thread owns
  static constexpr int BQ = RM * kTY;       // query rows of a block
  static constexpr int NV = DMAX / 32;      // float4 column groups a thread owns
  static constexpr int QP = DMAX + 4;       // padded q row
  static constexpr int KP = DMAX + 4;       // padded k row
  static constexpr int VP = DMAX;           // v row
  static constexpr int PP = kBK + 8;        // padded p row
  static constexpr int MIN_BLOCKS = DMAX == 64 ? 2 : 1;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * QP + (size_t)kBK * KP + (size_t)kBK * VP + (size_t)BQ * PP);
};

struct FlashArgs {
  int64_t b, h, kh, lq, s, d;
  int64_t qs[4], ks[4], vs[4];   // element strides of q, k and v
  int64_t causal, has_window, window;
  int vec;                        // q, k, v copied 16 bytes at a time (cp.async)
  int out_vec;                    // the output stored as float4
  float scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// Whether query row qpos has a valid key in [0, S).
__device__ __forceinline__ bool row_has_key(const FlashArgs& a, int64_t qpos) {
  int64_t lo = 0, hi = a.s - 1;
  if (a.causal) hi = imin(hi, qpos);
  if (a.has_window) lo = imax(lo, qpos - a.window + 1);
  return lo <= hi;
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until every copy this thread committed has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + ROWS - 1 of one (rows, d) operand into a row-major f32
// tile of row stride STRIDE and DMAX columns, zero past nrows and past d.
// Each thread moves 4 neighbouring columns of a row at a time, so a warp
// covers whole rows and the global reads are coalesced.
template <typename T, int ROWS, int DMAX, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row0, int64_t nrows,
                                          int64_t rs, int64_t cs, int64_t d, bool vec) {
  constexpr int G4 = DMAX / 4;
  for (int e = threadIdx.x; e < ROWS * G4; e += kFlashThreads) {
    const int r = e / G4, c = (e % G4) * 4;
    const int64_t row = row0 + r;
    float* sp = dst + r * STRIDE + c;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        const bool ok = row < nrows && c < d;   // d % 4 == 0 on this path
        cp_async16(sp, ok ? (const void*)(src + row * rs + c) : (const void*)src, ok);
        continue;
      }
    }
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = (row < nrows && c + i < d) ? load_f(src + row * rs + (c + i) * cs) : 0.0f;
    *reinterpret_cast<float4*>(sp) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float comp(const float4& f, int x) {
  return x == 0 ? f.x : (x == 1 ? f.y : (x == 2 ? f.z : f.w));
}

// One tile's step of the online softmax for the RM rows ty + 16 i of a
// thread: scale (and under MASK, mask) its scores s[i][j] of keys
// k0 + tx + 8 j, update m and l, return alpha and store p = exp(s - m') in
// the thread's places of the p tile. The mask compares int32 offsets in the
// tile: key k0 + kk lies past S for kk >= past, and outside row r's band
// for kk < lo or kk > hi.
template <int RM, int PP, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[RM][8], float (&m)[RM], float (&l)[RM],
                                             float (&alpha)[RM], float* ps, const FlashArgs& a,
                                             int64_t q0, int64_t k0, int tx, int ty) {
  const int past = (int)imin(a.s - k0, kBK);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = q0 + ty + kTY * i;
    int lo = 0, hi = kBK - 1;
    if (MASK) {
      if (a.causal) hi = (int)imax(imin(row - k0, kBK - 1), -1);
      if (a.has_window) lo = (int)imin(imax(row - a.window + 1 - k0, 0), kBK);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = s[i][j] * a.scale;
      if (MASK) {
        const int kk = tx + kTX * j;
        if (kk >= past) x = -INFINITY;                 // no key here: adds nothing
        else if (kk < lo || kk > hi) x = kNeg;
      }
      s[i][j] = x;
      mx = maxval(mx, x);
    }
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = maxval(m[i], mx);
    alpha[i] = expf(m[i] - mn);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = expf(s[i][j] - mn);
      rs += s[i][j];
    }
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l[i] = l[i] * alpha[i] + rs;
    m[i] = mn;
#pragma unroll
    for (int j = 0; j < 8; ++j) ps[(ty + kTY * i) * PP + tx + kTX * j] = s[i][j];
  }
}

template <typename T, int DMAX, bool kLse>
__global__ void __launch_bounds__(kFlashThreads, FlashTiles<DMAX>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, FlashArgs a) {
  using L = FlashTiles<DMAX>;
  constexpr int RM = L::RM, BQ = L::BQ, NV = L::NV;
  constexpr int QP = L::QP, KP = L::KP, VP = L::VP, PP = L::PP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][QP]: q tile
  float* ks = qs + BQ * QP;           // [kBK][KP]: k tile
  float* vs = ks + kBK * KP;          // [kBK][VP]: v tile
  float* ps = vs + kBK * VP;          // [BQ][PP]: probabilities

  const int t = threadIdx.x, tx = t % kTX, ty = t / kTX;
  const int64_t nbh = a.b * a.h;
  const int64_t bh = (int64_t)blockIdx.x % nbh, rank = (int64_t)blockIdx.x / nbh;
  const int64_t nq = (a.lq + BQ - 1) / BQ;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (a.causal ? nq - 1 - rank : rank) * BQ;   // heaviest first
  const int64_t khi = hi / (a.h / a.kh);
  const T* qb = q + bi * a.qs[0] + hi * a.qs[1];
  const T* kb = k + bi * a.ks[0] + khi * a.ks[1];
  const T* vb = v + bi * a.vs[0] + khi * a.vs[1];
  const bool vec = a.vec != 0;

  // the key tiles to visit (see the note on skipped tiles above)
  const int64_t qlast = imin(q0 + BQ, a.lq) - 1;
  bool rows_ok = true;
  for (int64_t r = q0 + t; r <= qlast; r += kFlashThreads) rows_ok = rows_ok && row_has_key(a, r);
  const bool every_row = __syncthreads_and(rows_ok) != 0;
  int64_t t_lo = 0, t_hi = (a.s + kBK - 1) / kBK;
  if (every_row) {
    int64_t lo = 0, hi_key = a.s - 1;
    if (a.causal) hi_key = imin(hi_key, qlast);
    if (a.has_window) lo = imax(lo, q0 - a.window + 1);
    t_lo = lo / kBK;
    t_hi = hi_key / kBK + 1;
  }

  // prologue: q and K(t_lo)
  load_tile<T, BQ, DMAX, QP>(qs, qb, q0, a.lq, a.qs[2], a.qs[3], a.d, vec);
  load_tile<T, kBK, DMAX, KP>(ks, kb, t_lo * kBK, a.s, a.ks[2], a.ks[3], a.d, vec);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][4 * NV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t kt = t_lo; kt < t_hi; ++kt) {
    const int64_t k0 = kt * kBK;
    cp_async_wait_all();              // K(kt) (and q) landed
    __syncthreads();                  // ... for every thread; every reader of V(kt-1) is done
    load_tile<T, kBK, DMAX, VP>(vs, vb, k0, a.s, a.vs[2], a.vs[3], a.d, vec);
    cp_async_commit();                // V(kt) lands during QK(kt) and the softmax

    // scores of rows ty + 16 i and keys tx + 8 j, 4 columns a step
    float s[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < DMAX; c += 4) {
      float4 kf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + kTX * j) * KP + c);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(qs + (ty + kTY * i) * QP + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // a tile wholly inside the band (and before S) needs no mask; the test
    // is uniform over the block, and each branch is straight-line code
    const bool inside = k0 + kBK <= a.s && (!a.causal || k0 + kBK - 1 <= q0) &&
                        (!a.has_window || k0 > qlast - a.window);
    float alpha[RM];
    if (inside)
      softmax_tile<RM, PP, false>(s, m, l, alpha, ps, a, q0, k0, tx, ty);
    else
      softmax_tile<RM, PP, true>(s, m, l, alpha, ps, a, q0, k0, tx, ty);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] *= alpha[i];
    cp_async_wait_all();              // V(kt) landed
    __syncthreads();                  // ... for every thread; every reader of K(kt) is done
    if (kt + 1 < t_hi) {              // K(kt+1) lands during PV(kt)
      load_tile<T, kBK, DMAX, KP>(ks, kb, k0 + kBK, a.s, a.ks[2], a.ks[3], a.d, vec);
      cp_async_commit();
    }

    // acc[i][4 c4 + x] += p[row i][kk] v[kk][4 tx + 32 c4 + x], 4 keys a step
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + kTY * i) * PP + kk);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float4 vf[NV];
#pragma unroll
        for (int c4 = 0; c4 < NV; ++c4)
          vf[c4] = *reinterpret_cast<const float4*>(vs + (kk + x) * VP + 4 * tx + 32 * c4);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = comp(pf[i], x);
#pragma unroll
          for (int c4 = 0; c4 < NV; ++c4) {
            acc[i][4 * c4 + 0] = fmaf(p, vf[c4].x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(p, vf[c4].y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(p, vf[c4].z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(p, vf[c4].w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = q0 + ty + kTY * i;
    if (row < a.lq) {
      const float ls = maxval(l[i], 1e-37f);
      // the 8 lanes of a row hold the same m and l; one writes the lse
      if constexpr (kLse)
        if (tx == 0) lse[(bi * a.h + hi) * a.lq + row] = __fadd_rn(m[i], logf(ls));
      T* o = out + ((bi * a.h + hi) * a.lq + row) * a.d;
#pragma unroll
      for (int c4 = 0; c4 < NV; ++c4) {
        const int col = 4 * tx + 32 * c4;
        float y[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) y[x] = acc[i][4 * c4 + x] / ls;
        if constexpr (std::is_same<T, float>::value) {
          if (a.out_vec) {                // d % 4 == 0 and o 16-byte aligned
            if (col < a.d) *reinterpret_cast<float4*>(o + col) = make_float4(y[0], y[1], y[2], y[3]);
            continue;
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (col + x < a.d) store_f(o + col + x, y[x]);
      }
    }
  }
}

template <typename T, int DMAX, bool kLse>
static int launch_flash_d(const void* q, const void* k, const void* v, void* out, float* lse,
                          const FlashArgs& a, cudaStream_t s) {
  using L = FlashTiles<DMAX>;
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
    // the largest shared-memory carveout, so MIN_BLOCKS blocks fit an SM
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX, kLse>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int64_t blocks = (a.lq + L::BQ - 1) / L::BQ * a.b * a.h;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, DMAX, kLse><<<(unsigned)blocks, kFlashThreads, L::SMEM, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, a);
  return (int)cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The 16-byte path's conditions on one operand, n elements to 16 bytes
// (checked again here: the wrapper decides, a misaligned cp.async would
// fault and TMA refuses a map off them): unit last stride, the head dim and
// every other stride multiples of n, a 16-byte aligned base.
__host__ __forceinline__ bool vec_ok(const void* p, const int64_t* st, int64_t d, int64_t n) {
  return aligned16(p) && st[3] == 1 && d % n == 0 && st[0] % n == 0 && st[1] % n == 0 &&
         st[2] % n == 0;
}

// dims: b, h, kh, lq, s, d, q strides (4), k strides (4), v strides (4),
// causal, has_window, window, vec (1: copy q, k, v 16 bytes at a time)
__host__ FlashArgs flash_args(const int64_t* dims, double scale) {
  FlashArgs a;
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.lq = dims[3]; a.s = dims[4]; a.d = dims[5];
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = dims[6 + i];
    a.ks[i] = dims[10 + i];
    a.vs[i] = dims[14 + i];
  }
  a.causal = dims[18]; a.has_window = dims[19]; a.window = dims[20];
  a.vec = dims[21] != 0;
  a.scale = (float)scale;
  return a;
}

__host__ bool flash_args_ok(const FlashArgs& a) {
  return a.b >= 1 && a.h >= 1 && a.kh >= 1 && a.h % a.kh == 0 && a.lq >= 1 && a.s >= 1 &&
         a.d >= 1 && a.d <= 256;
}

// lse: null, or the (B, H, Lq) f32 log-sum-exp (kLse)
template <typename T, bool kLse>
static int launch_flash(const void* q, const void* k, const void* v, void* out, float* lse,
                        const int64_t* dims, double scale, void* stream) {
  FlashArgs a = flash_args(dims, scale);
  constexpr bool is_f32 = std::is_same<T, float>::value;
  a.out_vec = is_f32 && a.d % 4 == 0 && aligned16(out);
  if (!flash_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.vec &&
      !(is_f32 && vec_ok(q, a.qs, a.d, 4) && vec_ok(k, a.ks, a.d, 4) && vec_ok(v, a.vs, a.d, 4)))
    return (int)cudaErrorMisalignedAddress;
  if (kLse && lse == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_flash_d<T, 64, kLse>(q, k, v, out, lse, a, s);
  if (a.d <= 128) return launch_flash_d<T, 128, kLse>(q, k, v, out, lse, a, s);
  return launch_flash_d<T, 256, kLse>(q, k, v, out, lse, a, s);
}

// ------------------------------------------------------------------------
// B14 in bf16: the tensor-core design.
//
// Same function as above, bf16 in and out: s = (q . k) * scale in f32 (the
// scale after the product, as JAX applies it; prescaling q in bf16 would
// round), the -1e30 mask on absolute positions, JAX's online softmax in f32
// (m, l, alpha; l summed from the f32 p), o = acc / max(l, 1e-37) rounded
// once to bf16, and with an lse pointer the f32 m + log(max(l, 1e-37)).
//
// Bound: operations. qwen3-4b's serve_long prefill (B 8, H 32, K 8, L 2048,
// d 128, causal) needs 2 * 2 * 8*32 * 2048*2049/2 * 128 = 275 GFLOP of
// products against 67 MB of q, k, v and o: 0.278 ms at an H100 SXM's 989
// TFLOP/s of dense bf16 tensor-core products, 0.02 ms at 3.35 TB/s.
//
// Arithmetic. Both products run on the bf16 tensor cores (wgmma) with f32
// accumulation:
//   S = Q K^T: q and k are bf16, so every product is exact in f32; only the
//     order of the f32 sums differs from the plain version.
//   O += P V: JAX keeps p in f32. One bf16 rounding of p (relative error up
//     to 2^-8) would be a larger change than summation order, so p is split
//     p_hi = bf16(p), p_lo = bf16(p - p_hi) (p - p_hi is exact in f32) and
//     both products go into the same f32 accumulator. p_hi + p_lo differs
//     from p by at most 2^-8 |p - p_hi| <= 2^-16 |p|, 2^-8 of the output's
//     own bf16 rounding. The cost is three products instead of two: 412
//     GFLOP at qwen3-4b's shape, 0.417 ms at 989 TFLOP/s.
//   The softmax is the f32 design's: IEEE-rounded f32 operations (the
//     build's -fmad=false) and expf, CUDA's f32 exp (within 2 ulps), not
//     ex2.approx on x log2(e), whose rounding of the product alone costs up
//     to 2^-24 |x| relative and which flushes subnormal results to zero.
//
// Design (one block of two consumer warpgroups, 256 threads, per (b, h,
// tile of kTcBM = 128 query rows); warpgroup w owns rows 64 w .. 64 w + 63):
//  1. Tiles. q (128 x DMAX) stays in shared memory for the block's life;
//     key tiles of kTcBN = 64 keys of k and of v go through two rings of
//     NST stages each (4 at DMAX <= 128; 2 at 256, where 3 do not fit).
//     Every tile is bf16 in wgmma's 128-byte-swizzled layout: rows of 64
//     elements (128 bytes), 16-byte chunk c of row r stored at chunk c ^
//     (r % 8), DMAX / 64 such column blocks one after another, each tile
//     1024-byte aligned. Past S, past Lq and past the head dim the tiles
//     are zero-filled (DMAX = 64, 128 or 256; d = 72 runs as 128).
//  2. Copies. Where every operand has unit last stride, a head dim and
//     strides that are multiples of 8 elements and 16-byte aligned bases
//     (the wrapper's flash_attention.tc_copy_ok, checked again here), TMA:
//     one thread copies each tile as boxes of 64 columns of a 4-D tensor
//     map (d, L, heads, batch) of the model's strided view, swizzled on the
//     way and zero-filled past S, Lq and d, completing the stage's "full"
//     mbarrier by its bytes. Otherwise the same kernel gathers 8 elements
//     at a time by strides and stores the 16 bytes itself (every thread,
//     then a proxy fence and an arrive). The copies of k's tile t + NST - 1
//     and v's tile t + NST - 2 (v is read one tile later than k, item 3)
//     start at tile t. Each stage's "empty" mbarrier completes when every
//     thread has read it (an arrive after the wgmma that read it); no
//     block barrier orders the loop, so the warpgroups need not meet.
//     Measured: with 16-byte cp.async from every thread the copies alone
//     took as long as the whole kernel with TMA (PERF.md §6).
//  3. Products. S (64 x 64 a warpgroup, 32 f32 registers a thread) by
//     wgmma m64n64k16 with q and k both K-major from shared memory, DMAX / 16
//     steps; then the softmax in registers (a row's 64 scores lie on the 4
//     lanes of a quad: two xor shuffles for its max and sum, every lane the
//     same bits); p_hi and p_lo converted in place, since the accumulator's
//     fragment of 16 keys is the A-register fragment of m64nDMAXk16; O +=
//     P_hi V + P_lo V by wgmma with A from registers and v MN-major from
//     shared memory (4 key steps x 2). O (64 x DMAX) stays in registers:
//     DMAX / 2 f32 a thread, 128 at d = 256. The tensor cores and the
//     softmax overlap inside a warpgroup: tile t issues S(t) and then the
//     P V of tile t - 1, waits for S(t) alone, runs the softmax of tile t
//     while P V(t - 1) runs, then waits for it, rescales O by alpha(t) and
//     converts P(t), whose P V tile t + 1 issues (the first tile's softmax
//     runs alone, the last tile's P V after the loop). Making the two
//     warpgroups issue their wgmmas in turn (named barriers, so that one's
//     softmax runs during the other's products) measured slower at all
//     three serving shapes, and is not done.
//  4. Masks. The block visits only the key tiles that meet the band of its
//     128 rows (heaviest query tile first under causal; a tile outside is
//     skipped, see the note on skipped tiles above). A visited tile is
//     classified against each warpgroup's 64 rows: inside the band and
//     before S (no compare) or not (the per-score test). A tile wholly
//     outside one warpgroup's band adds exactly nothing to its rows, so the
//     warpgroup runs it masked rather than branch around its wgmmas: ptxas
//     serializes wgmmas issued under a branch it cannot prove uniform, and
//     the warpgroup index reaches it through a shuffle for the same reason.
// Registers: ptxas reports them per DMAX (-Xptxas=-v, kept by build.py's
// log): at most 255 a thread, one block of 256 threads an SM.
// Shared memory: 1024 bytes of alignment slack, q 16 KB per column block,
// NST tiles each of k and v at 8 KB per column block, 4 NST mbarriers:
// 83,072 bytes at DMAX 64, 164,992 at 128, 197,696 at 256. No atomics:
// the same bits on every call. The swizzle, TMA, mbarrier and wgmma
// helpers are in tc.cuh, which the flash backward's bf16 passes share.

constexpr int kTcBM = 128;            // query rows of a block
constexpr int kTcBN = 64;             // keys of a tile
constexpr int kTcThreads = 256;       // two warpgroups

template <int DMAX>
struct TcTiles {
  static constexpr int CB = DMAX / 64;                        // column blocks
  static constexpr int Q_CB = kTcBM * kSwRow;                 // bytes of q's column block
  static constexpr int KV_CB = kTcBN * kSwRow;                // bytes of k's (or v's)
  static constexpr int Q_BYTES = CB * Q_CB;
  static constexpr int KV_BYTES = CB * KV_CB;                 // one k (or v) tile
  // stages of each ring: as many as fit (3 do not at DMAX 256)
  static constexpr int NST = DMAX <= 128 ? 4 : 2;
  // alignment slack, q, the k and v rings and their 4 NST mbarriers
  static constexpr size_t SMEM =
      1024 + (size_t)Q_BYTES + 2 * NST * (size_t)KV_BYTES + 32 * NST;
};

// O += P_hi V + P_lo V of one key tile: 4 steps of 16 keys, 2048 bytes
// apart in the v tile at vt
template <int DMAX>
__device__ __forceinline__ void pv_tile(float (&o)[DMAX / 2], const uint32_t (&ph)[4][4],
                                        const uint32_t (&pl)[4][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor(vt + kk * 16 * kSwRow, TcTiles<DMAX>::KV_CB);
    wgmma_rs<DMAX>(o, ph[kk], db);
    wgmma_rs<DMAX>(o, pl[kk], db);
  }
}


// One key tile's step of the online softmax for the two rows row0 and
// row0 + 8 of a thread, whose scores of keys k0 + 8 n + 2 tq + j lie in
// s[4 n + 2 i + j] (wgmma's accumulator fragment): scale (and under MASK,
// mask) them, update m and l, return alpha and leave p in s. The mask
// compares int32 offsets in the tile, as softmax_tile does.
template <bool MASK>
__device__ __forceinline__ void tc_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], const FlashArgs& a, int64_t row0,
                                           int64_t k0, int tq) {
  const int past = (int)imin(a.s - k0, kTcBN);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    int lo = 0, hi = kTcBN - 1;
    if (MASK) {
      if (a.causal) hi = (int)imax(imin(row - k0, kTcBN - 1), -1);
      if (a.has_window) lo = (int)imin(imax(row - a.window + 1 - k0, 0), kTcBN);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[4 * n + 2 * i + j] * a.scale;
        if (MASK) {
          const int kk = 8 * n + 2 * tq + j;
          if (kk >= past) x = -INFINITY;                 // no key here: adds nothing
          else if (kk < lo || kk > hi) x = kNeg;
        }
        s[4 * n + 2 * i + j] = x;
        mx = maxval(mx, x);
      }
    mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = maxval(m[i], mx);
    alpha[i] = expf(m[i] - mn);
    float rs = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[4 * n + 2 * i + j] - mn);
        s[4 * n + 2 * i + j] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[i] = l[i] * alpha[i] + rs;
    m[i] = mn;
  }
}

template <int DMAX, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, FlashArgs a, const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v) {
  using L = TcTiles<DMAX>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  constexpr int NST = L::NST;
  const uint32_t kring = qs + L::Q_BYTES;            // NST k tiles
  const uint32_t vring = kring + NST * L::KV_BYTES;  // NST v tiles

  // the warpgroup's index through a shuffle, so the compiler sees it (and
  // every branch on it) uniform over each warp: a branch it may take as
  // divergent makes ptxas serialize every wgmma (C7520)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wi = (tid % 128) / 32, lane = tid % 32;
  const int tq = lane % 4;
  const int64_t nbh = a.b * a.h;
  const int64_t bh = (int64_t)blockIdx.x % nbh, rank = (int64_t)blockIdx.x / nbh;
  const int64_t nq = (a.lq + kTcBM - 1) / kTcBM;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (a.causal ? nq - 1 - rank : rank) * kTcBM;   // heaviest first
  const int64_t khi = hi / (a.h / a.kh);
  const __nv_bfloat16* qb = q + bi * a.qs[0] + hi * a.qs[1];
  const __nv_bfloat16* kb = k + bi * a.ks[0] + khi * a.ks[1];
  const __nv_bfloat16* vb = v + bi * a.vs[0] + khi * a.vs[1];
  const bool vec = a.vec != 0;

  // The rows without a valid key in [0, S) form a suffix of all rows
  // (qpos >= S + window - 1, or every row for a window below 1), so rows
  // r0 .. r1 all have one iff r1 has: the block visits the key tiles that
  // meet the band of its rows if its last row has a valid key, else every
  // tile (see the note on skipped tiles above).
  const int64_t qlast = imin(q0 + kTcBM, a.lq) - 1;
  int64_t t_lo = 0, t_hi = (a.s + kTcBN - 1) / kTcBN;
  if (row_has_key(a, qlast)) {
    int64_t lo = 0, hi_key = a.s - 1;
    if (a.causal) hi_key = imin(hi_key, qlast);
    if (a.has_window) lo = imax(lo, q0 - a.window + 1);
    t_lo = lo / kTcBN;
    t_hi = hi_key / kTcBN + 1;
  }
  // this warpgroup's rows w0 .. w1 and this thread's two, row0 and row0 + 8
  const int64_t w0 = q0 + 64 * wg, w1 = imin(w0 + 63, a.lq - 1);
  const int64_t row0 = w0 + 16 * wi + lane / 4;

  // The rings' barriers: full_k[j] / full_v[j] complete when the copies
  // into stage j have landed (TMA: thread 0's arrive with the tile's bytes,
  // which the copies complete; element path: 256 arrivals after each
  // thread's stores and a proxy fence); empty_k[j] / empty_v[j] when every
  // thread is done reading it (256 arrivals after the wgmma that read it).
  // Fill n of a stage waits for use n - 1 to be over; use n for fill n.
  const uint32_t bars = kring + 2 * NST * L::KV_BYTES;
  const uint32_t full_k = bars, full_v = bars + 8 * NST, empty_k = bars + 16 * NST,
                 empty_v = bars + 24 * NST;
  if (tid == 0) {
    for (int j = 0; j < 2 * NST; ++j) mbar_init(bars + 8 * j, vec ? 1 : kTcThreads);
    for (int j = 2 * NST; j < 4 * NST; ++j) mbar_init(bars + 8 * j, kTcThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one key tile of k or v into stage j of its ring, once the stage's
  // previous tile is read: TMA boxes from thread 0, or every thread's
  // gather
  auto fill = [&](uint32_t ring, uint32_t full, uint32_t empty, const CUtensorMap& map,
                  const __nv_bfloat16* base, const int64_t* st, int64_t head, int64_t kt) {
    const int64_t rel = kt - t_lo;
    const uint32_t j = (uint32_t)(rel % NST);
    const uint32_t dst = ring + j * L::KV_BYTES;
    if (vec) {
      if (tid != 0) return;
      if (rel >= NST) mbar_wait(empty + 8 * j, (uint32_t)((rel / NST - 1) & 1));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       full + 8 * j),
                   "r"((uint32_t)L::KV_BYTES)
                   : "memory");
#pragma unroll
      for (int cb = 0; cb < L::CB; ++cb)
        tma_box(dst + cb * L::KV_CB, map, 64 * cb, kt * kTcBN, head, bi, full + 8 * j);
      return;
    }
    if (rel >= NST) mbar_wait(empty + 8 * j, (uint32_t)((rel / NST - 1) & 1));
    tc_gather<kTcBN, DMAX, kTcThreads>(dst, base, kt * kTcBN, a.s, st[2], st[3], a.d);
    fence_proxy_async();
    mbar_arrive(full + 8 * j);
  };
  auto load_k = [&](int64_t kt) { fill(kring, full_k, empty_k, map_k, kb, a.ks, khi, kt); };
  auto load_v = [&](int64_t kt) { fill(vring, full_v, empty_v, map_v, vb, a.vs, khi, kt); };
  // use of a stage: wait for its fill (the element path's writers fenced
  // their stores for wgmma's async proxy before arriving; TMA writes
  // through that proxy), and after the wgmma that read it release it
  auto wait_k = [&](int64_t kt) {
    const int64_t rel = kt - t_lo;
    mbar_wait(full_k + 8 * (uint32_t)(rel % NST), (uint32_t)((rel / NST) & 1));
  };
  auto wait_v = [&](int64_t kt) {
    const int64_t rel = kt - t_lo;
    mbar_wait(full_v + 8 * (uint32_t)(rel % NST), (uint32_t)((rel / NST) & 1));
  };
  auto free_k = [&](int64_t kt) { mbar_arrive(empty_k + 8 * (uint32_t)((kt - t_lo) % NST)); };
  auto free_v = [&](int64_t kt) { mbar_arrive(empty_v + 8 * (uint32_t)((kt - t_lo) % NST)); };

  // prologue: q (behind k's first barrier), k's tiles t_lo .. t_lo + NST - 2
  // and v's tiles t_lo .. t_lo + NST - 3
  if (!vec) {
    tc_gather<kTcBM, DMAX, kTcThreads>(qs, qb, q0, a.lq, a.qs[2], a.qs[3], a.d);
  } else if (tid == 0) {
    mbar_expect(full_k, (uint32_t)L::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < L::CB; ++cb)
      tma_box(qs + cb * L::Q_CB, map_q, 64 * cb, q0, hi, bi, full_k);
  }
  for (int i = 0; i < NST - 1; ++i)
    if (t_lo + i < t_hi) load_k(t_lo + i);
  for (int i = 0; i < NST - 2; ++i)
    if (t_lo + i < t_hi) load_v(t_lo + i);

  float o[DMAX / 2], s[32], m[2], l[2], alpha[2];
  uint32_t ph[4][4], pl[4][4];        // p_hi, p_lo of the tile whose P V is next
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }

  // The start of tile kt: the copies of k's tile kt + NST - 1 and v's tile
  // kt + NST - 2 start (each thread its share), NST - 1 tiles ahead of use.
  auto next_tile = [&](int64_t kt) {
    if (kt + NST - 1 < t_hi) load_k(kt + NST - 1);
    if (kt + NST - 2 < t_hi) load_v(kt + NST - 2);
  };
  // S = Q K^T of tile kt: DMAX / 16 steps of 16 columns, 32 bytes apart in
  // a swizzled row, 64 columns a column block
  auto issue_s = [&](int64_t kt) {
    const uint32_t ks = kring + (uint32_t)((kt - t_lo) % NST) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t col = (uint32_t)(kk % 4) * 32;
      wgmma_ss_n64(s, desc_kmajor(qs + (kk / 4) * L::Q_CB + wg * 64 * kSwRow + col),
                   desc_kmajor(ks + (kk / 4) * L::KV_CB + col), kk > 0);
    }
    wgmma_commit();
  };
  // the softmax of tile kt on s (the tile's class against this warpgroup's
  // rows, uniform over it: inside the band and before S, no compare)
  auto softmax = [&](int64_t kt) {
    const int64_t k0 = kt * kTcBN;
    if (k0 + kTcBN <= a.s && (!a.causal || k0 + kTcBN - 1 <= w0) &&
        (!a.has_window || k0 > w1 - a.window))
      tc_softmax<false>(s, m, l, alpha, a, row0, k0, tq);
    else
      tc_softmax<true>(s, m, l, alpha, a, row0, k0, tq);
  };
  // keys 16 kk .. 16 kk + 15: registers (g, c), (g + 8, c), (g, c + 8),
  // (g + 8, c + 8) of m64nNk16's A fragment are s[8 kk + 2 r], r = 0..3
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
  };
  auto v_tile = [&](int64_t kt) {
    return vring + (uint32_t)((kt - t_lo) % NST) * L::KV_BYTES;
  };

  // tile t_lo: S and its softmax (O is still zero)
  next_tile(t_lo);
  wait_k(t_lo);
  reg_fence(s);
  wgmma_fence();
  issue_s(t_lo);
  wgmma_wait<0>();
  reg_fence(s);
  free_k(t_lo);
  softmax(t_lo);
  split_p();
  // the steady state: tile kt issues S(kt), then P V of tile kt - 1, which
  // runs during the softmax of tile kt; the same wgmma sequence in every
  // warpgroup and tile, so ptxas keeps it asynchronous
  for (int64_t kt = t_lo + 1; kt < t_hi; ++kt) {
    next_tile(kt);
    wait_k(kt);
    wait_v(kt - 1);
    reg_fence(s);
    reg_fence(o);
      wgmma_fence();
    issue_s(kt);
    pv_tile<DMAX>(o, ph, pl, v_tile(kt - 1));
    wgmma_commit();
      wgmma_wait<1>();                  // S(kt) landed; P V(kt - 1) may still run
    reg_fence(s);
    free_k(kt);
    softmax(kt);
    wgmma_wait<0>();                  // P V(kt - 1) is done with o, ph and pl
    reg_fence(o);
    free_v(kt - 1);
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    split_p();
  }
  // the last tile's P V, once its v tile has landed
  wait_v(t_hi - 1);
  reg_fence(o);
  wgmma_fence();
  pv_tile<DMAX>(o, ph, pl, v_tile(t_hi - 1));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);

  const bool active = w0 < a.lq;
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    if (row >= a.lq) continue;
    const float ls = maxval(l[i], 1e-37f);
    // the 4 lanes of a row hold the same m and l; one writes the lse
    if constexpr (kLse)
      if (tq == 0) lse[(bi * a.h + hi) * a.lq + row] = __fadd_rn(m[i], logf(ls));
    __nv_bfloat16* op = out + ((bi * a.h + hi) * a.lq + row) * a.d;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      const float y0 = o[4 * n + 2 * i] / ls, y1 = o[4 * n + 2 * i + 1] / ls;
      if (a.d % 2 == 0) {               // 4-byte aligned pairs: out is contiguous
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < a.d) op[col] = __float2bfloat16_rn(y0);
        if (col + 1 < a.d) op[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}


template <int DMAX, bool kLse>
static int launch_flash_tc_d(const void* q, const void* k, const void* v, void* out, float* lse,
                             const FlashArgs& a, cudaStream_t s) {
  using L = TcTiles<DMAX>;
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_tc_kernel<DMAX, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_tc_kernel<DMAX, kLse>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int64_t blocks = (a.lq + kTcBM - 1) / kTcBM * a.b * a.h;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};             // unused on the element path
  if (a.vec && !(tensor_map(&maps[0], q, a.qs, a.b, a.h, a.lq, a.d, kTcBM) &&
                 tensor_map(&maps[1], k, a.ks, a.b, a.kh, a.s, a.d, kTcBN) &&
                 tensor_map(&maps[2], v, a.vs, a.b, a.kh, a.s, a.d, kTcBN)))
    return (int)cudaErrorInvalidValue;
  flash_tc_kernel<DMAX, kLse><<<(unsigned)blocks, kTcThreads, L::SMEM, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, lse, a, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

template <bool kLse>
static int launch_flash_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                           const int64_t* dims, double scale, void* stream) {
  FlashArgs a = flash_args(dims, scale);
  a.out_vec = 0;
  if (!flash_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.vec && !(vec_ok(q, a.qs, a.d, 8) && vec_ok(k, a.ks, a.d, 8) && vec_ok(v, a.vs, a.d, 8)))
    return (int)cudaErrorMisalignedAddress;
  if (kLse && lse == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_flash_tc_d<64, kLse>(q, k, v, out, lse, a, s);
  if (a.d <= 128) return launch_flash_tc_d<128, kLse>(q, k, v, out, lse, a, s);
  return launch_flash_tc_d<256, kLse>(q, k, v, out, lse, a, s);
}

}  // namespace

extern "C" {

// lse: null (serving's prefill: the kernel it always ran), or the (B, H, Lq)
// f32 log-sum-exp to write (training's forward)
int flash_attention_f32(int device, const void* q, const void* k, const void* v, void* out,
                        void* lse, const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  if (lse != nullptr)
    return launch_flash<float, true>(q, k, v, out, (float*)lse, dims, scale, stream);
  return launch_flash<float, false>(q, k, v, out, nullptr, dims, scale, stream);
}

int flash_attention_bf16(int device, const void* q, const void* k, const void* v, void* out,
                         void* lse, const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  if (lse != nullptr)
    return launch_flash_tc<true>(q, k, v, out, (float*)lse, dims, scale, stream);
  return launch_flash_tc<false>(q, k, v, out, nullptr, dims, scale, stream);
}

}  // extern "C"

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
// Given an lse pointer (training's forward) it also writes the (B, H, Lq)
// f32 log-sum-exp lse = m + log(max(l, 1e-37)) of flash.py:77-79, which the
// backward kernel (flash_backward.cu) reads. That is a second instantiation
// (kLse): with a null pointer (serving's prefill) the launcher runs the
// same code as before the log-sum-exp existed.
//
// Bound: operations. Causal prefill of batch 8, 12 heads, 2048 tokens,
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
//     launcher checks again. Otherwise (bf16, d = 33, a view off by one
//     element) the same kernel loads by strides element by element,
//     converting to f32, at the same points. Past S and past the head dim
//     the tiles are zero-filled.
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
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// The 16-byte path's conditions on one operand (checked again here: the
// wrapper decides, a misaligned cp.async would fault).
__host__ __forceinline__ bool vec_ok(const void* p, const int64_t* st, int64_t d) {
  return aligned16(p) && st[3] == 1 && d % 4 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
         st[2] % 4 == 0;
}

// dims: b, h, kh, lq, s, d, q strides (4), k strides (4), v strides (4),
// causal, has_window, window, vec (1: copy q, k, v with 16-byte cp.async);
// lse: null, or the (B, H, Lq) f32 log-sum-exp (kLse)
template <typename T, bool kLse>
static int launch_flash(const void* q, const void* k, const void* v, void* out, float* lse,
                        const int64_t* dims, double scale, void* stream) {
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
  constexpr bool is_f32 = std::is_same<T, float>::value;
  a.out_vec = is_f32 && a.d % 4 == 0 && aligned16(out);
  if (a.b < 1 || a.h < 1 || a.kh < 1 || a.h % a.kh != 0 || a.lq < 1 || a.s < 1 || a.d < 1 ||
      a.d > 256)
    return (int)cudaErrorInvalidValue;
  if (a.vec && !(is_f32 && vec_ok(q, a.qs, a.d) && vec_ok(k, a.ks, a.d) && vec_ok(v, a.vs, a.d)))
    return (int)cudaErrorMisalignedAddress;
  if (kLse && lse == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_flash_d<T, 64, kLse>(q, k, v, out, lse, a, s);
  if (a.d <= 128) return launch_flash_d<T, 128, kLse>(q, k, v, out, lse, a, s);
  return launch_flash_d<T, 256, kLse>(q, k, v, out, lse, a, s);
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
    return launch_flash<__nv_bfloat16, true>(q, k, v, out, (float*)lse, dims, scale, stream);
  return launch_flash<__nv_bfloat16, false>(q, k, v, out, nullptr, dims, scale, stream);
}

}  // extern "C"

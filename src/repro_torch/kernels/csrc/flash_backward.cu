// The flash-attention backward pass of training, on Hopper (port-only).
//
// Replaces no TPU kernel: the JAX package trains through the pure-JAX custom
// VJP of src/repro/models/flash.py (_make_flash.bwd, :96-165), which XLA
// compiles; no pallas_call computes it. This kernel computes the same
// FlashAttention-2 equations from the forward's o and its log-sum-exp lse
// (B14 given an lse pointer, flash_attention.cu):
//
//   D[i] = sum_c dO[i, c] o[i, c]
//   s = mask(q k^T * scale) (-1e30 where masked); p = exp(s - lse[i])
//   dp = dO v^T;  ds = p (dp - D[i])
//   dq = scale * ds k;  dk = scale * ds^T q;  dv = p^T dO
//
// with GQA (kv head = h / G; dk and dv sum over the G query heads of a kv
// head), the causal and sliding-window masks on absolute positions of B14
// and flash.py's _block_mask (kpos <= qpos, kpos > qpos - window). Lq != S
// is allowed; q, k, v, o and dO are read by strides (the model's (B, H, L,
// d) views of (B, L, H, d) tensors), dq, dk and dv written by strides.
//
// Two builds of one design, by operand type T: float32
// (flash_attention_bwd_f32) and bfloat16 (flash_attention_bwd_bf16). lse,
// D, every product, sum and exp, the shared-memory tiles and the dq
// partials are f32 in both: a bf16 operand is widened to f32 (exact) as it
// is loaded, and dq, dk and dv are rounded to bf16 once, at the store
// (__float2bfloat16_rn). That is JAX's bwd on bf16 operands: it upcasts
// dO, o, k and v, runs _sdot on bf16 q and k with f32 accumulation (each
// bf16 product is exact in f32) and casts dq, dk and dv to their operands'
// dtypes once at the end (flash.py:103-104, :120-131, :149-162).
//
// Bound: operations. Five products of the causal band: at training's shape
// (B 4 a worker, H = K = 12, L 256, d 64: 32,896 (q, k) pairs a head)
// 2 * 5 * 48 * 32,896 * 64 = 1.01 GFLOP, 0.0151 ms at an H100 SXM's 67
// TFLOP/s of f32 outside the tensor cores, against 6 x 3.1 MB read and 3 x
// 3.1 MB written (0.0075 ms at 3.35 TB/s). The products are fmaf on the
// CUDA cores: TF32 would not hold the f32 tolerance. The bf16 build runs
// the same f32 products on the CUDA cores; what the card could do for its
// work is the band's five products on the bf16 tensor cores (989 TFLOP/s
// dense): at qwen3-4b's training shape (B 4, H 32, K 8, L 256, d 128) 2 *
// 5 * 128 * 32,896 * 128 = 5.4 GFLOP, 0.0054 ms there, against 0.080 ms
// as f32 FMAs at 67 TFLOP/s. A wgmma design is left to a later change.
//
// Three grids a call on the caller's stream, behind the one C entry point;
// the second and third start by programmatic dependent launch (their blocks
// load what does not depend on the grid before, then wait for it):
//   prep: D of every query row, once (8 lanes a row, a xor butterfly), so
//     every block of the next grid reads the same bits.
//   main: one block of 256 threads (8 warps) per (b, kv head, tile of BK
//     keys), key tile 0 first (the heaviest under causal). A block walks the
//     G query heads of its kv head in order and, for each, the query tiles
//     of BQ rows that meet its key tile, from the last down. For each
//     (query tile, key tile) pair it computes s, p, dp and ds once: warps
//     0-3 s = q k^T, p, then dv += p^T dO; warps 4-7 dp = dO v^T, then (once
//     p is in shared memory, a named barrier) ds, then dk += ds^T q; then
//     all eight the pair's dq partial ds k, into a scratch slot of its own.
//     Five products, each 4 x 4 outputs a thread (8 float4 reads of shared
//     memory to 64 FMA). dk and dv stay in registers; each pair's product is
//     summed apart, then added (a two-level sum).
//   dq: the slots of a query tile summed in key-tile order, times scale;
//     a thread a float4. No float atomics: two calls give the same bits.
// The slot of (b, h, query tile qt, key tile kt) lies at ((b H + h) pairs +
// base[qt] + kt - lo[qt]) BQ DMAX floats, base[qt] the pairs of the query
// tiles before qt in the band, so the scratch holds the band's pairs, not
// L^2 (15.7 MB at training's shape, in the 50 MB L2). The wrapper
// (kernels/flash_backward.py) allocates it, the partials then D, with the
// same plan (flash_backward.plan); the launcher recomputes the size and
// refuses another.
//
// Tiles by head dim (BwdTiles): d <= 64: 64 query rows x 32 keys, 112 KB of
// shared memory, two blocks (16 warps) an SM under __launch_bounds__(256, 2)
// (at most 128 registers a thread; the H100 build: 128, no spills); d <=
// 128: 32 x 32, 113 KB, two blocks (127 registers, 24 bytes of spills);
// d <= 256: 32 x 32, 209 KB, one block. Shared memory holds the K and V
// tiles, two buffers of the q and dO tiles and of the tile's lse and D (the
// next query tile's land by cp.async while this one's products run; 16-byte
// copies where an operand allows them: a unit last stride, the head dim and
// every other stride a multiple of 4, a 16-byte aligned base, which the
// wrapper checks per operand and the launcher checks again; else element by
// element; bf16: 16-byte loads of 8 elements where the head dim and every
// other stride are multiples of 8, widened and stored to shared memory by
// the thread, so its copies land before the products rather than during
// them), p^T and ds^T [BK][BQ + 4] and ds [BQ][BK + 4]. Rows are padded
// to 4 floats past a multiple of 32, so the eight rows or eight column
// groups a warp reads as float4s fall on distinct banks.
//
// Heaviest block at training's shape: key tiles 0 and 1 meet all four
// 64-row query tiles, 4 x 5 x 64 x 32 x 64 = 2.6M FMA. The 384 blocks
// overfill the 264 block slots (132 SMs x 2), so every such block shares
// its SM and gets at most half its 128 FMA a clock: 20.7 us at 1.98 GHz,
// over the whole kernel's 15.1 us bound (10.3 us only with an SM to
// itself). Splitting its query range would not shorten the grid here: the
// 960 pairs are 3.6 a slot, so in whole pairs some slot runs 4 whatever
// the split, and the split would add dk and dv partials and their sum.
//
// Skipped tiles: a query tile whose rows all have a valid key in [0, S)
// meets only the key tiles of its causal/window band; outside it p =
// exp(-1e30 - lse) = 0 exactly, so nothing is added. A row with no valid key
// has lse = -1e30 (flash.py's forward gives it the mean of v) and p = 1 on
// every key, as in flash.py, so a query tile that holds such a row meets
// every key tile. The rows with a valid key form a prefix of [0, Lq) (a
// row's band moves right by at most one key a row), so the tile's last row
// decides. Keys past S and query rows past Lq get p = 0.
#include "reduce.cuh"

using namespace repro;

namespace {

constexpr int kBwdThreads = 256;
constexpr int kHalf = 128;           // threads of one half (4 warps)
constexpr int kTX = 8;               // lanes that share a row of D's sum
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

// the operands read 16 bytes at a time: bits of BwdArgs::vec (o: D's sum)
constexpr int kVecQ = 1, kVecK = 2, kVecV = 4, kVecDO = 8, kVecO = 16;

// query rows (BQ) and keys (BK) of a tile pair, and the blocks an SM holds,
// by head-dim capacity; kernels/flash_backward.py's TILES mirrors them
template <int DMAX>
struct BwdTiles;
template <>
struct BwdTiles<64> {
  static constexpr int BQ = 64, BK = 32, MIN_BLOCKS = 2;
};
template <>
struct BwdTiles<128> {
  static constexpr int BQ = 32, BK = 32, MIN_BLOCKS = 2;
};
template <>
struct BwdTiles<256> {
  static constexpr int BQ = 32, BK = 32, MIN_BLOCKS = 1;
};

template <int DMAX>
struct BwdLayout {
  static constexpr int BQ = BwdTiles<DMAX>::BQ, BK = BwdTiles<DMAX>::BK;
  static constexpr int RP = DMAX + 4;    // padded operand row (q, dO, k, v)
  static constexpr int TP = BQ + 4;      // padded row of p^T and dp^T / ds^T [BK][TP]
  static constexpr int SP = BK + 4;      // padded row of ds [BQ][SP]
  // s (warps 0-3) or dp (warps 4-7): rows ty + 16 i, keys tx + 8 j of a half
  static constexpr int S_RM = BQ / 16, S_CN = BK / 8;
  // dk (warps 0-3) or dv (warps 4-7): keys kr + 8 i, columns 4 cg + 64 c
  static constexpr int K_RM = BK / 8, NC = DMAX / 64;
  // dq (all warps): rows qr + 16 i, columns 4 cg + 64 c
  static constexpr int Q_RM = BQ / 16;
  static constexpr int SLOT = BQ * DMAX;  // floats of one dq partial
  static constexpr int BUF = 2 * BQ * RP + 2 * BQ;   // one query tile's buffer
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (size_t)BK * RP + 2 * (size_t)BUF + 2 * (size_t)BK * TP +
                       (size_t)BQ * SP);
  static_assert(S_RM * 16 == BQ && S_CN * 8 == BK && K_RM * 8 == BK && Q_RM * 16 == BQ &&
                    NC * 64 == DMAX,
                "tiles must fill the thread layouts");
  static_assert(RP % 32 == 4 && TP % 32 == 4 && SP % 32 == 4, "bank-spreading pads");
};

struct BwdArgs {
  int64_t b, h, kh, lq, s, d;
  int64_t qs[4], ks[4], vs[4], os[4], dos[4], dqs[4], dks[4], dvs[4];  // element strides
  int64_t causal, has_window, window;
  int vec;                        // kVec* bits
  float scale;
  int64_t nq, nk, pairs;          // query tiles, key tiles, tile pairs of one head's band
};

template <typename T>
struct BwdPtrs {
  const T *q, *k, *v, *o, *dout;  // operands in T (float or bf16)
  const float* lse;
  T *dq, *dk, *dv;
  float* part;                    // dq partials [b][h][pairs][BQ][DMAX]
  float* delta;                   // D [b][h][lq]
};

// elements of T in 16 bytes: the unit of the 16-byte copies
template <typename T>
constexpr int kVecElems = 16 / (int)sizeof(T);

// a computed f32 value stored in T: itself, or rounded once to bf16
__device__ __forceinline__ void put(float* dst, float y) { *dst = y; }
__device__ __forceinline__ void put(bf16* dst, float y) { *dst = __float2bfloat16_rn(y); }

// 8 bf16 of one 16-byte word widened to f32 (exact: a bf16 is the top
// half of an f32)
__device__ __forceinline__ void widen8(const uint4& raw, float4& lo, float4& hi) {
  lo = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                   __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  hi = make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                   __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
}

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ float comp(const float4& f, int x) {
  return x == 0 ? f.x : (x == 1 ? f.y : (x == 2 ? f.z : f.w));
}

// Whether query row qpos has a valid key in [0, S).
__host__ __device__ __forceinline__ bool row_has_key(const BwdArgs& a, int64_t qpos) {
  int64_t lo = 0, hi = a.s - 1;
  if (a.causal) hi = imin(hi, qpos);
  if (a.has_window) lo = imax(lo, qpos - a.window + 1);
  return lo <= hi;
}

// Whether key kpos is masked for query row qpos (kpos < S).
__device__ __forceinline__ bool masked(const BwdArgs& a, int64_t qpos, int64_t kpos) {
  return (a.causal && kpos > qpos) || (a.has_window && kpos <= qpos - a.window);
}

// The key tiles [lo, hi) that query tile qt meets (see the note on skipped
// tiles): its rows' band, or every key tile if its last row has no key.
template <int BQ, int BK>
__host__ __device__ __forceinline__ void key_tiles(const BwdArgs& a, int64_t qt, int64_t& lo,
                                                   int64_t& hi) {
  const int64_t q0 = qt * BQ, qlast = imin(q0 + BQ, a.lq) - 1;
  if (!row_has_key(a, qlast)) {
    lo = 0;
    hi = a.nk;
    return;
  }
  int64_t klo = 0, khi = a.s - 1;
  if (a.causal) khi = imin(khi, qlast);
  if (a.has_window) klo = imax(klo, q0 - a.window + 1);
  lo = klo / BK;
  hi = khi / BK + 1;
}

// One step of a block's walk: head gi of the kv head's group, query tile qt,
// the key tiles [lo, hi) that qt meets, and base, the slots of the query
// tiles before qt in one head's band (the launcher keeps all of them under
// 2^31).
struct Visit {
  int gi, qt, lo, hi, base;
};

// Advances v to the next (head, query tile) of the walk that meets key tile
// kt: the G heads in order, each head's query tiles from the last down;
// false past the end. Start from {-1, 0, 0, 0, 0}.
template <int BQ, int BK>
__device__ __forceinline__ bool advance(const BwdArgs& a, int kt, int g, Visit& v) {
  while (true) {
    if (v.qt == 0) {
      if (++v.gi == g) return false;
      v.qt = (int)a.nq;
      v.base = (int)a.pairs;
    }
    --v.qt;
    int64_t lo, hi;
    key_tiles<BQ, BK>(a, v.qt, lo, hi);
    v.lo = (int)lo;
    v.hi = (int)hi;
    v.base -= v.hi - v.lo;
    if (v.lo <= kt && kt < v.hi) return true;
  }
}

// 16 bytes from global to shared memory, asynchronously; valid = false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until every copy this thread committed has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// named barriers (0 is __syncthreads'): wait for `count` threads, or
// arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Programmatic dependent launch: a grid lets the next one in the stream
// start, and a grid launched that way waits for the previous one's end and
// its writes before it reads them (both no-ops without the launch attribute)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Rows row0 .. row0 + ROWS - 1 of one (rows, d) operand into a row-major f32
// tile of row stride STRIDE and DMAX columns, zero past nrows and past d.
// f32: by cp.async 16 bytes at a time where vec, else element by element,
// each thread moving 4 neighbouring columns of a row at a time. bf16: where
// vec, 8 neighbouring columns a thread from one 16-byte load, widened to
// f32 and stored; else element by element, widened.
template <int ROWS, int DMAX, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const bf16* src, int64_t row0,
                                          int64_t nrows, int64_t rs, int64_t cs, int64_t d,
                                          bool vec) {
  if (vec) {                           // d % 8 == 0 on this path
    constexpr int G8 = DMAX / 8;
    for (int e = threadIdx.x; e < ROWS * G8; e += kBwdThreads) {
      const int r = e / G8, c = (e % G8) * 8;
      const int64_t row = row0 + r;
      float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
      if (row < nrows && c < d)
        widen8(*reinterpret_cast<const uint4*>(src + row * rs + c), lo, hi);
      float* sp = dst + r * STRIDE + c;
      *reinterpret_cast<float4*>(sp) = lo;
      *reinterpret_cast<float4*>(sp + 4) = hi;
    }
    return;
  }
  constexpr int G4 = DMAX / 4;
  for (int e = threadIdx.x; e < ROWS * G4; e += kBwdThreads) {
    const int r = e / G4, c = (e % G4) * 4;
    const int64_t row = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < nrows && c < d) {
      const bf16* p = src + row * rs + c * cs;
      x.x = to_f32(p[0]);
      if (c + 1 < d) x.y = to_f32(p[cs]);
      if (c + 2 < d) x.z = to_f32(p[2 * cs]);
      if (c + 3 < d) x.w = to_f32(p[3 * cs]);
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = x;
  }
}
template <int ROWS, int DMAX, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row0,
                                          int64_t nrows, int64_t rs, int64_t cs, int64_t d,
                                          bool vec) {
  constexpr int G4 = DMAX / 4;
  for (int e = threadIdx.x; e < ROWS * G4; e += kBwdThreads) {
    const int r = e / G4, c = (e % G4) * 4;
    const int64_t row = row0 + r;
    float* sp = dst + r * STRIDE + c;
    const bool ok = row < nrows && c < d;
    if (vec) {                         // d % 4 == 0 on this path
      cp_async16(sp, ok ? (const void*)(src + row * rs + c) : (const void*)src, ok);
      continue;
    }
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok) {
      const float* p = src + row * rs + c * cs;
      x.x = p[0];
      if (c + 1 < d) x.y = p[cs];
      if (c + 2 < d) x.z = p[2 * cs];
      if (c + 3 < d) x.w = p[3 * cs];
    }
    *reinterpret_cast<float4*>(sp) = x;
  }
}

// The q and dO tiles of query tile q0 of head (bi, hq) and its rows' lse and
// D into one buffer (q [BQ][RP], dO [BQ][RP], lse [BQ], D [BQ]).
template <int DMAX, typename T>
__device__ __forceinline__ void load_query_tile(const BwdPtrs<T>& p, const BwdArgs& a, int64_t bi,
                                                int64_t hq, int64_t q0, float* buf) {
  using L = BwdLayout<DMAX>;
  constexpr int BQ = L::BQ, RP = L::RP;
  load_tile<BQ, DMAX, RP>(buf, p.q + bi * a.qs[0] + hq * a.qs[1], q0, a.lq, a.qs[2], a.qs[3],
                          a.d, a.vec & kVecQ);
  load_tile<BQ, DMAX, RP>(buf + BQ * RP, p.dout + bi * a.dos[0] + hq * a.dos[1], q0, a.lq,
                          a.dos[2], a.dos[3], a.d, a.vec & kVecDO);
  const int64_t rb = (bi * a.h + hq) * a.lq;
  for (int r = threadIdx.x; r < 2 * BQ; r += kBwdThreads) {
    const int64_t row = q0 + r % BQ;
    const bool ok = row < a.lq;
    const float* src = (r < BQ ? p.lse : p.delta) + (ok ? rb + row : 0);
    cp_async4(buf + 2 * BQ * RP + r, src, ok);
  }
}

// s[i][j] = sum_c A[ty + 16 i][c] B[tx + 8 j][c] over DMAX columns, 4 at a
// time: a score tile of two row-major operand tiles.
template <int RM, int CN, int DMAX, int RP>
__device__ __forceinline__ void score_tile(float (&s)[RM][CN], const float* A, const float* B,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < DMAX; c += 4) {
    float4 bf[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j)
      bf[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * RP + c);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * RP + c);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(af.x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af.y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af.z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af.w, bf[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][4 c + x] += sum_kk A[r + RSTEP i][kk] B[kk][4 cg + 64 c + x] over
// DEPTH, 4 at a time: dk += ds^T q, dv += p^T dO (RSTEP 8), dq = ds k
// (RSTEP 16).
template <int RM, int RSTEP, int NC, int DEPTH, int AS, int BS>
__device__ __forceinline__ void tile_product(float (&acc)[RM][4 * NC], const float* A,
                                             const float* B, int r, int cg) {
#pragma unroll 2
  for (int kk = 0; kk < DEPTH; kk += 4) {
    float4 af[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      af[i] = *reinterpret_cast<const float4*>(A + (r + RSTEP * i) * AS + kk);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float4 bf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        bf[c] = *reinterpret_cast<const float4*>(B + (kk + x) * BS + 4 * cg + 64 * c);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float w = comp(af[i], x);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][4 * c + 0] = fmaf(w, bf[c].x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(w, bf[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(w, bf[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(w, bf[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// p = exp(mask(s * scale) - lse) of query row qpos and key kpos: 0 past S
// or past Lq, -1e30 for a masked key (flash.py's _NEG).
__device__ __forceinline__ float prob(const BwdArgs& a, float s, float lse, int64_t qpos,
                                      int64_t kpos) {
  if (kpos >= a.s || qpos >= a.lq) return 0.0f;
  const float x = masked(a, qpos, kpos) ? kNeg : __fmul_rn(s, a.scale);
  return expf(__fsub_rn(x, lse));
}

// Writes a thread's RM x 4 NC tile (rows r0 + r + RSTEP i, columns 4 cg +
// 64 c + x), times scale or not, by strides; rows past nrows and columns
// past d are dropped.
template <int RM, int RSTEP, int NC, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[RM][4 * NC], int64_t r0,
                                           int64_t nrows, int64_t rs, int64_t cs, int64_t d,
                                           float scale, bool scaled, int r, int cg) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = r0 + r + RSTEP * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * cg + 64 * c + x;
        if (col < d) {
          const float y = acc[i][4 * c + x];
          put(dst + row * rs + col * cs, scaled ? __fmul_rn(scale, y) : y);
        }
      }
  }
}

// The first grid: D of query rows blockIdx.x * 32 .. + 31 of the flattened
// (b, h, lq) rows (the 8 lanes of a row each sum their columns in order, 4
// (f32) or 8 (bf16) neighbours at a time where dO and o allow 16-byte
// loads, then a xor butterfly adds their sums).
__device__ __forceinline__ float dot_vec(const float* dr, const float* orow, int tx, int64_t d) {
  float acc = 0.0f;
  for (int64_t c = 4 * tx; c < d; c += 4 * kTX) {
    const float4 x = *reinterpret_cast<const float4*>(dr + c);
    const float4 y = *reinterpret_cast<const float4*>(orow + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot_vec(const bf16* dr, const bf16* orow, int tx, int64_t d) {
  float acc = 0.0f;
  for (int64_t c = 8 * tx; c < d; c += 8 * kTX) {
    float4 x[2], y[2];
    widen8(*reinterpret_cast<const uint4*>(dr + c), x[0], x[1]);
    widen8(*reinterpret_cast<const uint4*>(orow + c), y[0], y[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc = fmaf(x[i].x, y[i].x, acc);
      acc = fmaf(x[i].y, y[i].y, acc);
      acc = fmaf(x[i].z, y[i].z, acc);
      acc = fmaf(x[i].w, y[i].w, acc);
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_prep_kernel(BwdPtrs<T> p, BwdArgs a, int64_t rows) {
  launch_dependents();                // the main grid may load its K and V tiles
  const int64_t row = (int64_t)blockIdx.x * (kBwdThreads / kTX) + threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  float acc = 0.0f;
  if (row < rows) {
    const int64_t bi = row / (a.h * a.lq), hi = row / a.lq % a.h, r = row % a.lq;
    const T* dr = p.dout + bi * a.dos[0] + hi * a.dos[1] + r * a.dos[2];
    const T* orow = p.o + bi * a.os[0] + hi * a.os[1] + r * a.os[2];
    if ((a.vec & kVecDO) && (a.vec & kVecO)) {     // unit column strides, 16-byte rows
      acc = dot_vec(dr, orow, tx, a.d);
    } else {
      for (int64_t c = tx; c < a.d; c += kTX)
        acc = fmaf(to_f32(dr[c * a.dos[3]]), to_f32(orow[c * a.os[3]]), acc);
    }
  }
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (row < rows && tx == 0) p.delta[row] = acc;
}

// The second grid: one block per (b, kv head, key tile), key tile 0 first.
// Warps 0-3 compute s and p and hold dv; warps 4-7 compute dp and ds and
// hold dk; all eight compute the dq partial. A pair's phases:
//   warps 0-3: s = q k^T, p -> p^T (then named barrier 2 says so), then
//     dv += p^T dO;
//   warps 4-7: dp = dO v^T; once p^T is there, ds = p (dp - D) -> ds^T and
//     ds, then dk += ds^T q;
//   then a barrier, and all eight: the dq partial ds k into the pair's slot.
// So a pair passes two barriers of the whole block: the halves wait on each
// other only where warps 4-7 need p. dk and dv add each pair's product,
// summed apart, to their sums (a two-level sum, shorter rounding chains).
template <int DMAX, typename T>
__global__ void __launch_bounds__(kBwdThreads, BwdTiles<DMAX>::MIN_BLOCKS)
flash_bwd_kernel(BwdPtrs<T> p, BwdArgs a) {
  using L = BwdLayout<DMAX>;
  constexpr int BQ = L::BQ, BK = L::BK, RP = L::RP, TP = L::TP, SP = L::SP, BUF = L::BUF;
  constexpr int S_RM = L::S_RM, S_CN = L::S_CN, K_RM = L::K_RM, Q_RM = L::Q_RM, NC = L::NC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BK][RP]
  float* vs = ks + BK * RP;         // [BK][RP]
  float* bufs = vs + BK * RP;       // 2 x (q [BQ][RP], dO [BQ][RP], lse [BQ], D [BQ])
  float* pt = bufs + 2 * BUF;       // p^T [BK][TP]
  float* dst = pt + BK * TP;        // ds^T [BK][TP]
  float* dss = dst + BK * TP;       // ds [BQ][SP]

  launch_dependents();              // the dq grid may take SMs as blocks finish
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const bool first = w < 4;                               // warps 0-3
  const int ht = t % kHalf, hw = ht / 32;
  const int tx = ht % 8, ty = ht / 8;                     // s or dp
  const int kcg = lane % 8 + 8 * (hw % 2), kr = lane / 8 + 4 * (hw / 2);   // dv or dk
  const int qcg = lane % 8 + 8 * (w % 2), qr = lane / 8 + 4 * (w / 2);     // dq
  const int nbk = (int)(a.b * a.kh);
  const int bk = (int)(blockIdx.x % nbk), kt = (int)(blockIdx.x / nbk);
  const int64_t bi = bk / a.kh, khi = bk % a.kh;
  const int g = (int)(a.h / a.kh);
  const int64_t k0 = (int64_t)kt * BK;

  load_tile<BK, DMAX, RP>(ks, p.k + bi * a.ks[0] + khi * a.ks[1], k0, a.s, a.ks[2], a.ks[3], a.d,
                          a.vec & kVecK);
  load_tile<BK, DMAX, RP>(vs, p.v + bi * a.vs[0] + khi * a.vs[1], k0, a.s, a.vs[2], a.vs[3], a.d,
                          a.vec & kVecV);
  Visit cur = {-1, 0, 0, 0, 0};
  bool have = advance<BQ, BK>(a, kt, g, cur);
  wait_for_previous_grid();         // D
  if (have) load_query_tile<DMAX, T>(p, a, bi, khi * g + cur.gi, (int64_t)cur.qt * BQ, bufs);
  cp_async_commit();

  float acc[K_RM][4 * NC];          // dv (warps 0-3) or dk (warps 4-7)
#pragma unroll
  for (int i = 0; i < K_RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;

  int buf = 0;
  while (have) {
    Visit nxt = cur;
    const bool more = advance<BQ, BK>(a, kt, g, nxt);
    cp_async_wait_all();
    __syncthreads();                  // this tile landed; the last pair's readers are done
    if (more)
      load_query_tile<DMAX, T>(p, a, bi, khi * g + nxt.gi, (int64_t)nxt.qt * BQ,
                               bufs + (buf ^ 1) * BUF);
    cp_async_commit();                // the next tile lands during this pair's products

    const int64_t hq = khi * g + cur.gi, q0 = (int64_t)cur.qt * BQ;
    const float* qs = bufs + buf * BUF;
    const float* dos = qs + BQ * RP;
    const float* lse_s = dos + BQ * RP;
    const float* del_s = lse_s + BQ;
    float s[S_RM][S_CN];
    score_tile<S_RM, S_CN, DMAX, RP>(s, first ? qs : dos, first ? ks : vs, tx, ty);
    float part[K_RM][4 * NC];
#pragma unroll
    for (int i = 0; i < K_RM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) part[i][c] = 0.0f;
    if (first) {
      // no test on a pair inside the band: every row < Lq and every key < S
      // unmasked for every row
      const bool inside = q0 + BQ <= a.lq && k0 + BK <= a.s &&
                          (!a.causal || k0 + BK - 1 <= q0) &&
                          (!a.has_window || k0 > q0 + BQ - 1 - a.window);
#pragma unroll
      for (int i = 0; i < S_RM; ++i) {
        const int r = ty + 16 * i;
        const float lse = lse_s[r];
#pragma unroll
        for (int j = 0; j < S_CN; ++j) {
          const int c = tx + 8 * j;
          pt[c * TP + r] = inside ? expf(__fsub_rn(__fmul_rn(s[i][j], a.scale), lse))
                                  : prob(a, s[i][j], lse, q0 + r, k0 + c);
        }
      }
      bar_arrive(2, kBwdThreads);     // p^T written, for warps 4-7
      bar_sync(1, kHalf);             // and for the rest of warps 0-3
      tile_product<K_RM, 8, NC, BQ, TP, RP>(part, pt, dos, kr, kcg);   // p^T dO
    } else {
      bar_sync(2, kBwdThreads);       // p^T written
#pragma unroll
      for (int i = 0; i < S_RM; ++i) {
        const int r = ty + 16 * i;
        const float del = del_s[r];
#pragma unroll
        for (int j = 0; j < S_CN; ++j) {
          const int c = tx + 8 * j;
          const float ds = __fmul_rn(pt[c * TP + r], __fsub_rn(s[i][j], del));
          dst[c * TP + r] = ds;
          dss[r * SP + c] = ds;
        }
      }
      bar_sync(3, kHalf);             // ds^T written
      tile_product<K_RM, 8, NC, BQ, TP, RP>(part, dst, qs, kr, kcg);   // ds^T q
    }
#pragma unroll
    for (int i = 0; i < K_RM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fadd_rn(acc[i][c], part[i][c]);
    __syncthreads();                  // ds written
    float dqa[Q_RM][4 * NC];
#pragma unroll
    for (int i = 0; i < Q_RM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) dqa[i][c] = 0.0f;
    tile_product<Q_RM, 16, NC, BK, SP, RP>(dqa, dss, ks, qr, qcg);
    float* slot = p.part + ((bi * a.h + hq) * a.pairs + cur.base + (kt - cur.lo)) * L::SLOT;
#pragma unroll
    for (int i = 0; i < Q_RM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float4*>(slot + (qr + 16 * i) * DMAX + 4 * qcg + 64 * c) =
            make_float4(dqa[i][4 * c], dqa[i][4 * c + 1], dqa[i][4 * c + 2], dqa[i][4 * c + 3]);
    cur = nxt;
    have = more;
    buf ^= 1;
  }
  cp_async_wait_all();
  if (first)
    store_rows<K_RM, 8, NC>(p.dv + bi * a.dvs[0] + khi * a.dvs[1], acc, k0, a.s, a.dvs[2],
                            a.dvs[3], a.d, a.scale, false, kr, kcg);
  else
    store_rows<K_RM, 8, NC>(p.dk + bi * a.dks[0] + khi * a.dks[1], acc, k0, a.s, a.dks[2],
                            a.dks[3], a.d, a.scale, true, kr, kcg);
}

// The third grid: dq. A query tile of one (b, head) takes PARTS blocks; a
// thread sums one float4 of the tile's slots in key-tile order (all its
// loads in flight together), times scale, and writes its 4 columns.
template <int DMAX, typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(BwdPtrs<T> p, BwdArgs a) {
  using L = BwdLayout<DMAX>;
  constexpr int SLOT = L::SLOT, PARTS = SLOT / 4 / kBwdThreads;
  static_assert(PARTS * 4 * kBwdThreads == SLOT, "whole blocks a tile");
  const int64_t tile = blockIdx.x / PARTS;
  const int64_t bh = tile / a.nq, qt = tile % a.nq;
  const int e = ((int)(blockIdx.x % PARTS) * kBwdThreads + threadIdx.x) * 4;
  const int64_t row = qt * L::BQ + e / DMAX;
  const int col = e % DMAX;
  int64_t lo = 0, hi = 0, base = 0;
  for (int64_t x = 0; x <= qt; ++x) {
    base += hi - lo;
    key_tiles<L::BQ, L::BK>(a, x, lo, hi);
  }
  const float* src = p.part + (bh * a.pairs + base) * SLOT + e;
  const int n = (int)(hi - lo);
  wait_for_previous_grid();         // the partials
  float4 s = *reinterpret_cast<const float4*>(src);
#pragma unroll 8
  for (int j = 1; j < n; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(src + (int64_t)j * SLOT);
    s.x = __fadd_rn(s.x, x.x);
    s.y = __fadd_rn(s.y, x.y);
    s.z = __fadd_rn(s.z, x.z);
    s.w = __fadd_rn(s.w, x.w);
  }
  if (row >= a.lq) return;
  T* dst = p.dq + bh / a.h * a.dqs[0] + bh % a.h * a.dqs[1] + row * a.dqs[2];
  const float y[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
    if (col + x < a.d) put(dst + (col + x) * a.dqs[3], __fmul_rn(a.scale, y[x]));
}

// One grid of the call, launched after the previous one by programmatic
// dependent launch (it waits inside for what it reads).
template <typename T, typename... Args>
static cudaError_t launch_after(void (*kernel)(Args...), int64_t blocks, size_t smem,
                                cudaStream_t s, BwdPtrs<T> p, BwdArgs a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, a);
}

// The plan of one call (flash_backward.plan in Python): tile counts, the
// band's pairs of one head and the scratch's bytes (partials, then D).
template <int DMAX>
static int64_t plan_bytes(BwdArgs& a) {
  using L = BwdLayout<DMAX>;
  a.nq = (a.lq + L::BQ - 1) / L::BQ;
  a.nk = (a.s + L::BK - 1) / L::BK;
  a.pairs = 0;
  for (int64_t qt = 0; qt < a.nq; ++qt) {
    int64_t lo, hi;
    key_tiles<L::BQ, L::BK>(a, qt, lo, hi);
    a.pairs += hi - lo;
  }
  const int64_t bh = a.b * a.h;
  return 4 * (bh * a.pairs * L::SLOT + bh * a.lq);
}

template <int DMAX, typename T>
static int launch_bwd_d(BwdPtrs<T> p, BwdArgs a, void* scratch, int64_t scratch_bytes,
                        cudaStream_t s) {
  using L = BwdLayout<DMAX>;
  if (plan_bytes<DMAX>(a) != scratch_bytes) return (int)cudaErrorInvalidValue;
  const int64_t bh = a.b * a.h, rows = bh * a.lq;
  p.part = (float*)scratch;
  p.delta = p.part + bh * a.pairs * L::SLOT;
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation (DMAX, T)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_kernel<DMAX, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_kernel<DMAX, T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int64_t prep_blocks = (rows + kBwdThreads / kTX - 1) / (kBwdThreads / kTX);
  const int64_t blocks = a.b * a.kh * a.nk, dq_blocks = bh * a.nq * (L::SLOT / 4 / kBwdThreads);
  // grid x, and the walk's tile and slot indices in 32-bit ints
  if (prep_blocks > 0x7fffffff || blocks > 0x7fffffff || dq_blocks > 0x7fffffff ||
      a.pairs > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  flash_bwd_prep_kernel<T><<<(unsigned)prep_blocks, kBwdThreads, 0, s>>>(p, a, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_after(flash_bwd_kernel<DMAX, T>, blocks, L::SMEM, s, p, a);
  if (e != cudaSuccess) return (int)e;
  e = launch_after(flash_bwd_dq_kernel<DMAX, T>, dq_blocks, 0, s, p, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// an operand read 16 bytes (kV elements) at a time: a 16-byte aligned base,
// a unit last stride, the head dim and every other stride multiples of kV
template <int kV>
__host__ __forceinline__ bool vec_ok(const void* ptr, const int64_t* st, int64_t d) {
  return aligned16(ptr) && st[3] == 1 && d % kV == 0 && st[0] % kV == 0 && st[1] % kV == 0 &&
         st[2] % kV == 0;
}

// The body of both entry points: dims as below, operands in T.
template <typename T>
static int flash_bwd_entry(int device, const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse, void* dq, void* dk,
                           void* dv, void* scratch, const int64_t* dims, double scale,
                           void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  BwdPtrs<T> p = {(const T*)q, (const T*)k,    (const T*)v, (const T*)o, (const T*)dout,
                  (const float*)lse, (T*)dq, (T*)dk, (T*)dv, nullptr, nullptr};
  BwdArgs a;
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.lq = dims[3]; a.s = dims[4]; a.d = dims[5];
  int64_t* st[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int x = 0; x < 8; ++x)
    for (int i = 0; i < 4; ++i) st[x][i] = dims[6 + 4 * x + i];
  a.causal = dims[38]; a.has_window = dims[39]; a.window = dims[40];
  a.vec = (int)dims[41];
  const int64_t scratch_bytes = dims[42];
  a.scale = (float)scale;
  if (a.b < 1 || a.h < 1 || a.kh < 1 || a.h % a.kh != 0 || a.lq < 1 || a.s < 1 || a.d < 1 ||
      a.d > 256 || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const void* vec_ptrs[5] = {q, k, v, dout, o};
  const int64_t* vec_strides[5] = {a.qs, a.ks, a.vs, a.dos, a.os};
  for (int x = 0; x < 5; ++x)
    if ((a.vec >> x & 1) && !vec_ok<kVecElems<T>>(vec_ptrs[x], vec_strides[x], a.d))
      return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_bwd_d<64, T>(p, a, scratch, scratch_bytes, s);
  if (a.d <= 128) return launch_bwd_d<128, T>(p, a, scratch, scratch_bytes, s);
  return launch_bwd_d<256, T>(p, a, scratch, scratch_bytes, s);
}

}  // namespace

extern "C" {

// dims: b, h, kh, lq, s, d, the strides (4 each) of q, k, v, o, dO, dq, dk
// and dv, causal, has_window, window, vec (kVec* bits: the operands read 16
// bytes at a time), the scratch's bytes (flash_backward.plan). q, k, v, o,
// dO, dq, dk and dv are float32 here, bfloat16 in flash_attention_bwd_bf16;
// lse is float32 in both
int flash_attention_bwd_f32(int device, const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse, void* dq, void* dk,
                            void* dv, void* scratch, const int64_t* dims, double scale,
                            void* stream) {
  return flash_bwd_entry<float>(device, q, k, v, o, dout, lse, dq, dk, dv, scratch, dims, scale,
                                stream);
}

int flash_attention_bwd_bf16(int device, const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse, void* dq,
                             void* dk, void* dv, void* scratch, const int64_t* dims,
                             double scale, void* stream) {
  return flash_bwd_entry<bf16>(device, q, k, v, o, dout, lse, dq, dk, dv, scratch, dims, scale,
                               stream);
}

}  // extern "C"

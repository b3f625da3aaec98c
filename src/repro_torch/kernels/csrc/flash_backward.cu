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
// and flash.py's _block_mask (kpos <= qpos, kpos > qpos - window), f32 math
// on f32 inputs. Lq != S is allowed; q, k, v, o and dO are read by strides
// (the model's (B, H, L, d) views of (B, L, H, d) tensors), dq, dk and dv
// written by strides.
//
// One launch, two kinds of block:
//   dk/dv blocks, one per (b, kv head, tile of BR keys), first: a loop over
//     the G query heads of the group and over the query tiles accumulates
//     dk and dv in registers, in that fixed order.
//   dq blocks, one per (b, head, tile of BR query rows): a loop over the
//     key tiles accumulates dq.
// Each output element is written by one thread of one block, summed in a
// fixed order: no atomics, so two runs give the same bits. Each block
// computes the D of the query rows it visits itself, from dO and o in
// global memory, with one routine (8 lanes a row, a xor butterfly), so the
// two kinds of block see the same bits of D.
//
// Bound: operations. At training's shape (B 4 a worker, H = K = 12, L 256,
// d 64, causal: 32,896 (q, k) pairs a head) the dq blocks do three products
// (s, dp, ds k) and the dk/dv blocks four (s and dp again, p^T dO, ds^T q):
// 2 * 7 * 48 * 32,896 * 64 = 1.41 GFLOP against 6 x 3.1 MB read and 3 x
// 3.1 MB written: 0.021 ms at an H100 SXM's 67 TFLOP/s of f32 outside the
// tensor cores, 0.008 ms at 3.35 TB/s. The products are fmaf on the CUDA
// cores: TF32 would not hold the f32 tolerance.
//
// Design: a simple register-tiled SIMT kernel of 128 threads, B14's thread
// layout. Thread (ty, tx) = (t / 8, t % 8) owns the RM rows ty + 16 i of a
// tile (query rows in a dq block, keys in a dk/dv block) and the CN columns
// tx + 8 j of the score tile (keys, or query rows), and the output columns
// 4 tx + 32 c4 .. +3 of its rows. Both products of a score tile read float4s
// of two row-major tiles padded to DMAX + 4 floats (8 lanes read 8 rows: 8
// distinct bank groups); the probabilities (dk/dv) and ds go to a tile
// padded to its width + 8, read back as float4s by the warp that wrote them
// (a __syncwarp, no barrier). The copies to shared memory are plain loads,
// 16 bytes at a time where an operand allows it (unit last stride, the head
// dim and every other stride a multiple of 4, a 16-byte aligned base: the
// wrapper checks it per operand and passes a mask, which the launcher checks
// again), else element by element; past the edges the tiles are zero. Tile
// sizes by head dim: DMAX 64 (RM 4, CN 8: 64 x 64 tiles), 128 (RM 4, CN 4:
// 64 rows against 32 columns) and 256 (RM 2, CN 4: 32 x 32); 88-143 KB of
// shared memory a block.
//
// Skipped tiles: as in B14, a block whose query rows all have a valid key in
// [0, S) visits only the tiles that meet their causal/window band; a tile
// outside it has p = exp(-1e30 - lse) = 0 exactly, so it adds nothing to dq,
// dk or dv. A row with no valid key has lse = -1e30 (flash.py's forward gives
// it the mean of v) and p = 1 on every key, as in flash.py, so a block that
// holds such a row visits every tile. Keys past S and query rows past Lq
// get p = 0.
#include "reduce.cuh"

using namespace repro;

namespace {

constexpr int kTX = 8;               // lanes that share a tile row
constexpr int kTY = 16;              // row groups of a block
constexpr int kBwdThreads = kTX * kTY;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

// the operands read 16 bytes at a time: bits of BwdArgs::vec
constexpr int kVecQ = 1, kVecK = 2, kVecV = 4, kVecDO = 8;

template <int DMAX>
struct BwdTiles {
  static constexpr int RM = DMAX == 256 ? 2 : 4;    // tile rows a thread owns
  static constexpr int CN = DMAX == 64 ? 8 : 4;     // score columns a thread owns
  static constexpr int BR = RM * kTY;               // rows of a block's tile
  static constexpr int BC = CN * kTX;               // columns of a score tile
  static constexpr int NV = DMAX / 32;              // float4 column groups a thread owns
  static constexpr int RP = DMAX + 4;               // padded operand row
  static constexpr int SP = BC + 8;                 // padded score row
  // dq: q, dO tiles [BR][RP], k, v tiles [BC][RP], ds [BR][SP]
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (2 * (size_t)BR * RP + 2 * (size_t)BC * RP + (size_t)BR * SP);
  // dk/dv: k, v tiles [BR][RP], q, dO tiles [BC][RP], p and ds [BR][SP],
  // lse and D [BC]
  static constexpr size_t SMEM_DKDV =
      sizeof(float) * (2 * (size_t)BR * RP + 2 * (size_t)BC * RP + 2 * (size_t)BR * SP +
                       2 * (size_t)BC);
  static constexpr size_t SMEM = SMEM_DQ > SMEM_DKDV ? SMEM_DQ : SMEM_DKDV;
};

struct BwdArgs {
  int64_t b, h, kh, lq, s, d;
  int64_t qs[4], ks[4], vs[4], os[4], dos[4], dqs[4], dks[4], dvs[4];  // element strides
  int64_t causal, has_window, window;
  int vec;                        // kVec* bits
  float scale;
};

struct BwdPtrs {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ float comp(const float4& f, int x) {
  return x == 0 ? f.x : (x == 1 ? f.y : (x == 2 ? f.z : f.w));
}

// Whether query row qpos has a valid key in [0, S).
__device__ __forceinline__ bool row_has_key(const BwdArgs& a, int64_t qpos) {
  int64_t lo = 0, hi = a.s - 1;
  if (a.causal) hi = imin(hi, qpos);
  if (a.has_window) lo = imax(lo, qpos - a.window + 1);
  return lo <= hi;
}

// Whether key kpos is masked for query row qpos (kpos < S).
__device__ __forceinline__ bool masked(const BwdArgs& a, int64_t qpos, int64_t kpos) {
  return (a.causal && kpos > qpos) || (a.has_window && kpos <= qpos - a.window);
}

// Whether every query row of [r0, r1) has a valid key (the same answer in
// every thread: each checks all the rows).
__device__ __forceinline__ bool rows_have_keys(const BwdArgs& a, int64_t r0, int64_t r1) {
  bool ok = true;
  for (int64_t r = r0; r < r1; ++r) ok = ok && row_has_key(a, r);
  return ok;
}

// Rows row0 .. row0 + ROWS - 1 of one (rows, d) operand into a row-major f32
// tile of row stride STRIDE and DMAX columns, zero past nrows and past d.
// Each thread moves 4 neighbouring columns of a row at a time.
template <int ROWS, int DMAX, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row0,
                                          int64_t nrows, int64_t rs, int64_t cs, int64_t d,
                                          bool vec) {
  constexpr int G4 = DMAX / 4;
  for (int e = threadIdx.x; e < ROWS * G4; e += kBwdThreads) {
    const int r = e / G4, c = (e % G4) * 4;
    const int64_t row = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < nrows && c < d) {
      if (vec) {                       // d % 4 == 0 on this path
        x = *reinterpret_cast<const float4*>(src + row * rs + c);
      } else {
        const float* p = src + row * rs + c * cs;
        x.x = p[0];
        if (c + 1 < d) x.y = p[cs];
        if (c + 2 < d) x.z = p[2 * cs];
        if (c + 3 < d) x.w = p[3 * cs];
      }
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = x;
  }
}

// acc[i][c] (+)= sum_kk sc[row ty + 16 i][kk] op[kk][4 tx + 32 c4 + x], over
// the BC columns of a score tile, 4 at a time: the two products into the
// output columns (dq += ds k; dv += p^T dO, dk += ds^T q).
template <int RM, int NV, int BC, int SP, int RP>
__device__ __forceinline__ void tile_product(float (&acc)[RM][4 * NV], const float* sc,
                                             const float* op, int tx, int ty) {
#pragma unroll 2
  for (int kk = 0; kk < BC; kk += 4) {
    float4 sf[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      sf[i] = *reinterpret_cast<const float4*>(sc + (ty + kTY * i) * SP + kk);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float4 of[NV];
#pragma unroll
      for (int c4 = 0; c4 < NV; ++c4)
        of[c4] = *reinterpret_cast<const float4*>(op + (kk + x) * RP + 4 * tx + 32 * c4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = comp(sf[i], x);
#pragma unroll
        for (int c4 = 0; c4 < NV; ++c4) {
          acc[i][4 * c4 + 0] = fmaf(p, of[c4].x, acc[i][4 * c4 + 0]);
          acc[i][4 * c4 + 1] = fmaf(p, of[c4].y, acc[i][4 * c4 + 1]);
          acc[i][4 * c4 + 2] = fmaf(p, of[c4].z, acc[i][4 * c4 + 2]);
          acc[i][4 * c4 + 3] = fmaf(p, of[c4].w, acc[i][4 * c4 + 3]);
        }
      }
    }
  }
}

// s[i][j] = sum_c a[row ty + 16 i][c] b[row tx + 8 j][c] over DMAX columns,
// 4 at a time: a score tile of two row-major operand tiles.
template <int RM, int CN, int DMAX, int RP>
__device__ __forceinline__ void score_tile(float (&s)[RM][CN], const float* a, const float* b,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < DMAX; c += 4) {
    float4 bf[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j)
      bf[j] = *reinterpret_cast<const float4*>(b + (tx + kTX * j) * RP + c);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(a + (ty + kTY * i) * RP + c);
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

// p = exp(mask(s * scale) - lse) of query row qpos and key kpos: 0 past S
// or past Lq, -1e30 for a masked key (flash.py's _NEG).
__device__ __forceinline__ float prob(const BwdArgs& a, float s, float lse, int64_t qpos,
                                      int64_t kpos) {
  if (kpos >= a.s || qpos >= a.lq) return 0.0f;
  const float x = masked(a, qpos, kpos) ? kNeg : __fmul_rn(s, a.scale);
  return expf(__fsub_rn(x, lse));
}

// Writes a thread's RM x 4 NV output tile, times scale (dq, dk) or not (dv),
// by strides; rows past nrows and columns past d are dropped.
template <int RM, int NV>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[RM][4 * NV], int64_t r0,
                                           int64_t nrows, int64_t rs, int64_t cs, int64_t d,
                                           float scale, bool scaled, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = r0 + ty + kTY * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int c4 = 0; c4 < NV; ++c4)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * tx + 32 * c4 + x;
        if (col < d) {
          const float y = acc[i][4 * c4 + x];
          dst[row * rs + col * cs] = scaled ? __fmul_rn(scale, y) : y;
        }
      }
  }
}


// D of query row `row` of head (bi, hi) (0 past Lq): the 8 lanes of a tile
// row each sum the columns tx + 8 c of dO o in order, then a xor butterfly
// adds their sums (every lane gets the same bits). Called by all 32 lanes of
// a warp together.
__device__ __forceinline__ float row_delta(const BwdPtrs& p, const BwdArgs& a, int64_t bi,
                                           int64_t hi, int64_t row, int tx) {
  float acc = 0.0f;
  if (row < a.lq) {
    const float* dr = p.dout + bi * a.dos[0] + hi * a.dos[1] + row * a.dos[2];
    const float* orow = p.o + bi * a.os[0] + hi * a.os[1] + row * a.os[2];
    for (int64_t c = tx; c < a.d; c += kTX) acc = fmaf(dr[c * a.dos[3]], orow[c * a.os[3]], acc);
  }
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

// One dq block: rank-th tile of BR query rows of head (bi, hi).
template <int DMAX>
__device__ __forceinline__ void dq_block(const BwdPtrs& p, const BwdArgs& a, int64_t block,
                                         float* smem) {
  using L = BwdTiles<DMAX>;
  constexpr int RM = L::RM, CN = L::CN, BQ = L::BR, BK = L::BC, NV = L::NV;
  constexpr int RP = L::RP, SP = L::SP;
  float* qs = smem;                 // [BQ][RP]
  float* dos = qs + BQ * RP;        // [BQ][RP]
  float* ks = dos + BQ * RP;        // [BK][RP]
  float* vs = ks + BK * RP;         // [BK][RP]
  float* dss = vs + BK * RP;        // [BQ][SP]: ds

  const int t = threadIdx.x, tx = t % kTX, ty = t / kTX;
  const int64_t nbh = a.b * a.h;
  const int64_t bh = block % nbh, rank = block / nbh;
  const int64_t nq = (a.lq + BQ - 1) / BQ;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (a.causal ? nq - 1 - rank : rank) * BQ;   // heaviest first
  const int64_t khi = hi / (a.h / a.kh);
  const float* kb = p.k + bi * a.ks[0] + khi * a.ks[1];
  const float* vb = p.v + bi * a.vs[0] + khi * a.vs[1];
  const int64_t row_base = (bi * a.h + hi) * a.lq;

  load_tile<BQ, DMAX, RP>(qs, p.q + bi * a.qs[0] + hi * a.qs[1], q0, a.lq, a.qs[2], a.qs[3], a.d,
                          a.vec & kVecQ);
  load_tile<BQ, DMAX, RP>(dos, p.dout + bi * a.dos[0] + hi * a.dos[1], q0, a.lq, a.dos[2],
                          a.dos[3], a.d, a.vec & kVecDO);
  float lse_r[RM], delta_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = q0 + ty + kTY * i;
    delta_r[i] = row_delta(p, a, bi, hi, row, tx);
    lse_r[i] = row < a.lq ? p.lse[row_base + row] : 0.0f;
  }

  // the key tiles to visit (see the note on skipped tiles above)
  const int64_t qlast = imin(q0 + BQ, a.lq) - 1;
  int64_t t_lo = 0, t_hi = (a.s + BK - 1) / BK;
  if (rows_have_keys(a, q0, qlast + 1)) {
    int64_t lo = 0, hi_key = a.s - 1;
    if (a.causal) hi_key = imin(hi_key, qlast);
    if (a.has_window) lo = imax(lo, q0 - a.window + 1);
    t_lo = lo / BK;
    t_hi = hi_key / BK + 1;
  }

  float acc[RM][4 * NV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.0f;

  for (int64_t kt = t_lo; kt < t_hi; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();                  // q, dO landed; every reader of the last K, V tiles is done
    load_tile<BK, DMAX, RP>(ks, kb, k0, a.s, a.ks[2], a.ks[3], a.d, a.vec & kVecK);
    load_tile<BK, DMAX, RP>(vs, vb, k0, a.s, a.vs[2], a.vs[3], a.d, a.vec & kVecV);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    score_tile<RM, CN, DMAX, RP>(s, qs, ks, tx, ty);
    score_tile<RM, CN, DMAX, RP>(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = q0 + ty + kTY * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pr = prob(a, s[i][j], lse_r[i], row, k0 + tx + kTX * j);
        dss[(ty + kTY * i) * SP + tx + kTX * j] = __fmul_rn(pr, __fsub_rn(dp[i][j], delta_r[i]));
      }
    }
    __syncwarp();                     // a warp reads back only the ds rows it wrote
    tile_product<RM, NV, BK, SP, RP>(acc, dss, ks, tx, ty);
  }
  store_rows<RM, NV>(p.dq + bi * a.dqs[0] + hi * a.dqs[1], acc, q0, a.lq, a.dqs[2], a.dqs[3], a.d,
                     a.scale, true, tx, ty);
}

// One dk/dv block: rank-th tile of BR keys of kv head (bi, khi).
template <int DMAX>
__device__ __forceinline__ void dkdv_block(const BwdPtrs& p, const BwdArgs& a, int64_t block,
                                           float* smem) {
  using L = BwdTiles<DMAX>;
  constexpr int RM = L::RM, CN = L::CN, BK = L::BR, BQ = L::BC, NV = L::NV;
  constexpr int RP = L::RP, SP = L::SP;
  float* ks = smem;                 // [BK][RP]
  float* vs = ks + BK * RP;         // [BK][RP]
  float* qs = vs + BK * RP;         // [BQ][RP]
  float* dos = qs + BQ * RP;        // [BQ][RP]
  float* ps = dos + BQ * RP;        // [BK][SP]: p^T
  float* dss = ps + BK * SP;        // [BK][SP]: ds^T
  float* lse_s = dss + BK * SP;     // [BQ]
  float* delta_s = lse_s + BQ;      // [BQ]

  const int t = threadIdx.x, tx = t % kTX, ty = t / kTX;
  const int64_t nbk = a.b * a.kh;
  const int64_t bk = block % nbk, rank = block / nbk;
  const int64_t bi = bk / a.kh, khi = bk % a.kh;
  const int64_t k0 = rank * BK;       // under causal the first key tiles are the heaviest
  const int64_t klast = imin(k0 + BK, a.s) - 1;
  const int64_t g = a.h / a.kh;
  load_tile<BK, DMAX, RP>(ks, p.k + bi * a.ks[0] + khi * a.ks[1], k0, a.s, a.ks[2], a.ks[3], a.d,
                          a.vec & kVecK);
  load_tile<BK, DMAX, RP>(vs, p.v + bi * a.vs[0] + khi * a.vs[1], k0, a.s, a.vs[2], a.vs[3], a.d,
                          a.vec & kVecV);

  float dka[RM][4 * NV], dva[RM][4 * NV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) dka[i][c] = dva[i][c] = 0.0f;

  const int64_t nq = (a.lq + BQ - 1) / BQ;
  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t hi = khi * g + gi;
    const int64_t row_base = (bi * a.h + hi) * a.lq;
    for (int64_t qt = 0; qt < nq; ++qt) {
      const int64_t q0 = qt * BQ, qlast = imin(q0 + BQ, a.lq) - 1;
      // a tile wholly outside the band adds exactly nothing, if its rows all
      // have a key (the test is the same in every thread)
      const bool outside = (a.causal && qlast < k0) || (a.has_window && klast <= q0 - a.window);
      if (outside && rows_have_keys(a, q0, qlast + 1)) continue;
      __syncthreads();                // every reader of the last q-side tiles is done
      load_tile<BQ, DMAX, RP>(qs, p.q + bi * a.qs[0] + hi * a.qs[1], q0, a.lq, a.qs[2], a.qs[3],
                              a.d, a.vec & kVecQ);
      load_tile<BQ, DMAX, RP>(dos, p.dout + bi * a.dos[0] + hi * a.dos[1], q0, a.lq, a.dos[2],
                              a.dos[3], a.d, a.vec & kVecDO);
#pragma unroll
      for (int i = 0; i < BQ / kTY; ++i) {
        const int r = ty + kTY * i;
        const float dl = row_delta(p, a, bi, hi, q0 + r, tx);
        if (tx == 0) {
          delta_s[r] = dl;
          lse_s[r] = q0 + r < a.lq ? p.lse[row_base + q0 + r] : 0.0f;
        }
      }
      __syncthreads();
      float s[RM][CN], dp[RM][CN];
      score_tile<RM, CN, DMAX, RP>(s, ks, qs, tx, ty);     // s^T: keys x query rows
      score_tile<RM, CN, DMAX, RP>(dp, vs, dos, tx, ty);   // dp^T
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int64_t key = k0 + ty + kTY * i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int r = tx + kTX * j;
          const float pr = prob(a, s[i][j], lse_s[r], q0 + r, key);
          ps[(ty + kTY * i) * SP + r] = pr;
          dss[(ty + kTY * i) * SP + r] = __fmul_rn(pr, __fsub_rn(dp[i][j], delta_s[r]));
        }
      }
      __syncwarp();                   // a warp reads back only the rows it wrote
      tile_product<RM, NV, BQ, SP, RP>(dva, ps, dos, tx, ty);
      tile_product<RM, NV, BQ, SP, RP>(dka, dss, qs, tx, ty);
    }
  }
  store_rows<RM, NV>(p.dk + bi * a.dks[0] + khi * a.dks[1], dka, k0, a.s, a.dks[2], a.dks[3], a.d,
                     a.scale, true, tx, ty);
  store_rows<RM, NV>(p.dv + bi * a.dvs[0] + khi * a.dvs[1], dva, k0, a.s, a.dvs[2], a.dvs[3], a.d,
                     a.scale, false, tx, ty);
}

// The dk/dv blocks first (the heaviest under causal, G query heads each),
// then the dq blocks.
template <int DMAX>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(BwdPtrs p, BwdArgs a, int64_t dkdv_blocks) {
  extern __shared__ __align__(16) float smem[];
  const int64_t block = blockIdx.x;
  if (block < dkdv_blocks)
    dkdv_block<DMAX>(p, a, block, smem);
  else
    dq_block<DMAX>(p, a, block - dkdv_blocks, smem);
}

template <int DMAX>
static int launch_bwd_d(const BwdPtrs& p, const BwdArgs& a, cudaStream_t s) {
  using L = BwdTiles<DMAX>;
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_kernel<DMAX>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int64_t dkdv_blocks = (a.s + L::BR - 1) / L::BR * a.b * a.kh;
  const int64_t blocks = dkdv_blocks + (a.lq + L::BR - 1) / L::BR * a.b * a.h;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_kernel<DMAX><<<(unsigned)blocks, kBwdThreads, L::SMEM, s>>>(p, a, dkdv_blocks);
  return (int)cudaGetLastError();
}

__host__ __forceinline__ bool vec_ok(const void* ptr, const int64_t* st, int64_t d) {
  return aligned16(ptr) && st[3] == 1 && d % 4 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
         st[2] % 4 == 0;
}

}  // namespace

extern "C" {

// dims: b, h, kh, lq, s, d, the strides (4 each) of q, k, v, o, dO, dq, dk
// and dv, causal, has_window, window, vec (kVec* bits: the operands read 16
// bytes at a time)
int flash_attention_bwd_f32(int device, const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse, void* dq, void* dk,
                            void* dv, const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  const BwdPtrs p = {(const float*)q,  (const float*)k,    (const float*)v,
                     (const float*)o,  (const float*)dout, (const float*)lse,
                     (float*)dq,       (float*)dk,         (float*)dv};
  BwdArgs a;
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.lq = dims[3]; a.s = dims[4]; a.d = dims[5];
  int64_t* st[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int x = 0; x < 8; ++x)
    for (int i = 0; i < 4; ++i) st[x][i] = dims[6 + 4 * x + i];
  a.causal = dims[38]; a.has_window = dims[39]; a.window = dims[40];
  a.vec = (int)dims[41];
  a.scale = (float)scale;
  if (a.b < 1 || a.h < 1 || a.kh < 1 || a.h % a.kh != 0 || a.lq < 1 || a.s < 1 || a.d < 1 ||
      a.d > 256)
    return (int)cudaErrorInvalidValue;
  const void* vec_ptrs[4] = {q, k, v, dout};
  const int64_t* vec_strides[4] = {a.qs, a.ks, a.vs, a.dos};
  for (int x = 0; x < 4; ++x)
    if ((a.vec >> x & 1) && !vec_ok(vec_ptrs[x], vec_strides[x], a.d))
      return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_bwd_d<64>(p, a, s);
  if (a.d <= 128) return launch_bwd_d<128>(p, a, s);
  return launch_bwd_d<256>(p, a, s);
}

}  // extern "C"

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
// Two designs behind the one C signature, by operand type: float32
// (flash_attention_bwd_f32) runs the SIMT design of the first part of this
// note on the CUDA cores; bfloat16 (flash_attention_bwd_bf16) the
// tensor-core design of the second part. lse, D, every sum and exp are f32
// in both, and the bf16 build rounds dq, dk and dv to bf16 once, at the
// store (__float2bfloat16_rn): that is JAX's bwd on bf16 operands, which
// upcasts dO, o, k and v, runs _sdot on bf16 q and k with f32 accumulation
// (each bf16 product is exact in f32) and casts dq, dk and dv to their
// operands' dtypes once at the end (flash.py:103-104, :120-131, :149-162).
// Both start with the same grid, prep: D of every query row, once (8 lanes
// a row, a xor butterfly), so every block after it reads the same bits.
// The grids after it start by programmatic dependent launch (their blocks
// load what does not depend on the grid before, then wait for it). No
// float atomics in either design: two calls give the same bits.
//
// ---- f32: the SIMT design.
//
// Bound: operations. Five products of the causal band: at training's shape
// (B 4 a worker, H = K = 12, L 256, d 64: 32,896 (q, k) pairs a head)
// 2 * 5 * 48 * 32,896 * 64 = 1.01 GFLOP, 0.0151 ms at an H100 SXM's 67
// TFLOP/s of f32 outside the tensor cores, against 6 x 3.1 MB read and 3 x
// 3.1 MB written (0.0075 ms at 3.35 TB/s). The products are fmaf on the
// CUDA cores: TF32 would not hold the f32 tolerance.
//
// Three grids a call on the caller's stream:
//   prep: D.
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
//     a thread a float4.
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
// element), p^T and ds^T [BK][BQ + 4] and ds [BQ][BK + 4]. Rows are padded
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
// Skipped tiles (both designs): a query tile whose rows all have a valid
// key in [0, S) meets only the key tiles of its causal/window band; outside
// it p = exp(-1e30 - lse) = 0 exactly, so nothing is added. A row with no
// valid key has lse = -1e30 (flash.py's forward gives it the mean of v) and
// p = 1 on every key, as in flash.py, so a query tile that holds such a row
// meets every key tile. The rows with a valid key form a prefix of [0, Lq)
// (a row's band moves right by at most one key a row), so the tile's last
// row decides. Keys past S and query rows past Lq get p = 0.
//
// ---- bf16: the tensor-core design.
//
// Bound: the five products of the band on the bf16 tensor cores (989
// TFLOP/s dense) or the bytes, the larger. qwen3-4b's training shape (B 4,
// H 32, K 8, L 256, d 128, causal: 32,896 pairs a head): 2 * 5 * 128 *
// 32,896 * 128 = 5.39 GFLOP, 0.0054 ms, against 29.5 MB read (q, dO, o
// 8.4 MB each, k, v 2.1 MB, lse) and 12.6 MB written, 0.0126 ms at 3.35
// TB/s: bytes. gemma3-12b's (B 1, H 16, K 8, L 2048, d 256, causal:
// 2,098,176 pairs a head): 85.9 GFLOP, 0.0869 ms: operations. This design
// runs 14 products of the band, not 5 (below), so its own floor at the
// tensor cores' rate is 2.8 times the operations bound.
//
// Arithmetic. S (or S^T) = Q K^T and dP (or dP^T) = dO V^T have bf16
// operands, so every product is exact in f32: plain wgmma with f32
// accumulation, the scale after the product. p and ds are f32 (IEEE-rounded
// operations under the build's -fmad=false, expf). In dV += P^T dO, dK +=
// dS^T Q and dQ += dS K each is split in three, x_hi = bf16(x), x_mid =
// bf16(x - x_hi), x_lo = bf16(x - x_hi - x_mid) (each residual exact in
// f32; the three within 2^-24 |x| of x), and the three products go into
// one f32 accumulator. Split in two (x_hi + x_lo, within 2^-16 |x|, as B14
// bf16 splits p) the result broke chip_smoke.bf16_bwd_excess, each output
// element's rule, on 3 of 26 cases on the card (by up to 6.7%) and 4 of 23
// in the CPU emulation (tests/test_torch_bwd_tc_numerics.py): a split error
// of 2^-16 of the large ds of rows with no valid key (p = 1 on every key)
// or of an element that cancels lands past the rule's f32 margin.
//
// Three grids a call on the caller's stream, each output element written
// by one block, its sum in a fixed order (flash.py's own split: dq_block by
// query block, dkv_block by key block), no dq scratch:
//   prep: D (flash_bwd_prep_kernel<bf16>, 16-byte loads of 8 where dO and o
//     allow them).
//   dk/dv (flash_bwd_dkv_kernel): one block of two warpgroups per (b, kv
//     head, tile of 64 keys), key tile 0 first. k and v stay in shared
//     memory; the block walks the G heads in order and each head's query
//     tiles of KV_BQ rows that meet its key tile, from the last down,
//     through a ring of KV_NST stages, each the q and dO tiles and their
//     rows' lse and D. A visit: S^T = K Q^T by wgmma m64nKV_BQk16 with the
//     keys as M and both operands K-major from shared memory, in both
//     warpgroups; warpgroup 1 also dP^T = V dO^T. p^T and ds^T then lie in
//     the accumulator fragment, which is the A-register fragment of dV +=
//     P^T dO (warpgroup 0) and dK += dS^T Q (warpgroup 1) (m64nDMAXk16, dO
//     and q MN-major from the stage): nothing goes through shared memory,
//     and the two warpgroups run one update sequence on two tiles. lse and
//     D are read along N from the stage. dK and dV sum over the heads and
//     query tiles in the walk's order; dk is scaled once at the store.
//     One warpgroup can not hold both dK and dV with the three-way split's
//     fragments (at d = 128: 128 f32 of sums, 48 of fragments, 64 of S^T
//     and dP^T a thread; at d = 256 the sums alone take 256), so each
//     warpgroup holds one, as the f32 design splits its halves, and
//     warpgroup 1 computes S^T again. Handing p^T from warpgroup 0 to 1
//     through shared memory instead measured 1-5% slower (PERF.md §6): it
//     puts warpgroup 1 behind warpgroup 0 on every visit. The stage copies
//     are warpgroup 1's (its first warp), the warpgroup that does more: a
//     thread that waits for a stage to empty stalls its warpgroup's
//     wgmmas, so warpgroup 0 runs ahead instead of in step.
//   dq (flash_bwd_dq_tc_kernel): one block of two warpgroups per (b, head,
//     tile of 128 query rows), warpgroup w on rows 64 w .. 64 w + 63, the
//     heaviest query tile first under causal. q and dO stay in shared
//     memory; the key tiles of DQ_BK keys that meet the query tile's band
//     go through a ring of DQ_NST stages (k, v) in order, both warpgroups
//     reading each (a tile outside one warpgroup's band adds exactly 0 to
//     its rows: p = 0 there). A key tile: S = Q K^T, dP = dO V^T
//     (m64nDQ_BKk16), p and ds in registers, dQ += dS K (A from registers,
//     k MN-major). dQ is one f32 sum in key-tile order, scaled and rounded
//     once at the store.
//   Products: S^T twice, dP^T and three each of dV and dK in the dk/dv
//   pass; S, dP and three of dQ in the dq pass: 14 in all, where the
//   function needs 5 (the dq pass recomputes S and dP, against a dq
//   scratch that cost more than the products: see (2) below).
// Copies: where q, k, v and dO all have unit last stride, a head dim and
// strides that are multiples of 8 elements and 16-byte aligned bases
// (flash_attention.tc_copy_ok, checked again here), TMA: one thread copies
// each tile as boxes of 64 columns of a 4-D tensor map (d, L, heads, batch),
// 128-byte swizzled, zero-filled past L and d, completing the stage's
// "full" mbarrier by its bytes. Otherwise (d 33, a view off by one
// element) every thread gathers 8 elements at a time by strides and stores
// the 16 bytes itself (tc.cuh:tc_gather), then a proxy fence and an
// arrive. The lse and D rows of a dk/dv stage come by 4-byte cp.async from
// the copying warp, whose 32 lanes each arrive on the stage's barrier when
// theirs landed. A stage's "empty" mbarrier completes when every thread has
// read it (an arrive after the wgmma that read it). The tiles, swizzle,
// descriptors and wgmma helpers are B14 bf16's (tc.cuh).
// Masks: a visited tile pair wholly inside a warpgroup's band and before
// Lq and S takes p = exp(s * scale - lse) with no test; any other the
// per-element test as int32 compares against a row's column bounds
// (RowMask: prob's function). Both choices are uniform over a warpgroup.
//
// Tiles by head dim (TcBwdTiles; registers and spills as ptxas reports
// them for the H100 build are in PERF.md §6):
//   d <= 64: dk/dv 64 keys x 64 query rows a stage, 4 stages, 85,064 bytes
//     of shared memory; dq 128 rows x 64 keys a stage, 3 stages, 83,000.
//   d <= 128: dk/dv 64 x 64, 3 stages, 133,688 bytes; dq 128 x 64, 2
//     stages, 132,136.
//   d <= 256: dk/dv 64 keys x 32 query rows a stage: k and v take 64 KB
//     and a stage of 32 rows 32 KB (64 rows would take 64 KB), so 3 stages
//     of 32 rows, 165,688 bytes. dq 128 rows x 32 keys a stage (the 128 f32
//     of dQ a thread leave no room for 64-key S and dP with the split's
//     fragments), 2 stages, 197,672 bytes.
//   Every block is two warpgroups, one block an SM.
//
// What became of the SIMT bf16 build's three limits (PERF.md §6 has the
// times): (1) every product runs on the tensor cores (wgmma; chip_smoke's
// phase bwd_bf16_sass counts HGMMA in all six kernels), where the SIMT
// build widened each operand and ran fmaf at about 11-19 TFLOP/s; (2) no
// dq scratch: dq is summed in registers by one block a query tile, so the
// bf16 scratch is D alone (4 b h Lq bytes: 0.13 MB at qwen3-4b's and
// gemma3-12b's shapes, where the slots took 75.6 MB and 1.09 GB); (3) the
// heaviest dk/dv block at qwen3-4b's shape walks 4 heads x 4 query tiles
// of 64 rows, 16 visits, on a grid of 128 blocks (one wave of 132 SMs),
// and the dq grid has 256 blocks of at most 4 key tiles.
// The G heads are not split across blocks: at qwen3-4b's shape that would
// give 512 dk/dv blocks of 4 visits, but their dk and dv partials (4 heads
// x 4 x 8 x 256 x 128 x 2 f32, 33.6 MB) would go to device memory and need
// a fixed-order sum after: 67 MB written and read, 0.02 ms at 3.35 TB/s,
// as long as the heaviest block's 16 visits take at the tensor cores' rate
// (16 x 9 products of 64 x 64 x 128, 0.15 GFLOP on one SM's 7.5 TFLOP/s).
#include <type_traits>

#include "reduce.cuh"
#include "tc.cuh"

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

// a computed f32 value stored in T (the SIMT design's f32)
__device__ __forceinline__ void put(float* dst, float y) { *dst = y; }

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

// The key tiles [lo, hi) of BK keys (nk of them) that query tile qt of BQ
// rows meets (see the note on skipped tiles): its rows' band, or every key
// tile if its last row has no key.
template <int BQ, int BK>
__host__ __device__ __forceinline__ void band_tiles(const BwdArgs& a, int64_t qt, int64_t nk,
                                                    int64_t& lo, int64_t& hi) {
  const int64_t q0 = qt * BQ, qlast = imin(q0 + BQ, a.lq) - 1;
  if (!row_has_key(a, qlast)) {
    lo = 0;
    hi = nk;
    return;
  }
  int64_t klo = 0, khi = a.s - 1;
  if (a.causal) khi = imin(khi, qlast);
  if (a.has_window) klo = imax(klo, q0 - a.window + 1);
  lo = klo / BK;
  hi = khi / BK + 1;
}
// the SIMT design's: BwdArgs::nk key tiles
template <int BQ, int BK>
__host__ __device__ __forceinline__ void key_tiles(const BwdArgs& a, int64_t qt, int64_t& lo,
                                                   int64_t& hi) {
  band_tiles<BQ, BK>(a, qt, a.nk, lo, hi);
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

// Rows row0 .. row0 + ROWS - 1 of one (rows, d) f32 operand into a
// row-major tile of row stride STRIDE and DMAX columns, zero past nrows and
// past d: by cp.async 16 bytes at a time where vec, else element by
// element, each thread moving 4 neighbouring columns of a row at a time.
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

// ------------------------------------------------------------------------
// The bf16 build: the tensor-core design (see the note at the top).

constexpr int kTcWG = 128;             // threads of a warpgroup
constexpr int kTcKvThreads = 2 * kTcWG;  // the dk/dv pass: dV's and dK's warpgroups

// Tiles of the two passes by head-dim capacity: the dk/dv pass's query
// rows a stage (KV_BQ) and keys a block (KV_BK), the dq pass's query rows a
// block (DQ_BQ) and keys a stage (DQ_BK); stages of each ring.
// kernels/flash_backward.py's TILES_BF16 mirrors the four tile sizes.
template <int DMAX>
struct TcBwdTiles;
template <>
struct TcBwdTiles<64> {
  static constexpr int KV_BQ = 64, KV_BK = 64, DQ_BQ = 128, DQ_BK = 64;
  static constexpr int KV_NST = 4, DQ_NST = 3;
};
template <>
struct TcBwdTiles<128> {
  static constexpr int KV_BQ = 64, KV_BK = 64, DQ_BQ = 128, DQ_BK = 64;
  static constexpr int KV_NST = 3, DQ_NST = 2;
};
template <>
struct TcBwdTiles<256> {
  static constexpr int KV_BQ = 32, KV_BK = 64, DQ_BQ = 128, DQ_BK = 32;
  static constexpr int KV_NST = 3, DQ_NST = 2;
};

// Shared memory of the two passes: 128-byte-swizzled bf16 tiles (tc.cuh),
// DMAX / 64 column blocks of rows x 128 bytes each, every tile 1024-byte
// aligned; then f32 rows and 8-byte mbarriers.
template <int DMAX>
struct TcBwdLayout : TcBwdTiles<DMAX> {
  using T = TcBwdTiles<DMAX>;
  static constexpr int CB = DMAX / 64;
  static_assert(T::KV_BK == 64 && T::DQ_BQ % 64 == 0, "a warpgroup's 64 rows of M");
  static constexpr int DQ_THREADS = kTcWG * (T::DQ_BQ / 64);  // a warpgroup per 64 rows
  // dk/dv pass: k and v resident, a ring of (q, dO, lse, D) stages
  static constexpr int K_CB = T::KV_BK * kSwRow;              // a k (v) tile's column block
  static constexpr int K_BYTES = CB * K_CB;
  static constexpr int Q_CB = T::KV_BQ * kSwRow;              // a streamed q (dO) tile's
  static constexpr int Q_BYTES = CB * Q_CB;
  static constexpr int KV_STAGE = 2 * Q_BYTES;                // q, dO
  static constexpr size_t KV_SMEM = 1024 + 2 * (size_t)K_BYTES + T::KV_NST * (size_t)KV_STAGE +
                                    T::KV_NST * 2 * T::KV_BQ * sizeof(float) +
                                    8 * (1 + 2 * T::KV_NST);
  // dq pass: q and dO resident, a ring of (k, v) stages
  static constexpr int QQ_CB = T::DQ_BQ * kSwRow;             // the q (dO) tile's column block
  static constexpr int QQ_BYTES = CB * QQ_CB;
  static constexpr int KQ_CB = T::DQ_BK * kSwRow;             // a streamed k (v) tile's
  static constexpr int KQ_BYTES = CB * KQ_CB;
  static constexpr int DQ_STAGE = 2 * KQ_BYTES;               // k, v
  static constexpr size_t DQ_SMEM = 1024 + 2 * (size_t)QQ_BYTES + T::DQ_NST * (size_t)DQ_STAGE +
                                    8 * (1 + 2 * T::DQ_NST);
  static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory of a block");
};

// bits of the tc kernels' `pair` argument: dq, dk, dv stored two bf16 at a
// time (a unit column stride, the other strides even, a 4-byte aligned base)
constexpr int kPairDQ = 1, kPairDK = 2, kPairDV = 4;

// 4 bytes from global to shared memory (cp_async4) land, then count as one
// arrival on the mbarrier at shared address bar (the arrival is in its
// expected count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The A-register fragments of one step of 16 along K, in three pieces:
// f[kk][piece][register]
template <int DEPTH>
using TcFrags = uint32_t[DEPTH / 16][3][4];

// x = x_hi + x_mid + x_lo: x_hi = bf16(x), x_mid = bf16(x - x_hi), x_lo =
// bf16(x - x_hi - x_mid), each residual exact in f32, so the three are
// within 2^-24 |x| of x (three roundings of 8 significant bits); two
// neighbouring values packed as wgmma's A registers take them (the lower
// column in the low half)
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = reinterpret_cast<const uint32_t&>(h);
  const float r0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  const float r1 = __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  mid = reinterpret_cast<const uint32_t&>(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, __uint_as_float(mid << 16)),
                                                 __fsub_rn(r1, __uint_as_float(mid & 0xffff0000u)));
  lo = reinterpret_cast<const uint32_t&>(l);
}

// The next (head of the group, query tile) of key tile kt's walk in the
// dk/dv pass: the G heads in order, each head's query tiles (nq of BQ
// rows) from the last down, those that meet kt; false past the end. Start
// from gi = -1, qt = 0; once false, false again.
template <int BQ, int BK>
__device__ __forceinline__ bool next_visit(const BwdArgs& a, int64_t nq, int64_t nk, int kt, int g,
                                           int& gi, int& qt) {
  while (true) {
    if (qt == 0) {
      if (gi + 1 >= g) {              // past the end, and stays there
        gi = g;
        return false;
      }
      ++gi;
      qt = (int)nq;
    }
    --qt;
    int64_t lo, hi;
    band_tiles<BQ, BK>(a, qt, nk, lo, hi);
    if (lo <= kt && kt < hi) return true;
  }
}

// A tile pair (rows q0 .. q0 + ROWS - 1, keys k0 .. k0 + KEYS - 1) inside
// the band and before Lq and S: every p there is exp(s * scale - lse), no
// test (uniform over the warpgroup, so it picks one of two straight-line
// copies of the fragment code)
template <int ROWS, int KEYS>
__device__ __forceinline__ bool pair_inside(const BwdArgs& a, int64_t q0, int64_t k0) {
  return q0 + ROWS <= a.lq && k0 + KEYS <= a.s && (!a.causal || k0 + KEYS - 1 <= q0) &&
         (!a.has_window || k0 > q0 + ROWS - 1 - a.window);
}

// The mask of one of a thread's two M rows in a tile pair, as column
// bounds in the tile (N columns; each bound clamped to [-1, N + 1]):
// column c is past Lq or S (p = 0) from cend on, and masked (-1e30, so p
// = exp(-1e30 - lse)) outside [clo, chi); prob's function in int32
// compares.
struct RowMask {
  int cend, clo, chi;
};
__device__ __forceinline__ int clamp_col(int64_t c, int n) {
  return (int)imin(imax(c, -1), n + 1);
}
// dk/dv pass: M row = key `key`, columns = query rows q0 + c
template <int N>
__device__ __forceinline__ RowMask key_row_mask(const BwdArgs& a, int64_t q0, int64_t key) {
  return {key < a.s ? clamp_col(a.lq - q0, N) : 0,
          a.causal ? clamp_col(key - q0, N) : -1,
          a.has_window ? clamp_col(key - q0 + a.window, N) : N + 1};
}
// dq pass: M row = query row `row`, columns = keys k0 + c
template <int N>
__device__ __forceinline__ RowMask query_row_mask(const BwdArgs& a, int64_t k0, int64_t row) {
  return {row < a.lq ? clamp_col(a.s - k0, N) : 0,
          a.has_window ? clamp_col(row - a.window + 1 - k0, N) : -1,
          a.causal ? clamp_col(row - k0 + 1, N) : N + 1};
}
// p of score s at column c of a row with mask m (MASK), or of an unmasked
// one
template <bool MASK>
__device__ __forceinline__ float tile_prob(float s, float lse, float scale, const RowMask& m,
                                           int c) {
  if (!MASK) return expf(__fsub_rn(__fmul_rn(s, scale), lse));
  if (c >= m.cend) return 0.0f;
  return expf(__fsub_rn(c < m.clo || c >= m.chi ? kNeg : __fmul_rn(s, scale), lse));
}

// The dk/dv pass's fragment step. st and dpt are wgmma m64nBQ accumulators
// of s^T and dp^T (M = the block's 64 keys, N = the stage's BQ query rows):
// x[4 n + 2 i + j] is key key0 + 8 i (key0 this thread's first) and query
// row 8 n + 2 tq + j of the stage, whose lse and D lie in shared memory.
// Computes p^T, or under DS ds^T = p^T (dp^T - D), and splits it into the
// A fragments of m64nDMAXk16 over the query rows: step kk, register r
// holds x[8 kk + 2 r] and x[8 kk + 2 r + 1] (rows 16 kk .. 16 kk + 15).
template <int BQ, bool MASK, bool DS>
__device__ __forceinline__ void dkv_frags(const float (&st)[BQ / 2], const float (&dpt)[BQ / 2],
                                          const float* lse_s, const float* d_s, float scale,
                                          const RowMask (&m)[2], int tq, TcFrags<BQ>& f) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 8 * kk + 2 * r + j;
        const int c = 16 * kk + 8 * (r / 2) + 2 * tq + j;
        const float p = tile_prob<MASK>(st[x], lse_s[c], scale, m[r % 2], c);
        y[j] = DS ? __fmul_rn(p, __fsub_rn(dpt[x], d_s[c])) : p;
      }
      split3_pair(y[0], y[1], f[kk][0][r], f[kk][1][r], f[kk][2][r]);
    }
}

// The dq pass's fragment step: s and dp are m64nBK accumulators (M = the
// block's 64 query rows, N = the stage's BK keys): x[4 n + 2 i + j] is
// query row row0 + 8 i (lse[i], D[i]) and key k0 + 8 n + 2 tq + j. Computes
// ds = p (dp - D) and splits it into the A fragments of m64nDMAXk16 over
// the keys.
template <int BK, bool MASK>
__device__ __forceinline__ void dq_frags(const float (&s)[BK / 2], const float (&dp)[BK / 2],
                                         const float (&lse)[2], const float (&del)[2],
                                         float scale, const RowMask (&m)[2], int tq,
                                         TcFrags<BK>& f) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 8 * kk + 2 * r + j, i = r % 2;
        const float p = tile_prob<MASK>(s[x], lse[i], scale, m[i],
                                        16 * kk + 8 * (r / 2) + 2 * tq + j);
        y[j] = __fmul_rn(p, __fsub_rn(dp[x], del[i]));
      }
      split3_pair(y[0], y[1], f[kk][0][r], f[kk][1][r], f[kk][2][r]);
    }
}

// D (64 x N) = A B^T over DMAX columns: A's 64 rows and B's N rows both
// K-major swizzled tiles (column blocks a_cb and b_cb bytes apart), DMAX /
// 16 steps of 16 columns, 32 bytes apart in a swizzled row
template <int N, int DMAX>
__device__ __forceinline__ void tc_scores(float (&d)[N / 2], uint32_t at, int a_cb, uint32_t bt,
                                          int b_cb) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const uint32_t col = (uint32_t)(kk % 4) * 32;
    wgmma_ss<N>(d, desc_kmajor(at + (kk / 4) * a_cb + col), desc_kmajor(bt + (kk / 4) * b_cb + col),
                kk > 0);
  }
}

// D (64 x DMAX) += (X_hi + X_mid + X_lo) B over DEPTH rows of B: the A
// fragments from registers, B an MN-major swizzled tile of DEPTH rows
// (column blocks DEPTH x 128 bytes apart), DEPTH / 16 steps of 16 rows,
// three products a step into the one accumulator
template <int DMAX, int DEPTH>
__device__ __forceinline__ void tc_update(float (&d)[DMAX / 2], const TcFrags<DEPTH>& f,
                                          uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const uint64_t db = desc_mnmajor(bt + kk * 16 * kSwRow, (uint32_t)(DEPTH * kSwRow));
#pragma unroll
    for (int x = 0; x < 3; ++x) wgmma_rs<DMAX>(d, f[kk][x], db);
  }
}

// Stores a warpgroup's m64nDMAX accumulator (x[4 n + 2 i + j]: row row0 +
// 8 i, column 8 n + 2 tq + j), times scale where `scaled`, rounded once to
// bf16, by strides; rows past nrows and columns past d are dropped. `pair`:
// two neighbouring columns at a time.
template <int DMAX>
__device__ __forceinline__ void tc_store(bf16* dst, const float (&x)[DMAX / 2], int64_t row0,
                                         int64_t nrows, const int64_t* st, int64_t d, float scale,
                                         bool scaled, bool pair, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    if (row >= nrows) continue;
    bf16* out = dst + row * st[2];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int64_t col = 8 * n + 2 * tq;
      float y0 = x[4 * n + 2 * i], y1 = x[4 * n + 2 * i + 1];
      if (scaled) {
        y0 = __fmul_rn(scale, y0);
        y1 = __fmul_rn(scale, y1);
      }
      if (pair && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < d) out[col * st[3]] = __float2bfloat16_rn(y0);
        if (col + 1 < d) out[(col + 1) * st[3]] = __float2bfloat16_rn(y1);
      }
    }
  }
}

// The second grid of the bf16 build: dk and dv, one block of two
// warpgroups per (b, kv head, key tile of KV_BK = 64 keys), key tile 0
// first. k and v stay in shared memory; the stages of a ring hold the q and
// dO tiles of KV_BQ rows and their lse and D, one stage a visit (head,
// query tile) of the walk (next_visit). A visit: S^T = K Q^T by wgmma with
// both operands from shared memory in both warpgroups; warpgroup 0 splits
// p^T and adds dV += P^T dO, warpgroup 1 computes dP^T = V dO^T too, splits
// ds^T and adds dK += dS^T Q, A from registers and dO or q MN-major from
// the stage: the two run the same update on another tile.
template <int DMAX>
__global__ void __launch_bounds__(kTcKvThreads, 1)
flash_bwd_dkv_kernel(BwdPtrs<bf16> p, BwdArgs a, int pair,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v) {
  using L = TcBwdLayout<DMAX>;
  constexpr int BQ = L::KV_BQ, BK = L::KV_BK, NST = L::KV_NST, NT = kTcKvThreads;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(tc_smem);
  const uint32_t ks = (sbase + 1023u) & ~1023u;
  const uint32_t vs = ks + L::K_BYTES, ring = vs + L::K_BYTES;
  const uint32_t rows = ring + NST * L::KV_STAGE;              // [NST][lse BQ, D BQ] f32
  float* const rows_f = reinterpret_cast<float*>(tc_smem + (rows - sbase));
  const uint32_t kvbar = rows + NST * 2 * BQ * (uint32_t)sizeof(float);
  const uint32_t full = kvbar + 8, empty = full + 8 * NST;

  launch_dependents();              // the dq grid may take SMs as blocks finish
  // the warpgroup's index through a shuffle, so ptxas sees every branch on
  // it uniform over each warp (a branch it may take as divergent makes it
  // serialize every wgmma); warpgroup 1 holds dK, warpgroup 0 dV
  const int tid = threadIdx.x;
  const bool dk_wg = __shfl_sync(0xffffffffu, tid / kTcWG, 0) == 1;
  const int lane = tid % 32, warp = (tid % kTcWG) / 32, tq = lane % 4;
  const int nbk = (int)(a.b * a.kh);
  const int bk = (int)(blockIdx.x % nbk), kt = (int)(blockIdx.x / nbk);
  const int64_t bi = bk / a.kh, khi = bk % a.kh;
  const int g = (int)(a.h / a.kh);
  const int64_t k0 = (int64_t)kt * BK, nq = (a.lq + BQ - 1) / BQ, nk = (a.s + BK - 1) / BK;
  const bool tma = (a.vec & (kVecQ | kVecK | kVecV | kVecDO)) == (kVecQ | kVecK | kVecV | kVecDO);

  // kvbar completes when k and v landed; full[j] when stage j's q, dO (TMA:
  // the lead producer thread's arrive with their bytes; element path: every
  // thread's, after its stores and a proxy fence) and lse, D (the producer
  // warp's 32 cp.async arrivals) landed; empty[j] when every thread has
  // read stage j
  if (tid == 0) {
    mbar_init(kvbar, tma ? 1 : NT);
    for (int j = 0; j < NST; ++j) {
      mbar_init(full + 8 * j, (tma ? 1 : NT) + 32);
      mbar_init(empty + 8 * j, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!tma) {
    tc_gather<BK, DMAX, NT>(ks, p.k + bi * a.ks[0] + khi * a.ks[1], k0, a.s, a.ks[2], a.ks[3], a.d);
    tc_gather<BK, DMAX, NT>(vs, p.v + bi * a.vs[0] + khi * a.vs[1], k0, a.s, a.vs[2], a.vs[3], a.d);
    fence_proxy_async();
    mbar_arrive(kvbar);
  } else if (tid == 0) {
    mbar_arrive_expect(kvbar, 2 * L::K_BYTES);
#pragma unroll
    for (int cb = 0; cb < L::CB; ++cb) {
      tma_box(ks + cb * L::K_CB, map_k, 64 * cb, k0, khi, bi, kvbar);
      tma_box(vs + cb * L::K_CB, map_v, 64 * cb, k0, khi, bi, kvbar);
    }
  }
  wait_for_previous_grid();         // D

  // visit n of the walk into stage n % NST, once use n - NST is over. The
  // copies are warpgroup 1's (its first warp): a thread that waits for a
  // stage to empty stalls its warpgroup's wgmmas, and warpgroup 1, which
  // also computes dP^T and ds, is the one behind, so warpgroup 0 runs up
  // to NST - 1 visits ahead instead of in step with it
  const bool producer = tid / 32 == kTcWG / 32, lead = tid == kTcWG;
  int fg = -1, fq = 0, filled = 0;
  auto fill_next = [&]() {
    if (!next_visit<BQ, BK>(a, nq, nk, kt, g, fg, fq)) return;
    const int n = filled++;
    const uint32_t j = (uint32_t)(n % NST), st = ring + j * L::KV_STAGE;
    const int64_t hq = khi * g + fg, q0 = (int64_t)fq * BQ;
    if (!tma || producer) {
      if (n >= NST) mbar_wait(empty + 8 * j, (uint32_t)((n / NST - 1) & 1));
    }
    if (!tma) {
      tc_gather<BQ, DMAX, NT>(st, p.q + bi * a.qs[0] + hq * a.qs[1], q0, a.lq, a.qs[2], a.qs[3],
                              a.d);
      tc_gather<BQ, DMAX, NT>(st + L::Q_BYTES, p.dout + bi * a.dos[0] + hq * a.dos[1], q0, a.lq,
                              a.dos[2], a.dos[3], a.d);
      fence_proxy_async();
      mbar_arrive(full + 8 * j);
    } else if (lead) {
      mbar_arrive_expect(full + 8 * j, L::KV_STAGE);
#pragma unroll
      for (int cb = 0; cb < L::CB; ++cb) {
        tma_box(st + cb * L::Q_CB, map_q, 64 * cb, q0, hq, bi, full + 8 * j);
        tma_box(st + L::Q_BYTES + cb * L::Q_CB, map_do, 64 * cb, q0, hq, bi, full + 8 * j);
      }
    }
    if (producer) {                 // the rows' lse and D
      const int64_t rb = (bi * a.h + hq) * a.lq;
      float* dst = rows_f + j * 2 * BQ;
      for (int r = lane; r < 2 * BQ; r += 32) {
        const int64_t row = q0 + r % BQ;
        const bool ok = row < a.lq;
        cp_async4(dst + r, (r < BQ ? p.lse : p.delta) + (ok ? rb + row : 0), ok);
      }
      cp_async_arrive(full + 8 * j);
    }
  };
  for (int i = 0; i < NST - 1; ++i) fill_next();

  float acc[DMAX / 2];              // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.0f;
  const int64_t key0 = k0 + 16 * warp + lane / 4;   // this thread's first key
  mbar_wait(kvbar, 0);

  int ug = -1, uq = 0;
  for (int u = 0; next_visit<BQ, BK>(a, nq, nk, kt, g, ug, uq); ++u) {
    fill_next();                    // visit u + NST - 1
    const uint32_t j = (uint32_t)(u % NST), st = ring + j * L::KV_STAGE, dst = st + L::Q_BYTES;
    const float* lse_s = rows_f + j * 2 * BQ;
    const float* d_s = lse_s + BQ;
    const int64_t q0 = (int64_t)uq * BQ;
    mbar_wait(full + 8 * j, (uint32_t)((u / NST) & 1));

    float s_t[BQ / 2], dp_t[BQ / 2];
    TcFrags<BQ> f;
    const bool inside = pair_inside<BQ, BK>(a, q0, k0);
    wgmma_fence();
    tc_scores<BQ, DMAX>(s_t, ks, L::K_CB, st, L::Q_CB);                  // S^T = K Q^T
    if (dk_wg) tc_scores<BQ, DMAX>(dp_t, vs, L::K_CB, dst, L::Q_CB);     // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s_t);
    const RowMask m[2] = {key_row_mask<BQ>(a, q0, key0), key_row_mask<BQ>(a, q0, key0 + 8)};
    if (dk_wg) {
      reg_fence(dp_t);
      if (inside)
        dkv_frags<BQ, false, true>(s_t, dp_t, lse_s, d_s, a.scale, m, tq, f);
      else
        dkv_frags<BQ, true, true>(s_t, dp_t, lse_s, d_s, a.scale, m, tq, f);
    } else {
      if (inside)
        dkv_frags<BQ, false, false>(s_t, dp_t, lse_s, d_s, a.scale, m, tq, f);
      else
        dkv_frags<BQ, true, false>(s_t, dp_t, lse_s, d_s, a.scale, m, tq, f);
    }
    reg_fence(acc);
    wgmma_fence();
    tc_update<DMAX, BQ>(acc, f, dk_wg ? st : dst);      // dK += dS^T Q, dV += P^T dO
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + 8 * j);     // this thread is done with stage j
  }

  if (dk_wg)
    tc_store<DMAX>(p.dk + bi * a.dks[0] + khi * a.dks[1], acc, key0, a.s, a.dks, a.d, a.scale,
                   true, pair & kPairDK, tq);
  else
    tc_store<DMAX>(p.dv + bi * a.dvs[0] + khi * a.dvs[1], acc, key0, a.s, a.dvs, a.d, a.scale,
                   false, pair & kPairDV, tq);
}

// The third grid of the bf16 build: dq, one block (a warpgroup) per (b,
// head, tile of DQ_BQ = 64 query rows), the heaviest query tile first under
// causal. q and dO stay in shared memory; the stages of a ring hold the k
// and v tiles of DQ_BK keys, the key tiles that meet the query tile's band
// in order. A key tile: S = Q K^T and dP = dO V^T by wgmma with both
// operands from shared memory; p and ds in registers and split; dQ +=
// dS K with A from registers and k MN-major from the stage. dQ is one f32
// sum in key-tile order, scaled and rounded once at the store.
template <int DMAX>
__global__ void __launch_bounds__(TcBwdLayout<DMAX>::DQ_THREADS, 1)
flash_bwd_dq_tc_kernel(BwdPtrs<bf16> p, BwdArgs a, int pair,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v) {
  using L = TcBwdLayout<DMAX>;
  constexpr int BM = L::DQ_BQ, BN = L::DQ_BK, NST = L::DQ_NST, NT = L::DQ_THREADS;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  const uint32_t dos = qs + L::QQ_BYTES, ring = dos + L::QQ_BYTES;
  const uint32_t qbar = ring + NST * L::DQ_STAGE, full = qbar + 8, empty = full + 8 * NST;

  // warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block's (its index
  // through a shuffle: see the dk/dv pass)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kTcWG, 0);
  const int lane = tid % 32, warp = (tid % kTcWG) / 32, tq = lane % 4;
  const int64_t nbh = a.b * a.h;
  const int64_t bh = (int64_t)blockIdx.x % nbh, rank = (int64_t)blockIdx.x / nbh;
  const int64_t nq = (a.lq + BM - 1) / BM, nk = (a.s + BN - 1) / BN;
  const int64_t bi = bh / a.h, hq = bh % a.h, khi = hq / (a.h / a.kh);
  const int64_t qt = a.causal ? nq - 1 - rank : rank, q0 = qt * BM;
  const bool tma = (a.vec & (kVecQ | kVecK | kVecV | kVecDO)) == (kVecQ | kVecK | kVecV | kVecDO);
  int64_t t_lo, t_hi;
  band_tiles<BM, BN>(a, qt, nk, t_lo, t_hi);

  // qbar completes when q and dO landed, full[j] when stage j's k and v
  // did, empty[j] when every thread has read stage j
  if (tid == 0) {
    mbar_init(qbar, tma ? 1 : NT);
    for (int j = 0; j < NST; ++j) {
      mbar_init(full + 8 * j, tma ? 1 : NT);
      mbar_init(empty + 8 * j, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bf16* const kb = p.k + bi * a.ks[0] + khi * a.ks[1];
  const bf16* const vb = p.v + bi * a.vs[0] + khi * a.vs[1];
  // key tile t into stage (t - t_lo) % NST, once its previous use is over
  auto fill = [&](int64_t t) {
    const int64_t n = t - t_lo;
    const uint32_t j = (uint32_t)(n % NST), st = ring + j * L::DQ_STAGE;
    if (!tma || tid == 0) {
      if (n >= NST) mbar_wait(empty + 8 * j, (uint32_t)((n / NST - 1) & 1));
    }
    if (!tma) {
      tc_gather<BN, DMAX, NT>(st, kb, t * BN, a.s, a.ks[2], a.ks[3], a.d);
      tc_gather<BN, DMAX, NT>(st + L::KQ_BYTES, vb, t * BN, a.s, a.vs[2], a.vs[3], a.d);
      fence_proxy_async();
      mbar_arrive(full + 8 * j);
    } else if (tid == 0) {
      mbar_arrive_expect(full + 8 * j, L::DQ_STAGE);
#pragma unroll
      for (int cb = 0; cb < L::CB; ++cb) {
        tma_box(st + cb * L::KQ_CB, map_k, 64 * cb, t * BN, khi, bi, full + 8 * j);
        tma_box(st + L::KQ_BYTES + cb * L::KQ_CB, map_v, 64 * cb, t * BN, khi, bi, full + 8 * j);
      }
    }
  };
  if (!tma) {
    tc_gather<BM, DMAX, NT>(qs, p.q + bi * a.qs[0] + hq * a.qs[1], q0, a.lq, a.qs[2], a.qs[3], a.d);
    tc_gather<BM, DMAX, NT>(dos, p.dout + bi * a.dos[0] + hq * a.dos[1], q0, a.lq, a.dos[2],
                            a.dos[3], a.d);
    fence_proxy_async();
    mbar_arrive(qbar);
  } else if (tid == 0) {
    mbar_arrive_expect(qbar, 2 * L::QQ_BYTES);
#pragma unroll
    for (int cb = 0; cb < L::CB; ++cb) {
      tma_box(qs + cb * L::QQ_CB, map_q, 64 * cb, q0, hq, bi, qbar);
      tma_box(dos + cb * L::QQ_CB, map_do, 64 * cb, q0, hq, bi, qbar);
    }
  }
  for (int i = 0; i < NST - 1; ++i)
    if (t_lo + i < t_hi) fill(t_lo + i);

  // this thread's rows row0 and row0 + 8: their lse and D (0 past Lq,
  // where p is 0)
  const int64_t w0 = q0 + 64 * wg, row0 = w0 + 16 * warp + lane / 4;
  float lse[2], del[2];
  wait_for_previous_grid();         // D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    const bool ok = row < a.lq;
    lse[i] = ok ? p.lse[bh * a.lq + row] : 0.0f;
    del[i] = ok ? p.delta[bh * a.lq + row] : 0.0f;
  }
  float dq[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dq[i] = 0.0f;
  mbar_wait(qbar, 0);

  for (int64_t t = t_lo; t < t_hi; ++t) {
    if (t + NST - 1 < t_hi) fill(t + NST - 1);
    const int64_t n = t - t_lo, k0 = t * BN;
    const uint32_t j = (uint32_t)(n % NST), st = ring + j * L::DQ_STAGE;
    mbar_wait(full + 8 * j, (uint32_t)((n / NST) & 1));
    float s[BN / 2], dp[BN / 2];
    TcFrags<BN> f;
    wgmma_fence();
    const uint32_t rows = wg * 64 * kSwRow;    // this warpgroup's rows of q and dO
    tc_scores<BN, DMAX>(s, qs + rows, L::QQ_CB, st, L::KQ_CB);          // S = Q K^T
    tc_scores<BN, DMAX>(dp, dos + rows, L::QQ_CB, st + L::KQ_BYTES, L::KQ_CB);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const RowMask m[2] = {query_row_mask<BN>(a, k0, row0), query_row_mask<BN>(a, k0, row0 + 8)};
    if (pair_inside<64, BN>(a, w0, k0))
      dq_frags<BN, false>(s, dp, lse, del, a.scale, m, tq, f);
    else
      dq_frags<BN, true>(s, dp, lse, del, a.scale, m, tq, f);
    reg_fence(dq);
    wgmma_fence();
    tc_update<DMAX, BN>(dq, f, st);                                    // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    mbar_arrive(empty + 8 * j);     // this thread is done with stage j
  }
  tc_store<DMAX>(p.dq + bi * a.dqs[0] + hq * a.dqs[1], dq, row0, a.lq, a.dqs, a.d, a.scale, true,
                 pair & kPairDQ, tq);
}

// One grid of the call, launched after the previous one by programmatic
// dependent launch (it waits inside for what it reads).
template <typename... Params, typename... Args>
static cudaError_t launch_after(void (*kernel)(Params...), int64_t blocks, int threads,
                                size_t smem, cudaStream_t s, const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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
  e = launch_after(flash_bwd_kernel<DMAX, T>, blocks, kBwdThreads, L::SMEM, s, p, a);
  if (e != cudaSuccess) return (int)e;
  e = launch_after(flash_bwd_dq_kernel<DMAX, T>, dq_blocks, kBwdThreads, 0, s, p, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 build (the tensor-core design): its scratch is D alone, b h Lq
// floats (flash_backward.plan with dtype bfloat16); `pair` holds the
// kPair* bits of the outputs stored two at a time.
template <int DMAX>
static int launch_bwd_tc(BwdPtrs<bf16> p, BwdArgs a, void* scratch, int64_t scratch_bytes,
                         int pair, cudaStream_t s) {
  using L = TcBwdLayout<DMAX>;
  const int64_t bh = a.b * a.h, rows = bh * a.lq;
  if (4 * rows != scratch_bytes) return (int)cudaErrorInvalidValue;
  p.part = nullptr;
  p.delta = (float*)scratch;
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    // the shared memory each block takes, and all of it for shared memory
    // (not L1), so that as many blocks fit an SM as TcBwdTiles says
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::KV_SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DMAX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DMAX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int64_t prep_blocks = (rows + kBwdThreads / kTX - 1) / (kBwdThreads / kTX);
  const int64_t kv_blocks = a.b * a.kh * ((a.s + L::KV_BK - 1) / L::KV_BK);
  const int64_t dq_blocks = bh * ((a.lq + L::DQ_BQ - 1) / L::DQ_BQ);
  // grid x, and the walks' tile indices and TMA's coordinates in 32-bit ints
  if (prep_blocks > 0x7fffffff || kv_blocks > 0x7fffffff || dq_blocks > 0x7fffffff ||
      a.lq > 0x7fffffff || a.s > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  constexpr int kAll = kVecQ | kVecK | kVecV | kVecDO;
  CUtensorMap maps[8] = {};             // unused on the element path
  if ((a.vec & kAll) == kAll &&
      !(tensor_map(&maps[0], p.q, a.qs, a.b, a.h, a.lq, a.d, L::KV_BQ) &&
        tensor_map(&maps[1], p.dout, a.dos, a.b, a.h, a.lq, a.d, L::KV_BQ) &&
        tensor_map(&maps[2], p.k, a.ks, a.b, a.kh, a.s, a.d, L::KV_BK) &&
        tensor_map(&maps[3], p.v, a.vs, a.b, a.kh, a.s, a.d, L::KV_BK) &&
        tensor_map(&maps[4], p.q, a.qs, a.b, a.h, a.lq, a.d, L::DQ_BQ) &&
        tensor_map(&maps[5], p.dout, a.dos, a.b, a.h, a.lq, a.d, L::DQ_BQ) &&
        tensor_map(&maps[6], p.k, a.ks, a.b, a.kh, a.s, a.d, L::DQ_BK) &&
        tensor_map(&maps[7], p.v, a.vs, a.b, a.kh, a.s, a.d, L::DQ_BK)))
    return (int)cudaErrorInvalidValue;
  flash_bwd_prep_kernel<bf16><<<(unsigned)prep_blocks, kBwdThreads, 0, s>>>(p, a, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_after(flash_bwd_dkv_kernel<DMAX>, kv_blocks, kTcKvThreads, L::KV_SMEM, s, p, a, pair,
                 maps[0], maps[1], maps[2], maps[3]);
  if (e != cudaSuccess) return (int)e;
  e = launch_after(flash_bwd_dq_tc_kernel<DMAX>, dq_blocks, L::DQ_THREADS, L::DQ_SMEM, s, p, a,
                 pair, maps[4], maps[5], maps[6], maps[7]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// an output of the bf16 build stored two elements at a time: a 4-byte
// aligned base, a unit last stride, every other stride even
__host__ __forceinline__ bool pair_ok(const void* ptr, const int64_t* st) {
  return (uintptr_t)ptr % 4 == 0 && st[3] == 1 && st[0] % 2 == 0 && st[1] % 2 == 0 &&
         st[2] % 2 == 0;
}

// an operand read 16 bytes (kV elements) at a time: a 16-byte aligned base,
// a unit last stride, the head dim and every other stride multiples of kV
template <int kV>
__host__ __forceinline__ bool vec_ok(const void* ptr, const int64_t* st, int64_t d) {
  return aligned16(ptr) && st[3] == 1 && d % kV == 0 && st[0] % kV == 0 && st[1] % kV == 0 &&
         st[2] % kV == 0;
}

// The body of both entry points: dims as below, operands in T (f32: the
// SIMT design, bf16: the tensor-core design).
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
  if constexpr (std::is_same<T, bf16>::value) {
    const int pair = (pair_ok(dq, a.dqs) ? kPairDQ : 0) | (pair_ok(dk, a.dks) ? kPairDK : 0) |
                     (pair_ok(dv, a.dvs) ? kPairDV : 0);
    if (a.d <= 64) return launch_bwd_tc<64>(p, a, scratch, scratch_bytes, pair, s);
    if (a.d <= 128) return launch_bwd_tc<128>(p, a, scratch, scratch_bytes, pair, s);
    return launch_bwd_tc<256>(p, a, scratch, scratch_bytes, pair, s);
  } else {
    if (a.d <= 64) return launch_bwd_d<64, T>(p, a, scratch, scratch_bytes, s);
    if (a.d <= 128) return launch_bwd_d<128, T>(p, a, scratch, scratch_bytes, s);
    return launch_bwd_d<256, T>(p, a, scratch, scratch_bytes, s);
  }
}

}  // namespace

extern "C" {

// dims: b, h, kh, lq, s, d, the strides (4 each) of q, k, v, o, dO, dq, dk
// and dv, causal, has_window, window, vec (kVec* bits: the operands read 16
// bytes at a time), the scratch's bytes (flash_backward.plan of the
// dtype). q, k, v, o, dO, dq, dk and dv are float32 here, bfloat16 in
// flash_attention_bwd_bf16; lse is float32 in both
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

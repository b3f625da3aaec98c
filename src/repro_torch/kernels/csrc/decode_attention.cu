// B13: single-query (decode) attention over a ring KV cache, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention_pallas.
//
//   o[b, h] = softmax_c(mask(q[b, h] . k[b, h/G, c] * scale)) v[b, h/G, c]
//
// where slot c is valid iff 0 <= cache_pos[c] <= pos; an invalid slot
// scores -1e30, as in the JAX kernel, so a step whose every slot is invalid
// comes out as the mean of v. f32 inside, q's dtype (f32 or bf16) out.
// f32 runs the design below; bf16 its own (decode_bf16_partials, further
// down), and both fold their partials with decode_combine.
//
// Bound: bytes. A decode step reads the whole cache once: at batch 8,
// 12 kv heads, 2081 slots, head dim 64, f32, k and v are 102.3 MB, at
// least 30.5 us at an H100 SXM's 3.35 TB/s (q, o and cache_pos are
// 50 KB); its 4 flops a slot and head element are far below the f32 rate.
//
// f32 design: the cache axis is split across blocks, since one block per
// (b, kv head) -- 48 or 96 of them at the serving shapes -- cannot fill 132
// SMs. Each warp owns a chunk of kDecodeSlots consecutive slots of one
// (b, kv head) and a group of MG of its G query heads (MG = 1, 2, 4 or 8,
// the least that holds G, or 8 at a time: a kernel sized to G keeps few
// registers, so more warps stay resident); a lane owns the head elements
// lane + 32*e. The warp loads kUnroll slots of k and v before it
// computes any (several loads in flight a lane), reduces each dot product
// with a xor butterfly (every lane gets the same bits), and runs JAX's
// online-softmax recurrence over its chunk from m = -1e30, l = 0, acc = 0:
//   m' = max(m, s); p = exp(s - m'); alpha = exp(m - m');
//   l' = l*alpha + sum p; acc' = acc*alpha + sum p v.
// It writes its partial (m, l, acc). A second pass folds each (b, h)'s
// partials in chunk order -- M = max m_i, l = sum l_i exp(m_i - M),
// acc = sum acc_i exp(m_i - M), o = acc / max(l, 1e-37) -- with no atomics,
// so a launch is deterministic. Slots past C score -inf and add nothing.
// k and v are read by strides: the model's cache is (B, C, K, hd) and the
// kernel sees it as (B, K, C, hd) without a copy. Validity comes from the
// cache_pos input, never from slot arithmetic here.
#include <cuda_bf16.h>

#include <type_traits>

#include "reduce.cuh"

using namespace repro;

namespace {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeSlots = 32;   // slots of one partial (kernels/build.py: DECODE_SLOTS)
constexpr int kUnroll = 8;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

struct DecodeArgs {
  int64_t b, h, kh, c, d;
  int64_t qs[3], ks[4], vs[4];     // element strides of q, k and v
  int64_t pos, nchunks, ngroups;
  float scale;
  int64_t chunk;                   // slots of one partial (bf16; f32: kDecodeSlots)
  int vec;                         // bf16: k and v copied 16 bytes at a time
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int DMAX, int MG>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_partials(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int32_t* __restrict__ cpos, float* __restrict__ part_ml,
                float* __restrict__ part_acc, DecodeArgs a) {
  constexpr int NE = DMAX / 32;     // head elements a lane owns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t chunk = (int64_t)blockIdx.x * kDecodeWarps + warp;
  if (chunk >= a.nchunks) return;
  const int64_t pair = blockIdx.y / a.ngroups, grp = blockIdx.y % a.ngroups;
  const int64_t bi = pair / a.kh, khi = pair % a.kh;
  const int64_t group = a.h / a.kh;
  const int64_t g0 = grp * MG;
  const int ng = (int)(group - g0 < MG ? group - g0 : MG);

  float qv[MG][NE], m[MG], l[MG], acc[MG][NE];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int col = lane + 32 * e;
      const int64_t hh = khi * group + g0 + g;
      qv[g][e] = (g < ng && col < a.d) ? load_f(q + bi * a.qs[0] + hh * a.qs[1] + col * a.qs[2])
                                       : 0.0f;
      acc[g][e] = 0.0f;
    }
  }

  const T* kb = k + bi * a.ks[0] + khi * a.ks[1];
  const T* vb = v + bi * a.vs[0] + khi * a.vs[1];
  const int64_t c0 = chunk * kDecodeSlots;
  const int64_t c1 = c0 + kDecodeSlots < a.c ? c0 + kDecodeSlots : a.c;
  for (int64_t c = c0; c < c1; c += kUnroll) {
    float kv[kUnroll][NE], vv[kUnroll][NE];
    int state[kUnroll];             // 0 no slot, 1 invalid slot, 2 valid slot
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = c + u;
      const bool here = slot < c1;
      const int32_t cp = here ? cpos[slot] : -1;
      state[u] = here ? ((cp >= 0 && (int64_t)cp <= a.pos) ? 2 : 1) : 0;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int col = lane + 32 * e;
        const bool in = here && col < a.d;
        kv[u][e] = in ? load_f(kb + slot * a.ks[2] + col * a.ks[3]) : 0.0f;
        vv[u][e] = in ? load_f(vb + slot * a.vs[2] + col * a.vs[3]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= ng) break;
      float sc[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < NE; ++e) dot = fmaf(qv[g][e], kv[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = state[u] == 2 ? dot * a.scale : (state[u] == 1 ? kNeg : -INFINITY);
        mx = maxval(mx, sc[u]);
      }
      const float alpha = expf(m[g] - mx);
      float ps = 0.0f, p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = expf(sc[u] - mx);
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        float x = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vv[u][e], x);
        acc[g][e] = x;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= ng) break;
    const int64_t bh = bi * a.h + khi * group + g0 + g;
    const int64_t idx = bh * a.nchunks + chunk;
    if (lane == 0) {
      part_ml[2 * idx] = m[g];
      part_ml[2 * idx + 1] = l[g];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int col = lane + 32 * e;
      if (col < a.d) part_acc[idx * a.d + col] = acc[g][e];
    }
  }
}

// Pass 2: one block per (b, h) folds its partials in chunk order. The
// weights exp(m_i - M) are computed once, into shared memory; then
// nsplit = kThreads / d threads share each output column, thread j of a
// column folding chunks j, j + nsplit, ..., and the nsplit sums of a
// column are added in order j = 0, 1, ...: a fixed order, no atomics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
               T* __restrict__ out, DecodeArgs a) {
  extern __shared__ float w[];                 // nchunks weights
  __shared__ float sums[kThreads];             // nsplit partial sums a column
  __shared__ float scratch[kThreads / 32];
  __shared__ float shared_m, shared_l;
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + bh * a.nchunks * 2;
  const float* pa = part_acc + bh * a.nchunks * a.d;
  float mx = -INFINITY;
  for (int64_t i = threadIdx.x; i < a.nchunks; i += kThreads) mx = maxval(mx, ml[2 * i]);
  mx = block_reduce(mx, -INFINITY, MaxOp(), scratch);
  if (threadIdx.x == 0) shared_m = mx;
  __syncthreads();
  mx = shared_m;
  float l = 0.0f;
  for (int64_t i = threadIdx.x; i < a.nchunks; i += kThreads) {
    const float wi = expf(ml[2 * i] - mx);
    w[i] = wi;
    l += ml[2 * i + 1] * wi;
  }
  l = block_reduce(l, 0.0f, SumOp(), scratch);
  if (threadIdx.x == 0) shared_l = maxval(l, 1e-37f);
  __syncthreads();
  const int t = (int)threadIdx.x, d = (int)a.d;
  const int nsplit = kThreads / d;             // >= 1: d <= 256
  const int col = t % d, j = t / d;
  if (j < nsplit) {
    float x = 0.0f;
#pragma unroll 4
    for (int64_t i = j; i < a.nchunks; i += nsplit) x += pa[i * a.d + col] * w[i];
    sums[j * d + col] = x;
  }
  __syncthreads();
  if (t < d) {
    float x = sums[col];
    for (int jj = 1; jj < nsplit; ++jj) x += sums[jj * d + col];
    store_f(out + bh * a.d + col, x / shared_l);
  }
}

// ------------------------------------------------------------------------
// B13 in bf16: a decode kernel that reads the cache at HBM speed.
//
// Same function, bf16 in and out: f32 scores of exact bf16 products (fmaf
// of two bf16 values rounds once), the -1e30 validity mask, the online
// softmax in f32, bf16 out. Bound: bytes (qwen3-4b's last serve_long step,
// B 8, K 8, C 2081, d 128: 68 MB of k and v, 20.4 us at 3.35 TB/s).
//
// Design: one block of NW warps (4; 2 at DMAX 64) per (b, kv head, group of
// MG query heads, chunk of `chunk` slots); the chunks are sized for about
// one wave of resident blocks (decode_attention_bf16_chunk, which the
// wrapper asks once a shape), so a (b, h) has a few partials (11 at
// qwen3-4b's shape, 2% of the cache's bytes). The block walks its chunk in sub-tiles of kDecSub = 32
// slots through a ring of two stages in shared memory: 16-byte cp.async by
// every thread (a warp moves whole 256- or 512-byte rows, coalesced), the
// copy of sub-tile t + 1 in flight during t's arithmetic, one barrier a
// sub-tile for the copies and one for the scores. k rows are padded by 16
// bytes, so the 16-byte reads of 8 lanes that own 8 rows fall on distinct
// banks. Scores: lane j of warp w owns slot j and sums q . k over the
// warp's NW-th of the head dim for its MG heads (q in shared memory as f32,
// read by broadcast); the NW partial sums meet in shared memory and every
// warp adds them in warp order: no butterfly per slot. The online softmax
// then takes one warp max and one warp sum (xor butterflies, every lane the
// same bits) per head and 32 slots, the same in every warp. Values: warp w
// owns the head elements w DMAX/NW .. (w + 1) DMAX/NW - 1 of acc, lane j
// NCL of them; it reads its part of each v row and takes each slot's p by
// a shuffle; acc' = acc * alpha, then the slots added in order. A view
// without 16-byte copies (a strided or misaligned cache; the wrapper's
// flag, checked again here) fills the same tiles by strided loads.
// decode_combine folds the partials in chunk order: no atomics, the same
// bits on every call.

constexpr int kDecSub = 32;           // slots of a sub-tile: one a lane

template <int DMAX, int MG>
struct DecTiles {
  static constexpr int NW = DMAX == 64 ? 2 : 4;               // warps of a block
  static constexpr int NT = 32 * NW;
  static constexpr int NCL = DMAX / (32 * NW);                // acc elements a lane owns
  static constexpr int MIN_BLOCKS = DMAX == 64 ? 8 : (DMAX == 128 ? 6 : 3);
  static constexpr int KROW = 2 * DMAX + 16;                  // bytes of a padded k row
  static constexpr int VROW = 2 * DMAX;
  static constexpr int STAGE = kDecSub * (KROW + VROW);
  static constexpr int Q_OFF = 2 * STAGE;                     // q: [MG][DMAX] f32
  static constexpr int RED_OFF = Q_OFF + 4 * MG * DMAX;       // partial dots: [NW][MG][32] f32
  static constexpr size_t SMEM = (size_t)RED_OFF + 4 * NW * MG * kDecSub;
};

__device__ __forceinline__ void cp_async16_d(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

// bf16 pair (the lower element in the low half) to two floats, exactly
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Rows slot0 .. slot0 + 31 (those below c1) of one (C, d) cache operand into
// a stage's tile of row stride ROW bytes, by the block's NT threads; zero
// past c1 and past d.
template <int DMAX, int ROW, int NT>
__device__ __forceinline__ void dec_load(uint32_t dst, const __nv_bfloat16* src, int64_t slot0,
                                         int64_t c1, int64_t rs, int64_t cs, int64_t d,
                                         bool vec) {
  constexpr int CPR = DMAX / 8;       // 16-byte chunks of a row
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 4
  for (int e = threadIdx.x; e < kDecSub * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    const int64_t slot = slot0 + r;
    const uint32_t sp = dst + r * ROW + c * 16;
    if (vec) {                          // d % 8 == 0 on this path
      const bool ok = slot < c1 && c * 8 < d;
      cp_async16_d(sp, ok ? (const void*)(src + slot * rs + c * 8) : (const void*)src, ok);
      continue;
    }
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t lo = 0, hi = 0;
      const int64_t col = c * 8 + 2 * i;
      if (slot < c1 && col < d) lo = raw[slot * rs + col * cs];
      if (slot < c1 && col + 1 < d) hi = raw[slot * rs + (col + 1) * cs];
      w[i] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(sp), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

template <int DMAX, int MG>
__global__ void __launch_bounds__(DecTiles<DMAX, MG>::NT, DecTiles<DMAX, MG>::MIN_BLOCKS)
decode_bf16_partials(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ cpos,
                     float* __restrict__ part_ml, float* __restrict__ part_acc, DecodeArgs a) {
  using L = DecTiles<DMAX, MG>;
  constexpr int NW = L::NW, NT = L::NT, NCL = L::NCL;
  constexpr int CPW = DMAX / 8 / NW;  // 16-byte chunks of a k row a warp sums
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const uint32_t st0 = (uint32_t)__cvta_generic_to_shared(dec_smem);
  float* qf = reinterpret_cast<float*>(dec_smem + L::Q_OFF);
  float* red = reinterpret_cast<float*>(dec_smem + L::RED_OFF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t chunk = blockIdx.x;
  const int64_t pair = blockIdx.y / a.ngroups, grp = blockIdx.y % a.ngroups;
  const int64_t bi = pair / a.kh, khi = pair % a.kh;
  const int64_t group = a.h / a.kh;
  const int64_t g0 = grp * MG;
  const int ng = (int)(group - g0 < MG ? group - g0 : MG);
  const __nv_bfloat16* kb = k + bi * a.ks[0] + khi * a.ks[1];
  const __nv_bfloat16* vb = v + bi * a.vs[0] + khi * a.vs[1];
  const int64_t c0 = chunk * a.chunk;
  const int64_t c1 = c0 + a.chunk < a.c ? c0 + a.chunk : a.c;
  const int64_t nsub = (c1 - c0 + kDecSub - 1) / kDecSub;
  const bool vec = a.vec != 0;

  auto issue = [&](int64_t t) {
    const uint32_t ks = st0 + (uint32_t)(t & 1) * L::STAGE;
    dec_load<DMAX, L::KROW, NT>(ks, kb, c0 + t * kDecSub, c1, a.ks[2], a.ks[3], a.d, vec);
    dec_load<DMAX, L::VROW, NT>(ks + kDecSub * L::KROW, vb, c0 + t * kDecSub, c1, a.vs[2],
                                a.vs[3], a.d, vec);
    cp_async_commit();
  };
  issue(0);

  for (int e = tid; e < MG * DMAX; e += NT) {
    const int g = e / DMAX, col = e % DMAX;
    const int64_t hh = khi * group + g0 + g;
    qf[e] = (g < ng && col < a.d)
                ? __bfloat162float(q[bi * a.qs[0] + hh * a.qs[1] + col * a.qs[2]])
                : 0.0f;
  }

  float m[MG], l[MG], acc[MG][NCL];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < NCL; ++e) acc[g][e] = 0.0f;
  }

  for (int64_t t = 0; t < nsub; ++t) {
    cp_async_wait_all();              // sub-tile t landed (this thread's copies)
    __syncthreads();                  // ... every thread's (and q); everyone is done with t - 1
    if (t + 1 < nsub) issue(t + 1);   // sub-tile t + 1 lands during t's arithmetic
    const unsigned char* kt = dec_smem + (t & 1) * L::STAGE;   // this stage's k rows
    const unsigned char* vt = kt + kDecSub * L::KROW;          // ... and v rows

    // scores: lane j owns slot c0 + 32 t + j; warp w sums its columns
    float dot[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) dot[g] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int c = warp * CPW + cc;
      const uint4 w = *reinterpret_cast<const uint4*>(kt + lane * L::KROW + c * 16);
      const float kx[8] = {lo_f(w.x), hi_f(w.x), lo_f(w.y), hi_f(w.y),
                           lo_f(w.z), hi_f(w.z), lo_f(w.w), hi_f(w.w)};
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float4 qa = *reinterpret_cast<const float4*>(qf + g * DMAX + 8 * c);
        const float4 qb = *reinterpret_cast<const float4*>(qf + g * DMAX + 8 * c + 4);
        float x = dot[g];
        x = fmaf(qa.x, kx[0], x);
        x = fmaf(qa.y, kx[1], x);
        x = fmaf(qa.z, kx[2], x);
        x = fmaf(qa.w, kx[3], x);
        x = fmaf(qb.x, kx[4], x);
        x = fmaf(qb.y, kx[5], x);
        x = fmaf(qb.z, kx[6], x);
        x = fmaf(qb.w, kx[7], x);
        dot[g] = x;
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) red[(warp * MG + g) * kDecSub + lane] = dot[g];
    __syncthreads();
    const int64_t slot = c0 + t * kDecSub + lane;
    const bool here = slot < c1;
    const int32_t cp = here ? cpos[slot] : -1;
    const int state = here ? ((cp >= 0 && (int64_t)cp <= a.pos) ? 2 : 1) : 0;

    // the online softmax of each head over the sub-tile's 32 slots
    float p[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float x = red[g * kDecSub + lane];
#pragma unroll
      for (int w = 1; w < NW; ++w) x += red[(w * MG + g) * kDecSub + lane];
      const float sc = state == 2 ? x * a.scale : (state == 1 ? kNeg : -INFINITY);
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = maxval(m[g], mx);
      const float alpha = expf(m[g] - mn);
      p[g] = expf(sc - mn);
      float ps = p[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha + ps;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < NCL; ++e) acc[g][e] *= alpha;
    }

    // values: acc[g][e] += p of slot j times v[j][col0 + e], j in order
    const int col0 = warp * (DMAX / NW) + lane * NCL;
#pragma unroll 8
    for (int j = 0; j < kDecSub; ++j) {
      float vx[NCL];
      const unsigned char* vp = vt + j * L::VROW + col0 * 2;
      if constexpr (NCL == 2) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vp);
        vx[0] = lo_f(w);
        vx[1] = hi_f(w);
      } else {
        vx[0] = __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(vp) << 16);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int e = 0; e < NCL; ++e) acc[g][e] = fmaf(pj, vx[e], acc[g][e]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= ng) break;
    const int64_t bh = bi * a.h + khi * group + g0 + g;
    const int64_t idx = bh * a.nchunks + chunk;
    if (tid == 0) {                   // m and l are the same bits in every lane
      part_ml[2 * idx] = m[g];
      part_ml[2 * idx + 1] = l[g];
    }
    const int col0 = warp * (DMAX / NW) + lane * NCL;
#pragma unroll
    for (int e = 0; e < NCL; ++e)
      if (col0 + e < a.d) part_acc[idx * a.d + col0 + e] = acc[g][e];
  }
}

// Pass 2's launch (after either design's partials). Past 48 KB of weights
// (C above 393,216 slots at 32-slot chunks) it opts in to more dynamic
// shared memory; below, nothing is set, so a launch inside a CUDA graph
// capture makes no attribute call.
template <typename T>
static int launch_combine(const void* part_ml, const void* part_acc, void* out,
                          const DecodeArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)a.nchunks;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        decode_combine<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  decode_combine<T><<<(unsigned)(a.b * a.h), kThreads, smem, s>>>(
      (const float*)part_ml, (const float*)part_acc, (T*)out, a);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX, int MG>
static int launch_decode_g(const void* q, const void* k, const void* v, const void* cpos,
                           void* part_ml, void* part_acc, void* out, DecodeArgs a,
                           cudaStream_t s) {
  const int64_t group = a.h / a.kh;
  a.ngroups = (group + MG - 1) / MG;
  const int64_t gy = a.b * a.kh * a.ngroups;
  const int64_t gx = (a.nchunks + kDecodeWarps - 1) / kDecodeWarps;
  if (gy > 65535 || gx > 0x7fffffff || a.b * a.h > 0x7fffffff) return (int)cudaErrorInvalidValue;
  decode_partials<T, DMAX, MG><<<dim3((unsigned)gx, (unsigned)gy), kDecodeWarps * 32, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)cpos, (float*)part_ml,
      (float*)part_acc, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine<T>(part_ml, part_acc, out, a, s);
}

// Calls f(std::integral_constant<int, MG>) with the least head group of 1,
// 2, 4 or 8 (4 at head dim 256) that holds G: the f32 and bf16 launchers
// and the bf16 plan (decode_attention_bf16_chunk) pick it here.
template <int DMAX, class F>
static int with_head_group(int64_t group, F&& f) {
  if (group <= 1) return f(std::integral_constant<int, 1>{});
  if (group <= 2) return f(std::integral_constant<int, 2>{});
  if (group <= 4 || DMAX > 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, (DMAX > 128 ? 4 : 8)>{});
}

// ... and f(std::integral_constant<int, DMAX>) with the head dim's tile
template <class F>
static int with_dmax(int64_t d, F&& f) {
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// dims: b, h, kh, c, d, q strides (3), k strides (4), v strides (4), pos,
// nchunks (the partial buffers' length), then for bf16 the slots of one
// partial and the copy flag (1: k and v 16 bytes at a time)
__host__ DecodeArgs decode_args(const int64_t* dims, double scale) {
  DecodeArgs a;
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.c = dims[3]; a.d = dims[4];
  for (int i = 0; i < 3; ++i) a.qs[i] = dims[5 + i];
  for (int i = 0; i < 4; ++i) {
    a.ks[i] = dims[8 + i];
    a.vs[i] = dims[12 + i];
  }
  a.pos = dims[16];
  a.nchunks = dims[17];
  a.ngroups = 1;
  a.scale = (float)scale;
  a.chunk = kDecodeSlots;
  a.vec = 0;
  return a;
}

__host__ bool decode_args_ok(const DecodeArgs& a) {
  return a.b >= 1 && a.h >= 1 && a.kh >= 1 && a.h % a.kh == 0 && a.c >= 1 && a.d >= 1 &&
         a.d <= 256 && a.chunk >= 1 && a.nchunks == (a.c + a.chunk - 1) / a.chunk;
}

// nchunks = ceil(c / kDecodeSlots)
template <typename T>
static int launch_decode(const void* q, const void* k, const void* v, const void* cpos,
                         void* part_ml, void* part_acc, void* out, const int64_t* dims,
                         double scale, void* stream) {
  DecodeArgs a = decode_args(dims, scale);
  if (!decode_args_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return with_dmax(a.d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    return with_head_group<DMAX>(a.h / a.kh, [&](auto mg) {
      return launch_decode_g<T, DMAX, decltype(mg)::value>(q, k, v, cpos, part_ml, part_acc, out,
                                                           a, s);
    });
  });
}

// The instantiation's shared memory, opted in once per device
template <int DMAX, int MG>
static cudaError_t dec_opt_in() {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t attr =
        cudaFuncSetAttribute(decode_bf16_partials<DMAX, MG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DecTiles<DMAX, MG>::SMEM);
    if (attr != cudaSuccess) return attr;
    opted_in[dev] = true;
  }
  return cudaSuccess;
}

// The slots of one partial: the fewest chunks that fill one wave (the SM
// count times the blocks of this instantiation that an SM holds, from the
// occupancy calculator: its shared memory, registers and threads), spread
// over the (b, kv head, head group) triples, in whole sub-tiles.
template <int DMAX, int MG>
static int dec_chunk(const DecodeArgs& a, int64_t* chunk) {
  using L = DecTiles<DMAX, MG>;
  int dev = 0, sms = 0, resident = 0;
  cudaError_t e = dec_opt_in<DMAX, MG>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, decode_bf16_partials<DMAX, MG>,
                                                      L::NT, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t triples = a.b * a.kh * ((a.h / a.kh + MG - 1) / MG);
  const int64_t wave = (int64_t)sms * (resident > 1 ? resident : 1);
  const int64_t per_pair = wave / triples > 1 ? wave / triples : 1;
  const int64_t slots = (a.c + per_pair - 1) / per_pair;
  *chunk = (slots + kDecSub - 1) / kDecSub * kDecSub;
  return 0;
}

template <int DMAX, int MG>
static int launch_decode_bf16_g(const void* q, const void* k, const void* v, const void* cpos,
                                void* part_ml, void* part_acc, void* out, DecodeArgs a,
                                cudaStream_t s) {
  using L = DecTiles<DMAX, MG>;
  const cudaError_t e = dec_opt_in<DMAX, MG>();
  if (e != cudaSuccess) return (int)e;
  const int64_t group = a.h / a.kh;
  a.ngroups = (group + MG - 1) / MG;
  const int64_t gy = a.b * a.kh * a.ngroups;
  if (gy > 65535 || a.nchunks > 0x7fffffff || a.b * a.h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  decode_bf16_partials<DMAX, MG><<<dim3((unsigned)a.nchunks, (unsigned)gy), L::NT, L::SMEM,
                                   s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)cpos, (float*)part_ml, (float*)part_acc, a);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return launch_combine<__nv_bfloat16>(part_ml, part_acc, out, a, s);
}

__host__ __forceinline__ bool dec_vec_ok(const void* p, const int64_t* st, int64_t d) {
  return (uintptr_t)p % 16 == 0 && st[3] == 1 && d % 8 == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

// dims as launch_decode's, then dims[18] the slots of one partial (a
// multiple of kDecSub; decode_attention_bf16_chunk's) and dims[19]
// the copy flag (checked again here: a misaligned cp.async would fault)
static int launch_decode_bf16(const void* q, const void* k, const void* v, const void* cpos,
                              void* part_ml, void* part_acc, void* out, const int64_t* dims,
                              double scale, void* stream) {
  DecodeArgs a = decode_args(dims, scale);
  a.chunk = dims[18];
  a.vec = dims[19] != 0;
  if (a.chunk < kDecSub || a.chunk % kDecSub != 0 || !decode_args_ok(a))
    return (int)cudaErrorInvalidValue;
  if (a.vec && !(dec_vec_ok(k, a.ks, a.d) && dec_vec_ok(v, a.vs, a.d)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  return with_dmax(a.d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    return with_head_group<DMAX>(a.h / a.kh, [&](auto mg) {
      return launch_decode_bf16_g<DMAX, decltype(mg)::value>(q, k, v, cpos, part_ml, part_acc,
                                                             out, a, s);
    });
  });
}

// dims: b, h, kh, c, d; writes the slots of one partial (dec_chunk)
static int decode_bf16_chunk(const int64_t* dims, int64_t* chunk) {
  DecodeArgs a = {};
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.c = dims[3]; a.d = dims[4];
  if (a.b < 1 || a.h < 1 || a.kh < 1 || a.h % a.kh != 0 || a.c < 1 || a.d < 1 || a.d > 256 ||
      chunk == nullptr)
    return (int)cudaErrorInvalidValue;
  return with_dmax(a.d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    return with_head_group<DMAX>(a.h / a.kh, [&](auto mg) {
      return dec_chunk<DMAX, decltype(mg)::value>(a, chunk);
    });
  });
}

}  // namespace

extern "C" {

int decode_attention_f32(int device, const void* q, const void* k, const void* v,
                         const void* cpos, void* part_ml, void* part_acc, void* out,
                         const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_decode<float>(q, k, v, cpos, part_ml, part_acc, out, dims, scale, stream);
}

int decode_attention_bf16(int device, const void* q, const void* k, const void* v,
                          const void* cpos, void* part_ml, void* part_acc, void* out,
                          const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_decode_bf16(q, k, v, cpos, part_ml, part_acc, out, dims, scale, stream);
}

// B13 bf16's plan on a device: dims (b, h, kh, c, d); writes the slots of
// one partial, which decode_attention_bf16 then takes as dims[18]
int decode_attention_bf16_chunk(int device, const int64_t* dims, int64_t* chunk) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return decode_bf16_chunk(dims, chunk);
}

}  // extern "C"

// B13: single-query (decode) attention over a ring KV cache, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention_pallas.
//
//   o[b, h] = softmax_c(mask(q[b, h] . k[b, h/G, c] * scale)) v[b, h/G, c]
//
// where slot c is valid iff 0 <= cache_pos[c] <= pos; an invalid slot
// scores -1e30, as in the JAX kernel, so a step whose every slot is invalid
// comes out as the mean of v. f32 inside, q's dtype (f32 or bf16) out.
//
// Bound: bytes. A decode step reads the whole cache once: at batch 8,
// 12 kv heads, 2081 slots, head dim 64, f32, k and v are 102.3 MB, at
// least 30.5 us at an H100 SXM's 3.35 TB/s (q, o and cache_pos are
// 50 KB); its 4 flops a slot and head element are far below the f32 rate.
//
// Design: the cache axis is split across blocks, since one block per
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

#include "reduce.cuh"

using namespace repro;

namespace {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeSlots = 32;   // slots of one partial (kernels/build.py: DECODE_SLOTS)
constexpr int kUnroll = 8;
constexpr float kNeg = -1e30f;

struct DecodeArgs {
  int64_t b, h, kh, c, d;
  int64_t qs[3], ks[4], vs[4];     // element strides of q, k and v
  int64_t pos, nchunks, ngroups;
  float scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
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
  // past 48 KB of weights (C above 393,216 slots) the combine pass opts in
  // to more dynamic shared memory; below, nothing is set, so a launch
  // inside a CUDA graph capture makes no attribute call
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

// the least head group of 1, 2, 4 or 8 (4 at head dim 256) that holds G
template <typename T, int DMAX>
static int launch_decode_d(const void* q, const void* k, const void* v, const void* cpos,
                           void* part_ml, void* part_acc, void* out, DecodeArgs a,
                           cudaStream_t s) {
  const int64_t group = a.h / a.kh;
  if (group <= 1) return launch_decode_g<T, DMAX, 1>(q, k, v, cpos, part_ml, part_acc, out, a, s);
  if (group <= 2) return launch_decode_g<T, DMAX, 2>(q, k, v, cpos, part_ml, part_acc, out, a, s);
  if (group <= 4 || DMAX > 128)
    return launch_decode_g<T, DMAX, 4>(q, k, v, cpos, part_ml, part_acc, out, a, s);
  return launch_decode_g<T, DMAX, (DMAX > 128 ? 4 : 8)>(q, k, v, cpos, part_ml, part_acc, out,
                                                         a, s);
}

// dims: b, h, kh, c, d, q strides (3), k strides (4), v strides (4), pos,
// nchunks (= ceil(c / kDecodeSlots), the partial buffers' length)
template <typename T>
static int launch_decode(const void* q, const void* k, const void* v, const void* cpos,
                         void* part_ml, void* part_acc, void* out, const int64_t* dims,
                         double scale, void* stream) {
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
  if (a.b < 1 || a.h < 1 || a.kh < 1 || a.h % a.kh != 0 || a.c < 1 || a.d < 1 || a.d > 256 ||
      a.nchunks != (a.c + kDecodeSlots - 1) / kDecodeSlots)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_decode_d<T, 64>(q, k, v, cpos, part_ml, part_acc, out, a, s);
  if (a.d <= 128) return launch_decode_d<T, 128>(q, k, v, cpos, part_ml, part_acc, out, a, s);
  return launch_decode_d<T, 256>(q, k, v, cpos, part_ml, part_acc, out, a, s);
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
  return launch_decode<__nv_bfloat16>(q, k, v, cpos, part_ml, part_acc, out, dims, scale,
                                      stream);
}

}  // extern "C"

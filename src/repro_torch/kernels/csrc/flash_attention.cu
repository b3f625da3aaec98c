// B14: the flash-attention forward pass of serving prefill, on Hopper.
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
//
// Bound: operations. Causal prefill of batch 8, 12 heads, 2048 tokens,
// head dim 64 does 2 * 2 * 8*12 * 2048*2049/2 * 64 = 51.6 GFLOP of
// products against 201 MB of q, k, v and o: 0.77 ms at an H100 SXM's
// 67 TFLOP/s of f32 outside the tensor cores, 0.06 ms at 3.35 TB/s. The
// products run in f32 on the CUDA cores: TF32 tensor cores would not hold
// the f32 tolerance.
//
// Design: one block of 256 threads per (b, h, tile of kBQ = 64 query rows).
// The q tile stays in shared memory; each tile of kBK = 64 keys of k and v
// is staged there in f32, zero-filled past S and past the head dim. Thread
// (ty, tx) = (t / 16, t % 16) owns query rows 4*ty .. 4*ty+3 of the tile,
// the keys 4*tx .. 4*tx+3 of the score tile and the output columns
// NC*tx .. NC*tx+NC-1, so a row's max and sum reduce over the 16 lanes of
// one half-warp (a xor butterfly: every lane gets the same bits) and its
// m, l and alpha stay in registers between the two products. The q, k and
// probability tiles are stored transposed (the q and k tiles swizzled, see
// swz), so each column of a product is two float4 reads for 16 fmaf: one
// shared-memory load feeds 8 FMAs, where a scalar layout fed 2.
// Inputs are read by strides (the model hands over transposed views of
// (B, L, H, d)); the output is contiguous (B, H, Lq, d).
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

#include "reduce.cuh"

using namespace repro;

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 256;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

struct FlashArgs {
  int64_t b, h, kh, lq, s, d;
  int64_t qs[4], ks[4], vs[4];   // element strides of q, k and v
  int64_t causal, has_window, window;
  float scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ bool key_valid(const FlashArgs& a, int64_t qpos, int64_t kpos) {
  bool ok = true;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.has_window) ok = ok && kpos > qpos - a.window;
  return ok;
}

// Whether query row qpos has a valid key in [0, S).
__device__ __forceinline__ bool row_has_key(const FlashArgs& a, int64_t qpos) {
  int64_t lo = 0, hi = a.s - 1;
  if (a.causal) hi = imin(hi, qpos);
  if (a.has_window) lo = imax(lo, qpos - a.window + 1);
  return lo <= hi;
}

// Where row (or key) r of column c of a transposed tile is stored: the
// groups of 4 rows are permuted by c / 4 (an XOR swizzle), so a warp that
// stores 4 neighbouring columns of a row at a time hits each bank at most
// twice, and a float4 read of rows 4g .. 4g+3 finds them side by side at
// 4 * (g ^ ((c / 4) % 8)).
__device__ __forceinline__ int swz(int c, int r) {
  return ((((r >> 2) ^ ((c >> 2) & 7)) << 2) | (r & 3));
}

template <int DMAX>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)DMAX * (kBQ + 4) + (size_t)DMAX * (kBK + 4) +
                          (size_t)kBK * DMAX + (size_t)kBK * (kBQ + 4));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, FlashArgs a) {
  constexpr int QP = kBQ + 4;         // padded row of the transposed q and p tiles
  constexpr int KP = kBK + 4;         // padded row of the transposed k tile
  constexpr int NC = DMAX / 16;       // output columns a thread owns, side by side
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [DMAX][QP]: q tile, transposed
  float* kt = qt + DMAX * QP;         // [DMAX][KP]: k tile, transposed
  float* vs = kt + DMAX * KP;         // [kBK][DMAX]: v tile
  float* pt = vs + kBK * DMAX;        // [kBK][QP]: probabilities, transposed

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int64_t bi = blockIdx.z, hi = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t khi = hi / (a.h / a.kh);
  const T* qb = q + bi * a.qs[0] + hi * a.qs[1];
  const T* kb = k + bi * a.ks[0] + khi * a.ks[1];
  const T* vb = v + bi * a.vs[0] + khi * a.vs[1];

  // a thread loads 4 neighbouring columns of one row; a warp covers whole
  // rows, so the global reads are coalesced
  constexpr int G4 = DMAX / 4;
  for (int e = t; e < kBQ * G4; e += kFlashThreads) {
    const int r = e / G4, c0 = (e % G4) * 4;
    const int64_t row = q0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      qt[c * QP + swz(c, r)] =
          (row < a.lq && c < a.d) ? load_f(qb + row * a.qs[2] + c * a.qs[3]) : 0.0f;
    }
  }

  // the key tiles to visit (see the note on skipped tiles above)
  const int64_t qlast = imin(q0 + kBQ, a.lq) - 1;
  bool every_row = true;
  for (int64_t r = q0; r <= qlast; ++r) every_row = every_row && row_has_key(a, r);
  int64_t t_lo = 0, t_hi = (a.s + kBK - 1) / kBK;
  if (every_row) {
    int64_t lo = 0, hi_key = a.s - 1;
    if (a.causal) hi_key = imin(hi_key, qlast);
    if (a.has_window) lo = imax(lo, q0 - a.window + 1);
    t_lo = lo / kBK;
    t_hi = hi_key / kBK + 1;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t kt_i = t_lo; kt_i < t_hi; ++kt_i) {
    const int64_t k0 = kt_i * kBK;
    __syncthreads();                  // the last tile's readers are done
    for (int e = t; e < kBK * G4; e += kFlashThreads) {
      const int r = e / G4, c0 = (e % G4) * 4;
      const int64_t key = k0 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i;
        kt[c * KP + swz(c, r)] =
            (key < a.s && c < a.d) ? load_f(kb + key * a.ks[2] + c * a.ks[3]) : 0.0f;
      }
    }
    for (int e = t; e < kBK * DMAX; e += kFlashThreads) {
      const int r = e / DMAX, c = e % DMAX;   // columns fastest: coalesced
      const int64_t key = k0 + r;
      vs[r * DMAX + c] = (key < a.s && c < a.d) ? load_f(vb + key * a.vs[2] + c * a.vs[3]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4*ty + i and keys 4*tx + j: two float4 reads a column
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      const int f = (c >> 2) & 7;
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * QP + 4 * (ty ^ f));
      const float4 kc = *reinterpret_cast<const float4*>(kt + c * KP + 4 * (tx ^ f));
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + tx * 4 + j;
        float x = -INFINITY;                       // no key here: adds nothing
        if (key < a.s) x = key_valid(a, row, key) ? s[i][j] * a.scale : kNeg;
        s[i][j] = x;
        mx = maxval(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = maxval(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = mn;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * QP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + kk * QP + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c4 = 0; c4 < NC / 4; ++c4) {
        const float4 vc = *reinterpret_cast<const float4*>(vs + kk * DMAX + tx * NC + 4 * c4);
        const float vv[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][4 * c4 + x] = fmaf(pv[i], vv[x], acc[i][4 * c4 + x]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row < a.lq) {
      const float ls = maxval(l[i], 1e-37f);
      T* o = out + ((bi * a.h + hi) * a.lq + row) * a.d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx * NC + c;
        if (col < a.d) store_f(o + col, acc[i][c] / ls);
      }
    }
  }
}

template <typename T, int DMAX>
static int launch_flash_d(const void* q, const void* k, const void* v, void* out,
                          const FlashArgs& a, cudaStream_t s) {
  constexpr size_t smem = flash_smem_bytes<DMAX>();
  static bool opted_in[kMaxDevices] = {};   // per device, once per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((unsigned)((a.lq + kBQ - 1) / kBQ), (unsigned)a.h, (unsigned)a.b);
  flash_fwd_kernel<T, DMAX><<<grid, kFlashThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, a);
  return (int)cudaGetLastError();
}

// dims: b, h, kh, lq, s, d, q strides (4), k strides (4), v strides (4),
// causal, has_window, window
template <typename T>
static int launch_flash(const void* q, const void* k, const void* v, void* out,
                        const int64_t* dims, double scale, void* stream) {
  FlashArgs a;
  a.b = dims[0]; a.h = dims[1]; a.kh = dims[2]; a.lq = dims[3]; a.s = dims[4]; a.d = dims[5];
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = dims[6 + i];
    a.ks[i] = dims[10 + i];
    a.vs[i] = dims[14 + i];
  }
  a.causal = dims[18]; a.has_window = dims[19]; a.window = dims[20];
  a.scale = (float)scale;
  if (a.b < 1 || a.b > 65535 || a.h < 1 || a.h > 65535 || a.kh < 1 || a.h % a.kh != 0 ||
      a.lq < 1 || (a.lq + kBQ - 1) / kBQ > 0x7fffffff || a.s < 1 || a.d < 1 || a.d > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d <= 64) return launch_flash_d<T, 64>(q, k, v, out, a, s);
  if (a.d <= 128) return launch_flash_d<T, 128>(q, k, v, out, a, s);
  return launch_flash_d<T, 256>(q, k, v, out, a, s);
}

}  // namespace

extern "C" {

int flash_attention_f32(int device, const void* q, const void* k, const void* v, void* out,
                        const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_flash<float>(q, k, v, out, dims, scale, stream);
}

int flash_attention_bf16(int device, const void* q, const void* k, const void* v, void* out,
                         const int64_t* dims, double scale, void* stream) {
  const cudaError_t sel = cudaSetDevice(device);
  if (sel != cudaSuccess) return (int)sel;
  return launch_flash<__nv_bfloat16>(q, k, v, out, dims, scale, stream);
}

}  // extern "C"

// Flash attention (online softmax) with GQA and causal / sliding-window /
// key-padding masks, for Hopper (sm_90a); fp32 or bf16 in, fp32 inside.
//
// Replaces kernels/flash_attention.py:flash_attention_pallas.  Layout as in
// models/layers.py:attention: q (B, S, H, hd), k and v (B, T, KVH, hd),
// contiguous; query head h reads KV head h / G (G = H / KVH); query row i
// sits at position i + q_offset.  Semantics of the Pallas kernel: q is cast
// to fp32 and then scaled by hd^-0.5, scores, running max, denominator and
// accumulator are fp32, masked scores count as -1e30, the denominator is
// floored at 1e-30, and the output takes q's dtype.  Unlike the Pallas
// kernel it neither transposes nor pads: ragged query and key tiles are
// masked here.
//
// Bound: on this path (hd 64 or 128, thousands of keys) the score and P·V
// products dominate: 4·hd multiply-adds per (query, key) pair against a
// few bytes per row, so operations bound it.  This first version runs them
// as fp32 FFMA (no tensor cores, no TF32: fp32 is the parity path), so its
// ceiling is the card's 67 TFLOP/s fp32 rate; mma.sync / wgmma on bf16,
// TMA and pipelining are later work.  The design keeps the FFMA issue rate
// up and skips work the masks remove:
//
// * one CTA of 256 threads per (batch, query head, 64-row query tile); the
//   grid walks the query tiles last-first, so the causal mask's longest
//   tiles start first;
// * the CTA visits only the 64-key tiles its causal and window footprint
//   reaches: a tile that the masks remove for every row of the query tile
//   is never loaded;
// * the scaled Q tile stays in shared memory for the whole key loop; each
//   K and V tile is staged there once (16-byte loads, converted to fp32),
//   rows past T zero-filled and masked;
// * thread (ty, tx) owns query rows 4·ty … 4·ty+3: scores for keys tx +
//   16·j (j < 4: the K rows a quarter-warp reads fall in distinct banks with
//   the padded stride hd + 4) and output columns 4·tx + 64·j' (j' < hd/64);
//   a row's running max m, denominator l and hd/16 accumulators live in
//   the registers of the 16 threads that share ty, which reduce a tile's
//   row max and row sum with four xor-shuffles;
// * masked entries contribute p = 0 outright, so a row whose first tiles
//   are all masked carries nothing forward (the Pallas recurrence sums
//   garbage there until a valid key wipes it); a row with no valid key at
//   all comes out 0;
// * the probability tile reuses the K tile's shared memory: 51,200 bytes a
//   CTA at hd 64, 100,352 at hd 128 (two CTAs an SM), above the 48 KB
//   default, so the host raises the dynamic limit before each launch.
//
// The host function returns cudaGetLastError() so the Python wrapper can
// raise; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 64;        // query rows per CTA
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_LDP = FA_BK + 4;
constexpr float FA_NEG = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Io<__nv_bfloat16> {
  // Four bf16 in 8 bytes; the element at the lower address is the low half
  // of each 32-bit word.  bf16 → fp32 is exact (a 16-bit shift).
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  // Round to nearest even, as a PyTorch cast from fp32 to bf16 does.
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int HD>
constexpr int smem_floats() {
  // Q tile, K tile (later the probability tile), V tile
  return 2 * FA_BQ * (HD + 4) + FA_BK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int Tn, int H,
    int KVH, int causal, int window, int q_offset, float scale) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  static_assert(FA_BQ * (HD + 4) >= FA_BQ * FA_LDP, "P must fit in K's tile");
  constexpr int LD = HD + 4;   // padded row stride of the Q and K tiles
  constexpr int NV = HD / 64;  // float4 output column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [FA_BQ][LD]
  float* ks = qs + FA_BQ * LD;  // [FA_BK][LD]
  float* ps = ks;               // [FA_BQ][FA_LDP], once the scores are done
  float* vs = ks + FA_BK * LD;  // [FA_BK][HD]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / (H / KVH);

  const long long q_stride = (long long)H * HD;     // between positions
  const long long kv_stride = (long long)KVH * HD;
  const T* qb = q + ((long long)b * S * H + h) * HD;
  const T* kb = k + ((long long)b * Tn * KVH + n) * HD;
  const T* vb = v + ((long long)b * Tn * KVH + n) * HD;
  T* ob = out + ((long long)b * S * H + h) * HD;

  for (int i = tid; i < FA_BQ * HD / 4; i += FA_THREADS) {
    const int r = i / (HD / 4);
    const int c4 = i % (HD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = Io<T>::load4(qb + (long long)(q0 + r) * q_stride + 4 * c4);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * LD + 4 * c4) = x;
  }

  float m[4], l[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) acc[i][e] = 0.f;
  }

  // the keys any row of this tile may see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + FA_BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tn, q_hi + 1) : Tn;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int k0 = (k_begin / FA_BK) * FA_BK; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // Q staged; the last tile's P and V consumed
    for (int i = tid; i < FA_BK * HD / 4; i += FA_THREADS) {
      const int r = i / (HD / 4);
      const int c4 = i % (HD / 4);
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Tn) {
        const long long off = (long long)(k0 + r) * kv_stride + 4 * c4;
        kx = Io<T>::load4(kb + off);
        vx = Io<T>::load4(vb + off);
      }
      *reinterpret_cast<float4*>(ks + r * LD + 4 * c4) = kx;
      *reinterpret_cast<float4*>(vs + r * HD + 4 * c4) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + q_offset;
      unsigned ok = 0;
      float mt = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < Tn && (!causal || kpos <= qpos) &&
                           (window <= 0 || kpos > qpos - window);
        ok |= (unsigned)valid << j;
        if (valid) mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha[i] + row_sum16(rs);
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(4 * ty + i) * FA_LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4 * NV; ++e) acc[i][e] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < FA_BK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * FA_LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[NV];
#pragma unroll
        for (int jj = 0; jj < NV; ++jj)
          vv[jj] = *reinterpret_cast<const float4*>(
              vs + (c + cc) * HD + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = comp(pr[i], cc);
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            acc[i][4 * jj + 0] = fmaf(pv, vv[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pv, vv[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pv, vv[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pv, vv[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const float4 o = make_float4(
          acc[i][4 * jj + 0] / den, acc[i][4 * jj + 1] / den,
          acc[i][4 * jj + 2] / den, acc[i][4 * jj + 3] / den);
      Io<T>::store4(ob + (long long)row * q_stride + 4 * tx + 64 * jj, o);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int kvh, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  // above the 48 KB default: raise the limit (per device, so every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s + FA_BQ - 1) / FA_BQ), (unsigned)h,
                  (unsigned)b);
  flash_attention_kernel<T, HD><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, t, h, kvh, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); window <= 0
// means no window.
int jk_flash_attention(const void* q, const void* k, const void* v,
                       void* out, int b, int s, int t, int h, int kvh,
                       int hd, int causal, int window, int q_offset,
                       float scale, int dtype, void* stream) {
  if (b < 0 || s < 0 || t < 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, b, s, t, h, kvh, causal, window,
                             q_offset, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, b, s, t, h, kvh, causal, window,
                              q_offset, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, b, s, t, h, kvh, causal,
                                     window, q_offset, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, b, s, t, h, kvh, causal,
                                      window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

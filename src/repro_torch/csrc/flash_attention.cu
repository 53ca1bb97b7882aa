// Flash attention (online softmax) with GQA and causal / sliding-window /
// key-padding masks, for Hopper (sm_90a): two forward kernels, chosen by
// dtype, and the three launches of its backward, also chosen by dtype (see
// "backward" below).
//
// Replaces kernels/flash_attention.py:flash_attention_pallas.  Layout as in
// models/layers.py:attention: q (B, S, H, hd), k and v (B, T, KVH, hd),
// contiguous; query head h reads KV head h / G (G = H / KVH); query row i
// sits at position i + q_offset.  Semantics of the Pallas kernel: scores,
// running max, denominator and accumulator are fp32, masked entries
// contribute nothing, the denominator is floored at 1e-30, and the output
// takes q's dtype.  Unlike the Pallas kernel neither kernel transposes or
// pads: ragged query and key tiles are masked here.  Both visit only the
// 64-key tiles that the causal and window masks reach, walk the query
// tiles last-first (the causal mask's longest tiles start first), and give
// masked entries p = 0 outright, so a row whose first visited keys are all
// masked carries nothing forward and a row with no valid key comes out 0.
//
// Bound: on this path (hd 64 or 128, thousands of keys) the score and P·V
// products dominate: 4·hd operations per unmasked (query, key) pair against
// a few bytes per row, so operations bound both kernels.
//
// flash_attention_tc_kernel (bf16) runs both products on the tensor cores
// (ceiling 989 TFLOP/s dense bf16), FlashAttention-2 style on mma.sync
// m16n8k16 with fp32 accumulators:
//
// * one CTA per (batch, query head, query tile of 128 rows at hd 64, 256 at
//   hd 128); each warp owns 32 query rows, two m16 tiles, so every K and V
//   fragment it reads from shared memory feeds two products.  Every warp
//   reads all of a K/V tile, so with 16-row warps those reads, not the
//   tensor cores, set the pace.  Q's fragments are reloaded from shared
//   memory each k16 step: O's accumulators leave no registers for them;
// * K and V tiles of 64 keys move through a three-stage cp.async ring in
//   shared memory, two tiles ahead of the one computed, with one barrier a
//   tile; rows past T are zero-filled by cp.async's src-size-0 form
//   (garbage in V would give NaN even at p = 0) and masked; rows are padded
//   by 16 bytes, so the eight rows an ldmatrix reads fall in distinct
//   banks, for K (the col-major B operand of Q·Kᵀ as stored) and for V
//   (ldmatrix.trans gives the B operand of P·V);
// * the online softmax runs on the S accumulator fragments: a row's max
//   takes a tree over the thread's 16 scores and two xor-shuffles within
//   the quad that holds the row, p = 2^(s·c − m·c) is one FFMA and one
//   MUFU op (c = hd^-0.5·log2 e), the accumulators are rescaled only when
//   a row's max moved, and denominators stay per thread until the end;
// * P is rounded to bf16 in registers and used directly as the A fragments
//   of P·V (the S accumulator layout is the A layout of m16n8k16), with no
//   trip through shared memory; like models/layers.py:attention and unlike
//   the Pallas kernel, P·V therefore sees bf16 probabilities;
// * masks are applied only on the tiles where the warp's rows need them,
//   and a warp skips a tile its rows cannot see at all.
//
// flash_attention_kernel (fp32) is the parity path and runs both products
// as fp32 FFMA (no tensor cores, no TF32: ceiling 67 TFLOP/s):
//
// * one CTA of 256 threads per (batch, query head, 64-row query tile);
// * the scaled Q tile stays in shared memory for the whole key loop; each
//   K and V tile is staged there once (16-byte loads), rows past T
//   zero-filled and masked;
// * thread (ty, tx) owns query rows 4·ty … 4·ty+3: scores for keys tx +
//   16·j (j < 4: the K rows a quarter-warp reads fall in distinct banks with
//   the padded stride hd + 4) and output columns 4·tx + 64·j' (j' < hd/64);
//   a row's running max m, denominator l and hd/16 accumulators live in
//   the registers of the 16 threads that share ty, which reduce a tile's
//   row max and row sum with four xor-shuffles;
// * the probability tile reuses the K tile's shared memory: 51,200 bytes a
//   CTA at hd 64, 100,352 at hd 128 (two CTAs an SM), above the 48 KB
//   default, so the host raises the dynamic limit before each launch.
//
// Both forward kernels write each row's log-sum-exp (m + ln l, fp32 (B, H,
// S), −inf for a row with no valid key) when the caller passes a pointer
// for it, which training does and serving does not.
//
// The host functions return cudaGetLastError() so the Python wrapper can
// raise; the launches go on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 64;        // query rows per CTA
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_LDP = FA_BK + 4;
constexpr float FA_NEG = -1e30f;

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

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 2) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int Tn, int H, int KVH, int causal,
    int window, int q_offset, float scale) {
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
  const float* qb = q + ((long long)b * S * H + h) * HD;
  const float* kb = k + ((long long)b * Tn * KVH + n) * HD;
  const float* vb = v + ((long long)b * Tn * KVH + n) * HD;
  float* ob = out + ((long long)b * S * H + h) * HD;

  for (int i = tid; i < FA_BQ * HD / 4; i += FA_THREADS) {
    const int r = i / (HD / 4);
    const int c4 = i % (HD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = load4(qb + (long long)(q0 + r) * q_stride + 4 * c4);
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
        kx = load4(kb + off);
        vx = load4(vb + off);
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
    // m + log l in scaled-score units; -inf for a row with no valid key
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + row] = m[i] + logf(l[i]);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const float4 o = make_float4(
          acc[i][4 * jj + 0] / den, acc[i][4 * jj + 1] / den,
          acc[i][4 * jj + 2] / den, acc[i][4 * jj + 3] / den);
      *reinterpret_cast<float4*>(ob + (long long)row * q_stride + 4 * tx +
                                 64 * jj) = o;
    }
  }
}

// ------------------------------------------------ bf16 on the tensor cores

constexpr int TC_BK = 64;      // keys per tile
constexpr int TC_STAGES = 3;   // K/V ring: tile j (V), j + 1 (K), j + 2 (loading)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// Tile shape by head dim (measured on the H100 with
// tools/kernel_variants.py; PERF.md): WARPS warps of 32 query rows (two
// m16 tiles, so each K and V fragment read from shared memory feeds two
// products), MINB CTAs an SM for the register budget.  O's 64 or 128
// accumulators a thread leave no room for Q's fragments, which are reloaded
// from shared memory each k16 step.
template <int HD>
struct TcShape {
  static constexpr int MT = 2;  // m16 tiles a warp
  static constexpr int WARPS = HD == 64 ? 4 : 8;
  static constexpr int MINB = HD == 64 ? 2 : 1;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;  // query rows per CTA
};

template <int HD>
constexpr int tc_smem_bytes() {
  // Q tile, then the K and V rings; rows padded by 8 bf16 (16 bytes)
  return (TcShape<HD>::BQ + 2 * TC_STAGES * TC_BK) * (HD + 8) *
         (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; zero-filled when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16×8 fp32) += a (16×16 bf16, row) · b (16×8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats → bf16x2, round to nearest even; lo is the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a, b ≈ hi + lo as two bf16 pairs (each rounded to nearest even): hi
// keeps 8 significant bits, lo the next 8, so a product split in two
// carries P or dS to ~2^-17 where one bf16 operand would carry 2^-9
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// 2^x on the special-function unit (one MUFU op; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layouts of mma.m16n8k16 for lane = 4·g + t (PTX ISA): the
// accumulator holds rows g and g + 8, columns 2t and 2t + 1; A the same
// rows at columns 2t, 2t + 1 and 2t + 8, 2t + 9; B columns (n) g, rows (k)
// 2t, 2t + 1 and 2t + 8, 2t + 9.  A thread holds 2·MT rows of its warp,
// indexed rr = 2·mt + (0 for row g, 1 for row g + 8).
template <int HD>
__global__ void __launch_bounds__(TcShape<HD>::THREADS, TcShape<HD>::MINB)
    flash_attention_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out,
                              bf16* __restrict__ out_lo,
                              float* __restrict__ lse, int S, int Tn, int H,
                              int KVH, int causal, int window, int q_offset,
                              float scale_log2) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  using C = TcShape<HD>;
  constexpr int MT = C::MT, NTHR = C::THREADS, BQ = C::BQ, BK = TC_BK;
  constexpr int NK = BK / 8;    // n8 tiles of S (keys) per tile
  constexpr int LD = HD + 8;    // padded row stride, in bf16
  constexpr int KT = HD / 16;   // k16 steps of Q·Kᵀ
  constexpr int NT = HD / 8;    // n8 tiles of the output
  constexpr int CH = HD / 8;    // 16-byte chunks of a row
  constexpr int WR = 16 * MT;   // query rows per warp
  constexpr int RR = 2 * MT;    // rows per thread
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                       // [TC_STAGES][BK][LD]
  bf16* vs = ks + TC_STAGES * BK * LD;           // [TC_STAGES][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / (H / KVH);

  const long long q_stride = (long long)H * HD;  // between positions
  const long long kv_stride = (long long)KVH * HD;
  const bf16* qb = q + ((long long)b * S * H + h) * HD;
  const bf16* kb = k + ((long long)b * Tn * KVH + n) * HD;
  const bf16* vb = v + ((long long)b * Tn * KVH + n) * HD;
  bf16* ob = out + ((long long)b * S * H + h) * HD;

  // the keys any row of this tile may see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tn, q_hi + 1) : Tn;
  const int k_first = (window > 0 ? max(0, q_lo - window + 1) : 0) / BK * BK;
  const int ntiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const int k0 = k_first + tile * BK;
    bf16* kd = ks + (tile % TC_STAGES) * BK * LD;
    bf16* vd = vs + (tile % TC_STAGES) * BK * LD;
#pragma unroll
    for (int j = 0; j < BK * CH / NTHR; ++j) {
      const int i = tid + j * NTHR;
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Tn;
      const long long off = (long long)(ok ? k0 + r : 0) * kv_stride + 8 * c;
      cp_async16(smem_addr(kd + r * LD + 8 * c), kb + off, ok);
      cp_async16(smem_addr(vd + r * LD + 8 * c), vb + off, ok);
    }
  };

  // Q and the first two K/V tiles: groups 0 (Q, tile 0) and 1 (tile 1)
#pragma unroll
  for (int j = 0; j < BQ * CH / NTHR; ++j) {
    const int i = tid + j * NTHR;
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < S;
    cp_async16(smem_addr(qs + r * LD + 8 * c),
               qb + (long long)(ok ? q0 + r : 0) * q_stride + 8 * c, ok);
  }
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  if (ntiles > 1) load_kv(1);
  cp_async_commit();

  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  // running max (raw score units) and this thread's share of the sum
  float m[RR], l[RR];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    m[rr] = FA_NEG;
    l[rr] = 0.f;
  }

  // this warp's rows
  const int wrow = q0 + WR * warp;
  const int wpos_lo = wrow + q_offset, wpos_hi = wpos_lo + WR - 1;

  // The ring runs two tiles ahead of the one computed (tile it + 1 may
  // still be in flight); one barrier a tile guards it.
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    // tile it landed for every thread; every warp is done with tile it - 1,
    // whose stage tile it + 2 takes
    __syncthreads();
    if (it + 2 < ntiles) load_kv(it + 2);
    cp_async_commit();
    const int k0 = k_first + it * BK;
    // a tile none of the warp's rows can see adds nothing
    if (wrow >= S || (causal && k0 > wpos_hi) ||
        (window > 0 && k0 + BK - 1 <= wpos_lo - window))
      continue;

    // S = Q·Kᵀ: WR rows × BK keys, NK n8 tiles per m16 tile
    const bf16* kt = ks + (it % TC_STAGES) * BK * LD;
    float sc[MT][NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[MT][4];  // Q's A fragments: rows 16·mt + 0..15
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qa[mt], smem_addr(qs + (WR * warp + 16 * mt + (lane & 15)) *
                                           LD +
                                  16 * kk + 8 * (lane >> 4)));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bk[4];  // keys 16·np + 0..7 and + 8..15, hd 16·kk + 0..15
        ldsm_x4(bk, smem_addr(kt + (16 * np + (lane & 7) + 8 * (lane >> 4)) *
                                       LD +
                              16 * kk + 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * np], qa[mt], bk[0], bk[1]);
          mma_bf16(sc[mt][2 * np + 1], qa[mt], bk[2], bk[3]);
        }
      }
    }

    // masked scores are -inf, so p = 0
    if (k0 + BK > Tn || (causal && k0 + BK - 1 > wpos_lo) ||
        (window > 0 && k0 <= wpos_hi - window)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = wpos_lo + 16 * mt + 8 * (e >> 1) + g;
            if (!(kpos < Tn && (!causal || kpos <= qp) &&
                  (window <= 0 || kpos > qp - window)))
              sc[mt][j][e] = -INFINITY;
          }
    }
    // online softmax: row max over the quad, p = 2^(s·c − m·c) by one FFMA
    // and one MUFU op, c = hd^-0.5·log2 e
    float alpha[RR], mc[RR];
    bool moved = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[NK];
#pragma unroll
        for (int j = 0; j < NK; ++j)
          x[j] = fmaxf(sc[mt][j][2 * r], sc[mt][j][2 * r + 1]);
#pragma unroll
        for (int w = NK / 2; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
        float mx = fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const int rr = 2 * mt + r;
        const float m_new = fmaxf(m[rr], mx);  // finite: at least FA_NEG
        moved |= m_new != m[rr];
        alpha[rr] = ex2((m[rr] - m_new) * scale_log2);
        m[rr] = m_new;
        mc[rr] = m_new * scale_log2;
      }
    // the accumulators need rescaling only where a row's max moved
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][0] *= alpha[2 * mt];
          o[mt][j][1] *= alpha[2 * mt];
          o[mt][j][2] *= alpha[2 * mt + 1];
          o[mt][j][3] *= alpha[2 * mt + 1];
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 2 * mt + r;
        float x[NK];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float p0 = ex2(fmaf(sc[mt][j][2 * r], scale_log2, -mc[rr]));
          const float p1 = ex2(fmaf(sc[mt][j][2 * r + 1], scale_log2, -mc[rr]));
          sc[mt][j][2 * r] = p0;
          sc[mt][j][2 * r + 1] = p1;
          x[j] = p0 + p1;
        }
#pragma unroll
        for (int w = NK / 2; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) x[j] += x[j + w];
        l[rr] = l[rr] * alpha[rr] + x[0];
      }

    // O += P·V: P's accumulator fragments are the A fragments, in bf16
    const bf16* vt = vs + (it % TC_STAGES) * BK * LD;
#pragma unroll
    for (int kc = 0; kc < NK / 2; ++kc) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(sc[mt][2 * kc][0], sc[mt][2 * kc][1]);
        pa[mt][1] = pack_bf16(sc[mt][2 * kc][2], sc[mt][2 * kc][3]);
        pa[mt][2] = pack_bf16(sc[mt][2 * kc + 1][0], sc[mt][2 * kc + 1][1]);
        pa[mt][3] = pack_bf16(sc[mt][2 * kc + 1][2], sc[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];  // keys 16·kc + 0..15, hd 16·np + 0..7 and + 8..15
        ldsm_x4_trans(bv, smem_addr(vt + (16 * kc + (lane & 7) +
                                          8 * ((lane >> 3) & 1)) * LD +
                                    16 * np + 8 * (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * np], pa[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * np + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing stays in flight

#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  // m·scale + ln l (m is in raw score units); -inf for a row with no
  // valid key
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int row = wrow + 8 * rr + g;  // rr = 2·mt + r: row 16·mt + 8·r
      if (row < S)
        lse[((long long)b * H + h) * S + row] =
            (m[rr] * scale_log2 + log2f(l[rr])) * LN2;
    }
  }
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 16 * mt + 8 * r + g;
      if (row >= S) continue;
      const float inv = l[2 * mt + r];
      const long long at = (long long)row * q_stride + 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t hi, lo;  // out_lo: the part of O that bf16 rounds away
        split_bf16(o[mt][j][2 * r] * inv, o[mt][j][2 * r + 1] * inv, hi, lo);
        *reinterpret_cast<uint32_t*>(ob + at + 8 * j) = hi;
        if (out_lo != nullptr)
          *reinterpret_cast<uint32_t*>(out_lo + (ob - out) + at + 8 * j) = lo;
      }
    }
}

// ------------------------------------------------------------- backward
//
// FlashAttention-2's backward, recomputing P from q, k and the forward's
// log-sum-exp (lse, fp32 (B, H, S)): with s = q·k and p = exp(s·scale −
// lse) on the unmasked pairs (0 elsewhere),
//   D = rowsum(dO ∘ O),  dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ∘ (dP − D),
//   dQ = scale · dS K,   dK = scale · dSᵀ Q,
// dK and dV summed over the G query heads of a KV head.  Three launches,
// for either dtype:
//
// * attn_bwd_preprocess_kernel: D in fp32, a group of 8–32 threads a
//   (batch, position, head) row reading 16 bytes each;
// * dK/dV: one CTA per (batch, KV head, key tile), walking the G query
//   heads of its group and, for each, the query tiles its causal and
//   window masks reach; dK and dV accumulate in registers and are written
//   once, so no atomics: the CTA owns its keys across the whole group.
//   Key tile 0 sees the most queries under the causal mask, and the grid
//   starts with it;
// * dQ: one CTA per (batch, query head, query tile), walking the key tiles
//   its masks reach (the forward's walk, last query tile first) and
//   writing dQ once.  Splitting dQ from dK/dV keeps every gradient
//   deterministic (two calls give the same bits; a resumed run repeats a
//   straight one) at the price of computing Q·Kᵀ and dO·Vᵀ twice.
//
// Bound: five products of 2·hd operations per unmasked pair (10·hd; the
// split makes it 14·hd as run) against ~hd·2 bytes a row per operand, so
// operations bound the backward.
//
// bf16 (attn_bwd_dkdv_tc_kernel, attn_bwd_dq_tc_kernel) runs all five
// products on the tensor cores, mma.sync m16n8k16 with fp32 accumulators
// and the forward's fragment tools:
//
// * dK/dV makes keys the M dimension: each warp owns 16 keys (one m16
//   tile) and computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with K and V as the A
//   operands (held in registers at hd 64, reloaded from shared memory each
//   k16 step at hd 128, where dK's and dV's 128 accumulators leave no room)
//   and the query tile's Q and dO as col-major B operands, read by
//   ldmatrix as stored (query, hd);
// * Pᵀ = 2^(sᵀ·c − lse·log2 e) (one FFMA and one MUFU op) and dSᵀ = Pᵀ ∘
//   (dPᵀ − D) are formed on the accumulator fragments, lse and D per query
//   column, rounded to bf16 and used directly as the A fragments of dV +=
//   Pᵀ·dO and dK += dSᵀ·Q (a pair of n8 accumulator tiles is an m16k16 A
//   fragment), whose B operands are the same Q and dO tiles read with
//   ldmatrix.trans: no trip through shared memory;
// * the Q and dO tiles, with their lse and D, stream through a cp.async
//   ring one tile ahead of the one computed, one barrier a tile; rows past
//   S are zero-filled and get lse = +inf, so p = 0 there;
// * dQ is the forward's structure: warps of 16 query rows with Q and dO as
//   A fragments (registers at hd 64, reloaded at hd 128), K and V tiles of
//   64 keys through a cp.async ring, S = Q·Kᵀ and dP = dO·Vᵀ with K and V
//   as col-major B operands, dS formed on the accumulators and used as the
//   A fragment of dQ += dS·K, K read with ldmatrix.trans;
// * masks are applied only on the tiles where a warp needs them, and a
//   warp skips a tile its keys (or rows) cannot see at all.
//
// Like FlashAttention-2, the bf16 path rounds P and dS to bf16 (nearest
// even) before their products; every sum is fp32 and each gradient rounds
// to bf16 once.  fp32 (attn_bwd_dkdv_kernel, attn_bwd_dq_kernel) is the
// parity path and runs every product as fp32 FFMA: thread (ty, tx) of 256
// owns rows 4·ty … 4·ty+3 and keys tx + 16·j (j < 4) of the score and dP
// tiles, as the fp32 forward does, and for the accumulating products rows
// (keys for dK/dV) 4·ty … 4·ty+3 and columns 4·tx + 64·j' (j' < hd/64),
// with 64-row query and 64-key tiles staged in shared memory.
//
// Masked pairs, rows past S and keys past T give p = 0 outright, so a row
// with no valid key (lse = −inf) has zero gradients rather than NaN, and a
// key no row sees gets dK = dV = 0.

constexpr int BW_THREADS = 256;
constexpr int BW_BQ = 64;  // query rows a tile
constexpr int BW_BK = 64;  // keys a tile
constexpr int BW_LDP = BW_BK + 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 (8 bytes, lowest address first) → fp32, exactly
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [0, 64) of a (positions, heads, HD) operand from position p0 into a
// padded fp32 tile; rows at or past n are zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int p0, int n,
                                           int tid) {
  constexpr int LD = HD + 4;
  for (int i = tid; i < 64 * HD / 4; i += BW_THREADS) {
    const int r = i / (HD / 4);
    const int c4 = i % (HD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < n) x = ld4(src + (long long)(p0 + r) * stride + 4 * c4);
    st4(dst + r * LD + 4 * c4, x);
  }
}

// the score and dP tiles: s[i][j] = a[4ty+i]·b[tx+16j], dp[i][j] =
// c[4ty+i]·d[tx+16j] over HD (a, c: query rows; b, d: keys)
template <int HD>
__device__ __forceinline__ void score_tiles(const float* a, const float* bm,
                                            const float* c, const float* d,
                                            int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < HD; e += 4) {
    float4 qa[4], ka[4], oa[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = ld4(a + (4 * ty + i) * LD + e);
      oa[i] = ld4(c + (4 * ty + i) * LD + e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ka[j] = ld4(bm + (tx + 16 * j) * LD + e);
      va[j] = ld4(d + (tx + 16 * j) * LD + e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        dp[i][j] = fmaf(oa[i].x, va[j].x, dp[i][j]);
        dp[i][j] = fmaf(oa[i].y, va[j].y, dp[i][j]);
        dp[i][j] = fmaf(oa[i].z, va[j].z, dp[i][j]);
        dp[i][j] = fmaf(oa[i].w, va[j].w, dp[i][j]);
      }
  }
}

// s ← p = exp(s·scale − lse) on valid pairs, else 0; dp ← dS = p·(dp − D).
// Rows q0 + 4ty + i (positions + q_offset), keys k0 + tx + 16j.
__device__ __forceinline__ void softmax_grad(
    float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
    const float* d_s, int q0, int k0, int ty, int tx, int S, int Tn,
    int causal, int window, int q_offset, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const int qpos = row + q_offset;
    const float li = lse_s[4 * ty + i], di = d_s[4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool valid = row < S && kpos < Tn && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
      const float p = valid ? expf(fmaf(s[i][j], scale, -li)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - di);
    }
  }
}

// D = rowsum(dO ∘ O) in fp32: a group of HD·sizeof(T)/16 neighbouring
// threads a (batch, position, head) row, 16 bytes of each operand a
// thread, so a warp's loads are contiguous; a shuffle tree in the group
template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS) attn_bwd_preprocess_kernel(
    const T* __restrict__ out, const T* __restrict__ out_lo,
    const T* __restrict__ dout, float* __restrict__ delta, int S, int H,
    long long rows) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a thread
  constexpr int L = HD / E;               // threads a row
  static_assert(L <= 32 && 32 % L == 0, "a row's threads share a warp");
  const long long r = ((long long)blockIdx.x * BW_THREADS + threadIdx.x) / L;
  const int c = threadIdx.x % L;
  float acc = 0.f;
  if (r < rows) {  // r = (b·S + i)·H + h
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      float4 x = ld4(out + r * HD + c * E + e);
      if (out_lo != nullptr) {  // O = hi + lo: D without O's bf16 rounding
        const float4 z = ld4(out_lo + r * HD + c * E + e);
        x = make_float4(x.x + z.x, x.y + z.y, x.z + z.z, x.w + z.w);
      }
      const float4 y = ld4(dout + r * HD + c * E + e);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && c == 0) {
    const long long h = r % H, bi = r / H;
    const long long b = bi / S, i = bi % S;
    delta[(b * H + h) * S + i] = acc;
  }
}

template <int HD>
constexpr int dkdv_smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and D of the query tile
  return 4 * 64 * (HD + 4) + 2 * BW_BQ * BW_LDP + 2 * BW_BQ;
}

template <int HD>
__global__ void __launch_bounds__(BW_THREADS) attn_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int Tn, int H,
    int KVH, int causal, int window, int q_offset, float scale) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  constexpr int LD = HD + 4;
  constexpr int NV = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [BW_BK][LD]
  float* vs = ks + BW_BK * LD;        // [BW_BK][LD]
  float* qs = vs + BW_BK * LD;        // [BW_BQ][LD]
  float* dos = qs + BW_BQ * LD;       // [BW_BQ][LD]
  float* ps = dos + BW_BQ * LD;       // [BW_BQ][BW_LDP]
  float* dss = ps + BW_BQ * BW_LDP;   // [BW_BQ][BW_LDP]
  float* lse_s = dss + BW_BQ * BW_LDP;
  float* d_s = lse_s + BW_BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BW_BK;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KVH * HD;
  const long long kv_off = ((long long)b * Tn * KVH + n) * HD;
  stage_rows<HD>(ks, k + kv_off, kv_stride, k0, Tn, tid);
  stage_rows<HD>(vs, v + kv_off, kv_stride, k0, Tn, tid);

  float dka[4][4 * NV], dva[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) dka[i][e] = dva[i][e] = 0.f;

  // the query rows that may see any of these keys
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  const int r_hi =
      window > 0 ? min(S - 1, k0 + BW_BK - 1 + window - 1 - q_offset) : S - 1;

  for (int g = 0; g < G; ++g) {
    const int h = n * G + g;
    const long long q_off = ((long long)b * S * H + h) * HD;
    const float* lse_h = lse + ((long long)b * H + h) * S;
    const float* delta_h = delta + ((long long)b * H + h) * S;
    for (int q0 = r_lo / BW_BQ * BW_BQ; q0 <= r_hi; q0 += BW_BQ) {
      __syncthreads();  // K/V staged; the last tile's P, dS, Q, dO consumed
      stage_rows<HD>(qs, q + q_off, q_stride, q0, S, tid);
      stage_rows<HD>(dos, dout + q_off, q_stride, q0, S, tid);
      if (tid < BW_BQ) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        d_s[tid] = in ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<HD>(qs, ks, dos, vs, ty, tx, s, dp);
      softmax_grad(s, dp, lse_s, d_s, q0, k0, ty, tx, S, Tn, causal, window,
                   q_offset, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(4 * ty + i) * BW_LDP + tx + 16 * j] = s[i][j];
          dss[(4 * ty + i) * BW_LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV[key] += Σ_r P[r][key] dO[r], dK[key] += Σ_r dS[r][key] Q[r]
      // for keys 4ty + i and columns 4tx + 64j'
#pragma unroll 2
      for (int r = 0; r < BW_BQ; ++r) {
        const float4 pr = ld4(ps + r * BW_LDP + 4 * ty);
        const float4 dr = ld4(dss + r * BW_LDP + 4 * ty);
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const float4 o = ld4(dos + r * LD + 4 * tx + 64 * jj);
          const float4 x = ld4(qs + r * LD + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = comp(pr, i), dv_ = comp(dr, i);
            dva[i][4 * jj + 0] = fmaf(pv, o.x, dva[i][4 * jj + 0]);
            dva[i][4 * jj + 1] = fmaf(pv, o.y, dva[i][4 * jj + 1]);
            dva[i][4 * jj + 2] = fmaf(pv, o.z, dva[i][4 * jj + 2]);
            dva[i][4 * jj + 3] = fmaf(pv, o.w, dva[i][4 * jj + 3]);
            dka[i][4 * jj + 0] = fmaf(dv_, x.x, dka[i][4 * jj + 0]);
            dka[i][4 * jj + 1] = fmaf(dv_, x.y, dka[i][4 * jj + 1]);
            dka[i][4 * jj + 2] = fmaf(dv_, x.z, dka[i][4 * jj + 2]);
            dka[i][4 * jj + 3] = fmaf(dv_, x.w, dka[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Tn) continue;
    const long long off = kv_off + (long long)key * kv_stride + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      st4(dk + off + 64 * jj,
          make_float4(dka[i][4 * jj] * scale, dka[i][4 * jj + 1] * scale,
                      dka[i][4 * jj + 2] * scale,
                      dka[i][4 * jj + 3] * scale));
      st4(dv + off + 64 * jj,
          make_float4(dva[i][4 * jj], dva[i][4 * jj + 1], dva[i][4 * jj + 2],
                      dva[i][4 * jj + 3]));
    }
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles; the dS tile; lse and D of the query tile
  return 4 * 64 * (HD + 4) + BW_BQ * BW_LDP + 2 * BW_BQ;
}

template <int HD>
__global__ void __launch_bounds__(BW_THREADS) attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, int Tn, int H, int KVH, int causal,
    int window, int q_offset, float scale) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  constexpr int LD = HD + 4;
  constexpr int NV = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BW_BQ][LD]
  float* dos = qs + BW_BQ * LD;       // [BW_BQ][LD]
  float* ks = dos + BW_BQ * LD;       // [BW_BK][LD]
  float* vs = ks + BW_BK * LD;        // [BW_BK][LD]
  float* dss = vs + BW_BK * LD;       // [BW_BQ][BW_LDP]
  float* lse_s = dss + BW_BQ * BW_LDP;
  float* d_s = lse_s + BW_BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BW_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / (H / KVH);

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KVH * HD;
  const long long q_off = ((long long)b * S * H + h) * HD;
  const long long kv_off = ((long long)b * Tn * KVH + n) * HD;
  stage_rows<HD>(qs, q + q_off, q_stride, q0, S, tid);
  stage_rows<HD>(dos, dout + q_off, q_stride, q0, S, tid);
  if (tid < BW_BQ) {
    const bool in = q0 + tid < S;
    const long long row = ((long long)b * H + h) * S + q0 + tid;
    lse_s[tid] = in ? lse[row] : 0.f;
    d_s[tid] = in ? delta[row] : 0.f;
  }

  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) acc[i][e] = 0.f;

  // the keys any row of this tile may see (the forward's walk)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + BW_BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tn, q_hi + 1) : Tn;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int k0 = k_begin / BW_BK * BW_BK; k0 < k_end; k0 += BW_BK) {
    __syncthreads();  // Q, dO staged; the last tile's K and dS consumed
    stage_rows<HD>(ks, k + kv_off, kv_stride, k0, Tn, tid);
    stage_rows<HD>(vs, v + kv_off, kv_stride, k0, Tn, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<HD>(qs, ks, dos, vs, ty, tx, s, dp);
    softmax_grad(s, dp, lse_s, d_s, q0, k0, ty, tx, S, Tn, causal, window,
                 q_offset, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(4 * ty + i) * BW_LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[row] += Σ_key dS[row][key] K[key] for rows 4ty + i and columns
    // 4tx + 64j'
#pragma unroll 2
    for (int c = 0; c < BW_BK; c += 4) {
      float4 dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dr[i] = ld4(dss + (4 * ty + i) * BW_LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 kk[NV];
#pragma unroll
        for (int jj = 0; jj < NV; ++jj)
          kk[jj] = ld4(ks + (c + cc) * LD + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = comp(dr[i], cc);
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            acc[i][4 * jj + 0] = fmaf(w, kk[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(w, kk[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(w, kk[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(w, kk[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const long long off = q_off + (long long)row * q_stride + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
      st4(dq + off + 64 * jj,
          make_float4(acc[i][4 * jj] * scale, acc[i][4 * jj + 1] * scale,
                      acc[i][4 * jj + 2] * scale,
                      acc[i][4 * jj + 3] * scale));
  }
}

// ---------------------------------------- bf16 backward on the tensor cores

// Tile shapes of the bf16 backward (timed on the H100 with
// tools/kernel_variants.py attention_bwd; PERF.md).  dK/dV: WARPS warps of
// 16·MT keys, query tiles of BQ rows through a STAGES-deep ring, K and V's
// A fragments in registers (KREG) or reloaded each k16 step.
template <int HD>
struct DkdvShape {
  static constexpr int MT = 1;  // m16 key tiles a warp
  static constexpr int WARPS = 4;
  static constexpr int BQ = 64;
  static constexpr int STAGES = 2;
  static constexpr bool KREG = HD == 64;
  static constexpr int MINB = 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = 16 * MT * WARPS;  // keys a CTA
};

// dQ: WARPS warps of 16·MT query rows, 64-key tiles (TC_BK) through a
// STAGES-deep ring, Q and dO's A fragments in registers (QREG) or
// reloaded each k16 step.
template <int HD>
struct DqShape {
  static constexpr int MT = 1;  // m16 row tiles a warp
  static constexpr int WARPS = 4;
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr bool QREG = HD == 64;
  static constexpr int MINB = 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;  // query rows a CTA
};

template <int HD>
constexpr int dkdv_tc_smem_bytes() {
  // K and V of the CTA, the Q and dO ring (rows padded by 8 bf16), and
  // the ring's lse·log2 e and D
  using C = DkdvShape<HD>;
  return (2 * C::BK + 2 * C::STAGES * C::BQ) * (HD + 8) * (int)sizeof(bf16) +
         2 * C::STAGES * C::BQ * (int)sizeof(float);
}

template <int HD>
constexpr int dq_tc_smem_bytes() {
  // Q and dO of the CTA, then the K and V rings
  using C = DqShape<HD>;
  return (2 * C::BQ + 2 * C::STAGES * TC_BK) * (HD + 8) * (int)sizeof(bf16);
}

// lse in the units of ex2, +inf for a row past S or with no valid key, so
// that p = 2^(s·c − lse) = 0 there
__device__ __forceinline__ float lse_log2(const float* lse, long long row,
                                          bool in) {
  const float l = in ? lse[row] : INFINITY;
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// Fragment layouts as in flash_attention_tc_kernel.  Keys are the M
// dimension: a thread holds keys g and g + 8 of each of the warp's m16
// tiles and query columns 2t, 2t + 1 of each n8 tile of Sᵀ and dPᵀ.
template <int HD>
__global__ void __launch_bounds__(DkdvShape<HD>::THREADS,
                                  DkdvShape<HD>::MINB)
    attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int S, int Tn, int H, int KVH, int causal,
                            int window, int q_offset, float scale) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  using C = DkdvShape<HD>;
  constexpr int MT = C::MT, NTHR = C::THREADS, BK = C::BK, BQ = C::BQ;
  constexpr int ST = C::STAGES;
  constexpr int LD = HD + 8;   // padded row stride, in bf16
  constexpr int KT = HD / 16;  // k16 steps of K·Qᵀ
  constexpr int NT = HD / 8;   // n8 tiles of dK and dV
  constexpr int NQ = BQ / 8;   // n8 tiles (queries) of Sᵀ and dPᵀ
  constexpr int CH = HD / 8;   // 16-byte chunks of a row
  constexpr int WK = 16 * MT;  // keys a warp
  static_assert(ST >= 2 && BQ % 16 == 0 && BQ <= NTHR &&
                    (BQ * CH) % NTHR == 0 && (BK * CH) % NTHR == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bw_smem);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* qs = vs + BK * LD;                       // [ST][BQ][LD]
  bf16* dos = qs + ST * BQ * LD;                 // [ST][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + ST * BQ * LD);  // [ST][BQ]
  float* dl = ls + ST * BQ;                                  // [ST][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const float scale_log2 = scale * LOG2E;

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KVH * HD;
  const long long kv_off = ((long long)b * Tn * KVH + n) * HD;

  // the query rows that may see any of these keys, in tiles of BQ, for
  // each of the G heads
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  const int r_hi =
      window > 0 ? min(S - 1, k0 + BK - 1 + window - 1 - q_offset) : S - 1;
  const int q_first = r_lo / BQ * BQ;
  const int nq = r_hi >= r_lo ? (r_hi - q_first) / BQ + 1 : 0;
  const int ntiles = G * nq;

  auto load_tile = [&](int it) {
    const int h = n * G + it / nq;
    const int q0 = q_first + (it % nq) * BQ;
    const int st = it % ST;
    const long long q_off = ((long long)b * S * H + h) * HD;
    bf16* qd = qs + st * BQ * LD;
    bf16* dd = dos + st * BQ * LD;
#pragma unroll
    for (int j = 0; j < BQ * CH / NTHR; ++j) {
      const int i = tid + j * NTHR;
      const int r = i / CH, c = i % CH;
      const bool ok = q0 + r < S;
      const long long off =
          q_off + (long long)(ok ? q0 + r : 0) * q_stride + 8 * c;
      cp_async16(smem_addr(qd + r * LD + 8 * c), q + off, ok);
      cp_async16(smem_addr(dd + r * LD + 8 * c), dout + off, ok);
    }
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      const long long row = ((long long)b * H + h) * S + q0 + tid;
      ls[st * BQ + tid] = lse_log2(lse, row, in);
      dl[st * BQ + tid] = in ? delta[row] : 0.f;
    }
  };

  // group 0: K, V and query tile 0; then tiles 1 … ST − 2
#pragma unroll
  for (int j = 0; j < BK * CH / NTHR; ++j) {
    const int i = tid + j * NTHR;
    const int r = i / CH, c = i % CH;
    const bool ok = k0 + r < Tn;
    const long long off =
        kv_off + (long long)(ok ? k0 + r : 0) * kv_stride + 8 * c;
    cp_async16(smem_addr(ks + r * LD + 8 * c), k + off, ok);
    cp_async16(smem_addr(vs + r * LD + 8 * c), v + off, ok);
  }
  if (ntiles > 0) load_tile(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < ST - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  float dka[MT][NT][4] = {}, dva[MT][NT][4] = {};
  uint32_t kf[MT][KT][4], vf[MT][KT][4];  // K's and V's A fragments (KREG)
  // this warp's keys: rows WK·warp … of ks and vs
  const int wk = k0 + WK * warp;
  auto a_frag = [&](uint32_t (&r)[4], const bf16* base, int mt, int kk) {
    ldsm_x4(r, smem_addr(base + (WK * warp + 16 * mt + (lane & 15)) * LD +
                         16 * kk + 8 * (lane >> 4)));
  };

  // The ring runs ST − 1 tiles ahead of the one computed; one barrier a
  // tile guards it.
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<ST - 2>();
    // tile it landed for every thread; every warp is done with tile it −
    // 1, whose stage tile it + ST − 1 takes
    __syncthreads();
    if (it + ST - 1 < ntiles) load_tile(it + ST - 1);
    cp_async_commit();
    if constexpr (C::KREG) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            a_frag(kf[mt][kk], ks, mt, kk);
            a_frag(vf[mt][kk], vs, mt, kk);
          }
      }
    }
    const int q0 = q_first + (it % nq) * BQ;
    const int st = it % ST;
    const int qp_lo = q0 + q_offset;
    const int qp_hi = min(q0 + BQ, S) - 1 + q_offset;
    // a tile none of the warp's keys can see adds nothing
    if (wk >= Tn || (causal && wk > qp_hi) ||
        (window > 0 && wk + WK - 1 <= qp_lo - window))
      continue;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: WK keys × BQ queries
    const bf16* qt = qs + st * BQ * LD;
    const bf16* dt = dos + st * BQ * LD;
    float sc[MT][NQ][4] = {}, dp[MT][NQ][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ka[MT][4], va[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::KREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[mt][e] = kf[mt][kk][e];
            va[mt][e] = vf[mt][kk][e];
          }
        } else {
          a_frag(ka[mt], ks, mt, kk);
          a_frag(va[mt], vs, mt, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        // queries 16·np + 0..7 and + 8..15, hd 16·kk + 0..15
        const int off = (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                        16 * kk + 8 * ((lane >> 3) & 1);
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, smem_addr(qt + off));
        ldsm_x4(bd, smem_addr(dt + off));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * np], ka[mt], bq[0], bq[1]);
          mma_bf16(sc[mt][2 * np + 1], ka[mt], bq[2], bq[3]);
          mma_bf16(dp[mt][2 * np], va[mt], bd[0], bd[1]);
          mma_bf16(dp[mt][2 * np + 1], va[mt], bd[2], bd[3]);
        }
      }
    }

    // Pᵀ = 2^(sᵀ·c − lse·log2 e) and dSᵀ = Pᵀ ∘ (dPᵀ − D), per query
    // column; masked pairs give p = 0
    const bool edge = wk + WK > Tn || (causal && wk + WK - 1 > qp_lo) ||
                      (window > 0 && wk <= qp_hi - window);
    const float* lt = ls + st * BQ;
    const float* dlt = dl + st * BQ;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * tq);
      const float2 d2 =
          *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * tq);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[mt][j][e], scale_log2, e & 1 ? -l2.y : -l2.x));
          if (edge) {
            const int key = wk + 16 * mt + 8 * (e >> 1) + g;
            const int qp = qp_lo + 8 * j + 2 * tq + (e & 1);
            if (!(key < Tn && (!causal || key <= qp) &&
                  (window <= 0 || key > qp - window)))
              p = 0.f;
          }
          sc[mt][j][e] = p;
          dp[mt][j][e] = p * (dp[mt][j][e] - (e & 1 ? d2.y : d2.x));
        }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: the accumulator fragments are the A
    // fragments, each as a bf16 hi + lo pair; dO and Q are the B operands
    // through ldmatrix.trans, each fragment feeding both halves
#pragma unroll
    for (int kc = 0; kc < NQ / 2; ++kc) {
      uint32_t ph[MT][4], pl[MT][4], sh[MT][4], sl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a0 … a3: tile 2kc rows g, g + 8, then tile 2kc + 1
          const float* x = sc[mt][2 * kc + (i >> 1)] + 2 * (i & 1);
          const float* y = dp[mt][2 * kc + (i >> 1)] + 2 * (i & 1);
          split_bf16(x[0], x[1], ph[mt][i], pl[mt][i]);
          split_bf16(y[0], y[1], sh[mt][i], sl[mt][i]);
        }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // queries 16·kc + 0..15, hd 16·np + 0..7 and + 8..15
        const int off = (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                        16 * np + 8 * (lane >> 4);
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, smem_addr(dt + off));
        ldsm_x4_trans(bq, smem_addr(qt + off));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(dva[mt][2 * np], ph[mt], bo[0], bo[1]);
          mma_bf16(dva[mt][2 * np + 1], ph[mt], bo[2], bo[3]);
          mma_bf16(dka[mt][2 * np], sh[mt], bq[0], bq[1]);
          mma_bf16(dka[mt][2 * np + 1], sh[mt], bq[2], bq[3]);
          mma_bf16(dva[mt][2 * np], pl[mt], bo[0], bo[1]);
          mma_bf16(dva[mt][2 * np + 1], pl[mt], bo[2], bo[3]);
          mma_bf16(dka[mt][2 * np], sl[mt], bq[0], bq[1]);
          mma_bf16(dka[mt][2 * np + 1], sl[mt], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing stays in flight

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = wk + 16 * mt + 8 * r + g;
      if (key >= Tn) continue;
      const long long off = kv_off + (long long)key * kv_stride + 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(
            dka[mt][j][2 * r] * scale, dka[mt][j][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(dva[mt][j][2 * r], dva[mt][j][2 * r + 1]);
      }
    }
}

// Rows are the M dimension, as in the forward: a thread holds rows g and
// g + 8 of each of the warp's m16 tiles, rr = 2·mt + (0 or 1).
template <int HD>
__global__ void __launch_bounds__(DqShape<HD>::THREADS, DqShape<HD>::MINB)
    attn_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int Tn, int H,
                          int KVH, int causal, int window, int q_offset,
                          float scale) {
  static_assert(HD % 64 == 0 && HD <= 128, "head_dim 64 or 128");
  using C = DqShape<HD>;
  constexpr int MT = C::MT, NTHR = C::THREADS, BQ = C::BQ, BK = TC_BK;
  constexpr int ST = C::STAGES;
  constexpr int NK = BK / 8;    // n8 tiles (keys) of S and dP
  constexpr int LD = HD + 8;    // padded row stride, in bf16
  constexpr int KT = HD / 16;   // k16 steps of Q·Kᵀ
  constexpr int NT = HD / 8;    // n8 tiles of dQ
  constexpr int CH = HD / 8;    // 16-byte chunks of a row
  constexpr int WR = 16 * MT;   // query rows a warp
  constexpr int RR = 2 * MT;    // rows a thread
  static_assert(ST >= 2 && (BQ * CH) % NTHR == 0 && (BK * CH) % NTHR == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bw_smem);  // [BQ][LD]
  bf16* dos = qs + BQ * LD;                      // [BQ][LD]
  bf16* ks = dos + BQ * LD;                      // [ST][BK][LD]
  bf16* vs = ks + ST * BK * LD;                  // [ST][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / (H / KVH);
  const float scale_log2 = scale * LOG2E;

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KVH * HD;
  const long long q_off = ((long long)b * S * H + h) * HD;
  const bf16* kb = k + ((long long)b * Tn * KVH + n) * HD;
  const bf16* vb = v + ((long long)b * Tn * KVH + n) * HD;

  // the keys any row of this tile may see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tn, q_hi + 1) : Tn;
  const int k_first = (window > 0 ? max(0, q_lo - window + 1) : 0) / BK * BK;
  const int ntiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const int kt0 = k_first + tile * BK;
    bf16* kd = ks + (tile % ST) * BK * LD;
    bf16* vd = vs + (tile % ST) * BK * LD;
#pragma unroll
    for (int j = 0; j < BK * CH / NTHR; ++j) {
      const int i = tid + j * NTHR;
      const int r = i / CH, c = i % CH;
      const bool ok = kt0 + r < Tn;
      const long long off = (long long)(ok ? kt0 + r : 0) * kv_stride + 8 * c;
      cp_async16(smem_addr(kd + r * LD + 8 * c), kb + off, ok);
      cp_async16(smem_addr(vd + r * LD + 8 * c), vb + off, ok);
    }
  };

  // group 0: Q, dO and key tile 0; then tiles 1 … ST − 2
#pragma unroll
  for (int j = 0; j < BQ * CH / NTHR; ++j) {
    const int i = tid + j * NTHR;
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < S;
    const long long off =
        q_off + (long long)(ok ? q0 + r : 0) * q_stride + 8 * c;
    cp_async16(smem_addr(qs + r * LD + 8 * c), q + off, ok);
    cp_async16(smem_addr(dos + r * LD + 8 * c), dout + off, ok);
  }
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < ST - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // this warp's rows, and the thread's rows' lse (ex2 units) and D
  const int wrow = q0 + WR * warp;
  const int wpos_lo = wrow + q_offset, wpos_hi = wpos_lo + WR - 1;
  float l2[RR], d2[RR];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int row = wrow + 8 * rr + g;  // rr = 2·mt + r: row 16·mt + 8·r
    const long long at = ((long long)b * H + h) * S + row;
    l2[rr] = lse_log2(lse, at, row < S);
    d2[rr] = row < S ? delta[at] : 0.f;
  }

  float dqa[MT][NT][4] = {};
  uint32_t qf[MT][KT][4], of[MT][KT][4];  // Q's and dO's A fragments (QREG)
  auto a_frag = [&](uint32_t (&r)[4], const bf16* base, int mt, int kk) {
    ldsm_x4(r, smem_addr(base + (WR * warp + 16 * mt + (lane & 15)) * LD +
                         16 * kk + 8 * (lane >> 4)));
  };

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<ST - 2>();
    // tile it landed for every thread; every warp is done with tile it −
    // 1, whose stage tile it + ST − 1 takes
    __syncthreads();
    if (it + ST - 1 < ntiles) load_kv(it + ST - 1);
    cp_async_commit();
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            a_frag(qf[mt][kk], qs, mt, kk);
            a_frag(of[mt][kk], dos, mt, kk);
          }
      }
    }
    const int k0 = k_first + it * BK;
    // a tile none of the warp's rows can see adds nothing
    if (wrow >= S || (causal && k0 > wpos_hi) ||
        (window > 0 && k0 + BK - 1 <= wpos_lo - window))
      continue;

    // S = Q·Kᵀ and dP = dO·Vᵀ: WR rows × BK keys
    const bf16* kt = ks + (it % ST) * BK * LD;
    const bf16* vt = vs + (it % ST) * BK * LD;
    float sc[MT][NK][4] = {}, dp[MT][NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[MT][4], oa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[mt][e] = qf[mt][kk][e];
            oa[mt][e] = of[mt][kk][e];
          }
        } else {
          a_frag(qa[mt], qs, mt, kk);
          a_frag(oa[mt], dos, mt, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        // keys 16·np + 0..7 and + 8..15, hd 16·kk + 0..15
        const int off = (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                        16 * kk + 8 * ((lane >> 3) & 1);
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, smem_addr(kt + off));
        ldsm_x4(bv, smem_addr(vt + off));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * np], qa[mt], bk[0], bk[1]);
          mma_bf16(sc[mt][2 * np + 1], qa[mt], bk[2], bk[3]);
          mma_bf16(dp[mt][2 * np], oa[mt], bv[0], bv[1]);
          mma_bf16(dp[mt][2 * np + 1], oa[mt], bv[2], bv[3]);
        }
      }
    }

    // dS = P ∘ (dP − D), P = 2^(s·c − lse·log2 e) per row; masked pairs
    // give p = 0
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > wpos_lo) ||
                      (window > 0 && k0 <= wpos_hi - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 2 * mt + (e >> 1);
          float p = ex2(fmaf(sc[mt][j][e], scale_log2, -l2[rr]));
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = wpos_lo + 16 * mt + 8 * (e >> 1) + g;
            if (!(kpos < Tn && (!causal || kpos <= qp) &&
                  (window <= 0 || kpos > qp - window)))
              p = 0.f;
          }
          sc[mt][j][e] = p * (dp[mt][j][e] - d2[rr]);
        }

    // dQ += dS·K: dS's accumulator fragments are the A fragments, as a
    // bf16 hi + lo pair; K is the B operand through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < NK / 2; ++kc) {
      uint32_t sh[MT][4], sl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* x = sc[mt][2 * kc + (i >> 1)] + 2 * (i & 1);
          split_bf16(x[0], x[1], sh[mt][i], sl[mt][i]);
        }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys 16·kc + 0..15, hd 16·np + 0..7 and + 8..15
        uint32_t bk[4];
        ldsm_x4_trans(bk, smem_addr(kt + (16 * kc + (lane & 7) +
                                          8 * ((lane >> 3) & 1)) * LD +
                                    16 * np + 8 * (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(dqa[mt][2 * np], sh[mt], bk[0], bk[1]);
          mma_bf16(dqa[mt][2 * np + 1], sh[mt], bk[2], bk[3]);
          mma_bf16(dqa[mt][2 * np], sl[mt], bk[0], bk[1]);
          mma_bf16(dqa[mt][2 * np + 1], sl[mt], bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing stays in flight

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 16 * mt + 8 * r + g;
      if (row >= S) continue;
      bf16* drow = dq + q_off + (long long)row * q_stride + 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j) = pack_bf16(
            dqa[mt][j][2 * r] * scale, dqa[mt][j][2 * r + 1] * scale);
    }
}

// ------------------------------------------------------------- launches

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int s, int t, int h, int kvh, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  // above the 48 KB default: raise the limit (per device, so every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s + FA_BQ - 1) / FA_BQ), (unsigned)h,
                  (unsigned)b);
  flash_attention_kernel<HD><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s, t, h,
      kvh, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* out_lo, float* lse, int b, int s, int t, int h, int kvh,
                int causal, int window, int q_offset, float scale,
                cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int bq = TcShape<HD>::BQ, threads = TcShape<HD>::THREADS;
  const dim3 grid((unsigned)((s + bq - 1) / bq), (unsigned)h, (unsigned)b);
  flash_attention_tc_kernel<HD><<<grid, threads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<bf16*>(out_lo), lse, s, t, h, kvh, causal, window,
      q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

// the three backward kernels in order on one stream: bf16 on the tensor
// cores, fp32 on FFMA
template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* out_lo, const void* dout, const float* lse,
               float* delta, void* dq,
               void* dk, void* dv, int b, int s, int t, int h, int kvh,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)b * s * h;
  cudaError_t err;
  if (rows > 0) {
    constexpr long long per_row = HD * (long long)sizeof(T) / 16;
    attn_bwd_preprocess_kernel<T, HD>
        <<<(unsigned)((rows * per_row + BW_THREADS - 1) / BW_THREADS),
           BW_THREADS, 0, stream>>>(static_cast<const T*>(out),
                                    static_cast<const T*>(out_lo), dot,
                                    delta, s, h, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (t > 0) {  // with s = 0 this writes dk = dv = 0
    constexpr int bk = tc ? DkdvShape<HD>::BK : BW_BK;
    const dim3 grid((unsigned)((t + bk - 1) / bk), (unsigned)kvh,
                    (unsigned)b);
    if constexpr (tc) {
      constexpr int bytes = dkdv_tc_smem_bytes<HD>();
      err = cudaFuncSetAttribute(attn_bwd_dkdv_tc_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return (int)err;
      attn_bwd_dkdv_tc_kernel<HD>
          <<<grid, DkdvShape<HD>::THREADS, bytes, stream>>>(
              qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
              static_cast<T*>(dv), s, t, h, kvh, causal, window, q_offset,
              scale);
    } else {
      constexpr int bytes = dkdv_smem_floats<HD>() * (int)sizeof(float);
      err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return (int)err;
      attn_bwd_dkdv_kernel<HD><<<grid, BW_THREADS, bytes, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), s, t, h, kvh, causal, window, q_offset, scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (s == 0) return 0;
  constexpr int bq = tc ? DqShape<HD>::BQ : BW_BQ;
  const dim3 grid((unsigned)((s + bq - 1) / bq), (unsigned)h, (unsigned)b);
  if constexpr (tc) {
    constexpr int bytes = dq_tc_smem_bytes<HD>();
    err = cudaFuncSetAttribute(attn_bwd_dq_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dq_tc_kernel<HD><<<grid, DqShape<HD>::THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s, t, h, kvh,
        causal, window, q_offset, scale);
  } else {
    constexpr int bytes = dq_smem_floats<HD>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dq_kernel<HD><<<grid, BW_THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s, t, h, kvh,
        causal, window, q_offset, scale);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int s, int t, int h, int kvh) {
  return b < 0 || s < 0 || t < 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
         h > 65535 || b > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FFMA kernel), 1 = bfloat16 (the tensor-core
// kernel), q, k, v and out alike; window <= 0 means no window.  lse, when
// not null, receives each row's log-sum-exp (fp32, (B, H, S)), which the
// backward needs; serving passes null.  out_lo (bf16 only; null for
// fp32), when not null, receives what rounding O to bf16 dropped, O − out
// rounded to bf16, so the backward's D = rowsum(dO ∘ O) sees O to ~2^-17.
int jk_flash_attention(const void* q, const void* k, const void* v,
                       void* out, void* out_lo, void* lse, int b, int s,
                       int t, int h, int kvh, int hd, int causal, int window,
                       int q_offset, float scale, int dtype, void* stream) {
  if (bad_shape(b, s, t, h, kvh) || (dtype == 0 && out_lo != nullptr))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && hd == 64)
    return launch_fp32<64>(q, k, v, out, l, b, s, t, h, kvh, causal, window,
                           q_offset, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_fp32<128>(q, k, v, out, l, b, s, t, h, kvh, causal,
                            window, q_offset, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, out, out_lo, l, b, s, t, h, kvh, causal,
                           window, q_offset, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, out, out_lo, l, b, s, t, h, kvh,
                            causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The gradients of jk_flash_attention given dout (the output's gradient)
// and the forward's out, out_lo (bf16: required; fp32: null) and lse: dq
// like q, dk and dv
// like k, all in the operands' dtype (0 = float32: the FFMA kernels, 1 =
// bfloat16: the tensor-core kernels); delta is fp32 (B, H, S) scratch.
// Three launches on the caller's stream.
int jk_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* out, const void* out_lo,
                           const void* dout, const void* lse, void* delta,
                           void* dq, void* dk, void* dv, int b, int s, int t,
                           int h, int kvh, int hd, int causal, int window,
                           int q_offset, float scale, int dtype,
                           void* stream) {
  if (bad_shape(b, s, t, h, kvh) || ((dtype == 0) != (out_lo == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
#define JK_BWD(T, HD)                                                        \
  return launch_bwd<T, HD>(q, k, v, out, out_lo, dout, l, d, dq, dk, dv, b, \
                           s, t, h, kvh, causal, window, q_offset, scale, st)
  if (dtype == 0 && hd == 64) JK_BWD(float, 64);
  if (dtype == 0 && hd == 128) JK_BWD(float, 128);
  if (dtype == 1 && hd == 64) JK_BWD(bf16, 64);
  if (dtype == 1 && hd == 128) JK_BWD(bf16, 128);
#undef JK_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

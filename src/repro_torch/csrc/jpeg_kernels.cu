// Hand-written Hopper (sm_90a) kernels of the JPEG-domain ResNet, fp32.
//
// Two device kernels cover the three TPU kernels of the serving path:
//
// * banded_conv_kernel — an implicit GEMM over the tile-packed layout,
//       out[r, :] = Σ_o x[gather_o(r), :] @ Ξ[o] (+ shift) (+ residual) (→ ASM)
//   It replaces kernels/jpeg_conv.py:jpeg_conv_pallas (no epilogue) and,
//   launched two or three times, kernels/fused_block.py:fused_block_pallas.
//   The gather reads block (s·i + oy + d_min, s·j + ox + d_min) of x straight
//   from device memory and reads zero outside the block grid, so no padded
//   copy exists.  Per-channel widths are fitted by index arithmetic: the
//   input is read at w_in lanes out of w_x stored, Ξ's w_b output lanes are
//   written at w_o lanes per channel, the residual is read at w_r lanes.
//   K is walked offset-major, then Cin·w, the order kernels/tiling.py packs.
//
//   Bound: at the shapes of the serving path the products are large, e.g.
//   (4·1024, 9216) @ (9216, 1024) for stage 0 at 16 bands and batch 4: some
//   1,400 FLOP per byte that must move, far above the card's fp32 ridge of
//   ~20 FLOP/B, so the fp32 FFMA rate bounds it (no TF32, to match the
//   float32 reference).  The design keeps the FFMA pipes fed:
//   - 128×128 output tiles (a 64-row variant, chosen by the wrapper, where
//     the 128-row grid would leave most SMs idle); 256 threads, each with an
//     8×8 (4×8) register block read as float4 from shared memory: 4 shared
//     loads per 64 FFMA;
//   - K in slices of 32, double-buffered in shared memory by cp.async (A's
//     rows padded to 36 floats, so the float4 reads of two rows fall in
//     distinct banks): slice k+1 is in flight while slice k is computed,
//     with one barrier a slice and no staging registers;
//   - each thread carries its slice's (offset, channel, lane) and element
//     offset forward from the previous slice: an add a slice and no
//     division in the loop; each row's block offset and B's column pointer
//     are computed once;
//   - where every lane width is a multiple of 4 floats (the fused blocks'
//     widths are multiples of 8), each thread moves 16-byte chunks of A and
//     B; otherwise (odd widths) 4-byte ones.  Out-of-grid blocks, lanes past
//     w_x, columns past w_b and the K tail are zero-filled by cp.async's
//     src-size-0 form.
//   wgmma, TMA and TF32/bf16 modes are later work.
//
// * asm_kernel — ASM ReLU (paper §4.2) per row of w lanes:
//       both = t @ cat (w×128); masked = both[:64] > 0 ? both[64:] : 0;
//       out = masked @ recon_t (64×w)
//   with cat and recon_t in shared memory.  It replaces
//   kernels/asm_relu.py:asm_relu_pallas.  The same device function
//   (asm_row) is banded_conv_kernel's ASM epilogue, applied to a tile whose
//   columns cover whole channels.  Bound: 192 FFMA per element moved, i.e.
//   operations, not bytes, at every w of the path.
//
// Every launch goes on the caller's stream; the host functions return
// cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // output columns per tile (upper bound)
constexpr int BK = 32;             // K slice staged per step
constexpr int LDA = BK + 4;        // A's row stride: conflict-free float4 reads
constexpr int STAGES = 2;          // cp.async ring depth
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NF = 64;             // pixels per 8×8 block
constexpr int MAX_W = 64;

// shared memory of one CTA, in floats: the GEMM ring, and the ASM
// epilogue's output tile (BM × BN), cat, recon_t and per-warp scratch
__host__ __device__ constexpr int gemm_floats(int bm) {
  return STAGES * (bm * LDA + BK * BN);
}
__host__ __device__ constexpr int asm_floats(int bm, int w) {
  return bm * BN + w * 2 * NF + NF * w + WARPS * NF;
}

struct ConvArgs {
  const float* x;      // (n, bh, bw, cin·w_x)
  const float* xi;     // (ndy·ndx·cin·w_in, cout·w_b)
  const float* shift;  // (cout·w_b) or null
  const float* res;    // (n, bh_o, bw_o, cout·w_r) or null
  const float* cat;    // (w_o, 128) or null: no ASM epilogue
  const float* rt;     // (64, w_o)
  float* out;          // (n, bh_o, bw_o, cout·w_o)
  int n, bh, bw, cin, w_x, w_in, stride, ndy, ndx, dmin_y, dmin_x;
  int cout, w_b, w_r, w_o, bh_o, bw_o;
  int wv;              // lanes per channel inside a tile
  int cpt;             // channels per tile
  long long m_rows, k_total;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4 or 16) global → shared; zero-filled when !valid, and the
// source is then not read
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// ASM of one w-lane vector t (in shared memory) by one warp; writes w lanes
// of out.  scratch holds 64 floats private to the warp.
__device__ __forceinline__ void asm_row(const float* t, int w, const float* cat,
                                        const float* rt, float* scratch,
                                        float* out, int lane) {
  float b0 = 0.f, b1 = 0.f, v0 = 0.f, v1 = 0.f;
  for (int l = 0; l < w; ++l) {
    const float tv = t[l];
    const float* c = cat + l * 2 * NF;
    b0 = fmaf(tv, c[lane], b0);
    b1 = fmaf(tv, c[lane + 32], b1);
    v0 = fmaf(tv, c[NF + lane], v0);
    v1 = fmaf(tv, c[NF + lane + 32], v1);
  }
  scratch[lane] = b0 > 0.f ? v0 : 0.f;
  scratch[lane + 32] = b1 > 0.f ? v1 : 0.f;
  __syncwarp();
  for (int l = lane; l < w; l += 32) {
    float s = 0.f;
    for (int p = 0; p < NF; ++p) s = fmaf(scratch[p], rt[p * w + l], s);
    out[l] = s;
  }
  __syncwarp();
}

// Position of one K index in the packed order (offset oy·ndx + ox, input
// channel c, lane l) and its element offset into a row of blocks of x,
// carried forward slice by slice: an add a slice, the rest only where the
// slice crosses into the next channel.
struct KPos {
  int oy, ox, c, l;
  long long off;  // (oy·bw + ox)·cin·w_x + c·w_x + l
  __device__ void init(long long k, const ConvArgs& a) {
    const int kc = a.cin * a.w_in;
    const int o = (int)(k / kc);
    const int rem = (int)(k - (long long)o * kc);
    c = rem / a.w_in;
    l = rem - c * a.w_in;
    oy = o / a.ndx;
    ox = o - oy * a.ndx;
    locate(a);
  }
  __device__ __forceinline__ void locate(const ConvArgs& a) {
    off = ((long long)oy * a.bw + ox) * a.cin * a.w_x + (long long)c * a.w_x + l;
  }
  __device__ __forceinline__ void advance(const ConvArgs& a) {
    l += BK;
    off += BK;
    if (l < a.w_in) return;
    do {
      l -= a.w_in;
      if (++c == a.cin) {
        c = 0;
        if (++ox == a.ndx) {
          ox = 0;
          ++oy;
        }
      }
    } while (l >= a.w_in);
    locate(a);
  }
};

// VEC: every width a multiple of 4 and x, xi 16-byte aligned, so each
// 4-lane group of K or of the tile's columns is 16 contiguous bytes.
// The 128-row variant keeps its 64 accumulators, 32 A and 8 B values a
// thread in registers at one CTA an SM (168 registers, no spills); capped
// at two CTAs it spills.
template <int BM, bool VEC>
__global__ void __launch_bounds__(THREADS, BM == 128 ? 1 : 2)
    banded_conv_kernel(ConvArgs a) {
  constexpr int TM = BM / 16;                       // rows per thread
  constexpr int AV = VEC ? 4 : 1;                   // floats per A copy
  constexpr int A_ROWS = BM * BK / AV / THREADS;    // A copies per thread
  constexpr int A_STEP = THREADS * AV / BK;         // rows between them
  constexpr int B_COPIES = BK * BN / (VEC ? 4 : 1) / THREADS;
  constexpr int B_STEP = THREADS * (VEC ? 4 : 1) / BN;  // k rows between
  constexpr int STAGE = BM * LDA + BK * BN;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int c0 = blockIdx.y * a.cpt;
  const int tile_cols = a.cpt * a.wv;

  // A copies: K lanes ka..ka+AV-1 of the slice, rows ra + A_STEP·p; the
  // element offset of each row's block (oy = ox = 0) and its position
  const int ka = (t % (BK / AV)) * AV;
  const int ra = t / (BK / AV);
  long long rbase[A_ROWS];
  int ry[A_ROWS], rx[A_ROWS];
#pragma unroll
  for (int p = 0; p < A_ROWS; ++p) {
    const long long r = m0 + ra + A_STEP * p;
    rbase[p] = 0;
    ry[p] = -(1 << 28);  // never inside the grid
    rx[p] = 0;
    if (r < a.m_rows) {
      const int j = (int)(r % a.bw_o);
      const long long q = r / a.bw_o;
      const int i = (int)(q % a.bh_o);
      ry[p] = i * a.stride + a.dmin_y;
      rx[p] = j * a.stride + a.dmin_x;
      rbase[p] = ((q / a.bh_o) * a.bh * a.bw + (long long)ry[p] * a.bw +
                  rx[p]) * a.cin * a.w_x;
    }
  }
  // B copies: tile columns bc..bc+BV-1, k rows kb0 + B_STEP·q
  const int bc = VEC ? (t % (BN / 4)) * 4 : t % BN;
  const int kb0 = VEC ? t / (BN / 4) : t / BN;
  int bcol = -1;  // column of Ξ, or -1: zero
  if (bc < tile_cols) {
    const int ch = bc / a.wv, l = bc - ch * a.wv, co = c0 + ch;
    if (co < a.cout && l < a.w_b) bcol = co * a.w_b + l;
  }
  const long long mb = (long long)a.cout * a.w_b;
  const float* bsrc = a.xi + (long long)kb0 * mb + (bcol < 0 ? 0 : bcol);

  KPos kp;
  kp.init(ka, a);
  long long k0 = 0;  // first K index of the next slice to load
  auto load = [&](int stage) {
    float* As = smem + stage * STAGE;
    float* Bs = As + BM * LDA;
    const bool kok = k0 + ka < a.k_total && kp.l < a.w_x;
#pragma unroll
    for (int p = 0; p < A_ROWS; ++p) {
      const bool ok = kok && (unsigned)(ry[p] + kp.oy) < (unsigned)a.bh &&
                      (unsigned)(rx[p] + kp.ox) < (unsigned)a.bw;
      cp_async<AV * 4>(As + (ra + A_STEP * p) * LDA + ka,
                       ok ? a.x + rbase[p] + kp.off : a.x, ok);
    }
#pragma unroll
    for (int q = 0; q < B_COPIES; ++q) {
      const bool ok = bcol >= 0 && k0 + kb0 + B_STEP * q < a.k_total;
      cp_async<VEC ? 16 : 4>(Bs + (kb0 + B_STEP * q) * BN + bc,
                             ok ? bsrc + B_STEP * q * mb : a.xi, ok);
    }
    kp.advance(a);
    k0 += BK;
    bsrc += BK * mb;
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (int)((a.k_total + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();
    // slice s landed for every thread; every thread is done with slice
    // s - 1, whose stage the next load overwrites
    __syncthreads();
    if (s + STAGES - 1 < nk) load((s + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* As = smem + (s % STAGES) * STAGE;
    const float* Bs = As + BM * LDA;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(Bs + (kq + kk) * BN + 4 * tx);
        const float4 b1 =
            *reinterpret_cast<const float4*>(Bs + (kq + kk) * BN + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av_k = comp(av[i], kk);
          acc[i][0] = fmaf(av_k, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av_k, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av_k, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av_k, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av_k, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av_k, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av_k, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av_k, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the ASM epilogue reuses it

  const bool do_asm = a.cat != nullptr;
  float* Cs = smem;  // [BM][BN]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tc = 4 * tx + 64 * (j >> 2) + (j & 3);
      if (tc >= tile_cols) continue;
      const int ch = tc / a.wv, l = tc - ch * a.wv, co = c0 + ch;
      const bool ok = r < a.m_rows && co < a.cout;
      float v = acc[i][j];
      if (ok) {
        if (a.shift != nullptr && l < a.w_b) v += a.shift[(long long)co * a.w_b + l];
        if (a.res != nullptr && l < a.w_r) v += a.res[(r * a.cout + co) * a.w_r + l];
      }
      if (do_asm) {
        Cs[(ty + 16 * i) * BN + tc] = v;
      } else if (ok) {
        float* orow = a.out + (r * a.cout + co) * a.w_o;
        if (l < a.w_o) orow[l] = v;
        for (int z = a.wv + l; z < a.w_o; z += a.wv) orow[z] = 0.f;
      }
    }
  }
  if (!do_asm) return;

  float* cat = smem + BM * BN;
  float* rt = cat + a.w_o * 2 * NF;
  float* scratch = rt + NF * a.w_o;
  for (int e = t; e < a.w_o * 2 * NF; e += THREADS) cat[e] = a.cat[e];
  for (int e = t; e < NF * a.w_o; e += THREADS) rt[e] = a.rt[e];
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  for (int pr = warp; pr < BM * a.cpt; pr += WARPS) {
    const int rl = pr / a.cpt, ch = pr - rl * a.cpt;
    const long long r = m0 + rl;
    const int co = c0 + ch;
    if (r >= a.m_rows || co >= a.cout) continue;  // uniform across the warp
    asm_row(Cs + rl * BN + ch * a.w_o, a.w_o, cat, rt, scratch + warp * NF,
            a.out + (r * a.cout + co) * a.w_o, lane);
  }
}

__global__ void __launch_bounds__(THREADS) asm_kernel(
    const float* x, const float* catg, const float* rtg, float* out,
    long long rows, int ld_in, int w, int ld_out) {
  extern __shared__ float smem[];
  float* cat = smem;
  float* rt = cat + w * 2 * NF;
  float* tbuf = rt + NF * w;
  float* scratch = tbuf + WARPS * NF;
  for (int e = threadIdx.x; e < w * 2 * NF; e += THREADS) cat[e] = catg[e];
  for (int e = threadIdx.x; e < NF * w; e += THREADS) rt[e] = rtg[e];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tw = tbuf + warp * NF;
  for (long long r = (long long)blockIdx.x * WARPS + warp; r < rows;
       r += (long long)gridDim.x * WARPS) {
    const float* xr = x + r * ld_in;
    for (int l = lane; l < w; l += 32) tw[l] = xr[l];
    __syncwarp();
    float* orow = out + r * ld_out;
    asm_row(tw, w, cat, rt, scratch + warp * NF, orow, lane);
    for (int l = w + lane; l < ld_out; l += 32) orow[l] = 0.f;
  }
}

// Dynamic shared memory of one banded_conv CTA of bm rows, in bytes.
int conv_smem(int w_o, bool with_asm, int bm) {
  const int g = gemm_floats(bm);
  if (!with_asm) return g * 4;
  const int e = asm_floats(bm, w_o);
  return (g > e ? g : e) * 4;
}

template <int BM, bool VEC>
int launch_conv(const ConvArgs& a, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_conv_kernel<BM, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem(MAX_W, true, BM));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((unsigned)((a.m_rows + BM - 1) / BM),
                  (unsigned)((a.cout + a.cpt - 1) / a.cpt));
  banded_conv_kernel<BM, VEC><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one banded_conv CTA of bm rows (64 or 128), in
// bytes.
int jk_banded_conv_smem(int w_o, int with_asm, int bm) {
  return conv_smem(w_o, with_asm != 0, bm);
}

// bm: output rows per tile, 128 or 64 (the wrapper's choice)
int jk_banded_conv(const float* x, const float* xi, const float* shift,
                   const float* res, const float* cat, const float* rt,
                   float* out, int n, int bh, int bw, int cin, int w_x,
                   int w_in, int stride, int ndy, int ndx, int dmin_y,
                   int dmin_x, int cout, int w_b, int w_r, int w_o, int bm,
                   void* stream) {
  if (w_o < 1 || w_o > MAX_W || w_b < 1 || w_b > MAX_W || w_in < 1 ||
      (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x; a.xi = xi; a.shift = shift; a.res = res; a.cat = cat; a.rt = rt;
  a.out = out;
  a.n = n; a.bh = bh; a.bw = bw; a.cin = cin; a.w_x = w_x; a.w_in = w_in;
  a.stride = stride; a.ndy = ndy; a.ndx = ndx; a.dmin_y = dmin_y;
  a.dmin_x = dmin_x; a.cout = cout; a.w_b = w_b; a.w_r = w_r; a.w_o = w_o;
  a.bh_o = bh / stride; a.bw_o = bw / stride;
  a.wv = cat != nullptr ? w_o : w_b;
  a.cpt = BN / a.wv;
  a.m_rows = (long long)n * a.bh_o * a.bw_o;
  a.k_total = (long long)ndy * ndx * cin * w_in;
  if (a.m_rows == 0) return 0;
  const bool vec = w_in % 4 == 0 && w_x % 4 == 0 && w_b % 4 == 0 &&
                   a.wv % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)xi % 16 == 0;
  const int smem = conv_smem(w_o, cat != nullptr, bm);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bm == 128)
    return vec ? launch_conv<128, true>(a, smem, st)
               : launch_conv<128, false>(a, smem, st);
  return vec ? launch_conv<64, true>(a, smem, st)
             : launch_conv<64, false>(a, smem, st);
}

int jk_asm(const float* x, const float* cat, const float* rt, float* out,
           long long rows, int ld_in, int w, int ld_out, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        asm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (MAX_W * 2 * NF + NF * MAX_W + 2 * WARPS * NF) * 4);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (w < 1 || w > MAX_W || ld_in < w || ld_out < w) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long want = (rows + WARPS - 1) / WARPS;
  const unsigned blocks = (unsigned)(want < 2112 ? want : 2112);
  const size_t smem = (size_t)(w * 2 * NF + NF * w + 2 * WARPS * NF) * 4;
  asm_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, cat, rt, out, rows, ld_in, w, ld_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

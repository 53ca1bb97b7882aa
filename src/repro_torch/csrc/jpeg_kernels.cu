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
//   float32 reference).  The design keeps
//   that rate reachable with 64×128 output tiles staged through shared memory
//   and a 4×8 register block per thread (12 shared loads per 32 FFMA).
//   wgmma, TMA and bf16 are later work.
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

namespace {

constexpr int BM = 64;             // output rows per tile
constexpr int BN = 128;            // output columns per tile (upper bound)
constexpr int BK = 16;             // K slice staged per step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NF = 64;             // pixels per 8×8 block
constexpr int AS_LD = BM + 2;      // conflict-free transposed A stores
constexpr int CS_LD = BN + 16;     // conflict-free epilogue stores
constexpr int GEMM_FLOATS = BK * AS_LD + BK * BN;
constexpr int CS_FLOATS = BM * CS_LD;
constexpr int MAX_W = 64;
constexpr int ASM_EPI_FLOATS = CS_FLOATS + MAX_W * 2 * NF + NF * MAX_W + WARPS * NF;

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

__global__ void __launch_bounds__(THREADS) banded_conv_kernel(ConvArgs a) {
  extern __shared__ float smem[];
  float* As = smem;               // [BK][AS_LD], A transposed
  float* Bs = smem + BK * AS_LD;  // [BK][BN]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int c0 = blockIdx.y * a.cpt;
  const int tile_cols = a.cpt * a.wv;

  // A loads: k lane tx of the slice, rows ty + 16p of the tile.
  long long rbase[4];
  int ry[4], rx[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long r = m0 + ty + 16 * p;
    if (r < a.m_rows) {
      const int j = (int)(r % a.bw_o);
      const long long q = r / a.bw_o;
      const int i = (int)(q % a.bh_o);
      rbase[p] = (q / a.bh_o) * a.bh * a.bw;
      ry[p] = i * a.stride + a.dmin_y;
      rx[p] = j * a.stride + a.dmin_x;
    } else {
      rbase[p] = 0;
      ry[p] = -(1 << 28);  // never inside the grid
      rx[p] = 0;
    }
  }
  // B loads: column btc of the tile, k rows (t >> 7) + 2q of the slice.
  const int btc = t & (BN - 1);
  long long bcol = -1;
  if (btc < tile_cols) {
    const int ch = btc / a.wv, l = btc - ch * a.wv, co = c0 + ch;
    if (co < a.cout && l < a.w_b) bcol = (long long)co * a.w_b + l;
  }
  const long long mb = (long long)a.cout * a.w_b;
  const long long kx = (long long)a.cin * a.w_x;
  const int kc = a.cin * a.w_in;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < a.k_total; k0 += BK) {
    const long long k = k0 + tx;
    int oy = 0, ox = 0;
    long long coff = 0;
    bool lok = false;
    if (k < a.k_total) {
      const int o = (int)(k / kc);
      const int rem = (int)(k - (long long)o * kc);
      const int c = rem / a.w_in, l = rem - c * a.w_in;
      oy = o / a.ndx;
      ox = o - oy * a.ndx;
      lok = l < a.w_x;
      coff = (long long)c * a.w_x + l;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int y = ry[p] + oy, xx = rx[p] + ox;
      float v = 0.f;
      if (lok && y >= 0 && y < a.bh && xx >= 0 && xx < a.bw)
        v = a.x[(rbase[p] + (long long)y * a.bw + xx) * kx + coff];
      As[tx * AS_LD + ty + 16 * p] = v;
    }
#pragma unroll
    for (int q = 0; q < BK / 2; ++q) {
      const int kk = (t >> 7) + 2 * q;
      const long long kb = k0 + kk;
      float v = 0.f;
      if (bcol >= 0 && kb < a.k_total) v = a.xi[kb * mb + bcol];
      Bs[kk * BN + btc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * AS_LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool do_asm = a.cat != nullptr;
  float* Cs = smem;  // the GEMM staging is free after the last barrier
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tc = tx + 16 * j;
      if (tc >= tile_cols) continue;
      const int ch = tc / a.wv, l = tc - ch * a.wv, co = c0 + ch;
      const bool ok = r < a.m_rows && co < a.cout;
      float v = acc[i][j];
      if (ok) {
        if (a.shift != nullptr && l < a.w_b) v += a.shift[(long long)co * a.w_b + l];
        if (a.res != nullptr && l < a.w_r) v += a.res[(r * a.cout + co) * a.w_r + l];
      }
      if (do_asm) {
        Cs[(ty + 16 * i) * CS_LD + tc] = v;
      } else if (ok) {
        float* orow = a.out + (r * a.cout + co) * a.w_o;
        if (l < a.w_o) orow[l] = v;
        for (int z = a.wv + l; z < a.w_o; z += a.wv) orow[z] = 0.f;
      }
    }
  }
  if (!do_asm) return;

  float* cat = smem + CS_FLOATS;
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
    asm_row(Cs + rl * CS_LD + ch * a.w_o, a.w_o, cat, rt, scratch + warp * NF,
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

}  // namespace

extern "C" {

// Dynamic shared memory of one banded_conv CTA, in bytes.
int jk_banded_conv_smem(int w_o, int with_asm) {
  if (!with_asm) return GEMM_FLOATS * 4;
  return (CS_FLOATS + w_o * 2 * NF + NF * w_o + WARPS * NF) * 4;
}

int jk_banded_conv(const float* x, const float* xi, const float* shift,
                   const float* res, const float* cat, const float* rt,
                   float* out, int n, int bh, int bw, int cin, int w_x,
                   int w_in, int stride, int ndy, int ndx, int dmin_y,
                   int dmin_x, int cout, int w_b, int w_r, int w_o,
                   void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ASM_EPI_FLOATS * 4);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (w_o < 1 || w_o > MAX_W || w_b < 1 || w_b > MAX_W) return (int)cudaErrorInvalidValue;
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
  const dim3 grid((unsigned)((a.m_rows + BM - 1) / BM),
                  (unsigned)((cout + a.cpt - 1) / a.cpt));
  const size_t smem = (size_t)jk_banded_conv_smem(w_o, cat != nullptr);
  banded_conv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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

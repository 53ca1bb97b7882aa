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
// * asm_kernel — ASM ReLU (paper §4.2) over a tile of rows of w lanes:
//       both = T @ cat (w×128); M = both[:64] > 0 ? both[64:] : 0;
//       out = M @ recon_t (64×w)
//   It replaces kernels/asm_relu.py:asm_relu_pallas.  One device routine,
//   asm_tile, computes it for a tile of rows in shared memory; asm_kernel
//   feeds it tiles of x, and banded_conv_kernel's ASM epilogue feeds it the
//   (row, channel) pairs of its output tile, one channel at a time.
//   Bound: 192 FFMA per lane read, i.e. operations at w = 64; at w = 16
//   bytes and operations are about even.  In practice shared memory bounds
//   it: an SM reads 128 bytes of it a clock against 128 FFMA, so the design
//   cuts the bytes each FFMA reads:
//   - product 1 is register-blocked: a thread holds R rows × 4
//     frequencies of both halves (approx f..f+3 and exact 64+f..64+f+3),
//     so the mask is applied in registers: per k, two float4 of cat and R
//     values of T for 8R FFMA (R = 8 in asm_kernel and the 128-row conv
//     tiles: 1 byte per FFMA);
//   - the masked tile goes to shared memory once; product 2 gives each
//     thread 4 output lanes of 8, 4, 2 or 1 rows, as many row groups as
//     fill 256 threads at the tile's width, so every thread works;
//   - persistent asm_kernel CTAs load cat and recon_t into shared memory
//     once (zero-padded to a multiple of 4 lanes) and walk tiles of ASM_BM
//     rows; the next tile's first w lanes are in flight by cp.async
//     (16-byte copies where w, ld_in and x allow) while this one is
//     computed; rows are padded so float4 reads of two rows fall in
//     distinct banks; where rows have zero lanes past w, a tile's output
//     rows are gathered in shared memory (the zero lanes written once) and
//     stored by one bulk copy, so the copy engine, not the threads, moves
//     them;
//   - sums run in ascending k, as the plain version's GEMMs do, so the
//     mask's sign is decided as close to it as FFMA allows.
//   TF32 and bf16 modes are later work.
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
constexpr int NF = 64;             // pixels per 8×8 block
constexpr int MAX_W = 64;
constexpr int LDC = BN + 4;        // the ASM epilogue's tile row stride
constexpr int LDM = NF + 4;        // the masked tile's row stride
constexpr int ASM_BM = 128;        // asm_kernel's rows per tile

__host__ __device__ constexpr int round4(int w) { return (w + 3) & ~3; }

// shared memory, in floats: the GEMM ring; cat and recon_t at width
// round4(w); the ASM epilogue's output tile (BM × LDC), operators and
// masked tile (BM × LDM)
__host__ __device__ constexpr int gemm_floats(int bm) {
  return STAGES * (bm * LDA + BK * BN);
}
__host__ __device__ constexpr int asm_ops_floats(int w) {
  return round4(w) * 3 * NF;
}
__host__ __device__ constexpr int asm_floats(int bm, int w) {
  return bm * LDC + asm_ops_floats(w) + bm * LDM;
}
// asm_kernel's staged tile row stride: round4(w) lanes padded so that the
// float4 reads of two rows fall in distinct banks
__host__ __device__ constexpr int asm_ldt(int w) {
  return round4(w) + ((round4(w) + 4) % 32 ? 4 : 8);
}
// asm_kernel: the operators, the masked tile, two staged tiles of x and,
// with the bulk copy, the output tile
__host__ __device__ constexpr int asm_kernel_floats(int w, bool bulk) {
  return asm_ops_floats(w) + ASM_BM * LDM + 2 * ASM_BM * asm_ldt(w) +
         (bulk ? ASM_BM * NF : 0);
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

// bytes (a multiple of 16; both ends 16-byte aligned) from shared to
// device memory by the copy engine, asynchronously: the thread's earlier
// writes to src must be made visible to it by fence_async_smem
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// until this thread's bulk stores have read their source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// cat (w × 128) and recon_t (64 × w) from device memory into shared memory
// at width round4(w): cat's rows and recon_t's columns past w are zero.
__device__ __forceinline__ void stage_asm_ops(const float* catg,
                                              const float* rtg, int w,
                                              float* cat, float* rt) {
  const int wp = round4(w);
  for (int e = threadIdx.x; e < wp * 2 * NF; e += THREADS)
    cat[e] = e < w * 2 * NF ? catg[e] : 0.f;
  for (int e = threadIdx.x; e < NF * wp; e += THREADS) {
    const int p = e / wp, l = e - p * wp;
    rt[e] = l < w ? rtg[p * w + l] : 0.f;
  }
}

// Product 2 and the stores for N rows rows[0..N-1] of the masked tile m:
// lanes l0..l0+3 (l0 = 4·cg) of o = m @ rt, those below w written (with
// VO, a float4 whose lanes from w are zero); rows from nrows on are
// skipped.
template <int N>
__device__ __forceinline__ void asm_rows(const int (&rows)[N],
                                         const float* m, const float* rt,
                                         int wp, int cg, int w, float* out,
                                         long long ld_out, int nrows,
                                         bool vo) {
  float acc[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kq = 0; kq < NF; kq += 4) {  // product 2's K loop
    float4 mv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) mv[i] = ld4(m + rows[i] * LDM + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = ld4(rt + (kq + kk) * wp + 4 * cg);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float v = comp(mv[i], kk);
        acc[i][0] = fmaf(v, b.x, acc[i][0]);
        acc[i][1] = fmaf(v, b.y, acc[i][1]);
        acc[i][2] = fmaf(v, b.z, acc[i][2]);
        acc[i][3] = fmaf(v, b.w, acc[i][3]);
      }
    }
  }
  const int l0 = 4 * cg;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (rows[i] >= nrows) continue;
    float* o = out + rows[i] * ld_out;
    if (vo) {
      *reinterpret_cast<float4*>(o + l0) = make_float4(
          acc[i][0], l0 + 1 < w ? acc[i][1] : 0.f,
          l0 + 2 < w ? acc[i][2] : 0.f, l0 + 3 < w ? acc[i][3] : 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l0 + j < w) o[l0 + j] = acc[i][j];
    }
  }
}

// ASM of a tile of 16·R rows of t (shared memory, row stride ldt, lanes
// 0..kw-1 read; lanes past w, up to kw, must be zero) with cat and rt from
// stage_asm_ops and m, a 16·R × LDM scratch tile:
//   both = t @ cat; m = both[:64] > 0 ? both[64:] : 0; o = m @ rt
// Row j < nrows of o goes to out + j·ld_out: its w lanes (with VO, zeros
// up to lane round4(w)).  TV: t's rows are 16-byte aligned and kw % 4 == 0
// (float4 reads); VO: out and ld_out allow float4 stores.  Every thread of
// the CTA calls it; it synchronises once (m written), and the caller
// synchronises before t or m is written again.
template <int R, bool TV>
__device__ __forceinline__ void asm_tile(const float* t, int ldt, int kw,
                                         int w, const float* cat,
                                         const float* rt, float* m,
                                         float* out, long long ld_out,
                                         int nrows, bool vo) {
  constexpr int BM = 16 * R;
  const int tid = threadIdx.x;
  {
    // product 1: rows ty + 16·i, frequencies 4tx..4tx+3 of both halves
    const int tx = tid & 15, ty = tid >> 4;
    float ap[R][4], ex[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ap[i][j] = ex[i][j] = 0.f;
    auto step = [&](const float* c, const float (&tv)[R]) {
      const float4 c0 = ld4(c + 4 * tx), c1 = ld4(c + NF + 4 * tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ap[i][0] = fmaf(tv[i], c0.x, ap[i][0]);
        ap[i][1] = fmaf(tv[i], c0.y, ap[i][1]);
        ap[i][2] = fmaf(tv[i], c0.z, ap[i][2]);
        ap[i][3] = fmaf(tv[i], c0.w, ap[i][3]);
        ex[i][0] = fmaf(tv[i], c1.x, ex[i][0]);
        ex[i][1] = fmaf(tv[i], c1.y, ex[i][1]);
        ex[i][2] = fmaf(tv[i], c1.z, ex[i][2]);
        ex[i][3] = fmaf(tv[i], c1.w, ex[i][3]);
      }
    };
    if (TV) {
      for (int kq = 0; kq < kw; kq += 4) {
        float4 t4[R];
#pragma unroll
        for (int i = 0; i < R; ++i) t4[i] = ld4(t + (ty + 16 * i) * ldt + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float tv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) tv[i] = comp(t4[i], kk);
          step(cat + (kq + kk) * 2 * NF, tv);
        }
      }
    } else {
      for (int k = 0; k < kw; ++k) {
        float tv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) tv[i] = t[(ty + 16 * i) * ldt + k];
        step(cat + k * 2 * NF, tv);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      *reinterpret_cast<float4*>(m + (ty + 16 * i) * LDM + 4 * tx) =
          make_float4(ap[i][0] > 0.f ? ex[i][0] : 0.f,
                      ap[i][1] > 0.f ? ex[i][1] : 0.f,
                      ap[i][2] > 0.f ? ex[i][2] : 0.f,
                      ap[i][3] > 0.f ? ex[i][3] : 0.f);
  }
  __syncthreads();
  // product 2: lanes 4cg..4cg+3 of rows rg + rgs·i (i < np), rgs row
  // groups of cgs lane groups filling the CTA (at most cgs - 1 threads
  // idle), taken 8, 4, 2 and 1 rows at a time
  const int wp = round4(w), cgs = wp >> 2, rgs = THREADS / cgs;
  const int cg = tid % cgs, rg = tid / cgs;
  const int np = rg < rgs && rg < BM ? (BM - 1 - rg) / rgs + 1 : 0;
  int i = 0;
  if constexpr (BM >= 128) {
    for (; i + 8 <= np; i += 8) {
      int rows[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) rows[j] = rg + rgs * (i + j);
      asm_rows<8>(rows, m, rt, wp, cg, w, out, ld_out, nrows, vo);
    }
  }
  if (i + 4 <= np) {
    const int rows[4] = {rg + rgs * i, rg + rgs * (i + 1),
                         rg + rgs * (i + 2), rg + rgs * (i + 3)};
    asm_rows<4>(rows, m, rt, wp, cg, w, out, ld_out, nrows, vo);
    i += 4;
  }
  if (i + 2 <= np) {
    const int rows[2] = {rg + rgs * i, rg + rgs * (i + 1)};
    asm_rows<2>(rows, m, rt, wp, cg, w, out, ld_out, nrows, vo);
    i += 2;
  }
  if (i < np) {
    const int rows[1] = {rg + rgs * i};
    asm_rows<1>(rows, m, rt, wp, cg, w, out, ld_out, nrows, vo);
  }
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

// VEC: every width a multiple of 4 and x, xi, out 16-byte aligned, so each
// 4-lane group of K, of the tile's columns or of an output row is 16
// contiguous bytes.
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
  float* Cs = smem;  // [BM][LDC]
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
        Cs[(ty + 16 * i) * LDC + tc] = v;
      } else if (ok) {
        float* orow = a.out + (r * a.cout + co) * a.w_o;
        if (l < a.w_o) orow[l] = v;
        for (int z = a.wv + l; z < a.w_o; z += a.wv) orow[z] = 0.f;
      }
    }
  }
  if (!do_asm) return;

  // ASM of the tile's (row, channel) pairs, one channel's BM rows at a time
  float* cat = smem + BM * LDC;
  float* rt = cat + round4(a.w_o) * 2 * NF;
  float* msk = rt + NF * round4(a.w_o);
  stage_asm_ops(a.cat, a.rt, a.w_o, cat, rt);
  const int rows = (int)(a.m_rows - m0 < BM ? a.m_rows - m0 : BM);
  for (int ch = 0; ch < a.cpt && c0 + ch < a.cout; ++ch) {
    __syncthreads();  // Cs, cat and rt written; the last channel's msk read
    asm_tile<TM, VEC>(Cs + ch * a.w_o, LDC, a.w_o, a.w_o, cat, rt, msk,
                      a.out + (m0 * a.cout + c0 + ch) * a.w_o,
                      (long long)a.cout * a.w_o, rows, VEC);
  }
}

// ASM ReLU over rows of x (row stride ld_in) read at w lanes, into out
// (row stride ld_out).  Persistent CTAs walk tiles of ASM_BM rows, the next
// tile in flight while this one is computed.  VIN: w, ld_in and x allow
// 16-byte copies; VO: out and ld_out allow float4 stores.  BULK (VO, rows
// of at most 64 lanes with zero lanes past w): a tile's output rows,
// contiguous in out, are gathered in shared memory, whose lanes from
// round4(w) are zeroed once, and stored by one bulk copy, so the threads
// issue no stores for the zero lanes; otherwise out's lanes from w are
// already zero and the threads store the w lanes.
__global__ void __launch_bounds__(THREADS, 2) asm_kernel(
    const float* x, const float* catg, const float* rtg, float* out,
    long long rows, int ld_in, int w, int ld_out, bool vin, bool vo,
    bool bulk) {
  extern __shared__ __align__(16) float smem[];
  const int wp = round4(w), ldt = asm_ldt(w);
  float* cat = smem;
  float* rt = cat + wp * 2 * NF;
  float* msk = rt + NF * wp;
  float* tiles = msk + ASM_BM * LDM;  // two of ASM_BM × ldt
  float* obuf = tiles + 2 * ASM_BM * ldt;  // ASM_BM × ld_out
  const long long ntiles = (rows + ASM_BM - 1) / ASM_BM;
  // rows of tile tl into dst: w lanes, zero to wp; rows past the end zero.
  // This thread copies lane group cc of rows cr0, cr0 + cstep, ...
  const int per = vin ? wp >> 2 : wp, cstep = THREADS / per;
  const int cr0 = threadIdx.x / per;
  const int cc = (threadIdx.x - cr0 * per) * (vin ? 4 : 1);
  auto load = [&](long long tl, float* dst) {
    const long long r0 = tl * ASM_BM;
    if (cr0 >= cstep) return;
    for (int r = cr0; r < ASM_BM; r += cstep) {
      const bool ok = r0 + r < rows && cc < w;
      const float* src = ok ? x + (r0 + r) * ld_in + cc : x;
      if (vin)
        cp_async<16>(dst + r * ldt + cc, src, ok);
      else
        cp_async<4>(dst + r * ldt + cc, src, ok);
    }
  };
  long long tile = blockIdx.x;
  load(tile, tiles);
  cp_async_commit();
  stage_asm_ops(catg, rtg, w, cat, rt);
  if (bulk)
    for (int e = threadIdx.x; e < ASM_BM * ld_out; e += THREADS)
      obuf[e] = 0.f;
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    if (bulk && threadIdx.x == 0) bulk_wait_read();  // obuf is free
    cp_async_wait<0>();
    // this tile landed for every thread; every thread is done with the
    // last tile, whose buffer the next load overwrites, and with msk
    __syncthreads();
    if (tile + gridDim.x < ntiles)
      load(tile + gridDim.x, tiles + ((it + 1) & 1) * ASM_BM * ldt);
    cp_async_commit();
    const long long r0 = tile * ASM_BM;
    const int nrows = (int)(rows - r0 < ASM_BM ? rows - r0 : ASM_BM);
    asm_tile<ASM_BM / 16, true>(tiles + (it & 1) * ASM_BM * ldt, ldt, wp, w,
                                cat, rt, msk, bulk ? obuf : out + r0 * ld_out,
                                ld_out, nrows, vo);
    if (bulk) {
      fence_async_smem();
      __syncthreads();
      if (threadIdx.x == 0)
        bulk_store(out + r0 * ld_out, obuf, nrows * ld_out * 4);
    }
  }
  if (bulk && threadIdx.x == 0) bulk_wait();
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
                   (uintptr_t)xi % 16 == 0 && (uintptr_t)out % 16 == 0;
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
  if (w < 1 || w > MAX_W || ld_in < w || ld_out < w)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bool vin = w % 4 == 0 && ld_in % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vo = ld_out % 4 == 0 && (uintptr_t)out % 16 == 0;
  // rows with zero lanes go out by the bulk copy; full rows (w == ld_out)
  // by the threads, which saves the copy's barrier a tile
  const bool bulk = vo && w < ld_out && ld_out <= NF;
  // per process: the SM count and, per width and store path, the CTAs an
  // SM holds
  static int sms = 0;
  static int per_sm[2][MAX_W + 1];
  const int smem = asm_kernel_floats(w, bulk) * 4;
  if (sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        asm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        asm_kernel_floats(MAX_W, true) * 4);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  int& ctas = per_sm[bulk][w];
  if (ctas == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, asm_kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long tiles = (rows + ASM_BM - 1) / ASM_BM;
  const long long cap = (long long)ctas * sms;
  if (!bulk && ld_out > w) {
    const cudaError_t e = cudaMemsetAsync(
        out, 0, (size_t)rows * ld_out * sizeof(float), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  asm_kernel<<<(unsigned)(tiles < cap ? tiles : cap), THREADS, smem,
               (cudaStream_t)stream>>>(x, cat, rt, out, rows, ld_in, w,
                                       ld_out, vin, vo, bulk);
  return (int)cudaGetLastError();
}

}  // extern "C"

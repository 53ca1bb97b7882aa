// Batched 8×8 block DCT / IDCT for Hopper (sm_90a), fp32.
//
// One kernel serves both directions: out (n, 64) = x (n, 64) @ op (64, 64)
// with the operator passed in.  block_dct passes the forward operator
// (flat pixels → zigzag coefficients, the quantization divisor folded in),
// block_idct the inverse one, and either backward pass the transpose of
// its operator.  It replaces kernels/block_dct.py:block_dct_pallas and
// block_idct_pallas (both through _run's pallas_call).
//
// Bound: 64 multiply-adds per output element against 8 bytes moved for it
// (its input row element in, the output element out): 16 FLOP per byte,
// next to the card's fp32 ridge of ~20 (67 TFLOP/s over 3.35 TB/s), so
// memory and FFMA bound it about equally.  The design therefore reads each
// row once and writes each output once, coalesced, and keeps the FFMA
// issue rate high:
//
// * the operator (16 KB) is loaded into shared memory once per CTA and
//   stays there for the whole launch; the grid strides over row tiles;
// * a tile of 64 rows is staged through shared memory with 16-byte loads
//   (a warp reads two whole 256-byte rows), its row stride padded to 68
//   floats so that the two rows a warp reads per step sit in different
//   banks;
// * each thread computes a 4-row × 4-column block of the tile's output: per
//   four steps of k it loads four float4 of x and four float4 of the
//   operator from shared memory for 64 FFMA, and stores four float4 rows;
// * the ragged tail is masked: rows at and past n read zero and are not
//   stored.  Nothing is padded in device memory.
//
// The host function returns cudaGetLastError() so the Python wrapper can
// raise; the launch goes on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int BD_THREADS = 256;
constexpr int BD_ROWS = 64;        // rows per tile
constexpr int BD_W = 64;           // pixels per block = coefficients per row
constexpr int BD_LD = BD_W + 4;    // padded row stride of the staged tile
constexpr int BD_MAX_CTAS = 132 * 8;

__global__ void __launch_bounds__(BD_THREADS) block_matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ op,
    float* __restrict__ out, long long n) {
  __shared__ __align__(16) float ops[BD_W * BD_W];
  __shared__ __align__(16) float xs[BD_ROWS * BD_LD];
  const int tid = threadIdx.x;
  for (int i = tid; i < BD_W * BD_W / 4; i += BD_THREADS)
    reinterpret_cast<float4*>(ops)[i] = reinterpret_cast<const float4*>(op)[i];
  const int tx = tid % 16;  // output columns 4·tx … 4·tx+3
  const int ty = tid / 16;  // tile rows 4·ty … 4·ty+3
  const long long tiles = (n + BD_ROWS - 1) / BD_ROWS;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * BD_ROWS;
    __syncthreads();  // the operator is in place; the last tile is consumed
    for (int i = tid; i < BD_ROWS * BD_W / 4; i += BD_THREADS) {
      const int r = i / (BD_W / 4);
      const int c4 = i % (BD_W / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n)
        v = reinterpret_cast<const float4*>(x + (row0 + r) * BD_W)[c4];
      *reinterpret_cast<float4*>(xs + r * BD_LD + 4 * c4) = v;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < BD_W; k += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (4 * ty + i) * BD_LD + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b =
            *reinterpret_cast<const float4*>(ops + (k + kk) * BD_W + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + 4 * ty + i;
      if (row < n)
        reinterpret_cast<float4*>(out + row * BD_W)[tx] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

}  // namespace

extern "C" {

int jk_block_matmul(const float* x, const float* op, float* out, long long n,
                    void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long tiles = (n + BD_ROWS - 1) / BD_ROWS;
  const unsigned ctas = (unsigned)(tiles < BD_MAX_CTAS ? tiles : BD_MAX_CTAS);
  block_matmul_kernel<<<ctas, BD_THREADS, 0, (cudaStream_t)stream>>>(
      x, op, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused dynamic-int8 matmul, written by hand for Hopper (sm_90a).
//
// int8_matmul_kernel replaces _kernel_v2 of
// kubeflow_controller_tpu/ops/quant_pallas.py (:46, launched :148):
//
//   out[m, n] = bf16( fp32(sum_k qa[m, k] * qb[k, n]) * sa[m] * sb[n] )
//
// with a bf16 [M, K] lhs quantized per row inside the kernel
// (sa = max(amax_row, 1e-30) * fp32(1/127), qa = clip(round(a / sa), ±127),
// round half to even), qb int8 [K, N] and sb fp32 [1, N] quantized per
// column by the caller, the products summed exactly in int32 on the int8
// tensor cores, and the dequantization done in fp32 in the reference's
// order. Every step is IEEE (the division __fdiv_rn, rintf, two
// __fmul_rn, __float2bfloat16_rn; no FMA, and the build does not use
// --use_fast_math), and the int32 sums are exact (|acc| <= 127^2 * 4096),
// so the output equals the plain PyTorch version's bit for bit.
//
// What bounds it on an H100: at the flagship's 16384x1024x4096 and
// 16384x4096x1024, operations (2mkn = 137 G int8 ops, 0.0694 ms at 1,979
// TOPS, against 0.04-0.06 ms for the bytes); at 16384x1024x1024, bytes
// (bf16 in, int8 rhs, bf16 out: 68 MB, 0.0204 ms at 3.35 TB/s). Both
// figures are data-sheet arithmetic.
//
// Design (the simple, correct first version). The TPU kernel streams lhs
// row blocks through a manual double buffer with the whole k extent in
// VMEM, carrying the quantized block across its sequential grid. Here a
// block owns one 128x128 output tile (8 warps, 4 along m by 2 along n)
// and carries nothing across blocks:
//   1. it reads its 128 lhs rows over the whole k with 16-byte loads and
//      takes each row's fp32 abs-max with warp shuffles: every column
//      block recomputes its rows' scales, extra lhs reads from L2 that
//      this version accepts (blocks of one row band run side by side, so
//      the band is read from device memory about once);
//   2. it walks k in steps of 64: the bf16 lhs tile is quantized into
//      int8 in shared memory, the int8 rhs tile copied beside it, and the
//      products run as WMMA 16x16x16 s8 x s8 -> s32 fragments (the warp
//      keeps a 32x64 int32 accumulator in registers);
//   3. each fragment is staged through shared memory, dequantized with
//      the row and column scales and written as bf16, 16 bytes a thread.
// Two blocks share an SM (at most 128 registers a thread, no spills), so
// one block's loads and quantization overlap the other's products.
// The shared tiles hold each 16-wide k (or n) slice contiguously, 16
// bytes a row, so every fragment starts 256-bit aligned as WMMA requires.
// Loads are not overlapped with the products and each row is quantized
// once per column block; wgmma, TMA and a single quantization pass are
// later work.
//
// The C function returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape it does not tile, without launching);
// the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarpM = 32, kWarpN = 64;     // per warp: 2 x 4 fragments
constexpr int kFragsM = kWarpM / 16, kFragsN = kWarpN / 16;
constexpr float kInv127 = 1.0f / 127.0f;    // fp32(1/127), as jitted XLA

__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ qb,
                   const float* __restrict__ sb, bf16* __restrict__ out,
                   int M, int K, int N) {
  // sa_tile[kk][r][c] = lhs code (row r, k = k0 + 16 kk + c);
  // qb_tile[nn][r][c] = rhs code (k = k0 + r, col n0 + 16 nn + c).
  __shared__ __align__(128) int8_t sa_tile[kBK / 16][kBM][16];
  __shared__ __align__(128) int8_t qb_tile[kBN / 16][kBK][16];
  __shared__ __align__(128) int stage[kThreads / 32][16][16];
  __shared__ float row_scale[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int wm = warp >> 1, wn = warp & 1;

  // 1. Row scales: warp w takes rows 16w .. 16w + 15.
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const uint4* row = reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K);
    float amax = 0.0f;
    for (int c = lane; c < K / 8; c += 32) {
      const uint4 v = row[c];
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(h[j])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) row_scale[r] = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kFragsM][kFragsN];
#pragma unroll
  for (int i = 0; i < kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 2a. Quantize the lhs tile: 128 rows x 8 chunks of 8 bf16.
#pragma unroll
    for (int it = 0; it < (kBM * kBK / 8) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      const int r = c >> 3, ch = c & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(
          a + (size_t)(m0 + r) * K + k0 + ch * 8);
      const bf16* h = reinterpret_cast<const bf16*>(&v);
      const float s = row_scale[r];
      uint2 pack;
      int8_t* codes = reinterpret_cast<int8_t*>(&pack);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float q = rintf(__fdiv_rn(__bfloat162float(h[j]), s));
        codes[j] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
      }
      *reinterpret_cast<uint2*>(&sa_tile[ch >> 1][r][(ch & 1) * 8]) = pack;
    }
    // 2b. Copy the rhs tile: 64 k-rows x 8 chunks of 16 codes.
#pragma unroll
    for (int it = 0; it < (kBK * kBN / 16) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      const int r = c >> 3, ch = c & 7;
      *reinterpret_cast<uint4*>(&qb_tile[ch][r][0]) =
          *reinterpret_cast<const uint4*>(qb + (size_t)(k0 + r) * N + n0 + ch * 16);
    }
    __syncthreads();

    // 2c. The products.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[kFragsM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[kFragsN];
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
        wmma::load_matrix_sync(fa[i], &sa_tile[kk][wm * kWarpM + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < kFragsN; ++j)
        wmma::load_matrix_sync(fb[j], &qb_tile[wn * kFragsN + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
#pragma unroll
        for (int j = 0; j < kFragsN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 3. Dequantize and write: each lane takes 8 columns of one row of a
  // staged 16x16 fragment.
  const int fr = lane >> 1, fc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) {
      wmma::store_matrix_sync(&stage[warp][0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int lr = wm * kWarpM + i * 16 + fr;
      const int gn = n0 + wn * kWarpN + j * 16 + fc;
      const float s = row_scale[lr];
      uint4 pack;
      bf16* y = reinterpret_cast<bf16*>(&pack);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __float2bfloat16_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(stage[warp][fr][fc + e]), s), sb[gn + e]));
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + lr) * N + gn) = pack;
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int kfc_int8_matmul(const void* a, const void* qb, const void* sb,
                               void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % kBM || N % kBN || K % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_matmul_kernel<<<dim3(N / kBN, M / kBM), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const int8_t*>(qb),
      static_cast<const float*>(sb), static_cast<bf16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

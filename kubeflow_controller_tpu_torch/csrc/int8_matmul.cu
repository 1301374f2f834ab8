// Fused dynamic-int8 matmul, written by hand for Hopper (sm_90a).
//
// Two kernels replace _kernel_v2 of
// kubeflow_controller_tpu/ops/quant_pallas.py (:46, launched :148):
//
//   out[m, n] = bf16( fp32(sum_k qa[m, k] * qb[k, n]) * sa[m] * sb[n] )
//
// with a bf16 [M, K] lhs quantized per row on the card
// (sa = max(amax_row, 1e-30) * fp32(1/127), qa = clip(round(a / sa), ±127),
// round half to even), the rhs codes and fp32 scales sb [1, N] quantized
// per column by the caller, the products summed exactly in int32 on the
// int8 tensor cores, and the dequantization done in fp32 in the
// reference's order. Every step is IEEE (the division __fdiv_rn, rintf,
// two __fmul_rn, __float2bfloat16_rn; no FMA, and the build does not use
// --use_fast_math), and the int32 sums are exact (|acc| <= 127^2 * 4096),
// so the output equals the plain PyTorch version's bit for bit.
//
// What bounds it on an H100: at the flagship's 16384x1024x4096 and
// 16384x4096x1024, operations (2mkn = 137 G int8 ops, 0.0694 ms at 1,979
// TOPS, against 0.04-0.06 ms for the bytes); at 16384x1024x1024, bytes
// (bf16 in, int8 rhs, bf16 out: 68 MB, 0.0204 ms at 3.35 TB/s). Both
// figures are data-sheet arithmetic.
//
// Design.
//   1. quantize_rows_kernel quantizes every lhs row once: one warp a row,
//      16-byte loads, the fp32 abs-max by shuffles, then the codes (16 a
//      store; the division by the row's scale is a product with its
//      reciprocal plus an exact correction, the same bits for a third of
//      the arithmetic) and the row's scale into scratch the wrapper
//      allocates. The TPU kernel kept a row block's codes in VMEM across
//      its sequential grid; Hopper's blocks share nothing, so one round
//      trip of the codes through device memory (3 bytes an element,
//      mostly L2) buys N / 128 fewer quantizations: no column block
//      divides or rounds anything.
//   2. int8_gemm_kernel is a pure s8 x s8 -> s32 product. Both operands
//      are K-contiguous (the lhs codes [M, K]; the rhs codes as [N, K],
//      which the wrapper provides: for 8-bit types the tensor cores take
//      no transposed operand). A block owns a 128x128 output tile and
//      walks K in steps of 128 through a ring of three stages in dynamic
//      shared memory, filled by cp.async (16 bytes a thread, written
//      straight into the 128-byte swizzle a wgmma descriptor names) two
//      steps ahead of the products. Each of the block's two warpgroups
//      starts four wgmma m64n128k32 a step on its 64 rows; the 64 int32
//      accumulators a thread holds stay in registers for the whole loop.
//      Two blocks share an SM (96 KB of the ring each, at most 128
//      registers a thread), so one block's epilogue and pipeline fill
//      overlap the other's products: with K = 1024 a tile's main loop is
//      only eight steps.
//   3. The epilogue dequantizes from registers with the row and column
//      scales, packs bf16 pairs, transposes them across the four lanes
//      of a row and writes 16 bytes a thread.
//
// The split entries. Over a mesh a projection's contraction may be split
// over ranks (a row-parallel layer's forward, a column-parallel one's dx
// over tp). Its scales are then the whole contraction's, which the caller
// computes (the abs-max all-reduced with MAX over the ranks), and each
// rank's product is a partial sum that must meet the others' before the
// one rounding to bf16. So quantize_rows_kernel<true> takes the row
// scales and only quantizes (the same division and rounding as above),
// and int8_gemm_kernel<true> writes the dequantized fp32 product (8 bytes
// a thread a column pair, no transpose), which the wrapper sums over the
// ranks and rounds. Same bounds as the bf16 entry but twice the output
// bytes: at the flagship's row-parallel shapes with tp=2 (16384x512x1024
// and 16384x2048x1024), 16384x1024x4 bytes = 67 MB of fp32 out, 0.020 ms
// at 3.35 TB/s, against 0.009-0.035 ms of int8 operations.
//
// The C functions return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape they do not tile, without
// launching); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 128;   // k step in bytes = int8 codes
constexpr int kStages = 3;
constexpr int kThreads = 256;                    // two warpgroups of 64 rows
constexpr int kTileBytes = kBM * kBK;            // one operand's stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment slack
constexpr float kInv127 = 1.0f / 127.0f;         // fp32(1/127), as jitted XLA
constexpr int kQuantThreads = 256;               // 8 rows a block

// x / scale rounded to nearest, as __fdiv_rn gives it, for one scale and
// many x. With the correctly rounded reciprocal (taken once per row) a
// product, the exact remainder and one correction round correctly
// whenever nothing under- or overflows (Markstein's quotient refinement):
// rows whose scale lies far outside any activation's range divide the
// slow way, and a quotient that underflows is far below the 0.5 that
// could change its code.
struct RowDivider {
  float scale, recip;
  bool fast;
};

__device__ __forceinline__ RowDivider row_divider(float scale) {
  return RowDivider{scale, __frcp_rn(scale), scale > 1e-30f && scale < 1e30f};
}

__device__ __forceinline__ float divide(float x, const RowDivider& d) {
  if (!d.fast) return __fdiv_rn(x, d.scale);
  const float q = __fmul_rn(x, d.recip);
  return __fmaf_rn(__fmaf_rn(-d.scale, q, x), d.recip, q);
}

__device__ __forceinline__ int8_t quantize(bf16 x, const RowDivider& div) {
  const float q = rintf(divide(__bfloat162float(x), div));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// One warp a row: abs-max, scale, codes. The second pass re-reads the row
// from L1; the kernel is bound by its arithmetic, not by that. kScalesIn:
// the row's scale is read from sa (the caller's), not computed or written.
template <bool kScalesIn>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const bf16* __restrict__ a, int8_t* __restrict__ qa,
                     float* __restrict__ sa, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kQuantThreads / 32) + warp;
  if (row >= M) return;
  const uint4* src = reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * K);
  float scale;
  if constexpr (kScalesIn) {
    scale = sa[row];
  } else {
    float amax = 0.0f;
    for (int c = lane; c < K / 8; c += 32) {
      const uint4 v = src[c];
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(h[j])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    scale = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
    if (lane == 0) sa[row] = scale;
  }
  const RowDivider div = row_divider(scale);
  uint4* dst = reinterpret_cast<uint4*>(qa + static_cast<size_t>(row) * K);
  for (int c = lane; c < K / 16; c += 32) {
    const uint4 v[2] = {src[2 * c], src[2 * c + 1]};
    const bf16* h = reinterpret_cast<const bf16*>(v);
    uint4 pack;
    int8_t* codes = reinterpret_cast<int8_t*>(&pack);
#pragma unroll
    for (int j = 0; j < 16; ++j) codes[j] = quantize(h[j], div);
    dst[c] = pack;
  }
}

// kF32Out: out is fp32 [M, N] (a split contraction's partial product),
// else bf16.
template <bool kF32Out>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ qa, const int8_t* __restrict__ qb,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 void* __restrict__ out_raw, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;

  // A stage's loads: thread t copies chunk t % 8 of rows t / 8 + 32 i of
  // both operands (rows 32 apart share their swizzle).
  const int chunk = tid & 7, row0 = tid >> 3;
  const int8_t* a_src = qa + static_cast<size_t>(m0 + row0) * K + chunk * 16;
  const int8_t* b_src = qb + static_cast<size_t>(n0 + row0) * K + chunk * 16;
  const uint32_t dst_off = swizzle_chunk(row0, chunk);
  auto load_stage = [&](int kt) {
    const uint32_t s_a = base + (kt % kStages) * kStageBytes, s_b = s_a + kTileBytes;
    const size_t k_off = static_cast<size_t>(kt) * kBK;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      cp_async16(s_a + dst_off + i * 32 * 128, a_src + static_cast<size_t>(i) * 32 * K + k_off);
      cp_async16(s_b + dst_off + i * 32 * 128, b_src + static_cast<size_t>(i) * 32 * K + k_off);
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  const int steps = K / kBK;
  load_stage(0);
  cp_async_commit();
  if (steps > 1) load_stage(1);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<1>();          // all but the newest group: step kt has landed
    fence_async_proxy();
    __syncthreads();             // everyone's part of it; everyone done with step kt - 1
    if (kt + 2 < steps) load_stage(kt + 2);   // into the stage step kt - 1 read
    cp_async_commit();
    const uint32_t s_a = base + (kt % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t s_b = base + (kt % kStages) * kStageBytes + kTileBytes;
    const uint64_t da = desc_sw128(s_a), db = desc_sw128(s_b);
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(acc);
  }

  // Dequantize and write. acc[4j + e]: row r0 + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2. After the transpose lane l of a row's
  // four holds the 8 columns of block 4 g + l.
  const int r0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;
  const float s_row[2] = {sa[r0], sa[r0 + 8]};
  if constexpr (kF32Out) {
    float* out = static_cast<float*>(out_raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 cs = *reinterpret_cast<const float2*>(sb + n0 + 8 * j + 2 * quad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s_row[h]), cs.x);
        const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s_row[h]), cs.y);
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r0 + 8 * h) * N + n0 + 8 * j +
                                   2 * quad) = make_float2(y0, y1);
      }
    }
    return;
  }
  bf16* out = static_cast<bf16*>(out_raw);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t w[2][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * g + jj;
      const float2 cs = *reinterpret_cast<const float2*>(sb + n0 + 8 * j + 2 * quad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s_row[h]), cs.x);
        const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s_row[h]), cs.y);
        w[h][jj] = pack_bf16(y0, y1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      quad_transpose(w[h], lane);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + 8 * h) * N + n0 +
                                8 * (4 * g + quad)) =
          make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
    }
  }
}

}  // namespace

// a bf16 [M, K] -> qa int8 [M, K], sa fp32 [M]. K a multiple of 16.
namespace {

template <bool kScalesIn>
int quantize_rows(const void* a, void* qa, void* sa, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kQuantThreads / 32;
  quantize_rows_kernel<kScalesIn><<<(M + rows - 1) / rows, kQuantThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<int8_t*>(qa),
      static_cast<float*>(sa), M, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32Out>
int int8_matmul(const void* qa, const void* qb, const void* sa, const void* sb,
                void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % kBM || N % kBN || K % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<kF32Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_gemm_kernel<kF32Out><<<dim3(N / kBN, M / kBM), kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb),
      static_cast<const float*>(sa), static_cast<const float*>(sb), out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a bf16 [M, K] -> qa int8 [M, K], sa fp32 [M]. K a multiple of 16.
extern "C" int kfc_int8_quantize_rows(const void* a, void* qa, void* sa, int M,
                                      int K, void* stream) {
  return quantize_rows<false>(a, qa, sa, M, K, stream);
}

// a bf16 [M, K], sa fp32 [M] (the caller's row scales) -> qa int8 [M, K].
extern "C" int kfc_int8_quantize_rows_scaled(const void* a, const void* sa, void* qa,
                                             int M, int K, void* stream) {
  return quantize_rows<true>(a, qa, const_cast<void*>(sa), M, K, stream);
}

// qa int8 [M, K], qb int8 [N, K] (the rhs codes, K-contiguous), sa fp32
// [M], sb fp32 [N] -> out bf16 [M, N]. M, N and K multiples of 128.
extern "C" int kfc_int8_matmul(const void* qa, const void* qb, const void* sa,
                               const void* sb, void* out, int M, int K, int N,
                               void* stream) {
  return int8_matmul<false>(qa, qb, sa, sb, out, M, K, N, stream);
}

// The same, out fp32 [M, N]: a split contraction's partial product.
extern "C" int kfc_int8_matmul_f32(const void* qa, const void* qb, const void* sa,
                                   const void* sb, void* out, int M, int K, int N,
                                   void* stream) {
  return int8_matmul<true>(qa, qb, sa, sb, out, M, K, N, stream);
}

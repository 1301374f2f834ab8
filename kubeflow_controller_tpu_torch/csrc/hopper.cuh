// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// cp.async copies and the proxy fence, mbarriers, TMA tile copies,
// setmaxnreg, wgmma descriptors for operand tiles kept in shared memory
// under the 128-byte swizzle, the wgmma products the kernels start,
// named barriers, 16-byte fp32 reductions into global memory, and a 4x4
// transpose across the four lanes that share an accumulator row.
//
// Operand tiles in shared memory are rows of 128 bytes: row r of a tile
// starts at r * 128 from a 1024-byte aligned base, and its 16-byte chunk
// c sits at ((c ^ (r & 7)) << 4) (swizzle_chunk; a TMA copy under
// CU_TENSOR_MAP_SWIZZLE_128B writes the same). A logical row wider
// than 128 bytes is cut into panels of 128 bytes, one whole tile after
// the other. That is the layout a wgmma descriptor names as "128B
// swizzle", for K-major operands (the row runs along the contraction)
// and for MN-major ones (the row runs along the output dimension, 16-bit
// types only).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t swizzle_chunk(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory writes (st.shared, landed cp.async)
// visible to the asynchronous proxy through which wgmma reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers: a count of arrivals completes a phase; a waiter names the
// parity of the phase it waits to see completed (0 for the first).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spins until the phase completes; a wait that outlasts any kernel here
// by orders of magnitude (a lost arrival) traps instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins > (1u << 28)) __trap();
  }
}

// Arrives and adds `bytes` to what the phase still expects from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One TMA copy of a box of a 4-d tensor (coordinates innermost first)
// into shared memory; its bytes complete on `bar`. Rows of the box that
// lie outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tensor_map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// Register budget of the calling warpgroup (all four warps together).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Descriptor of an operand tile under the 128-byte swizzle. Eight rows
// are 1024 bytes apart (the stride byte offset). For a K-major operand
// one wgmma's contraction (32 bytes) lies inside a row, so the
// leading byte offset is unused (1) and the next 32 bytes of K are the
// descriptor plus 2. For an MN-major operand the leading byte offset is
// the distance between panels of 64 elements along the output dimension.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t leading_bytes = 16) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define KFC_L8(M, d, o) \
  M(d[o]), M(d[o + 1]), M(d[o + 2]), M(d[o + 3]), M(d[o + 4]), M(d[o + 5]), M(d[o + 6]), M(d[o + 7])
#define KFC_L32(M, d, o) KFC_L8(M, d, o), KFC_L8(M, d, o + 8), KFC_L8(M, d, o + 16), KFC_L8(M, d, o + 24)
#define KFC_RW_R(x) "+r"(x)
#define KFC_RW_F(x) "+f"(x)
#define KFC_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define KFC_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KFC_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T, int8 operands K-major in
// shared memory, int32 sums. Thread t of the warpgroup holds, for each
// 8-column block j, d[4j], d[4j+1] = row 16 (t / 32) + (t % 32) / 4,
// columns 8j + 2 (t % 4) + {0, 1}, and d[4j+2], d[4j+3] = that row + 8.
// Every wgmma below lays its accumulator out the same way.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " KFC_D64 ", %64, %65, p;\n}\n"
      : KFC_L32(KFC_RW_R, d, 0), KFC_L32(KFC_RW_R, d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, bf16 operands K-major in
// shared memory, fp32 sums.
__device__ __forceinline__ void wgmma_bf16_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFC_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KFC_L32(KFC_RW_F, d, 0), KFC_L32(KFC_RW_F, d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (four words of
// two bf16 in the accumulator's own row/column pattern: a[0] = row,
// columns 2 (t % 4) + {0, 1}; a[1] = row + 8; a[2], a[3] = the same
// rows, columns + 8), B MN-major in shared memory (each row one k, 128
// bytes of n).
__device__ __forceinline__ void wgmma_bf16_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFC_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : KFC_L32(KFC_RW_F, d, 0), KFC_L32(KFC_RW_F, d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with 64 output columns.
__device__ __forceinline__ void wgmma_bf16_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KFC_L32(KFC_RW_F, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, bf16 operands in shared memory
// under the 128-byte swizzle, fp32 sums; TA / TB = 1 take A / B
// MN-major (the tile's rows run along the output dimension).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFC_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : KFC_L32(KFC_RW_F, d, 0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The same with 32 output columns.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_ss_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " KFC_D16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : KFC_L8(KFC_RW_F, d, 0), KFC_L8(KFC_RW_F, d, 8)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// Barrier `id` (1..15) over `threads` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// dst[0..3] += v, one 16-byte vector reduction (dst 16-byte aligned).
__device__ __forceinline__ void add_v4_f32(float* dst, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(dst), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across an asynchronous wgmma that still owns them.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_registers(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The four lanes that share an accumulator row (lane % 4 = 0..3) each
// hold four words w[0..3], one per 8-column block of a group of four.
// Afterwards lane l holds the four lanes' words of block l in lane
// order: 16 contiguous bytes of that row.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int lane) {
  const bool hi = lane & 2, odd = lane & 1;
  uint32_t s0 = hi ? w[0] : w[2], s1 = hi ? w[1] : w[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 2), r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) { w[0] = r0; w[1] = r1; } else { w[2] = r0; w[3] = r1; }
  s0 = odd ? w[0] : w[1];
  s1 = odd ? w[2] : w[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) { w[0] = r0; w[2] = r1; } else { w[1] = r0; w[3] = r1; }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace hopper

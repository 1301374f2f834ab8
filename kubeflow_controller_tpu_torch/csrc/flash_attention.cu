// Flash attention for training, written by hand for Hopper (sm_90a).
//
// The kernels here cover the four TPU kernels of
// kubeflow_controller_tpu/ops/flash_attention.py:
//
// * flash_fwd_wgmma_kernel (head_dim 64 and 128) and flash_fwd_kernel
//   (every other head_dim a multiple of 16 up to 256) replace _fwd_kernel
//   (:203, launched :576 via _fwd_wide :530 / _fwd :599): o = softmax(q
//   k^T * scale + mask) v and the row log-sum-exp lse [B, H, S] (the
//   narrow residual of _fwd). rope_rotate_kernel is the wgmma forward's
//   prepass: it rotates Q and K once per call.
// * flash_bwd_wgmma_kernel<D, kDq = true> (head_dim 64 and 128) and
//   flash_bwd_kv_kernel<kDq = true> (every other head_dim) replace
//   _bwd_fused_kernel (:766, launched :1109): dk and dv, and every tile's
//   dq, from one score recompute. flash_bwd_prep_kernel (delta =
//   rowsum(dO O), the dq scratch zeroed) and flash_bwd_post_kernel (dq
//   counter-rotated and cast) are the warpgroup kernel's prepass and
//   postprocess.
// * flash_bwd_wgmma_kernel<D, kDq = false> (head_dim 64 and 128) and
//   flash_bwd_kv_kernel<kDq = false> (every other head_dim) replace
//   _bwd_dkdv_kernel (:621, launched :1187): the two-pass backward's
//   first pass, dk and dv.
// * flash_bwd_dq_wgmma_kernel (head_dim 64 and 128) and
//   flash_bwd_dq_kernel (every other head_dim) replace _bwd_dq_kernel
//   (:919, launched :1227): the second pass, dq. At head_dim 64 and 128
//   the two passes share one rope prepass and take delta from
//   flash_bwd_prep_kernel, which then writes no scratch.
//
// Layouts are BSHD: q, o, do [B, S, H, D]; k, v [B, S, KVH, D] (query
// head h reads KV head h / (H / KVH)); segment ids [B, S] int32; rope
// tables C, S [B, S, D] fp32 with rot(x) = x * C + roll(x, D/2) * S
// (rotated in fp32 and cast back to bf16, as _rope_rot does; dq and dk
// are counter-rotated with -S before their cast). Row i sees column j
// iff (!causal || j <= i) && seg[i] == seg[j]; masked scores are the
// finite -1e30 of the TPU kernels, and masked probabilities are exactly
// 0. Segment id 0 is not special here: a padding row still sees its own
// diagonal, so no row is ever fully masked.
//
// What bounds them on an H100: operations. At the flagship's shape (B16
// H8 S1024 D128, causal) the forward does 2 * 2 * B*H*S^2*D / 2 = 34
// GFLOP (0.035 ms at 989 TFLOP/s bf16) against ~150 MB of inputs and
// outputs (0.045 ms at 3.35 TB/s), so the two bounds are close; the
// fused backward does 2.5x the forward's products, the dk/dv pass 2x,
// the dq pass 1.5x. No kernel writes the S x S scores to device memory,
// and every kernel skips the tiles wholly above the diagonal (the
// counterpart of the splash dead-triangle skip), which halves the causal
// work.
//
// The forward (flash_fwd_wgmma_kernel), FlashAttention's shape on
// Hopper's warpgroup MMA (wgmma). The TPU kernel carries m, l and the
// output accumulator in VMEM scratch across its sequential grid; here a
// warpgroup carries them in registers across its own loop over 128-row
// k-tiles:
//   - Q and K are rotated once per call by rope_rotate_kernel into
//     scratch: rotating on load would repeat a K tile's rotation in each
//     of its head's q-tile blocks and read 64 KB of fp32 tables for 16 KB
//     of K, and would keep the tiles from being plain copies. It uses
//     rope_mix, so a rotated element is the plain version's bit for bit.
//     SDPA, the yardstick, is timed on q and k that are already rotated;
//     the prepass is part of this forward's time;
//   - the tiles are then plain bf16 boxes, which one thread copies by
//     TMA: a tensor map per operand ([D, heads, S, B], boxes of 64
//     elements by 128 rows, written under the 128-byte swizzle, rows past
//     S zero-filled by the hardware). A producer warp keeps a ring of two
//     K/V stages full and signals each tile on an mbarrier; it has given
//     its warpgroup's registers to the consumers (setmaxnreg);
//   - two consumer warpgroups own 64 rows each of a 128-row q-tile. They
//     wait on a tile's mbarrier and release its stage on another, and
//     otherwise never wait on each other, so one's softmax runs under the
//     other's products: the exponentials alone take half as long as the
//     products (16 a clock and SM against 4096 multiply-adds);
//   - S = Q K^T runs as wgmma m64n128k16 with both operands K-major in
//     shared memory; the scores stay in registers, where the online
//     softmax runs (row max and sum across the four lanes that share a
//     row; exp2 with scale * log2(e) folded into one multiply-add; the
//     mask compared only on diagonal, ragged or segmented tiles); the
//     output accumulator (64 x D fp32 a warpgroup) is rescaled in
//     registers;
//   - P is cast to bf16 in registers, whose layout is already the A
//     operand's, and O += P V runs as wgmma with V row-major [k][D] as
//     an MN-major B;
//   - the epilogue multiplies by 1 / l, packs bf16, transposes across the
//     four lanes of a row and writes 16 bytes a thread; lse = m + log(l);
//   - the grid is persistent: one block of 384 threads an SM (161 KB of
//     shared memory at D = 128) walks the (q-tile, head, batch) items,
//     the heaviest causal q-tiles first, and the producer runs ahead
//     across items, so an item's Q and first tiles land under the last
//     item's final products and epilogue.
//
// The fused backward (flash_bwd_wgmma_kernel), FlashAttention-3's
// backward shape on wgmma. The first version (flash_bwd_kv_kernel<true>,
// below) ran 64-row WMMA tiles staged through fp32 shared memory, one
// block an SM, dq added by 8192 scalar atomics a tile pair, Q rotated
// from fp32 tables at every visit: 3.6 ms at the flagship's shape for a
// bound of 0.087. Here:
//   - Q and K are rotated once per call (rope_rotate_kernel), so every
//     tile is a plain bf16 box that one thread copies by TMA; a block owns
//     a 128-row k-tile of one KV head (K and V loaded once) and streams
//     Q, dO (64-row boxes), lse, delta and the segment ids of each
//     (query head of the group, live q-tile) through two stages on
//     mbarriers. The block is the two warpgroups alone (warp 0 refills a
//     stage once both are past it): a ninth warp, producer or not, would
//     cap every thread at 168 registers and spill dV and dK;
//   - the two warpgroups own 64 k rows each. S^T = K Q^T and dP^T =
//     V dO^T run as wgmma with both operands K-major in shared memory;
//     P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale are
//     formed in registers, masks applied there (causal dead q-tiles are
//     never visited; rows past S are zero-filled by TMA and masked);
//   - dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers as
//     the A operand (their accumulator layout is the A layout) and dO, Q
//     as MN-major B; dV and dK stay in registers over the whole loop,
//     and dK is counter-rotated from registers in the epilogue;
//   - dS^T goes to shared memory in bf16 (two buffers, one barrier of the
//     two warpgroups a tile), dQ = dS K runs as wgmma with both operands
//     MN-major, each warpgroup 64 of the output columns, and is added to
//     the fp32 scratch by 16-byte vector reductions (neighbouring lanes
//     trade a pair of columns first), never by scalar atomics;
//   - the prepass writes delta and zeroes the scratch in one pass; the
//     postprocess counter-rotates dq and casts it, rounding as _rope_rot.
//
// The two-pass backward at head_dim 64 and 128 reuses the fused
// backward's design. Its dk/dv pass is flash_bwd_wgmma_kernel without
// dQ: no dS^T buffer, no barrier between the warpgroups, and the last
// warp done with a stage refills it, so the warpgroups drift apart. Its
// dq pass (flash_bwd_dq_wgmma_kernel) is the mirror: a block owns a
// 128-row q-tile, loads Q and dO once, streams 64-row k-tiles of K and V
// through a three-stage TMA ring, forms S, dP, P and dS in registers and
// keeps dQ in fp32 registers to the epilogue, which counter-rotates it:
// no scratch, no atomics, the same bits every run.
//
// The two-pass kernels at other head dims, the fused backward's first
// kernel and the forward for other head dims (flash_fwd_kernel) are the
// first, simple versions: a block owns a
// 64-row tile (32 rows when D = 256), rope rotates on load, every
// product is bf16 WMMA 16x16x16 with operands and fp32 accumulators
// staged in shared memory, the softmax bookkeeping is scalar fp32 there,
// and loads are not overlapped with compute. The dk/dv kernel's block
// (batch, KV head, k-tile) loops over the KV head's query heads and their
// live q-tiles, so the GQA group sum falls out of the accumulation with
// no atomics; dq in the fused kernel crosses blocks: each (q-tile,
// k-tile) pair adds its [T, D] tile into an fp32 scratch with atomicAdd
// (so dq's fp32 sums run in a launch-dependent order; dk and dv are
// deterministic), and the wrapper counter-rotates and casts it.
//
// The C functions return cudaGetLastError() after the launch (or the
// error that stopped it); the Python wrappers raise when it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

struct Problem {
  int B, S, H, KVH, D;
  float scale;
  int causal;
  const int* seg;    // [B, S] or null
  const float* rc;   // [B, S, D] or null
  const float* rs;
};

// Shared-memory carve-up, identical on host (size) and device (offsets).
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 127) / 128 * 128;
  return at;
}

// The tile rows of each kernel: 64 for head_dim <= 128, 32 for 256.
__host__ __device__ inline int tile_rows(int D) { return D <= 128 ? 64 : 32; }

struct Layout {
  int T, D, ldh, ldf, lds, ldp;
  // bf16 tiles [T][ldh]; fp32 [T][ldf] accumulators; fp32 [T][lds]
  // scores; bf16 [T][ldp] probabilities.
  size_t q, k, v, dout, s, dp, p, ds, acc0, acc1, acc2, r0, r1, segq, segk,
      bytes;
  __host__ __device__ Layout(int T_, int D_, int n_acc, bool bwd)
      : T(T_), D(D_), ldh(D_ + 8), ldf(D_ + 4), lds(T_ + 4), ldp(T_ + 8) {
    size_t off = 0;
    const size_t th = sizeof(bf16) * T * ldh, tf = sizeof(float) * T * ldf;
    const size_t ts = sizeof(float) * T * lds, tp = sizeof(bf16) * T * ldp;
    q = take(off, th);
    k = take(off, th);
    v = take(off, th);
    dout = bwd ? take(off, th) : 0;
    s = take(off, ts);
    dp = bwd ? take(off, ts) : 0;
    p = take(off, tp);
    ds = bwd ? take(off, tp) : 0;
    acc0 = take(off, tf);
    acc1 = n_acc > 1 ? take(off, tf) : 0;
    acc2 = n_acc > 2 ? take(off, tf) : 0;
    r0 = take(off, sizeof(float) * T);
    r1 = take(off, sizeof(float) * T);
    segq = take(off, sizeof(int) * T);
    segk = take(off, sizeof(int) * T);
    bytes = off;
  }
};

template <typename X>
__device__ __forceinline__ X* at(unsigned char* base, size_t off) {
  return reinterpret_cast<X*>(base + off);
}

// x * c + xr * s as two rounded products and a rounded sum, never
// contracted into an FMA: the rotation _rope_rot (and the plain version)
// computes, bit for bit, so a rotated element never lands on the other
// side of a bf16 rounding boundary than it does there.
__device__ __forceinline__ float rope_mix(float x, float c, float xr, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xr, s));
}

// Rows [r0, r0 + T) of head `head` of x [B, S, heads, D] into shared
// bf16 [T][ld]; rotated by the rope tables when `rotate` and the problem
// has them; rows at or past S are zero. Each thread moves 8 consecutive
// elements (16 bytes) at a time: with rotation, their partners half a
// row away and 8 entries of each table.
__device__ void load_rows(const bf16* __restrict__ x, int heads, int head,
                          int b, int r0, int T, const Problem& p, bool rotate,
                          bf16* dst, int ld) {
  const int D = p.D, half = D / 2, nv = D / 8;
  const bool rot = rotate && p.rc != nullptr;
  for (int i = threadIdx.x; i < T * nv; i += blockDim.x) {
    const int r = i / nv, d0 = (i - r * nv) * 8, s = r0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (s < p.S) {
      const bf16* row = x + ((static_cast<size_t>(b) * p.S + s) * heads + head) * D;
      out = *reinterpret_cast<const uint4*>(row + d0);
      if (rot) {
        const uint4 partner =
            *reinterpret_cast<const uint4*>(row + (d0 < half ? d0 + half : d0 - half));
        const size_t t = (static_cast<size_t>(b) * p.S + s) * D + d0;
        const float4 c0 = *reinterpret_cast<const float4*>(p.rc + t);
        const float4 c1 = *reinterpret_cast<const float4*>(p.rc + t + 4);
        const float4 s0 = *reinterpret_cast<const float4*>(p.rs + t);
        const float4 s1 = *reinterpret_cast<const float4*>(p.rs + t + 4);
        const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const bf16* xv = reinterpret_cast<const bf16*>(&out);
        const bf16* xr = reinterpret_cast<const bf16*>(&partner);
        uint4 rotated;
        bf16* ov = reinterpret_cast<bf16*>(&rotated);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ov[j] = __float2bfloat16(rope_mix(__bfloat162float(xv[j]), c[j],
                                            __bfloat162float(xr[j]), sn[j]));
        out = rotated;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + d0) = out;
  }
}

// Elements [d0, d0 + 8) of one row of D rotated by the tables' row: the
// arithmetic of load_rows for one 16-byte chunk (load_rows keeps its own
// copy, so the backward kernels compile as they did).
__device__ __forceinline__ uint4 load8_rotated(const bf16* __restrict__ row, int d0,
                                               int D, const float* __restrict__ rc,
                                               const float* __restrict__ rs) {
  const int half = D / 2;
  const uint4 own = *reinterpret_cast<const uint4*>(row + d0);
  const uint4 partner =
      *reinterpret_cast<const uint4*>(row + (d0 < half ? d0 + half : d0 - half));
  const float4 c0 = *reinterpret_cast<const float4*>(rc + d0);
  const float4 c1 = *reinterpret_cast<const float4*>(rc + d0 + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(rs + d0);
  const float4 s1 = *reinterpret_cast<const float4*>(rs + d0 + 4);
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const bf16* xv = reinterpret_cast<const bf16*>(&own);
  const bf16* xr = reinterpret_cast<const bf16*>(&partner);
  uint4 rotated;
  bf16* ov = reinterpret_cast<bf16*>(&rotated);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    ov[j] = __float2bfloat16(rope_mix(__bfloat162float(xv[j]), c[j],
                                      __bfloat162float(xr[j]), sn[j]));
  return rotated;
}

// The forward's prepass: q [tokens, H, D] and k [tokens, KVH, D] rotated
// by the tables [tokens, D] into q_out and k_out, 8 elements a thread.
__global__ void __launch_bounds__(kThreads)
rope_rotate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const float* __restrict__ rc, const float* __restrict__ rs,
                   bf16* __restrict__ q_out, bf16* __restrict__ k_out, size_t tokens,
                   int H, int KVH, int D) {
  const int nv = D / 8, heads = H + KVH;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= tokens * heads * nv) return;
  const size_t row = i / nv, token = row / heads;
  const int d0 = static_cast<int>(i - row * nv) * 8;
  const int head = static_cast<int>(row - token * heads);
  const bool is_q = head < H;
  const size_t at = is_q ? (token * H + head) * D : (token * KVH + head - H) * D;
  *reinterpret_cast<uint4*>((is_q ? q_out : k_out) + at + d0) =
      load8_rotated((is_q ? q : k) + at, d0, D, rc + token * D, rs + token * D);
}

// Eight consecutive fp32 values stored as bf16 in one 16-byte store.
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 out;
  bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(dst) = out;
}

__device__ void load_seg(const Problem& p, int b, int r0, int T, int* dst) {
  for (int r = threadIdx.x; r < T; r += blockDim.x)
    dst[r] = (p.seg != nullptr && r0 + r < p.S)
                 ? p.seg[static_cast<size_t>(b) * p.S + r0 + r] : 0;
}

// lse or delta rows [r0, r0 + T) of head h, 0 past S.
__device__ void load_stat(const float* __restrict__ x, const Problem& p, int b,
                          int h, int r0, int T, float* dst) {
  for (int r = threadIdx.x; r < T; r += blockDim.x)
    dst[r] = r0 + r < p.S
                 ? x[(static_cast<size_t>(b) * p.H + h) * p.S + r0 + r] : 0.f;
}

__device__ __forceinline__ bool visible(const Problem& p, const int* segq,
                                        const int* segk, int q0, int r, int k0,
                                        int c) {
  const int qi = q0 + r, kj = k0 + c;
  if (qi >= p.S || kj >= p.S) return false;
  if (p.causal && kj > qi) return false;
  return p.seg == nullptr || segq[r] == segk[c];
}

// C[M][N] (fp32, ldc) = (accumulate ? C : 0) + A[M][K] B[K][N] on the
// tensor cores, bf16 operands in shared memory. LA / LB say how A and B
// are stored: row_major A is X[i][k] (lda), col_major A is X[k][i] (the
// transpose of a row-major X); likewise row_major B is X[k][j],
// col_major B is X[j][k]. Each warp takes whole 16x16 output fragments.
template <typename LA, typename LB>
__device__ void gemm(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                     int ldb, int M, int N, int K, bool accumulate) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int tn = N / 16;
  for (int t = warp; t < (M / 16) * tn; t += nwarps) {
    const int i0 = (t / tn) * 16, j0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (accumulate)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bm;
      const bf16* pa;
      const bf16* pb;
      if constexpr (std::is_same<LA, wmma::row_major>::value)
        pa = A + i0 * lda + k0;
      else
        pa = A + k0 * lda + i0;
      if constexpr (std::is_same<LB, wmma::row_major>::value)
        pb = B + k0 * ldb + j0;
      else
        pb = B + j0 * ldb + k0;
      wmma::load_matrix_sync(a, pa, lda);
      wmma::load_matrix_sync(bm, pb, ldb);
      wmma::mma_sync(c, a, bm, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

using RowM = wmma::row_major;
using ColM = wmma::col_major;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element d of an fp32 gradient row for sequence position pos of batch
// b, counter-rotated (table S negated) when the problem has rope tables.
__device__ __forceinline__ float counter_rotated(const Problem& p, const float* row,
                                                 int b, int pos, int d) {
  if (p.rc == nullptr) return row[d];
  const int half = p.D / 2;
  const int dr = d < half ? d + half : d - half;
  const size_t t = (static_cast<size_t>(b) * p.S + pos) * p.D + d;
  return rope_mix(row[d], p.rc[t], row[dr], -p.rs[t]);
}

// -- forward, other head dims --------------------------------------------------
// Block (q-tile, head h, batch b). Online softmax over the live k-tiles;
// the running max m, sum l and output accumulator stay in shared memory.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Problem p, bf16* __restrict__ o,
                 float* __restrict__ lse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = tile_rows(p.D), D = p.D;
  const Layout L(T, D, 1, false);
  bf16* Qs = at<bf16>(smem, L.q);
  bf16* Ks = at<bf16>(smem, L.k);
  bf16* Vs = at<bf16>(smem, L.v);
  float* Ss = at<float>(smem, L.s);
  bf16* Ps = at<bf16>(smem, L.p);
  float* Acc = at<float>(smem, L.acc0);
  float* m_s = at<float>(smem, L.r0);
  float* l_s = at<float>(smem, L.r1);
  int* segq = at<int>(smem, L.segq);
  int* segk = at<int>(smem, L.segk);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KVH);
  const int q0 = qt * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  load_rows(q, p.H, h, b, q0, T, p, true, Qs, L.ldh);
  load_seg(p, b, q0, T, segq);
  for (int i = threadIdx.x; i < T * D; i += blockDim.x)
    Acc[(i / D) * L.ldf + i % D] = 0.f;
  for (int r = threadIdx.x; r < T; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int n_tiles = (p.S + T - 1) / T;
  const int nk = p.causal ? qt + 1 : n_tiles;   // tiles above the diagonal skipped
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    __syncthreads();   // the previous tile's products are done with Ks, Vs, Ps
    load_rows(k, p.KVH, g, b, k0, T, p, true, Ks, L.ldh);
    load_rows(v, p.KVH, g, b, k0, T, p, false, Vs, L.ldh);
    load_seg(p, b, k0, T, segk);
    __syncthreads();
    gemm<RowM, ColM>(Ss, L.lds, Qs, L.ldh, Ks, L.ldh, T, T, D, false);
    __syncthreads();
    // One warp per row: masked scores, new running max, p, the row sum,
    // and the rescale of that row's accumulator.
    for (int r = warp; r < T; r += nwarps) {
      float sv[2];
      float m_cur = kNegInf;
      for (int j = 0; j < T / 32; ++j) {
        const int c = lane + 32 * j;
        const float s = Ss[r * L.lds + c] * p.scale;
        sv[j] = visible(p, segq, segk, q0, r, k0, c) ? s : kNegInf;
        m_cur = fmaxf(m_cur, sv[j]);
      }
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < T / 32; ++j) {
        const int c = lane + 32 * j;
        const float pv = visible(p, segq, segk, q0, r, k0, c) ? expf(sv[j] - m_new) : 0.f;
        Ps[r * L.ldp + c] = __float2bfloat16(pv);
        sum += pv;
      }
      sum = warp_sum(sum);
      for (int d = lane; d < D; d += 32) Acc[r * L.ldf + d] *= alpha;
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    gemm<RowM, RowM>(Acc, L.ldf, Ps, L.ldp, Vs, L.ldh, T, D, T, true);
  }
  __syncthreads();
  const int nv = D / 8;
  for (int i = threadIdx.x; i < T * nv; i += blockDim.x) {
    const int r = i / nv, d0 = (i - r * nv) * 8, row = q0 + r;
    if (row >= p.S) continue;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = Acc[r * L.ldf + d0 + j] / l_safe;
    store8(o + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D + d0, vals);
    if (d0 == 0)
      lse[(static_cast<size_t>(b) * p.H + h) * p.S + row] = m_s[r] + logf(l_safe);
  }
}

// -- forward, head_dim 64 and 128 ------------------------------------------------
constexpr int kFwdRows = 128;      // q-tile and k-tile rows
constexpr int kFwdThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kFwdStages = 2;

// Shared memory of the forward, from a 1024-byte aligned base: the Q
// tile, the stages of K and of V (each a tile of 128 rows, D / 64 panels
// of 128-byte rows), the stages of the k-tile's segment ids and the
// mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int kPanel = kFwdRows * 128;
  static constexpr int kTile = (D / 64) * kPanel;
  static constexpr int q = 0, k = kTile, v = k + kFwdStages * kTile;
  static constexpr int seg = v + kFwdStages * kTile;
  static constexpr int bars = seg + kFwdStages * kFwdRows * 4;   // q_full, kv_full[], kv_empty[]
  static constexpr int bytes = bars + 64 + 1024;                 // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One 128-row tile of head `head`, rows from s0 of batch b, by TMA: a box
// of 64 elements by 128 rows per panel of the tile.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int s0, int b) {
#pragma unroll
  for (int pnl = 0; pnl < D / 64; ++pnl)
    tma_load_4d(dst + pnl * FwdSmem<D>::kPanel, map, bar, 64 * pnl, head, s0, b);
}

// One (q-tile, head, batch) of the forward's work, by its index in the
// order the blocks take them: for a causal problem the q-tiles with the
// most k-tiles first, and the heads of one KV group next to each other.
struct FwdItem {
  int h, b, g, q0, nk;
  __device__ FwdItem(const Problem& p, int item) {
    const int n_tiles = (p.S + kFwdRows - 1) / kFwdRows, per_tile = p.H * p.B;
    const int qt = p.causal ? n_tiles - 1 - item / per_tile : item / per_tile;
    const int rem = item % per_tile;
    h = rem % p.H;
    b = rem / p.H;
    g = h / (p.H / p.KVH);
    q0 = qt * kFwdRows;
    nk = p.causal ? qt + 1 : n_tiles;   // tiles above the diagonal skipped
  }
};

// A persistent block walks the items blockIdx.x, blockIdx.x + gridDim.x,
// ... q and k are already rotated; the tensor maps describe q, k and v as
// [D, heads, S, B]. Warp 8 streams the tiles in by TMA, across item
// boundaries, so the next item's Q and first tiles land under this
// item's last products and epilogue; warps 0-7 are two warpgroups of 64
// q rows each, which wait on a tile's mbarrier and otherwise do not wait
// on each other, so one's softmax runs under the other's products. A
// consumer's accumulator registers [4 j + e] hold row (lane / 4) + 8
// (e / 2) of its warp's 16, column 8 j + 2 (lane % 4) + e % 2.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, Problem p,
                       bf16* __restrict__ o, float* __restrict__ lse, int n_items) {
  using L = FwdSmem<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + L::bars, q_empty = q_full + 8, kv_full = q_empty + 8,
                 kv_empty = kv_full + 8 * kFwdStages;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                // the consumer warps
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(kv_full + 8 * st, 32);    // the producer's lanes
      mbar_init(kv_empty + 8 * st, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // The producer's warpgroup gives its registers to the consumers; its
    // first warp streams each item's Q once the consumers are done with
    // the last one's, then each tile as its stage comes free. Lane 0
    // starts the TMA copies; every lane brings 4 of the tile's segment
    // ids and arrives.
    setmaxnreg_dec<40>();
    if (tid >= 256 + 32) return;
    int t = 0;   // tiles so far, over all items: stage t % stages, use t / stages
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const FwdItem w(p, item);
      if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full, L::kTile);
        tma_tile<D>(base + L::q, &map_q, q_full, w.h, w.q0, w.b);
      }
      for (int j = 0; j < w.nk; ++j, ++t) {
        const int st = t % kFwdStages, k0 = j * kFwdRows;
        if (t >= kFwdStages) mbar_wait(kv_empty + 8 * st, (t / kFwdStages - 1) & 1);
        if (p.seg != nullptr) {
          int* segk = reinterpret_cast<int*>(smem + L::seg) + st * kFwdRows;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 4 * lane + i;
            segk[4 * lane + i] = col < p.S ? p.seg[static_cast<size_t>(w.b) * p.S + col] : 0;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(kv_full + 8 * st, 2 * L::kTile);
          tma_tile<D>(base + L::k + st * L::kTile, &map_k, kv_full + 8 * st, w.g, k0, w.b);
          tma_tile<D>(base + L::v + st * L::kTile, &map_v, kv_full + 8 * st, w.g, k0, w.b);
        } else {
          mbar_arrive(kv_full + 8 * st);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int wg = tid >> 7, quad = lane & 3;
  const int row_lo = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);   // and row_lo + 8
  const float to_log2 = p.scale * kLog2e;
  int t = 0;
  for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
    const FwdItem w(p, item);
    const int q0 = w.q0;
    int segq[2] = {0, 0};
    if (p.seg != nullptr) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = q0 + row_lo + 8 * hh;
        segq[hh] = qi < p.S ? p.seg[static_cast<size_t>(w.b) * p.S + qi] : 0;
      }
    }
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    // Running max of the raw scores (q . k, before the scale) and each
    // thread's share of the running sum; p = 2^(to_log2 * (s - max)).
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

    mbar_wait(q_full, it & 1);
    for (int j = 0; j < w.nk; ++j, ++t) {
      const int st = t % kFwdStages, k0 = j * kFwdRows;
      mbar_wait(kv_full + 8 * st, (t / kFwdStages) & 1);

      float s_acc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            desc_sw128(base + L::q + (kk >> 2) * L::kPanel + wg * 64 * 128) + 2 * (kk & 3);
        const uint64_t db =
            desc_sw128(base + L::k + st * L::kTile + (kk >> 2) * L::kPanel) + 2 * (kk & 3);
        wgmma_bf16_ss_m64n128k16(s_acc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(s_acc);
      if (j == w.nk - 1) {   // this warp has read the item's Q for the last time
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }

      // The mask is compared only where a tile can hold a masked pair: the
      // diagonal tile, a tile that runs past S, any tile under segment ids.
      const bool masked = p.seg != nullptr || (p.causal && k0 + kFwdRows - 1 > q0) ||
                          k0 + kFwdRows > p.S;
      float mx[2] = {kNegInf, kNegInf};
      if (masked) {
        const int* segk = reinterpret_cast<const int*>(smem + L::seg) + st * kFwdRows;
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
          int2 sk2 = make_int2(0, 0);
          if (p.seg != nullptr) sk2 = *reinterpret_cast<const int2*>(segk + 8 * jb + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * jb + 2 * quad + (e & 1);
            const int row = q0 + row_lo + 8 * (e >> 1);
            const bool vis = col < p.S && (!p.causal || col <= row) &&
                             (p.seg == nullptr || segq[e >> 1] == ((e & 1) ? sk2.y : sk2.x));
            s_acc[4 * jb + e] = vis ? s_acc[4 * jb + e] : kNegInf;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
      float alpha[2], m_log2[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
        alpha[hh] = ex2((m_run[hh] - m_new) * to_log2);
        m_run[hh] = m_new;
        m_log2[hh] = m_new * to_log2;
      }
      // A masked score (exactly kNegInf) gives exactly 0 even while the
      // row's max is still kNegInf itself.
      uint32_t pw[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = i & 1;     // s_acc[2 i], s_acc[2 i + 1]: one row, two columns
        float p0 = ex2(fmaf(s_acc[2 * i], to_log2, -m_log2[hh]));
        float p1 = ex2(fmaf(s_acc[2 * i + 1], to_log2, -m_log2[hh]));
        if (masked) {
          p0 = s_acc[2 * i] > 0.5f * kNegInf ? p0 : 0.f;
          p1 = s_acc[2 * i + 1] > 0.5f * kNegInf ? p1 : 0.f;
        }
        sum[hh] += p0 + p1;
        pw[i] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P's words are the A operand of each 16 rows of V.
      fence_registers(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kFwdRows / 16; ++kc) {
        const uint32_t a[4] = {pw[4 * kc], pw[4 * kc + 1], pw[4 * kc + 2], pw[4 * kc + 3]};
        const uint64_t db = desc_sw128(base + L::v + st * L::kTile + kc * 16 * 128, L::kPanel);
        if constexpr (D == 128)
          wgmma_bf16_rs_m64n128k16(o_acc, a, db);
        else
          wgmma_bf16_rs_m64n64k16(o_acc, a, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(o_acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(pw[i])::"memory");   // live until here
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);   // this warp is done with the stage
    }

    float inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = fmaxf(l, 1e-30f);
      inv_l[hh] = 1.0f / l_safe;
      const int row = q0 + row_lo + 8 * hh;
      if (quad == 0 && row < p.S)
        lse[(static_cast<size_t>(w.b) * p.H + w.h) * p.S + row] =
            m_run[hh] * p.scale + logf(l_safe);
    }
#pragma unroll
    for (int gq = 0; gq < D / 32; ++gq) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t wd[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = 4 * (4 * gq + jj) + 2 * hh;
          wd[jj] = pack_bf16(o_acc[i] * inv_l[hh], o_acc[i + 1] * inv_l[hh]);
        }
        quad_transpose(wd, lane);
        const int row = q0 + row_lo + 8 * hh;
        if (row < p.S)
          *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(w.b) * p.S + row) * p.H + w.h) * D +
                                    8 * (4 * gq + quad)) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
  }
}

// -- dk / dv (and, fused, dq) -------------------------------------------------
// Block (k-tile, KV head g, batch b): loops over the KV head's query heads
// and, for each, the q-tiles at or below the diagonal; dk and dv
// accumulate in shared memory. With kDq, each (q-tile, k-tile) pair's
// dq = ds k goes into dq_acc (fp32 [B, S, H, D], rotation space) by
// atomicAdd.
template <bool kDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    Problem p, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ dq_acc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = tile_rows(p.D), D = p.D;
  const Layout L(T, D, kDq ? 3 : 2, true);
  bf16* Qs = at<bf16>(smem, L.q);
  bf16* Ks = at<bf16>(smem, L.k);
  bf16* Vs = at<bf16>(smem, L.v);
  bf16* dOs = at<bf16>(smem, L.dout);
  float* Ss = at<float>(smem, L.s);
  float* dPs = at<float>(smem, L.dp);
  bf16* Pb = at<bf16>(smem, L.p);
  bf16* dSb = at<bf16>(smem, L.ds);
  float* dKacc = at<float>(smem, L.acc0);
  float* dVacc = at<float>(smem, L.acc1);
  float* dQs = at<float>(smem, L.acc2);
  float* lse_s = at<float>(smem, L.r0);
  float* delta_s = at<float>(smem, L.r1);
  int* segq = at<int>(smem, L.segq);
  int* segk = at<int>(smem, L.segk);

  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.KVH;
  const int k0 = kt * T;
  const int n_tiles = (p.S + T - 1) / T;

  load_rows(k, p.KVH, g, b, k0, T, p, true, Ks, L.ldh);
  load_rows(v, p.KVH, g, b, k0, T, p, false, Vs, L.ldh);
  load_seg(p, b, k0, T, segk);
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int o = (i / D) * L.ldf + i % D;
    dKacc[o] = 0.f;
    dVacc[o] = 0.f;
  }
  for (int hr = 0; hr < rep; ++hr) {
    const int h = g * rep + hr;
    for (int qt = p.causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * T;
      __syncthreads();   // the previous pair is done with Qs, dOs, Pb, dSb, dQs
      load_rows(q, p.H, h, b, q0, T, p, true, Qs, L.ldh);
      load_rows(dout, p.H, h, b, q0, T, p, false, dOs, L.ldh);
      load_stat(lse, p, b, h, q0, T, lse_s);
      load_stat(delta, p, b, h, q0, T, delta_s);
      load_seg(p, b, q0, T, segq);
      __syncthreads();
      gemm<RowM, ColM>(Ss, L.lds, Qs, L.ldh, Ks, L.ldh, T, T, D, false);    // q k^T
      gemm<RowM, ColM>(dPs, L.lds, dOs, L.ldh, Vs, L.ldh, T, T, D, false);  // do v^T
      __syncthreads();
      for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
        const int r = i / T, c = i - r * T;
        const float pv = visible(p, segq, segk, q0, r, k0, c)
                             ? expf(Ss[r * L.lds + c] * p.scale - lse_s[r]) : 0.f;
        const float ds = pv * (dPs[r * L.lds + c] - delta_s[r]) * p.scale;
        Pb[r * L.ldp + c] = __float2bfloat16(pv);
        dSb[r * L.ldp + c] = __float2bfloat16(ds);
      }
      __syncthreads();
      gemm<ColM, RowM>(dVacc, L.ldf, Pb, L.ldp, dOs, L.ldh, T, D, T, true);   // p^T do
      gemm<ColM, RowM>(dKacc, L.ldf, dSb, L.ldp, Qs, L.ldh, T, D, T, true);  // ds^T q
      if constexpr (kDq) {
        gemm<RowM, RowM>(dQs, L.ldf, dSb, L.ldp, Ks, L.ldh, T, D, T, false);  // ds k
        __syncthreads();
        for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
          const int r = i / D, d = i - r * D, row = q0 + r;
          if (row < p.S)
            atomicAdd(dq_acc + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D + d,
                      dQs[r * L.ldf + d]);
        }
      }
    }
  }
  __syncthreads();
  const int nv = D / 8;
  for (int i = threadIdx.x; i < T * nv; i += blockDim.x) {
    const int r = i / nv, d0 = (i - r * nv) * 8, row = k0 + r;
    if (row >= p.S) continue;
    const size_t out = ((static_cast<size_t>(b) * p.S + row) * p.KVH + g) * D + d0;
    float vk[8], vv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vk[j] = counter_rotated(p, dKacc + r * L.ldf, b, row, d0 + j);
      vv[j] = dVacc[r * L.ldf + d0 + j];
    }
    store8(dk + out, vk);
    store8(dv + out, vv);
  }
}

// -- dq ---------------------------------------------------------------------
// Block (q-tile, head h, batch b): loops over the live k-tiles; dq
// accumulates in shared memory and is counter-rotated once at the end.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    Problem p, bf16* __restrict__ dq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = tile_rows(p.D), D = p.D;
  const Layout L(T, D, 1, true);
  bf16* Qs = at<bf16>(smem, L.q);
  bf16* Ks = at<bf16>(smem, L.k);
  bf16* Vs = at<bf16>(smem, L.v);
  bf16* dOs = at<bf16>(smem, L.dout);
  float* Ss = at<float>(smem, L.s);
  float* dPs = at<float>(smem, L.dp);
  bf16* dSb = at<bf16>(smem, L.ds);
  float* dQacc = at<float>(smem, L.acc0);
  float* lse_s = at<float>(smem, L.r0);
  float* delta_s = at<float>(smem, L.r1);
  int* segq = at<int>(smem, L.segq);
  int* segk = at<int>(smem, L.segk);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KVH);
  const int q0 = qt * T;
  const int n_tiles = (p.S + T - 1) / T;

  load_rows(q, p.H, h, b, q0, T, p, true, Qs, L.ldh);
  load_rows(dout, p.H, h, b, q0, T, p, false, dOs, L.ldh);
  load_stat(lse, p, b, h, q0, T, lse_s);
  load_stat(delta, p, b, h, q0, T, delta_s);
  load_seg(p, b, q0, T, segq);
  for (int i = threadIdx.x; i < T * D; i += blockDim.x)
    dQacc[(i / D) * L.ldf + i % D] = 0.f;
  const int nk = p.causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    __syncthreads();   // the previous tile's product is done with Ks, dSb
    load_rows(k, p.KVH, g, b, k0, T, p, true, Ks, L.ldh);
    load_rows(v, p.KVH, g, b, k0, T, p, false, Vs, L.ldh);
    load_seg(p, b, k0, T, segk);
    __syncthreads();
    gemm<RowM, ColM>(Ss, L.lds, Qs, L.ldh, Ks, L.ldh, T, T, D, false);
    gemm<RowM, ColM>(dPs, L.lds, dOs, L.ldh, Vs, L.ldh, T, T, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
      const int r = i / T, c = i - r * T;
      const float pv = visible(p, segq, segk, q0, r, k0, c)
                           ? expf(Ss[r * L.lds + c] * p.scale - lse_s[r]) : 0.f;
      dSb[r * L.ldp + c] =
          __float2bfloat16(pv * (dPs[r * L.lds + c] - delta_s[r]) * p.scale);
    }
    __syncthreads();
    gemm<RowM, RowM>(dQacc, L.ldf, dSb, L.ldp, Ks, L.ldh, T, D, T, true);
  }
  __syncthreads();
  const int nv = D / 8;
  for (int i = threadIdx.x; i < T * nv; i += blockDim.x) {
    const int r = i / nv, d0 = (i - r * nv) * 8, row = q0 + r;
    if (row >= p.S) continue;
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      vals[j] = counter_rotated(p, dQacc + r * L.ldf, b, row, d0 + j);
    store8(dq + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D + d0, vals);
  }
}

// -- fused backward, head_dim 64 and 128 ----------------------------------------
// The prepass: delta [B, H, S] = rowsum(dO * O) in fp32 and, for the fused
// backward, the dq scratch zeroed (the two-pass backward passes none),
// one thread per 8 elements of a row, D / 8 lanes a row.
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, float* __restrict__ dq_acc, size_t rows, int S,
                      int H, int D) {
  const int nv = D / 8;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < rows * nv;
  float sum = 0.f;
  const size_t row = i / nv;
  const int d0 = static_cast<int>(i - row * nv) * 8;
  if (live) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + d0);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + row * D + d0);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum = __fadd_rn(sum, __fmul_rn(__bfloat162float(de[j]), __bfloat162float(oe[j])));
    if (dq_acc != nullptr) {
      float4* z = reinterpret_cast<float4*>(dq_acc + row * D + d0);
      z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int off = nv / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (live && d0 == 0) {
    const size_t token = row / H;
    const int h = static_cast<int>(row - token * H);
    const size_t b = token / S, s = token - b * S;
    delta[(b * H + h) * S + s] = sum;
  }
}

// The postprocess: dq [tokens, H, D] bf16 from the fp32 scratch,
// counter-rotated (table S negated) when there are tables, 8 elements a
// thread; rounds like _rope_rot(dq_acc, C, -S).to(bf16).
__global__ void __launch_bounds__(kThreads)
flash_bwd_post_kernel(const float* __restrict__ dq_acc, const float* __restrict__ rc,
                      const float* __restrict__ rs, bf16* __restrict__ dq, size_t tokens, int H,
                      int D) {
  const int nv = D / 8, half = D / 2;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= tokens * H * nv) return;
  const size_t row = i / nv, token = row / H;
  const int d0 = static_cast<int>(i - row * nv) * 8;
  const float* x = dq_acc + row * D;
  float out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = x[d0 + j];
  if (rc != nullptr) {
    const float* xr = x + (d0 < half ? d0 + half : d0 - half);
    const float* c = rc + token * D + d0;
    const float* sn = rs + token * D + d0;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = rope_mix(out[j], c[j], xr[j], -sn[j]);
  }
  store8(dq + row * D + d0, out);
}

constexpr int kBwdKRows = 128;     // k-tile rows: 64 for each consumer warpgroup
constexpr int kBwdQRows = 64;      // q-tile rows
// Two warpgroups and no producer warp: a block's registers are split
// over the SM's four quarters, so a ninth warp caps every thread at 168
// registers (with or without setmaxnreg), and dV and dK alone hold 128 of
// them at head_dim 128. With eight warps the cap is 255.
constexpr int kBwdThreads = 256;
constexpr int kBwdStages = 2;

// A warp counts itself out of a ring stage once it has read the stage for
// the last time; the last of the block's eight warps resets the count and
// runs `refill` (a whole-warp fill of the stage). No warp waits here.
template <typename Refill>
__device__ __forceinline__ void release_stage(int* count, int lane, Refill refill) {
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    __threadfence_block();
    last = atomicAdd(count, 1) == kBwdThreads / 32 - 1;
    if (last) atomicExch(count, 0);
  }
  if (__shfl_sync(0xffffffffu, last, 0)) {
    __threadfence_block();
    refill();
  }
}

// Shared memory of the backward, from a 1024-byte aligned base: the K and
// V tiles (128 rows, D / 64 panels of 128-byte rows), the stages of Q and
// dO (64 rows), with dQ two buffers of dS^T ([128 k][64 q] bf16, one
// 128-byte row a k), the stages' lse, delta and segment ids, and the
// mbarriers and the stages' release counts.
template <int D, bool kDq>
struct BwdSmem {
  static constexpr int kKPanel = kBwdKRows * 128;
  static constexpr int kQPanel = kBwdQRows * 128;
  static constexpr int kKTile = (D / 64) * kKPanel;
  static constexpr int kQTile = (D / 64) * kQPanel;
  static constexpr int kDsBuf = kBwdKRows * 128;
  static constexpr int kSide = 3 * kBwdQRows * 4;
  static constexpr int k = 0, v = kKTile, q = 2 * kKTile;
  static constexpr int dout = q + kBwdStages * kQTile;
  static constexpr int ds = dout + kBwdStages * kQTile;
  static constexpr int side = ds + (kDq ? 2 * kDsBuf : 0);
  static constexpr int bars = side + kBwdStages * kSide;   // kv_full, q_full[], free[]
  static constexpr int bytes = bars + 64 + 1024;           // + alignment slack
};

// `rows` rows of head `head` from s0 of batch b by TMA, one box of 64
// elements per panel of `panel` bytes.
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int s0, int b, int panel) {
#pragma unroll
  for (int pnl = 0; pnl < D / 64; ++pnl) tma_load_4d(dst + pnl * panel, map, bar, 64 * pnl, head, s0, b);
}

// Block (k-tile kt, KV head g, batch b), by index in the order kt-major,
// so a causal problem's k-tiles with the most q-tiles start first. q and
// k are already rotated; the maps describe q, do as [D, H, S, B] in
// boxes of 64 rows and k, v as [D, KVH, S, B] in boxes of 128 rows. Warp
// 0 loads K and V once and fills the two stages with Q, dO, lse, delta
// and the segment ids of each (query head of the group, live q-tile).
// Warpgroup w owns k rows [64 w, 64 w + 64) of the tile: S^T = K Q^T and
// dP^T = V dO^T by wgmma into registers (accumulator [4 j + e]: k row
// (lane / 4) + 8 (e / 2) of its warp's 16, q column 8 j + 2 (lane % 4) +
// e % 2), P^T and dS^T there, dV += P^T dO and dK += dS^T Q with P^T, dS^T
// as register A operands (dV, dK stay in registers over the whole loop).
// With kDq (the fused backward), dS^T goes to shared memory in bf16;
// after a barrier of the two warpgroups, warpgroup w computes dQ = dS K
// for output columns [64 w, 64 w + 64) (D = 128; at D = 64 each its own
// k rows) and adds it into dq_acc by 16-byte reductions, and warp 0
// refills the stage. Without dQ (the two-pass backward's dk/dv pass)
// there is no dS^T buffer and no barrier: each warp counts itself out of
// a stage once its products are done, and the last of the eight refills
// it, so the two warpgroups drift apart and one's exponentials run under
// the other's products.
template <int D, bool kDq>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do, Problem p,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc) {
  using L = BwdSmem<D, kDq>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + L::bars, q_full = kv_full + 8;
  int* free_count = reinterpret_cast<int*>(smem + L::bars + 8 + 8 * kBwdStages);
  const int tid = threadIdx.x, lane = tid & 31;

  const int per_kt = p.KVH * p.B;
  const int kt = blockIdx.x / per_kt, g = blockIdx.x % per_kt % p.KVH,
            b = blockIdx.x % per_kt / p.KVH;
  const int k0 = kt * kBwdKRows, rep = p.H / p.KVH;
  const int n_qt = (p.S + kBwdQRows - 1) / kBwdQRows;
  const int qt0 = p.causal ? k0 / kBwdQRows : 0;   // q-tiles wholly above the diagonal skipped
  const int n_q = n_qt - qt0, total = rep * n_q;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      // The 32 lanes' arrivals (lane 0's with the TMA bytes); without dQ
      // one more, lane 0's cp.async arrival.
      mbar_init(q_full + 8 * st, kDq ? 32 : 33);
      free_count[st] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A whole warp fills stage t % 2 with item t: lse, delta and the segment
  // ids of its 64 q rows (two a lane), and Q and dO by TMA. Without dQ the
  // side rows come by cp.async, so the warp that refills (whichever is
  // last out of the stage) does not wait on their loads.
  auto fill = [&](int t) {
    const int st = t % kBwdStages, h = g * rep + t / n_q, q0 = (qt0 + t % n_q) * kBwdQRows;
    const uint32_t side = base + L::side + st * L::kSide;
    float* side_p = reinterpret_cast<float*>(smem + L::side + st * L::kSide);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane + 32 * i, row = q0 + r;
      const bool in = row < p.S, in_seg = in && p.seg != nullptr;
      const size_t at = in ? (static_cast<size_t>(b) * p.H + h) * p.S + row : 0;
      const int* seg_at = in_seg ? p.seg + static_cast<size_t>(b) * p.S + row : nullptr;
      if constexpr (kDq) {
        side_p[r] = in ? lse[at] : 0.f;
        side_p[kBwdQRows + r] = in ? delta[at] : 0.f;
        reinterpret_cast<int*>(side_p)[2 * kBwdQRows + r] = in_seg ? *seg_at : 0;
      } else {
        cp_async4_zfill(side + 4 * r, lse + at, in);
        cp_async4_zfill(side + 4 * (kBwdQRows + r), delta + at, in);
        cp_async4_zfill(side + 4 * (2 * kBwdQRows + r),
                        in_seg ? static_cast<const void*>(seg_at) : static_cast<const void*>(lse),
                        in_seg);
      }
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full + 8 * st, 2 * L::kQTile);
      tma_rows<D>(base + L::q + st * L::kQTile, &map_q, q_full + 8 * st, h, q0, b, L::kQPanel);
      tma_rows<D>(base + L::dout + st * L::kQTile, &map_do, q_full + 8 * st, h, q0, b,
                  L::kQPanel);
    } else if constexpr (kDq) {
      mbar_arrive(q_full + 8 * st);
    }
    if constexpr (!kDq) cp_async_mbar_arrive(q_full + 8 * st);
  };
  if (tid < 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKTile);
      tma_rows<D>(base + L::k, &map_k, kv_full, g, k0, b, L::kKPanel);
      tma_rows<D>(base + L::v, &map_v, kv_full, g, k0, b, L::kKPanel);
    }
    for (int t = 0; t < kBwdStages && t < total; ++t) fill(t);
  }

  const int wg = tid >> 7, wq = (tid >> 5) & 3, quad = lane & 3;
  const int lrow = wg * 64 + wq * 16 + (lane >> 2);   // tile-local k row, and lrow + 8
  const int k_lo = k0 + lrow;
  int segk[2] = {0, 0};
  if (p.seg != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      segk[hh] = k_lo + 8 * hh < p.S ? p.seg[static_cast<size_t>(b) * p.S + k_lo + 8 * hh] : 0;
  }
  const float to_log2 = p.scale * kLog2e;
  // With dQ, this warpgroup's share of it: all 128 k rows and output
  // columns [64 wg, 64 wg + 64) at D = 128; its own 64 k rows and all 64
  // columns at D = 64.
  constexpr int kDqSteps = D == 128 ? 8 : 4;
  const int dq_row0 = D == 128 ? 0 : wg * 64, dq_panel = D == 128 ? wg : 0;

  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < total; ++t) {
    const int st = t % kBwdStages, h = g * rep + t / n_q, q0 = (qt0 + t % n_q) * kBwdQRows;
    mbar_wait(q_full + 8 * st, (t / kBwdStages) & 1);
    // The shared base, opaque to the compiler in each iteration: the
    // descriptors of the K and V tiles do not change over the loop, and
    // hoisted out of it they would hold ~50 registers all the way.
    uint32_t sbase = base;
    asm volatile("" : "+r"(sbase));
    const uint32_t q_s = sbase + L::q + st * L::kQTile, do_s = sbase + L::dout + st * L::kQTile;

    // P^T = exp(S^T scale - lse[q]) and dS^T = P^T (dP^T - delta[q]) scale,
    // masked pairs exactly 0: the diagonal tile, a tile past S (rows TMA
    // zero-filled; lse and delta read as 0 there), any tile under segment
    // ids. In two halves of 32 q columns, so that S^T and dP^T hold 32
    // registers beside dV and dK.
    const float* side = reinterpret_cast<const float*>(smem + L::side + st * L::kSide);
    const int* segq = reinterpret_cast<const int*>(side) + 2 * kBwdQRows;
    const int kw0 = k0 + wg * 64;
    const bool masked = p.seg != nullptr || (p.causal && q0 < kw0 + 63) ||
                        q0 + kBwdQRows > p.S || kw0 + 64 > p.S;
    uint32_t pw[16], dsw[16];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t hb = sbase;   // descriptors made here, not ahead of the last wait
      asm volatile("" : "+r"(hb));
      const uint32_t qh = hb + L::q + st * L::kQTile + half * 32 * 128;
      const uint32_t doh = hb + L::dout + st * L::kQTile + half * 32 * 128;
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * L::kKPanel + wg * 64 * 128;
        wgmma_bf16_ss_m64n32k16<0, 0>(s, desc_sw128(hb + L::k + off) + 2 * (kk & 3),
                                      desc_sw128(qh + (kk >> 2) * L::kQPanel) + 2 * (kk & 3),
                                      kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * L::kKPanel + wg * 64 * 128;
        wgmma_bf16_ss_m64n32k16<0, 0>(dp, desc_sw128(hb + L::v + off) + 2 * (kk & 3),
                                      desc_sw128(doh + (kk >> 2) * L::kQPanel) + 2 * (kk & 3),
                                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(s);
      fence_registers(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * half + 8 * j + 2 * quad, jg = 4 * half + j;
        const float2 l2 = *reinterpret_cast<const float2*>(side + c);
        const float2 d2 = *reinterpret_cast<const float2*>(side + kBwdQRows + c);
        const int2 sq = *reinterpret_cast<const int2*>(segq + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, odd = e & 1;
          bool vis = true;
          if (masked) {
            const int qi = q0 + c + odd, kj = k_lo + 8 * hh;
            vis = qi < p.S && kj < p.S && (!p.causal || kj <= qi) &&
                  (p.seg == nullptr || segk[hh] == (odd ? sq.y : sq.x));
          }
          const float lse_q = odd ? l2.y : l2.x, delta_q = odd ? d2.y : d2.x;
          const float pv = vis ? ex2(fmaf(s[4 * j + e], to_log2, -lse_q * kLog2e)) : 0.f;
          s[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - delta_q) * p.scale;
        }
        pw[2 * jg] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pw[2 * jg + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        dsw[2 * jg] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
        dsw[2 * jg + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }
    }
    if constexpr (kDq) {
      // dS^T into buffer t % 2: row = k, 64 q columns of 128 bytes.
      unsigned char* dsb = smem + L::ds + (t & 1) * L::kDsBuf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(dsb + swizzle_chunk(lrow + 8 * hh, j) + 4 * quad) =
              dsw[2 * j + hh];
      fence_async_proxy();
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows: the
    // registers are the A operand, dO and Q MN-major B.
    fence_registers(dv_acc);
    fence_registers(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBwdQRows / 16; ++kc) {
      const uint32_t a[4] = {pw[4 * kc], pw[4 * kc + 1], pw[4 * kc + 2], pw[4 * kc + 3]};
      const uint64_t db = desc_sw128(do_s + kc * 16 * 128, L::kQPanel);
      if constexpr (D == 128)
        wgmma_bf16_rs_m64n128k16(dv_acc, a, db);
      else
        wgmma_bf16_rs_m64n64k16(dv_acc, a, db);
    }
#pragma unroll
    for (int kc = 0; kc < kBwdQRows / 16; ++kc) {
      const uint32_t a[4] = {dsw[4 * kc], dsw[4 * kc + 1], dsw[4 * kc + 2], dsw[4 * kc + 3]};
      const uint64_t db = desc_sw128(q_s + kc * 16 * 128, L::kQPanel);
      if constexpr (D == 128)
        wgmma_bf16_rs_m64n128k16(dk_acc, a, db);
      else
        wgmma_bf16_rs_m64n64k16(dk_acc, a, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(dv_acc);
    fence_registers(dk_acc);
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(pw[i]), "+r"(dsw[i])::"memory");

    if constexpr (!kDq) {
      // This warp is done with the stage; the last of the eight refills
      // it with item t + 2.
      release_stage(free_count + st, lane, [&] {
        if (t + kBwdStages < total) fill(t + kBwdStages);
      });
      continue;
    }
    // dQ = dS K once both warpgroups' dS^T are in: dS^T is an MN-major A,
    // K an MN-major B. Past this barrier every warp is done with the
    // stage, and warp 0 refills it with item t + 2.
    named_barrier(1, 256);
    if (tid < 32 && t + kBwdStages < total) fill(t + kBwdStages);
    uint32_t qb = sbase;
    asm volatile("" : "+r"(qb));
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDqSteps; ++kc) {
      const uint32_t row = (dq_row0 + 16 * kc) * 128;
      wgmma_bf16_ss_m64n64k16<1, 1>(
          dq, desc_sw128(qb + L::ds + (t & 1) * L::kDsBuf + row, L::kDsBuf),
          desc_sw128(qb + L::k + dq_panel * L::kKPanel + row, L::kKPanel), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(dq);
    // Pairs of 8-column blocks: the even lane of two neighbours adds
    // block j's four columns, the odd one block j + 1's.
    const int odd = quad & 1;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float a0 = dq[4 * j + 2 * hh], a1 = dq[4 * j + 2 * hh + 1];
        const float b0 = dq[4 * j + 4 + 2 * hh], b1 = dq[4 * j + 4 + 2 * hh + 1];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const int qi = q0 + wq * 16 + (lane >> 2) + 8 * hh;
        const int col = (D == 128 ? 64 * wg : 0) + 8 * (j + odd) + 2 * (quad - odd);
        if (qi < p.S) {
          float* dst = dq_acc + ((static_cast<size_t>(b) * p.S + qi) * p.H + h) * D + col;
          add_v4_f32(dst, odd ? r0 : a0, odd ? r1 : a1, odd ? b0 : r0, odd ? b1 : r1);
        }
      }
    }
  }

  // Epilogue: dK counter-rotated from registers (element d and d +- D/2
  // of a row are this thread's blocks j and j +- D/16), dV as it is.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k_lo + 8 * hh;
    if (row >= p.S) continue;
    const size_t out = ((static_cast<size_t>(b) * p.S + row) * p.KVH + g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * quad, i = 4 * j + 2 * hh;
      float x0 = dk_acc[i], x1 = dk_acc[i + 1];
      if (p.rc != nullptr) {
        const int ir = 4 * ((j + D / 16) % (D / 8)) + 2 * hh;
        const size_t tt = (static_cast<size_t>(b) * p.S + row) * D + d;
        const float2 c2 = *reinterpret_cast<const float2*>(p.rc + tt);
        const float2 s2 = *reinterpret_cast<const float2*>(p.rs + tt);
        x0 = rope_mix(dk_acc[i], c2.x, dk_acc[ir], -s2.x);
        x1 = rope_mix(dk_acc[i + 1], c2.y, dk_acc[ir + 1], -s2.y);
      }
      *reinterpret_cast<uint32_t*>(dk + out + d) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(dv + out + d) = pack_bf16(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// -- two-pass dq, head_dim 64 and 128 ---------------------------------------------
// The mirror of the dk/dv pass: a block owns a 128-row q-tile of one head
// (64 rows for each warpgroup), loads Q and dO once and streams the KV
// head's k-tiles (64 rows) through a TMA ring. dQ stays in fp32 registers
// over the whole walk, so the pass needs no scratch and no atomics, and
// its sums run in one fixed order (dq is the same bits run to run).
constexpr int kDqQRows = 128;   // q-tile rows: 64 for each consumer warpgroup
constexpr int kDqKRows = 64;    // k-tile rows
constexpr int kDqStages = 3;

// Shared memory of the dq pass, from a 1024-byte aligned base: the Q and
// dO tiles (128 rows, D / 64 panels of 128-byte rows), the stages of K
// and V (64 rows) and of the k-tile's segment ids, the mbarriers and the
// stages' release counts.
template <int D>
struct DqSmem {
  static constexpr int kQPanel = kDqQRows * 128;
  static constexpr int kKPanel = kDqKRows * 128;
  static constexpr int kQTile = (D / 64) * kQPanel;
  static constexpr int kKTile = (D / 64) * kKPanel;
  static constexpr int q = 0, dout = kQTile, k = 2 * kQTile;
  static constexpr int v = k + kDqStages * kKTile;
  static constexpr int seg = v + kDqStages * kKTile;
  static constexpr int bars = seg + kDqStages * kDqKRows * 4;   // q_full, kv_full[], free[]
  static constexpr int bytes = bars + 64 + 1024;               // + alignment slack
};

// The block's (q-tile, head, batch), by index: for a causal problem the
// q-tiles with the most k-tiles first, the heads of one KV group next to
// each other (their K and V stay in L2). nk: the k-tiles the block
// streams (the second warpgroup's live ones).
struct DqItem {
  int h, b, g, q0, nk, n_kt;
  __device__ DqItem(const Problem& p, int item) {
    const int n_qt = (p.S + kDqQRows - 1) / kDqQRows, per_tile = p.H * p.B;
    const int qt = p.causal ? n_qt - 1 - item / per_tile : item / per_tile;
    const int rem = item % per_tile;
    h = rem % p.H;
    b = rem / p.H;
    g = h / (p.H / p.KVH);
    q0 = qt * kDqQRows;
    n_kt = (p.S + kDqKRows - 1) / kDqKRows;
    nk = p.causal ? min(n_kt, q0 / kDqKRows + 2) : n_kt;   // tiles above the diagonal skipped
  }
};

// Block (q-tile, head h, batch b); q and k already rotated; the maps
// describe q, do as [D, H, S, B] in boxes of 128 rows and k, v as [D, KVH,
// S, B] in boxes of 64 rows. Warp 0 loads Q and dO and fills the first
// stages; afterwards the last warp to be done with a stage refills it
// (release_stage). Warpgroup w owns q rows [64 w, 64 w + 64): per live
// k-tile S = Q K^T and dP = dO V^T by wgmma into registers (accumulator
// [4 j + e]: q row (lane / 4) + 8 (e / 2) of its warp's 16, k column 8 j
// + 2 (lane % 4) + e % 2), P = exp2(S scale log2e - lse log2e) and dS = P
// (dP - delta) scale there, masks compared only on diagonal, ragged or
// segmented tiles, then dQ += dS K with dS as the register A operand and
// K MN-major B. Under a causal mask the first warpgroup's last streamed
// tile lies wholly above its diagonal: it skips it. The epilogue
// counter-rotates dQ from registers and casts it.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, Problem p,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq) {
  using L = DqSmem<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + L::bars, kv_full = q_full + 8;
  int* free_count = reinterpret_cast<int*>(smem + L::bars + 8 + 8 * kDqStages);
  const int tid = threadIdx.x, lane = tid & 31;
  const DqItem w(p, blockIdx.x);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(kv_full + 8 * st, 33);   // lane 0's expect_tx and the 32 lanes' cp.async
      free_count[st] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A whole warp fills stage j % stages with k-tile j: K and V by TMA, the
  // tile's 64 segment ids (two a lane) by cp.async.
  auto fill = [&](int j) {
    const int st = j % kDqStages, k0 = j * kDqKRows;
    const uint32_t segs = base + L::seg + st * kDqKRows * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i, col = k0 + c;
      const bool in = p.seg != nullptr && col < p.S;
      cp_async4_zfill(segs + 4 * c,
                      in ? static_cast<const void*>(p.seg + static_cast<size_t>(w.b) * p.S + col)
                         : static_cast<const void*>(lse),
                      in);
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full + 8 * st, 2 * L::kKTile);
      tma_rows<D>(base + L::k + st * L::kKTile, &map_k, kv_full + 8 * st, w.g, k0, w.b,
                  L::kKPanel);
      tma_rows<D>(base + L::v + st * L::kKTile, &map_v, kv_full + 8 * st, w.g, k0, w.b,
                  L::kKPanel);
    }
    cp_async_mbar_arrive(kv_full + 8 * st);
  };
  if (tid < 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::kQTile);
      tma_rows<D>(base + L::q, &map_q, q_full, w.h, w.q0, w.b, L::kQPanel);
      tma_rows<D>(base + L::dout, &map_do, q_full, w.h, w.q0, w.b, L::kQPanel);
    }
    for (int j = 0; j < kDqStages && j < w.nk; ++j) fill(j);
  }

  const int wg = tid >> 7, wq = (tid >> 5) & 3, quad = lane & 3;
  const int q_lo = w.q0 + wg * 64 + wq * 16 + (lane >> 2);   // this thread's q rows: q_lo, q_lo + 8
  const int qw0 = w.q0 + wg * 64;                            // the warpgroup's first row
  float lse2[2], dl[2];
  int segq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q_lo + 8 * hh;
    const bool in = row < p.S;
    const size_t at = (static_cast<size_t>(w.b) * p.H + w.h) * p.S + row;
    lse2[hh] = in ? lse[at] * kLog2e : 0.f;
    dl[hh] = in ? delta[at] : 0.f;
    segq[hh] = in && p.seg != nullptr ? p.seg[static_cast<size_t>(w.b) * p.S + row] : 0;
  }
  const int nk_w = p.causal ? min(w.n_kt, w.q0 / kDqKRows + wg + 1) : w.n_kt;
  const float to_log2 = p.scale * kLog2e;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < w.nk; ++j) {
    const int st = j % kDqStages, k0 = j * kDqKRows;
    if (j < nk_w) {
      mbar_wait(kv_full + 8 * st, (j / kDqStages) & 1);
      // The shared base, opaque to the compiler in each iteration, so the
      // descriptors are made here and not held across the loop.
      uint32_t sb = base;
      asm volatile("" : "+r"(sb));
      const uint32_t k_s = sb + L::k + st * L::kKTile, v_s = sb + L::v + st * L::kKTile;
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qo = (kk >> 2) * L::kQPanel + wg * 64 * 128, ko = (kk >> 2) * L::kKPanel;
        wgmma_bf16_ss_m64n64k16<0, 0>(s, desc_sw128(sb + L::q + qo) + 2 * (kk & 3),
                                      desc_sw128(k_s + ko) + 2 * (kk & 3), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qo = (kk >> 2) * L::kQPanel + wg * 64 * 128, ko = (kk >> 2) * L::kKPanel;
        wgmma_bf16_ss_m64n64k16<0, 0>(dp, desc_sw128(sb + L::dout + qo) + 2 * (kk & 3),
                                      desc_sw128(v_s + ko) + 2 * (kk & 3), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(s);
      fence_registers(dp);

      // P and dS; masked pairs exactly 0: the diagonal tile, a tile past S
      // (rows TMA zero-filled), any tile under segment ids.
      const bool masked = p.seg != nullptr || (p.causal && k0 + kDqKRows - 1 > qw0) ||
                          k0 + kDqKRows > p.S || qw0 + 64 > p.S;
      const int* segk = reinterpret_cast<const int*>(smem + L::seg) + st * kDqKRows;
      uint32_t dsw[16];
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        int2 sk = make_int2(0, 0);
        if (p.seg != nullptr) sk = *reinterpret_cast<const int2*>(segk + 8 * jb + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, odd = e & 1;
          bool vis = true;
          if (masked) {
            const int col = k0 + 8 * jb + 2 * quad + odd, row = q_lo + 8 * hh;
            vis = row < p.S && col < p.S && (!p.causal || col <= row) &&
                  (p.seg == nullptr || segq[hh] == (odd ? sk.y : sk.x));
          }
          const float pv = vis ? ex2(fmaf(s[4 * jb + e], to_log2, -lse2[hh])) : 0.f;
          s[4 * jb + e] = pv * (dp[4 * jb + e] - dl[hh]) * p.scale;
        }
        dsw[2 * jb] = pack_bf16(s[4 * jb], s[4 * jb + 1]);
        dsw[2 * jb + 1] = pack_bf16(s[4 * jb + 2], s[4 * jb + 3]);
      }

      // dQ += dS K: dS's words are the A operand of each 16 rows of K.
      fence_registers(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kDqKRows / 16; ++kc) {
        const uint32_t a[4] = {dsw[4 * kc], dsw[4 * kc + 1], dsw[4 * kc + 2], dsw[4 * kc + 3]};
        const uint64_t db = desc_sw128(k_s + kc * 16 * 128, L::kKPanel);
        if constexpr (D == 128)
          wgmma_bf16_rs_m64n128k16(dq_acc, a, db);
        else
          wgmma_bf16_rs_m64n64k16(dq_acc, a, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(dq_acc);
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(dsw[i])::"memory");   // live until here
    }
    release_stage(free_count + st, lane, [&] {
      if (j + kDqStages < w.nk) fill(j + kDqStages);
    });
  }

  // Epilogue: dQ counter-rotated from registers (element d and d +- D/2 of
  // a row are this thread's blocks j and j +- D/16) and cast.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q_lo + 8 * hh;
    if (row >= p.S) continue;
    const size_t out = ((static_cast<size_t>(w.b) * p.S + row) * p.H + w.h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int d = 8 * jj + 2 * quad, i = 4 * jj + 2 * hh;
      float x0 = dq_acc[i], x1 = dq_acc[i + 1];
      if (p.rc != nullptr) {
        const int ir = 4 * ((jj + D / 16) % (D / 8)) + 2 * hh;
        const size_t tt = (static_cast<size_t>(w.b) * p.S + row) * D + d;
        const float2 c2 = *reinterpret_cast<const float2*>(p.rc + tt);
        const float2 s2 = *reinterpret_cast<const float2*>(p.rs + tt);
        x0 = rope_mix(dq_acc[i], c2.x, dq_acc[ir], -s2.x);
        x1 = rope_mix(dq_acc[i + 1], c2.y, dq_acc[ir + 1], -s2.y);
      }
      *reinterpret_cast<uint32_t*>(dq + out + d) = pack_bf16(x0, x1);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool make_problem(Problem* p, int B, int S, int H, int KVH, int D, float scale,
                  int causal, const void* seg, const void* rc, const void* rs) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || D % 16 != 0 || D <= 0 ||
      D > 256 || (rc == nullptr) != (rs == nullptr))
    return false;
  *p = Problem{B, S, H, KVH, D, scale, causal, static_cast<const int*>(seg),
               static_cast<const float*>(rc), static_cast<const float*>(rs)};
  return true;
}

}  // namespace

// q bf16 [tokens, H, D] and k bf16 [tokens, KVH, D] rotated by the fp32
// tables [tokens, D] into q_out and k_out (the forward's prepass).
extern "C" int kfc_rope_rotate(const void* q, const void* k, const void* rope_c,
                               const void* rope_s, void* q_out, void* k_out, int tokens,
                               int H, int KVH, int D, void* stream) {
  if (tokens <= 0 || H <= 0 || KVH <= 0 || D <= 0 || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(tokens) * (H + KVH) * (D / 8);
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  rope_rotate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const float*>(rope_c), static_cast<const float*>(rope_s),
      static_cast<bf16*>(q_out), static_cast<bf16*>(k_out),
      static_cast<size_t>(tokens), H, KVH, D);
  return static_cast<int>(cudaGetLastError());
}

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime (the
// library links against no stub of it).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      found = nullptr;
    return reinterpret_cast<EncodeTiled>(found);
  }();
  return fn;
}

// x bf16 [B, S, heads, D] as the tensor [D, heads, S, B] cut into boxes of
// 64 elements by `rows` rows of S, written under the 128-byte swizzle.
bool tile_map(CUtensorMap* map, const void* x, int B, int S, int heads, int D,
              int rows = kFwdRows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const Problem& p,
                     bf16* o, float* lse, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!tile_map(&map_q, q, p.B, p.S, p.H, D) || !tile_map(&map_k, k, p.B, p.S, p.KVH, D) ||
      !tile_map(&map_v, v, p.B, p.S, p.KVH, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(flash_fwd_wgmma_kernel<D>, FwdSmem<D>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_items = (p.S + kFwdRows - 1) / kFwdRows * p.H * p.B;
  flash_fwd_wgmma_kernel<D><<<n_items < sms ? n_items : sms, kFwdThreads, FwdSmem<D>::bytes,
                              stream>>>(map_q, map_k, map_v, p, o, lse, n_items);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDq>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const Problem& p, const float* lse, const float* delta, bf16* dk, bf16* dv,
                     float* dq_acc, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tile_map(&map_q, q, p.B, p.S, p.H, D, kBwdQRows) ||
      !tile_map(&map_k, k, p.B, p.S, p.KVH, D, kBwdKRows) ||
      !tile_map(&map_v, v, p.B, p.S, p.KVH, D, kBwdKRows) ||
      !tile_map(&map_do, dout, p.B, p.S, p.H, D, kBwdQRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(flash_bwd_wgmma_kernel<D, kDq>, BwdSmem<D, kDq>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (p.S + kBwdKRows - 1) / kBwdKRows * p.KVH * p.B;
  flash_bwd_wgmma_kernel<D, kDq><<<n_items, kBwdThreads, BwdSmem<D, kDq>::bytes, stream>>>(
      map_q, map_k, map_v, map_do, p, lse, delta, dk, dv, dq_acc);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const Problem& p, const float* lse, const float* delta, bf16* dq,
                    cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tile_map(&map_q, q, p.B, p.S, p.H, D, kDqQRows) ||
      !tile_map(&map_k, k, p.B, p.S, p.KVH, D, kDqKRows) ||
      !tile_map(&map_v, v, p.B, p.S, p.KVH, D, kDqKRows) ||
      !tile_map(&map_do, dout, p.B, p.S, p.H, D, kDqQRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(flash_bwd_dq_wgmma_kernel<D>, DqSmem<D>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (p.S + kDqQRows - 1) / kDqQRows * p.H * p.B;
  flash_bwd_dq_wgmma_kernel<D><<<n_items, kBwdThreads, DqSmem<D>::bytes, stream>>>(
      map_q, map_k, map_v, map_do, p, lse, delta, dq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors bf16 unless named: lse, delta, rope tables and dq_acc fp32,
// segment ids int32. seg, rope_c/rope_s and dq_acc may be null. The
// forward picks its kernel by head_dim: 64 and 128 take the wgmma kernel,
// which wants q and k already rotated (kfc_rope_rotate) and refuses
// tables; every other head_dim takes the first kernel, which rotates on
// load.
extern "C" int kfc_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* rope_c,
                             const void* rope_s, void* o, void* lse, int B,
                             int S, int H, int KVH, int D, float scale,
                             int causal, void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) {
    if (rope_c != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? launch_fwd_wgmma<64>(q, k, v, p, static_cast<bf16*>(o),
                                          static_cast<float*>(lse), st)
                   : launch_fwd_wgmma<128>(q, k, v, p, static_cast<bf16*>(o),
                                           static_cast<float*>(lse), st);
  }
  const int T = tile_rows(D);
  const size_t bytes = Layout(T, D, 1, false).bytes;
  cudaError_t err = prepare(flash_fwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<<<dim3((S + T - 1) / T, H, B), kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), p, static_cast<bf16*>(o),
      static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// dq_acc null: the two-pass backward's dk/dv pass; else the first fused
// backward (head dims other than 64 and 128), adding dq (rotation space)
// into dq_acc (fp32 [B, S, H, D], zeroed by the caller). At head_dim 64
// and 128 the pass is the warpgroup kernel without dQ: q and k already
// rotated (kfc_rope_rotate), the tables only counter-rotate dk, and
// dq_acc must be null.
extern "C" int kfc_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg,
                                const void* rope_c, const void* rope_s, void* dk,
                                void* dv, void* dq_acc, int B, int S, int H,
                                int KVH, int D, float scale, int causal,
                                void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) {
    if (dq_acc != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    bf16* dkp = static_cast<bf16*>(dk);
    bf16* dvp = static_cast<bf16*>(dv);
    return D == 64 ? launch_bwd_wgmma<64, false>(q, k, v, dout, p, l, dl, dkp, dvp, nullptr, st)
                   : launch_bwd_wgmma<128, false>(q, k, v, dout, p, l, dl, dkp, dvp, nullptr, st);
  }
  const int T = tile_rows(D);
  const dim3 grid((S + T - 1) / T, KVH, B);
  if (dq_acc != nullptr) {
    const size_t bytes = Layout(T, D, 3, true).bytes;
    cudaError_t err = prepare(flash_bwd_kv_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_kv_kernel<true><<<grid, kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), p,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dq_acc));
  } else {
    const size_t bytes = Layout(T, D, 2, true).bytes;
    cudaError_t err = prepare(flash_bwd_kv_kernel<false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_kv_kernel<false><<<grid, kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), p,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two-pass backward's dq pass. At head_dim 64 and 128 the warpgroup
// kernel: q and k already rotated (kfc_rope_rotate), the tables only
// counter-rotate dq; every other head_dim the first kernel, which rotates
// on load.
extern "C" int kfc_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg,
                                const void* rope_c, const void* rope_s, void* dq,
                                int B, int S, int H, int KVH, int D, float scale,
                                int causal, void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 || D == 128) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    bf16* dqp = static_cast<bf16*>(dq);
    return D == 64 ? launch_dq_wgmma<64>(q, k, v, dout, p, l, dl, dqp, st)
                   : launch_dq_wgmma<128>(q, k, v, dout, p, l, dl, dqp, st);
  }
  const int T = tile_rows(D);
  const size_t bytes = Layout(T, D, 1, true).bytes;
  cudaError_t err = prepare(flash_bwd_dq_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((S + T - 1) / T, H, B), kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), p,
      static_cast<bf16*>(dq));
  return static_cast<int>(cudaGetLastError());
}

// The backward's prepass: delta fp32 [B, H, S] = rowsum(dout * o) of o,
// dout bf16 [B, S, H, D], and dq_acc fp32 [B, S, H, D] zeroed unless null
// (the two-pass backward's dq pass needs no scratch).
extern "C" int kfc_flash_bwd_prep(const void* o, const void* dout, void* delta, void* dq_acc,
                                  int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(B) * S * H;
  const size_t blocks = (rows * (D / 8) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_prep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      static_cast<float*>(dq_acc), rows, S, H, D);
  return static_cast<int>(cudaGetLastError());
}

// The fused backward's postprocess: dq bf16 [tokens, H, D] from dq_acc
// fp32, counter-rotated by the tables [tokens, D] (both null: a cast).
extern "C" int kfc_flash_bwd_post(const void* dq_acc, const void* rope_c, const void* rope_s,
                                  void* dq, int tokens, int H, int D, void* stream) {
  if (tokens <= 0 || H <= 0 || D <= 0 || D % 16 || (rope_c == nullptr) != (rope_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(tokens) * H * (D / 8);
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_post_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(rope_c),
      static_cast<const float*>(rope_s), static_cast<bf16*>(dq), static_cast<size_t>(tokens), H,
      D);
  return static_cast<int>(cudaGetLastError());
}

// The fused backward at head_dim 64 and 128: q and k already rotated
// (kfc_rope_rotate); the tables, when given, only counter-rotate dk.
// dq_acc (fp32 [B, S, H, D], zeroed by kfc_flash_bwd_prep) receives dq
// in rotation space, for kfc_flash_bwd_post.
extern "C" int kfc_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* seg, const void* rope_c, const void* rope_s,
                                   void* dk, void* dv, void* dq_acc, int B, int S, int H,
                                   int KVH, int D, float scale, int causal, void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s) ||
      (D != 64 && D != 128) || dq_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* acc = static_cast<float*>(dq_acc);
  return D == 64 ? launch_bwd_wgmma<64, true>(q, k, v, dout, p, l, dl, dkp, dvp, acc, st)
                 : launch_bwd_wgmma<128, true>(q, k, v, dout, p, l, dl, dkp, dvp, acc, st);
}

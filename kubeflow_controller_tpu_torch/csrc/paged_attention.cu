// Paged attention for the serving engine, written by hand for Hopper (sm_90a).
//
// Two kernels, one per attention phase of the engine:
//
// * paged_decode_kernel replaces the Pallas kernel
//   kubeflow_controller_tpu/ops/paged_attention_pallas.py:72 _decode_kernel
//   (launched from paged_attention_decode :129). One query group
//   [rep, D] per (slot, KV head) attends the slot's table-resolved pool
//   pages, columns c <= pos[b].
// * paged_chunk_kernel replaces
//   kubeflow_controller_tpu/ops/paged_attention_pallas.py:223 _chunk_kernel
//   (launched from _paged_chunk_attention :308, behind
//   paged_attention_prefill :403 and paged_attention_verify :448).
//   W*rep query rows per (slot, KV head) attend the chunk's own fresh K/V
//   as a causal tile (column c visible to row r iff c <= r / rep), then
//   the slot's cached pool columns c < pos[b].
//
// What bounds them on an H100: the KV bytes. Each (slot, head) reads its
// pages once and does 4*rep (decode) or 4*W*rep (chunk) flops per KV
// element, far below the ~295 flops/byte at which the tensor cores would
// become the limit. The design therefore reads every page exactly once,
// in place through the block table: no dense [B, S, KVH, D] view is ever
// written and read back (the gather path moves each KV byte three times),
// and int8 pages are dequantized inside the tile load, so a quantized
// pool never has an fp copy either.
//
// The TPU kernel carried its online-softmax state from one grid step to
// the next; on Hopper blocks run in no order, so the page walk is a loop
// inside one block. Each block (slot b, KV head g) reads its own table
// entries and clamps sentinel ids (== n_blocks, "unallocated") to the
// last real page; those columns are masked by the position test, so the
// bytes never matter. K/V tiles go through shared memory in fp32 (bf16
// converted, int8 multiplied by its per-(token, head) scale); scores,
// running max, running sum and the output accumulator stay fp32. Masked
// scores take the finite value -1e30 (the Pallas kernels' _MASK_VALUE).
// The chunk kernel runs the intra-chunk tile FIRST: its diagonal is always
// visible, so the running max is finite before any fully masked page and
// such a page contributes exp(-1e30 - m) == 0.
//
// paged_decode_kernel, and paged_chunk_kernel for fp32 queries, are the
// simple first versions: scalar fp32 FMAs, one page in flight per block,
// four __syncthreads per page.
//
// paged_decode_mma_kernel also replaces the decode Pallas kernel
// (_decode_kernel :72), for bf16 queries over bf16 or int8 pools at head_dim
// 64 and 128 with rep <= 16 (every decode the engine runs); kfc_paged_decode
// picks it by dtype, head_dim and rep. Bytes bound it (4 * rep flops per KV
// element). At the serving shape (8 slots, 8 KV heads, rep 4, 288 columns)
// the first kernel ran 64 blocks on 132 SMs, each walking its 18 pages one
// after the other, and walked every page up to the width cap. Its design
// takes the chunk kernel's machinery:
//   - the walk is split flash-decoding style: grid (part, slot x KV head),
//     parts sized by the width cap (pos is on the device) to fill the card;
//     a part past its slot's live columns writes an empty partial at once,
//     and the last part to finish merges in the same launch (one launch a
//     call; the counters and the scratch are the wrapper's, one set per
//     stream);
//   - only columns c < min(pos[b] + 1, nb * bs) are walked;
//   - inside a block each of the four warps walks every fourth tile of the
//     part through a ring of its own (two stages of 16-byte cp.async
//     copies in the pool's type), ordered by __syncwarp alone; the warps'
//     states merge in shared memory at the end;
//   - the rep query rows sit in the first rows of an m16n8k16 tile (the
//     rest zero) and the tile math is the chunk kernel's: K's scale on the
//     fp32 score column, V's scale folded into P, P as a bf16 hi/lo pair.
//   Measured on the H100 against its alternatives, which lost and were
//   removed (times in PERF.md, section 6): keys as the M rows (S^T = K Q^T,
//   rep padded to 8) took 0.92-1.04x its device time (faster on bf16
//   pools, slower on int8 at 2048 columns; it takes rep <= 8 only and a
//   tile_math of its own, and a decode call is bound by the host), fp32
//   FMAs 1.7-2.0x, one bulk copy (the TMA engine) per K or V row in place
//   of cp.async 0.96-1.15x.
//
// paged_chunk_mma_kernel is the chunk attention for bf16 queries over
// bf16 or int8 pools at head_dim 64 and 128 (every chunk the engine
// runs); kfc_paged_chunk picks it by dtype and head_dim. At the serving
// shape (one slot, W 16, 8 KV heads, rep 4, 240 cached columns) the first
// kernel ran 8 blocks on 132 SMs, each walking 18 pages one after the
// other: a chain of latencies at ~1300x the byte bound. Its design:
//   - the page walk is split flash-decoding style: grid (part, row
//     group, slot x KV head). Part 0 is the intra-chunk causal tile;
//     part p >= 1 walks its own run of 16-column tiles of the pool. The
//     host sizes the parts so that the grid covers the SMs, by the live
//     columns where it knows them (prefill: its offset) or by the width
//     cap (verify: pos is on the device, and a part past its slot's live
//     columns writes an empty partial at once);
//   - only columns c < min(pos[b], nb * bs) are walked: a page that holds
//     no visible column is never read (exact: once the running max is
//     finite, a fully masked page adds exp(-1e30 - m) == 0 and alpha 1);
//   - every part writes its fp32 (m, l, acc) to scratch the wrapper
//     allocates; the last block to finish a (slot, head, row group),
//     found by a counter the kernel resets itself, merges them. One
//     launch a call: the serving step is host-bound, and a second launch
//     per layer would cost more than it saves;
//   - pages arrive by 16-byte cp.async copies of the pool's own type into
//     a ring of two stages (no fp32 staging);
//   - a warp owns 16 query rows (position, rep pairs; a block 64) and
//     runs the scores and P V as mma.sync m16n8k16 bf16 with fp32 sums,
//     the softmax in registers. int8 codes are exact in bf16: K's scale
//     multiplies the fp32 score column, V's scale is folded into P
//     before the product; no dequantized copy is formed. P goes into the
//     product as a bf16 hi/lo pair, so the product carries ~16 bits of P
//     (the plain version is fp32 throughout; a single bf16 P would cost
//     2^-9 of |v|, ~25 for int8 rows).
//
// The C functions return cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMaskValue = -1e30f;
constexpr int kDecodeThreads = 128;
constexpr int kChunkThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// One pool page of one KV head into shared memory as fp32 rows of stride
// `ld`: dst[row * ld + d] = pool[page, row, g, d] (* scale[page, row, g]).
template <typename TKV>
__device__ __forceinline__ void load_page(
    const TKV* __restrict__ pool, const float* __restrict__ scale,
    int page, int g, int G, int D, int bs, float* dst, int ld) {
  for (int i = threadIdx.x; i < bs * D; i += blockDim.x) {
    const int row = i / D;
    const int d = i - row * D;
    const size_t tok = static_cast<size_t>(page) * bs + row;
    float x = to_f32(pool[(tok * G + g) * D + d]);
    if (scale != nullptr) x *= scale[tok * G + g];
    dst[row * ld + d] = x;
  }
}

// s[r, c] = (q[r] . k[c]) * sm_scale, or kMaskValue where !visible(r, c).
template <typename Visible>
__device__ __forceinline__ void score_tile(
    const float* q_s, const float* k_s, int ldk, float* s_s, int R, int C,
    int D, float sm_scale, Visible visible) {
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i - r * C;
    const float* qr = q_s + r * D;
    const float* kc = k_s + c * ldk;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
    const float s = dot * sm_scale;
    s_s[i] = visible(r, c) ? s : kMaskValue;
  }
}

// Online-softmax bookkeeping for R rows of C scores: the new running max,
// the rescale factor alpha = exp(m_prev - m_new), p = exp(s - m_new) in
// place of s, and l = alpha * l + sum(p).
__device__ __forceinline__ void online_rows(
    float* s_s, int R, int C, float* m_s, float* l_s, float* a_s) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* sr = s_s + r * C;
    float m_cur = neg_inf();
    for (int c = 0; c < C; ++c) m_cur = fmaxf(m_cur, sr[c]);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, m_cur);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float p = expf(sr[c] - m_new);
      sr[c] = p;
      sum += p;
    }
    l_s[r] = alpha * l_s[r] + sum;
    m_s[r] = m_new;
    a_s[r] = alpha;
  }
}

// acc[r, d] = acc[r, d] * alpha[r] + sum_c p[r, c] * v[c, d].
__device__ __forceinline__ void accumulate(
    const float* p_s, const float* v_s, int ldv, float* acc,
    const float* a_s, int R, int C, int D) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const float* pr = p_s + r * C;
    float x = 0.f;
    for (int c = 0; c < C; ++c) x = fmaf(pr[c], v_s[c * ldv + d], x);
    acc[i] = acc[i] * a_s[r] + x;
  }
}

// Shared-memory carve-up shared by both kernels. T is the tile height
// (pool page rows, or the chunk width when larger).
struct Smem {
  float *q, *k, *v, *s, *acc, *m, *l, *a;
  __device__ Smem(float* base, int R, int T, int D) {
    q = base;
    k = q + R * D;              // [T][D + 1]: padded against bank conflicts
    v = k + T * (D + 1);        // [T][D]
    s = v + T * D;              // [R][T]
    acc = s + R * T;            // [R][D]
    m = acc + R * D;            // [R]
    l = m + R;                  // [R]
    a = l + R;                  // [R]
  }
};

size_t smem_bytes(int R, int T, int D) {
  return sizeof(float) *
         (static_cast<size_t>(R) * D + static_cast<size_t>(T) * (D + 1) +
          static_cast<size_t>(T) * D + static_cast<size_t>(R) * T +
          static_cast<size_t>(R) * D + 3 * static_cast<size_t>(R));
}

// grid (B, G): q [B, G, rep, D]; pools [n_pages, bs, G, D]; scales
// [n_pages, bs, G] or null; tables [B, mb]; pos [B]; out [B, G, rep, D].
template <typename TQ, typename TKV>
__global__ void paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, TQ* __restrict__ out, int G, int rep,
    int D, int bs, int mb, int nb, int last_page, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int R = rep;
  Smem sm(smem, R, bs, D);
  const size_t qoff = (static_cast<size_t>(b) * G + g) * R * D;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    sm.q[i] = to_f32(q[qoff + i]);
    sm.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = neg_inf();
    sm.l[r] = 0.f;
  }
  const int p = pos[b];
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    const int page = min(max(tables[static_cast<size_t>(b) * mb + j], 0), last_page);
    load_page(k_pool, k_scale, page, g, G, D, bs, sm.k, D + 1);
    load_page(v_pool, v_scale, page, g, G, D, bs, sm.v, D);
    __syncthreads();
    const int col0 = j * bs;
    score_tile(sm.q, sm.k, D + 1, sm.s, R, bs, D, sm_scale,
               [=](int, int c) { return col0 + c <= p; });
    __syncthreads();
    online_rows(sm.s, R, bs, sm.m, sm.l, sm.a);
    __syncthreads();
    accumulate(sm.s, sm.v, D, sm.acc, sm.a, R, bs, D);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    out[qoff + i] = from_f32<TQ>(sm.acc[i] / sm.l[i / D]);
  }
}

// grid (B, G): q [B, W, G, rep, D]; k_new/v_new [B, W, G, D]; pools,
// scales and tables as the decode kernel; pos [B] (cached columns < pos
// are visible); out [B, W, G, rep, D]. Row r of a block is chunk position
// r / rep, query head r % rep of the group.
template <typename TQ, typename TKV>
__global__ void paged_chunk_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, TQ* __restrict__ out, int W, int G,
    int rep, int D, int bs, int mb, int nb, int last_page, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int R = W * rep;
  const int T = W > bs ? W : bs;
  Smem sm(smem, R, T, D);
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int w = r / rep;
    const int h = r - w * rep;
    const size_t off =
        (((static_cast<size_t>(b) * W + w) * G + g) * rep + h) * D + d;
    sm.q[i] = to_f32(q[off]);
    sm.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = neg_inf();
    sm.l[r] = 0.f;
  }
  // Step 0: the intra-chunk causal tile over the chunk's fresh K/V.
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int w = i / D;
    const int d = i - w * D;
    const size_t off = ((static_cast<size_t>(b) * W + w) * G + g) * D + d;
    sm.k[w * (D + 1) + d] = to_f32(k_new[off]);
    sm.v[w * D + d] = to_f32(v_new[off]);
  }
  const int p = pos[b];
  __syncthreads();
  score_tile(sm.q, sm.k, D + 1, sm.s, R, W, D, sm_scale,
             [=](int r, int c) { return c <= r / rep; });
  __syncthreads();
  online_rows(sm.s, R, W, sm.m, sm.l, sm.a);
  __syncthreads();
  accumulate(sm.s, sm.v, D, sm.acc, sm.a, R, W, D);
  __syncthreads();
  // Steps 1..nb: the slot's pool pages, cached columns < pos visible.
  for (int j = 0; j < nb; ++j) {
    const int page = min(max(tables[static_cast<size_t>(b) * mb + j], 0), last_page);
    load_page(k_pool, k_scale, page, g, G, D, bs, sm.k, D + 1);
    load_page(v_pool, v_scale, page, g, G, D, bs, sm.v, D);
    __syncthreads();
    const int col0 = j * bs;
    score_tile(sm.q, sm.k, D + 1, sm.s, R, bs, D, sm_scale,
               [=](int, int c) { return col0 + c < p; });
    __syncthreads();
    online_rows(sm.s, R, bs, sm.m, sm.l, sm.a);
    __syncthreads();
    accumulate(sm.s, sm.v, D, sm.acc, sm.a, R, bs, D);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int w = r / rep;
    const int h = r - w * rep;
    const size_t off =
        (((static_cast<size_t>(b) * W + w) * G + g) * rep + h) * D + d;
    out[off] = from_f32<TQ>(sm.acc[i] / sm.l[r]);
  }
}

// -- chunk attention on the tensor cores (bf16 queries) -------------------------
constexpr int kMmaThreads = 128;   // four warps of 16 query rows
constexpr int kMmaRows = 64;       // query rows of one block (a row group)
constexpr int kTileCols = 16;      // columns of one tile (one mma k-step of P V)
constexpr int kMaxParts = 64;      // part 0 and at most 63 runs of pool tiles

using bf16 = __nv_bfloat16;

struct ChunkArgs {
  const bf16* q;            // [B, W, G, rep, D]
  const bf16* k_new;        // [B, W, G, D]
  const bf16* v_new;
  const void* k_pool;       // [n_pages, bs, G, D] bf16 or int8
  const void* v_pool;
  const float* k_scale;     // [n_pages, bs, G] or null
  const float* v_scale;
  const int* tables;        // [B, mb]
  const int* pos;           // [B], or null: every slot at pos_host
  bf16* out;                // [B, W, G, rep, D]
  float* part_acc;          // [B * G * RG * parts, 64, D], parts > 1
  float* part_ml;           // [B * G * RG * parts, 64, 2]
  int* counters;            // [B * G * RG], zero between launches
  int W, G, rep, bs, mb, nb, last_page, parts, tiles_per_part, pos_host;
  float sm_scale;
};

// Bytes of one stage row: the row of D elements and 16 bytes of padding,
// so that the 8 rows a fragment load touches fall on distinct banks.
template <int D, typename T>
__host__ __device__ constexpr int stage_row_bytes() {
  return D * static_cast<int>(sizeof(T)) + 16;
}

// One stage: K rows, V rows (kTileCols each), K and V scales.
template <int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kTileCols * stage_row_bytes<D, bf16>() + 2 * kTileCols * 4;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two consecutive elements of a stage row as a bf16 pair (low half the
// first); int8 codes convert exactly.
__device__ __forceinline__ uint32_t pair_at(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair_at(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return hopper::pack_bf16(static_cast<float>(c.x), static_cast<float>(c.y));
}

// Two elements of one column from two rows as a bf16 pair.
__device__ __forceinline__ uint32_t pair_of(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}
__device__ __forceinline__ uint32_t pair_of(const int8_t* lo, const int8_t* hi) {
  return hopper::pack_bf16(static_cast<float>(*lo), static_cast<float>(*hi));
}

// Starts the copies of tile `tile` of a part into `stage`: kTileCols K and
// V rows of KV head g of slot b. Fresh rows (pool == false) come from
// k_new/v_new, rows past W zero-filled; pool rows through the slot's
// table (sentinel ids clamped to the last real page; columns past the
// table read its last entry: both are masked). int8 rows bring their
// scales.
// The kThreads threads that share the stage (the block, or one warp) each
// pass their index tid < kThreads.
template <int D, typename T, int kThreads>
__device__ __forceinline__ void load_tile(const ChunkArgs& a, int b, int g, bool pool, int tile,
                                          unsigned char* stage, int tid) {
  constexpr int kRow = stage_row_bytes<D, T>();
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static_assert((2 * kTileCols * kChunks) % kThreads == 0, "whole copies per thread");
  const uint32_t base = hopper::smem_u32(stage);
  const int c0 = tile * kTileCols;
  // Pool column c as a token row of the pool, through the slot's table. A
  // tile lies in one page when bs is a multiple of 16: one lookup.
  const bool one_page = pool && a.bs % kTileCols == 0;
  size_t tok0 = 0;
  if (one_page) {
    const int j = min(c0 / a.bs, a.mb - 1);
    const int page = min(max(a.tables[static_cast<size_t>(b) * a.mb + j], 0), a.last_page);
    tok0 = static_cast<size_t>(page) * a.bs + c0 % a.bs;
  }
  auto token = [&](int c) -> size_t {
    if (one_page) return tok0 + (c - c0);
    const int j = min(c / a.bs, a.mb - 1);
    const int page = min(max(a.tables[static_cast<size_t>(b) * a.mb + j], 0), a.last_page);
    return static_cast<size_t>(page) * a.bs + c % a.bs;
  };
#pragma unroll
  for (int k = 0; k < 2 * kTileCols * kChunks / kThreads; ++k) {
    const int i = tid + k * kThreads;
    const int kv = i / (kTileCols * kChunks);
    const int row = (i / kChunks) % kTileCols, ch = i % kChunks, c = c0 + row;
    const uint32_t dst = base + (kv * kTileCols + row) * kRow + ch * 16;
    const unsigned char* src;
    if (!pool) {
      if (c >= a.W) {
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(dst), "r"(0) : "memory");
        continue;
      }
      src = reinterpret_cast<const unsigned char*>(
          (kv ? a.v_new : a.k_new) + ((static_cast<size_t>(b) * a.W + c) * a.G + g) * D);
    } else {
      src = static_cast<const unsigned char*>(kv ? a.v_pool : a.k_pool) +
            (token(c) * a.G + g) * D * sizeof(T);
    }
    hopper::cp_async16(dst, src + ch * 16);
  }
  if (pool && a.k_scale != nullptr && tid < 2 * kTileCols) {
    const int kv = tid / kTileCols, row = tid % kTileCols;
    cp_async4(base + 2 * kTileCols * kRow + tid * 4,
              (kv ? a.v_scale : a.k_scale) + token(c0 + row) * a.G + g);
  }
}

// Online-softmax state of one warp's 16 rows: each thread holds rows
// r0 = lane / 4 and r0 + 8 (hh = 0, 1), the output columns 8 n + 2 (lane
// % 4) + {0, 1} of each n (mma C layout), its share of l, and m.
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2], l[2];
};

// One tile's scores, softmax update and P V for one warp. `visible(hh,
// col)` says whether tile column col (0..15) is visible to row hh.
template <int D, typename T, typename Visible>
__device__ __forceinline__ void tile_math(const unsigned char* stage, const uint32_t (&qa)[D / 16][4],
                                          RowState<D>& st, float sm_scale, bool scaled,
                                          Visible visible) {
  constexpr int kRow = stage_row_bytes<D, T>();
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const unsigned char* k_rows = stage;
  const unsigned char* v_rows = stage + kTileCols * kRow;
  const float* scales = reinterpret_cast<const float*>(stage + 2 * kTileCols * kRow);

  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const T* kr = reinterpret_cast<const T*>(k_rows + (8 * nt + g8) * kRow) + 16 * kk + 2 * q4;
      mma_16816(s[nt], qa[kk], pair_at(kr), pair_at(kr + 8));
    }
  }
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * q4 + (e & 1), hh = e >> 1;
      float x = s[nt][e] * sm_scale;
      if (scaled) x *= scales[col];
      x = visible(hh, col) ? x : kMaskValue;
      s[nt][e] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
  }
  float alpha[2], m_log2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(st.m[hh], v);
    alpha[hh] = exp2_approx((st.m[hh] - m_new) * kLog2e);
    st.m[hh] = m_new;
    m_log2[hh] = m_new * kLog2e;
  }
  // p, its share of l, and p (times V's scale) as a bf16 hi/lo pair in
  // the A layout: a[0] = (row, cols 2q..), a[1] = (row + 8, ...), a[2],
  // a[3] = the same at cols + 8.
  uint32_t hi[4], lo[4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_approx(fmaf(s[nt][2 * hh + e], kLog2e, -m_log2[hh]));
        sum[hh] += p;
        pv[e] = scaled ? p * scales[kTileCols + 8 * nt + 2 * q4 + e] : p;
      }
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(pv[0], pv[1]);
      const float2 hf = __bfloat1622float2(h2);
      hi[2 * nt + hh] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[2 * nt + hh] = hopper::pack_bf16(pv[0] - hf.x, pv[1] - hf.y);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) st.l[hh] = st.l[hh] * alpha[hh] + sum[hh];
  const uint32_t a_hi[4] = {hi[0], hi[1], hi[2], hi[3]};
  const uint32_t a_lo[4] = {lo[0], lo[1], lo[2], lo[3]};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
    const T* v0 = reinterpret_cast<const T*>(v_rows + 2 * q4 * kRow) + 8 * n + g8;
    const T* v1 = reinterpret_cast<const T*>(v_rows + (2 * q4 + 1) * kRow) + 8 * n + g8;
    const T* v8 = reinterpret_cast<const T*>(v_rows + (2 * q4 + 8) * kRow) + 8 * n + g8;
    const T* v9 = reinterpret_cast<const T*>(v_rows + (2 * q4 + 9) * kRow) + 8 * n + g8;
    const uint32_t b0 = pair_of(v0, v1), b1 = pair_of(v8, v9);
    mma_16816(st.o[n], a_hi, b0, b1);
    mma_16816(st.o[n], a_lo, b0, b1);
  }
}

// Walks tiles t0, t0 + step, ... (below t1) of one part through a ring of
// two stages at `smem`, shared by the whole block (kThreads ==
// kMmaThreads: every warp computes its own rows on each tile) or private
// to one warp (kThreads == 32: the warp walks its own tiles, and only
// __syncwarp orders its ring). tile_fn(stage, c0) consumes a stage whose
// first column is c0.
template <int D, typename T, int kThreads, typename TileFn>
__device__ __forceinline__ void walk(const ChunkArgs& a, int b, int g, bool pool, int t0, int t1,
                                     int step, unsigned char* smem, TileFn tile_fn) {
  const int tid = threadIdx.x % kThreads;
  const int n = t1 > t0 ? (t1 - t0 + step - 1) / step : 0;
  auto sync = [] {
    if constexpr (kThreads == 32) __syncwarp(); else __syncthreads();
  };
  for (int i = 0; i < 2; ++i) {
    if (i < n) load_tile<D, T, kThreads>(a, b, g, pool, t0 + i * step, smem + i * stage_bytes<D>(), tid);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    unsigned char* stage = smem + (i & 1) * stage_bytes<D>();
    hopper::cp_async_wait<1>();
    sync();
    tile_fn(static_cast<const unsigned char*>(stage), (t0 + i * step) * kTileCols);
    sync();
    if (i + 2 < n) load_tile<D, T, kThreads>(a, b, g, pool, t0 + (i + 2) * step, stage, tid);
    hopper::cp_async_commit();
  }
}

// grid (parts, row groups, B * G), kMmaThreads threads. Block (part, rg,
// b * G + g) computes query rows [64 rg, 64 rg + 64) of (slot b, KV head
// g) over its part's columns; with one part it writes the output, else
// its partial, and the last of the parts to finish merges.
template <int D, typename TKV>
__global__ void __launch_bounds__(kMmaThreads)
paged_chunk_mma_kernel(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  unsigned char* smem = chunk_smem;
  const int part = blockIdx.x, rg = blockIdx.y;
  const int b = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int R = a.W * a.rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const int row0 = rg * kMmaRows + warp * 16 + g8;   // and row0 + 8

  // This thread's query fragments: rows row0 and row0 + 8 (zero past R).
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    const bf16* qr = nullptr;
    if (r < R) {
      const int w = r / a.rep, h = r % a.rep;
      qr = a.q + (((static_cast<size_t>(b) * a.W + w) * a.G + g) * a.rep + h) * D;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][hh] = qr ? pair_at(qr + 16 * kk + 2 * q4) : 0u;
      qa[kk][2 + hh] = qr ? pair_at(qr + 16 * kk + 8 + 2 * q4) : 0u;
    }
  }
  RowState<D> st;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  st.m[0] = st.m[1] = neg_inf();
  st.l[0] = st.l[1] = 0.f;

  // Pool columns c < live are visible (the width cap bounds the walk).
  const int live = min(a.pos != nullptr ? a.pos[b] : a.pos_host, a.nb * a.bs);
  bool empty = false;
  if (part == 0) {
    // The intra-chunk causal tile first: row r sees fresh column c <= r /
    // rep; the tiles past the group's last row's diagonal are skipped.
    const int last = min(rg * kMmaRows + kMmaRows, R) - 1;
    const int cols = min(a.W, last / a.rep + 1);
    const int rep = a.rep;
    walk<D, bf16, kMmaThreads>(
        a, b, g, false, 0, (cols + kTileCols - 1) / kTileCols, 1, smem,
        [&](const unsigned char* stage, int c0) {
          tile_math<D, bf16>(stage, qa, st, a.sm_scale, false, [&](int hh, int col) {
            const int c = c0 + col;
            return c < a.W && c <= (row0 + 8 * hh) / rep;
          });
        });
  } else {
    const int live_tiles = (live + kTileCols - 1) / kTileCols;
    const int t0 = (part - 1) * a.tiles_per_part;
    const int t1 = min(t0 + a.tiles_per_part, live_tiles);
    empty = t0 >= t1;
    if (!empty)
      walk<D, TKV, kMmaThreads>(
          a, b, g, true, t0, t1, 1, smem, [&](const unsigned char* stage, int c0) {
            tile_math<D, TKV>(stage, qa, st, a.sm_scale, a.k_scale != nullptr,
                              [&](int, int col) { return c0 + col < live; });
          });
  }

  float l_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = st.l[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hh] = l;
  }
  const int bgr = blockIdx.z * gridDim.y + rg;
  auto out_at = [&](int r) {
    const int w = r / a.rep, h = r % a.rep;
    return a.out + (((static_cast<size_t>(b) * a.W + w) * a.G + g) * a.rep + h) * D;
  };
  if (a.parts == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      if (r >= R) continue;
      const float inv = 1.f / l_row[hh];
      bf16* o = out_at(r);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * q4) =
            hopper::pack_bf16(st.o[n][2 * hh] * inv, st.o[n][2 * hh + 1] * inv);
    }
    return;
  }

  // Partial of this part: m, l (l == 0 marks an empty part) and acc.
  const size_t pidx = static_cast<size_t>(bgr) * a.parts + part;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rl = warp * 16 + g8 + 8 * hh;
    if (q4 == 0)
      *reinterpret_cast<float2*>(a.part_ml + (pidx * kMmaRows + rl) * 2) =
          make_float2(empty ? neg_inf() : st.m[hh], empty ? 0.f : l_row[hh]);
    if (empty) continue;
    float* acc = a.part_acc + (pidx * kMmaRows + rl) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + 8 * n + 2 * q4) =
          make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
  }
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + 2 * stage_bytes<D>());
  float* wts = reinterpret_cast<float*>(flag + 4);      // [parts][64]
  float* inv_l = wts + a.parts * kMmaRows;               // [64]
  if (threadIdx.x == 0) flag[0] = atomicAdd(a.counters + bgr, 1) == a.parts - 1;
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();

  // The last part merges: out = sum_p w_p acc_p / sum_p w_p l_p with w_p
  // = exp(m_p - max m); empty parts weigh 0 and their acc is not read.
  const size_t first = static_cast<size_t>(bgr) * a.parts;
  for (int rl = threadIdx.x; rl < kMmaRows; rl += kMmaThreads) {
    float mmax = neg_inf();
    for (int p = 0; p < a.parts; ++p) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + (first + p) * kMmaRows + rl);
      if (ml.y > 0.f) mmax = fmaxf(mmax, ml.x);
    }
    float l = 0.f;
    for (int p = 0; p < a.parts; ++p) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + (first + p) * kMmaRows + rl);
      const float w = ml.y > 0.f ? expf(ml.x - mmax) : 0.f;
      wts[p * kMmaRows + rl] = w;
      l += w * ml.y;
    }
    inv_l[rl] = 1.f / l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMmaRows * (D / 4); i += kMmaThreads) {
    const int rl = i / (D / 4), d0 = (i % (D / 4)) * 4, r = rg * kMmaRows + rl;
    if (r >= R) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < a.parts; ++p) {
      const float w = wts[p * kMmaRows + rl];
      if (w == 0.f) continue;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          a.part_acc + ((first + p) * kMmaRows + rl) * D + d0));
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    const float il = inv_l[rl];
    *reinterpret_cast<uint2*>(out_at(r) + d0) =
        make_uint2(hopper::pack_bf16(acc.x * il, acc.y * il), hopper::pack_bf16(acc.z * il, acc.w * il));
  }
  if (threadIdx.x == 0) a.counters[bgr] = 0;   // ready for the next launch
}

// -- decode attention on the tensor cores (bf16 queries) -------------------------
constexpr int kDecodeWarps = kMmaThreads / 32;   // warps of a decode block
constexpr int kMaxDecodeRep = 16;                // query rows one warp's mma tile holds

// A merged row: sum_i w_i acc_i (four columns) and sum_i w_i l_i over n
// partials (m_i, l_i, acc_i), w_i = exp(m_i - max m) over the partials with
// l_i > 0; an empty partial (l_i == 0) weighs 0 and its acc is not read. m
// is the max (-inf when every partial is empty). kGlobal: the partials lie
// in device memory, written by other blocks (read past L1).
struct Merged {
  float4 acc;
  float m, l;
};
template <bool kGlobal>
__device__ __forceinline__ Merged merge_partials(const float2* ml, int ml_stride, const float* acc,
                                                 size_t acc_stride, int n) {
  auto ld_ml = [&](int i) {
    if constexpr (kGlobal) return __ldcg(ml + i * ml_stride);
    else return ml[i * ml_stride];
  };
  Merged r{make_float4(0.f, 0.f, 0.f, 0.f), neg_inf(), 0.f};
  for (int i = 0; i < n; ++i) {
    const float2 x = ld_ml(i);
    if (x.y > 0.f) r.m = fmaxf(r.m, x.x);
  }
  for (int i = 0; i < n; ++i) {
    const float2 x = ld_ml(i);
    if (!(x.y > 0.f)) continue;
    const float w = expf(x.x - r.m);
    const float4* src = reinterpret_cast<const float4*>(acc + i * acc_stride);
    float4 v;
    if constexpr (kGlobal) v = __ldcg(src);
    else v = *src;
    r.l = fmaf(w, x.y, r.l);
    r.acc.x = fmaf(w, v.x, r.acc.x);
    r.acc.y = fmaf(w, v.y, r.acc.y);
    r.acc.z = fmaf(w, v.z, r.acc.z);
    r.acc.w = fmaf(w, v.w, r.acc.w);
  }
  return r;
}

// Shared memory of a decode block: each warp's ring of two stages (after
// the walk the same bytes hold the warps' partials for the block's
// merge) and 16 bytes for the merge flag.
template <int D>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return static_cast<size_t>(kDecodeWarps) * 2 * stage_bytes<D>() + 16;
}

// The warps' partials of a block, in the ring's bytes once every warp is
// done with its ring: (m, l) [warps][16] and acc [warps][rep][D].
struct WarpPartials {
  float2* ml;
  float* acc;
  __device__ explicit WarpPartials(unsigned char* smem)
      : ml(reinterpret_cast<float2*>(smem)),
        acc(reinterpret_cast<float*>(smem) + 2 * kDecodeWarps * kMaxDecodeRep) {}
};

// One decode warp's walk over tiles t0, t0 + 4, ... (below t1) of the pool
// through its own ring of two stages (walk's warp form, 16-byte cp.async
// copies), the rep query rows as the first rows of m16n8k16 tiles (rows g8
// and g8 + 8 of this thread's fragments, zero past rep; the chunk kernel's
// tile_math); then its (m, l, acc) into the block's WarpPartials.
template <int D, typename TKV>
__device__ __forceinline__ void decode_warp(const ChunkArgs& a, int bg, int b, int g, int t0,
                                            int t1, unsigned char* smem, int live) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const int rep = a.rep;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g8 + 8 * hh;
    const bf16* qr = r < rep ? a.q + (static_cast<size_t>(bg) * rep + r) * D : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][hh] = qr ? pair_at(qr + 16 * kk + 2 * q4) : 0u;
      qa[kk][2 + hh] = qr ? pair_at(qr + 16 * kk + 8 + 2 * q4) : 0u;
    }
  }
  RowState<D> st;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  st.m[0] = st.m[1] = neg_inf();
  st.l[0] = st.l[1] = 0.f;
  walk<D, TKV, 32>(a, b, g, true, t0, t1, kDecodeWarps, smem + warp * 2 * stage_bytes<D>(),
                   [&](const unsigned char* stage, int c0) {
                     tile_math<D, TKV>(stage, qa, st, a.sm_scale, a.k_scale != nullptr,
                                       [&](int, int col) { return c0 + col < live; });
                   });
  float l_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = st.l[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hh] = l;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  const WarpPartials wp(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g8 + 8 * hh;
    if (r >= rep) continue;
    if (q4 == 0) wp.ml[warp * kMaxDecodeRep + r] = make_float2(st.m[hh], l_row[hh]);
    float* acc = wp.acc + (warp * rep + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + 8 * n + 2 * q4) =
          make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
  }
}

// -- the decode kernel -------------------------------------------------------------

// grid (parts, B * G), kMmaThreads threads; a.W == 1, q and out [B, G,
// rep, D]. Block (part, b * G + g) covers the part's run of 16-column
// tiles [t0, t1) of (slot b, KV head g), cut at the slot's live columns
// c < min(pos[b] + 1, nb * bs); warp w walks tiles t0 + w, t0 + w + 4, ...
// through a ring of its own (every walked tile holds a visible column, so
// each warp's running max is finite from its first tile on). The four
// warps' states merge in shared memory; with one part the block writes
// the output, else its partial, and the last of the parts to finish
// merges.
template <int D, typename TKV>
__global__ void __launch_bounds__(kMmaThreads, 3)   // 3 blocks an SM: the grid in one wave
paged_decode_mma_kernel(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  unsigned char* smem = decode_smem;
  const int part = blockIdx.x, bg = blockIdx.y;
  const int b = bg / a.G, g = bg % a.G, rep = a.rep, warp = threadIdx.x >> 5;
  const int live = min(a.pos[b] + 1, a.nb * a.bs);
  const int t0 = part * a.tiles_per_part + warp;
  const int t1 = min(part * a.tiles_per_part + a.tiles_per_part, (live + kTileCols - 1) / kTileCols);
  decode_warp<D, TKV>(a, bg, b, g, t0, t1, smem, live);
  __syncthreads();

  const WarpPartials wp(smem);
  auto store_out = [&](int r, int d0, const Merged& mg) {
    const float il = 1.f / mg.l;
    *reinterpret_cast<uint2*>(a.out + (static_cast<size_t>(bg) * rep + r) * D + d0) =
        make_uint2(hopper::pack_bf16(mg.acc.x * il, mg.acc.y * il),
                   hopper::pack_bf16(mg.acc.z * il, mg.acc.w * il));
  };
  const size_t first = static_cast<size_t>(bg) * a.parts;   // partial of part 0
  for (int i = threadIdx.x; i < rep * (D / 4); i += kMmaThreads) {
    const int r = i / (D / 4), d0 = (i % (D / 4)) * 4;
    const Merged mg = merge_partials<false>(wp.ml + r, kMaxDecodeRep, wp.acc + r * D + d0,
                                            static_cast<size_t>(rep) * D, kDecodeWarps);
    if (a.parts == 1) {
      store_out(r, d0, mg);
      continue;
    }
    const size_t row = (first + part) * rep + r;
    if (d0 == 0) reinterpret_cast<float2*>(a.part_ml)[row] = make_float2(mg.m, mg.l);
    if (mg.l > 0.f) *reinterpret_cast<float4*>(a.part_acc + row * D + d0) = mg.acc;
  }
  if (a.parts == 1) return;

  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + decode_smem_bytes<D>() - 16);
  if (threadIdx.x == 0) flag[0] = atomicAdd(a.counters + bg, 1) == a.parts - 1;
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();
  // The last part merges every part's partial (empty parts weigh 0).
  for (int i = threadIdx.x; i < rep * (D / 4); i += kMmaThreads) {
    const int r = i / (D / 4), d0 = (i % (D / 4)) * 4;
    store_out(r, d0, merge_partials<true>(
                         reinterpret_cast<const float2*>(a.part_ml) + first * rep + r, rep,
                         a.part_acc + (first * rep + r) * D + d0, static_cast<size_t>(rep) * D,
                         a.parts));
  }
  if (threadIdx.x == 0) a.counters[bg] = 0;   // ready for the next launch
}

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > kDefaultSmem) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
  }
  return cudaSuccess;
}

template <typename TQ, typename TKV>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale,
                  const void* tables, const void* pos, void* out, int B,
                  int G, int rep, int D, int bs, int mb, int nb,
                  int last_page, float sm_scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(rep, bs, D);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, G), kDecodeThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<TQ*>(out), G, rep, D, bs,
      mb, nb, last_page, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_chunk(const void* q, const void* k_new, const void* v_new,
                 const void* k_pool, const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables, const void* pos,
                 void* out, int B, int W, int G, int rep, int D, int bs,
                 int mb, int nb, int last_page, float sm_scale,
                 cudaStream_t stream) {
  const size_t bytes = smem_bytes(W * rep, W > bs ? W : bs, D);
  auto kernel = paged_chunk_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, G), kChunkThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new),
      static_cast<const TQ*>(v_new), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<TQ*>(out), W, G, rep, D, bs,
      mb, nb, last_page, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TKV>
int launch_chunk_mma(const ChunkArgs& a, int B, int row_groups, cudaStream_t stream) {
  const size_t bytes = 2 * stage_bytes<D>() + 16 + static_cast<size_t>(a.parts + 1) * kMmaRows * 4;
  auto kernel = paged_chunk_mma_kernel<D, TKV>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.parts, row_groups, B * a.G), kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TKV>
int launch_decode_mma(const ChunkArgs& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = decode_smem_bytes<D>();
  auto kernel = paged_decode_mma_kernel<D, TKV>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.parts, B * a.G), kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables, const void* pos, void* out,
                 void* part_acc, void* part_ml, void* counters, int B, int G, int rep, int D,
                 int bs, int mb, int nb, int last_page, int parts, int tiles_per_part,
                 float sm_scale, int q_dtype, int quantized, cudaStream_t s) {
  if (q_dtype == 1 && (D == 64 || D == 128) && rep <= kMaxDecodeRep) {
    if (parts < 1 || parts > kMaxParts || tiles_per_part < 1 ||
        (parts > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)) ||
        B <= 0 || rep <= 0 || pos == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const ChunkArgs a{static_cast<const bf16*>(q), nullptr, nullptr, k_pool, v_pool,
                      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                      static_cast<const int*>(tables), static_cast<const int*>(pos),
                      static_cast<bf16*>(out), static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), static_cast<int*>(counters), 1, G, rep, bs,
                      mb, nb, last_page, parts, tiles_per_part, 0, sm_scale};
    if (D == 64)
      return quantized ? launch_decode_mma<64, int8_t>(a, B, s)
                       : launch_decode_mma<64, bf16>(a, B, s);
    return quantized ? launch_decode_mma<128, int8_t>(a, B, s)
                     : launch_decode_mma<128, bf16>(a, B, s);
  }
  if (q_dtype == 0 && !quantized)
    return launch_decode<float, float>(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out,
                                       B, G, rep, D, bs, mb, nb, last_page, sm_scale, s);
  if (q_dtype == 0 && quantized)
    return launch_decode<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, pos,
                                        out, B, G, rep, D, bs, mb, nb, last_page, sm_scale, s);
  if (q_dtype == 1 && !quantized)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, B, G, rep, D, bs, mb, nb,
        last_page, sm_scale, s);
  if (q_dtype == 1 && quantized)
    return launch_decode<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                                pos, out, B, G, rep, D, bs, mb, nb, last_page,
                                                sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A decode launch's shape arguments, which the wrapper builds once per
// configuration. q_dtype: 0 = float32, 1 = bfloat16 (q and out share it).
// quantized: pools are int8 with float32 scales; else pools have q's type.
struct KfcDecodeDims {
  int B, G, rep, D, bs, mb, nb, last_page, parts, tiles_per_part;
  float sm_scale;
  int q_dtype, quantized;
};

// bf16 queries at head_dim 64 and 128 with rep <= 16 take
// paged_decode_mma_kernel in `parts` parts of `tiles_per_part` 16-column
// tiles (part_acc [B * G * parts, rep, D] and part_ml [B * G * parts,
// rep, 2] fp32 scratch and counters [B * G], zero between launches; unused
// with one part); every other call takes paged_decode_kernel, which
// ignores those five.
extern "C" int kfc_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, void* out, void* part_acc, void* part_ml, void* counters,
    const KfcDecodeDims* d, void* stream) {
  return paged_decode(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part_acc, part_ml,
                      counters, d->B, d->G, d->rep, d->D, d->bs, d->mb, d->nb, d->last_page,
                      d->parts, d->tiles_per_part, d->sm_scale, d->q_dtype, d->quantized,
                      static_cast<cudaStream_t>(stream));
}

// q_dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and out share it).
// quantized: pools are int8 with float32 scales; else pools have q's type.
// bf16 queries at head_dim 64 and 128 take paged_chunk_mma_kernel in
// `parts` parts of `tiles_per_part` 16-column pool tiles (part_acc,
// part_ml and counters as ChunkArgs says; unused with one part; pos may
// be null, every slot then at pos_host); every other call takes
// paged_chunk_kernel, which ignores those six and needs pos.
extern "C" int kfc_paged_chunk(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* pos, void* out, void* part_acc,
    void* part_ml, void* counters, int B, int W, int G, int rep, int D,
    int bs, int mb, int nb, int last_page, int parts, int tiles_per_part,
    int pos_host, float sm_scale, int q_dtype, int quantized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && (D == 64 || D == 128)) {
    if (parts < 1 || parts > kMaxParts || tiles_per_part < 1 ||
        (parts > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)) ||
        B <= 0 || W <= 0 || rep <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const ChunkArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
                      static_cast<const bf16*>(v_new), k_pool, v_pool,
                      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                      static_cast<const int*>(tables), static_cast<const int*>(pos),
                      static_cast<bf16*>(out), static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), static_cast<int*>(counters), W, G, rep, bs,
                      mb, nb, last_page, parts, tiles_per_part, pos_host, sm_scale};
    const int row_groups = (W * rep + kMmaRows - 1) / kMmaRows;
    if (D == 64)
      return quantized ? launch_chunk_mma<64, int8_t>(a, B, row_groups, s)
                       : launch_chunk_mma<64, bf16>(a, B, row_groups, s);
    return quantized ? launch_chunk_mma<128, int8_t>(a, B, row_groups, s)
                     : launch_chunk_mma<128, bf16>(a, B, row_groups, s);
  }
  if (pos == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0 && !quantized)
    return launch_chunk<float, float>(q, k_new, v_new, k_pool, v_pool, nullptr, nullptr,
                                      tables, pos, out, B, W, G, rep, D, bs, mb, nb,
                                      last_page, sm_scale, s);
  if (q_dtype == 0 && quantized)
    return launch_chunk<float, int8_t>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                                       tables, pos, out, B, W, G, rep, D, bs, mb, nb,
                                       last_page, sm_scale, s);
  if (q_dtype == 1 && !quantized)
    return launch_chunk<__nv_bfloat16, __nv_bfloat16>(
        q, k_new, v_new, k_pool, v_pool, nullptr, nullptr, tables, pos, out, B, W, G, rep, D,
        bs, mb, nb, last_page, sm_scale, s);
  if (q_dtype == 1 && quantized)
    return launch_chunk<__nv_bfloat16, int8_t>(q, k_new, v_new, k_pool, v_pool, k_scale,
                                               v_scale, tables, pos, out, B, W, G, rep, D, bs,
                                               mb, nb, last_page, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

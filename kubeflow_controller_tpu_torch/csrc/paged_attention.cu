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
// This is the simple, correct first version: scalar fp32 FMAs, one page
// in flight per block, four __syncthreads per page. The next design
// questions (recorded in PERF.md): at B=8 the decode grid is 64 blocks on
// 132 SMs, so a split over pages (flash-decoding) with a second reduce
// pass would fill the card; cp.async/TMA double buffering would overlap
// the page loads with the math; wgmma would take the chunk kernel's
// [W*rep, D] x [D, bs] products.
//
// The C functions return cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and out share it).
// quantized: pools are int8 with float32 scales; else pools have q's type.
extern "C" int kfc_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int G, int rep, int D, int bs, int mb,
    int nb, int last_page, float sm_scale, int q_dtype, int quantized,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

extern "C" int kfc_paged_chunk(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* pos, void* out, int B, int W, int G,
    int rep, int D, int bs, int mb, int nb, int last_page, float sm_scale,
    int q_dtype, int quantized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

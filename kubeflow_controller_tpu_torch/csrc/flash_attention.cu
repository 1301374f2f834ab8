// Flash attention for training, written by hand for Hopper (sm_90a).
//
// Three kernels cover the four TPU kernels of
// kubeflow_controller_tpu/ops/flash_attention.py:
//
// * flash_fwd_kernel replaces _fwd_kernel (:203, launched :576 via
//   _fwd_wide :530 / _fwd :599): o = softmax(q k^T * scale + mask) v and
//   the row log-sum-exp lse [B, H, S] (the narrow residual of _fwd).
// * flash_bwd_kv_kernel<kDq = true> replaces _bwd_fused_kernel (:766,
//   launched :1109): dk and dv, and every tile's dq, from one score
//   recompute.
// * flash_bwd_kv_kernel<kDq = false> replaces _bwd_dkdv_kernel (:621,
//   launched :1187): the two-pass backward's first pass, dk and dv.
// * flash_bwd_dq_kernel replaces _bwd_dq_kernel (:919, launched :1227):
//   the second pass, dq.
//
// Layouts are BSHD: q, o, do [B, S, H, D]; k, v [B, S, KVH, D] (query
// head h reads KV head h / (H / KVH)); segment ids [B, S] int32; rope
// tables C, S [B, S, D] fp32 with rot(x) = x * C + roll(x, D/2) * S
// (rotated in fp32 on load and cast back to bf16, as _rope_rot does; dq
// and dk are counter-rotated with -S before their cast). Row i sees
// column j iff (!causal || j <= i) && seg[i] == seg[j]; masked scores
// are the finite -1e30 of the TPU kernels, and masked probabilities are
// exactly 0. Segment id 0 is not special here: a padding row still sees
// its own diagonal, so no row is ever fully masked.
//
// What bounds them on an H100: operations. At the flagship's shape (B16
// H8 S1024 D128, causal) the forward does 2 * 2 * B*H*S^2*D / 2 = 34
// GFLOP (0.035 ms at 989 TFLOP/s bf16) against ~150 MB of inputs and
// outputs (0.045 ms at 3.35 TB/s), so the two bounds are close; the
// fused backward does 2.5x the forward's products, the dk/dv pass 2x,
// the dq pass 1.5x. The design therefore:
//   - never writes the S x S scores to device memory: a block owns a
//     64-row tile (32 rows when D = 256) and walks the other operand's
//     tiles itself, the TPU's sequential grid carry (m/l/acc scratch)
//     becoming shared memory inside the block;
//   - skips every tile wholly above the diagonal (the counterpart of the
//     splash dead-triangle skip), which halves the causal work;
//   - runs every product on the tensor cores: bf16 WMMA 16x16x16
//     fragments with fp32 accumulation, operands staged in shared
//     memory (the probabilities and ds cast to bf16 first, as the TPU
//     kernels cast p and ds to the input dtype);
//   - gives the dk/dv kernel a (batch, KV head, k-tile) block that loops
//     over the KV head's query heads and their live q-tiles, so the GQA
//     group sum falls out of the accumulation with no atomics and no
//     fp32 staging tensor; the dq kernel a (batch, head, q-tile) block.
//   dq in the fused kernel crosses blocks: each (q-tile, k-tile) pair
//   adds its [T, D] tile into an fp32 scratch with atomicAdd (so dq's
//   fp32 sums run in a launch-dependent order; dk and dv are
//   deterministic), and the wrapper counter-rotates and casts it.
//
// This is the simple, correct first version: the softmax bookkeeping is
// scalar fp32 in shared memory, accumulators make a round trip through
// shared memory around every product, and loads are not overlapped with
// compute. wgmma, TMA and register-resident accumulators are later work.
//
// The C functions return cudaGetLastError() after the launch (or the
// error that stopped it); the Python wrappers raise when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
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

// -- forward ----------------------------------------------------------------
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

// All tensors bf16 unless named: lse, delta, rope tables and dq_acc fp32,
// segment ids int32. seg, rope_c/rope_s and dq_acc may be null.
extern "C" int kfc_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* rope_c,
                             const void* rope_s, void* o, void* lse, int B,
                             int S, int H, int KVH, int D, float scale,
                             int causal, void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = tile_rows(D);
  const size_t bytes = Layout(T, D, 1, false).bytes;
  cudaError_t err = prepare(flash_fwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<<<dim3((S + T - 1) / T, H, B), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), p, static_cast<bf16*>(o),
      static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// dq_acc null: the two-pass backward's dk/dv pass; else the fused
// backward, adding dq (rotation space) into dq_acc (fp32 [B, S, H, D],
// zeroed by the caller).
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
  const int T = tile_rows(D);
  const dim3 grid((S + T - 1) / T, KVH, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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

extern "C" int kfc_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg,
                                const void* rope_c, const void* rope_s, void* dq,
                                int B, int S, int H, int KVH, int D, float scale,
                                int causal, void* stream) {
  Problem p;
  if (!make_problem(&p, B, S, H, KVH, D, scale, causal, seg, rope_c, rope_s))
    return static_cast<int>(cudaErrorInvalidValue);
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

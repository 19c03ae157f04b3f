// Backward of the decomposed relative-position attention: shared pieces of
// relpos_global_bwd.cu and relpos_window_bwd.cu.
//
// With s2[q, j] = q.k_j * scale * log2(e) + r[q, ky(j)] + r[q, kh + kx(j)]
// and the forward's saved per-row log-sum-exp lse2[q] (log2 domain):
//   P   = exp2(s2 - lse2)                      (exact softmax, recomputed)
//   dP  = dO . V^T
//   dS  = P * (dP - delta),  delta[q] = sum_d dO[q, d] O[q, d]
//   dQ  = scale * dS . K       dK = scale * dS^T . Q       dV = P^T . dO
//   dr[q, ky]      = sum_kx dS[q, ky * kw + kx] / log2(e)
//   dr[q, kh + kx] = sum_ky dS[q, ky * kw + kx] / log2(e)
// Blocks on the card run in no order and share nothing, so the work is cut
// twice: once by query rows (dQ and dr are local to a query tile) and once
// by key rows (dK and dV are local to a key tile). Both cuts recompute P
// and dP; no atomics are used, so gradients are identical from run to run.
// delta is a small pre-pass (delta_kernel).
#pragma once

#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {
namespace bwd {

constexpr float kInvLog2e = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[(b, h, q)] = sum_d dout[b, q, h, d] * out[b, q, h, d]; one warp per
// (row, head), two channels per lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int n, int heads) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= rows * heads) return;
  const long long row = w / heads;
  const int h = (int)(w - row * heads);
  const long long off = (row * heads + h) * kDh + 2 * lane;
  float x = to_float(out[off]) * to_float(dout[off]) +
            to_float(out[off + 1]) * to_float(dout[off + 1]);
  x = warp_sum(x);
  if (lane == 0) {
    const long long b = row / n, q = row - b * n;
    delta[(b * heads + h) * n + q] = x;
  }
}

// One warp adds a tile of dS (`rows` query rows x `len` keys, the first
// being key `kbase` of the sequence; row stride `ld`) into the rows' bias
// gradient dr_s (row stride rs): columns [0, kh) take the sums over kx,
// columns [kh, kh + kw) the sums over ky. `rows` divides 32. Every sum is
// taken in a fixed order (no atomics).
__device__ __forceinline__ void accumulate_dr(const float* ds, int ld,
                                              int rows, int kbase, int len,
                                              int kh, int kw, float* dr_s,
                                              int rs, int lane) {
  const int phase = kbase % kw;
  for (int kx = lane; kx < kw; kx += 32) {
    int k0 = kx - phase;
    if (k0 < 0) k0 += kw;
    if (k0 >= len) continue;
    for (int i = 0; i < rows; ++i) {
      float sum = 0.f;
      for (int k = k0; k < len; k += kw) sum += ds[i * ld + k];
      dr_s[i * rs + kh + kx] += sum;
    }
  }
  // rel_h: lane = part * rows + i sums the part-th piece of each ky bin of
  // row i; the pieces are then added across parts by shuffles
  const int parts = 32 / rows;
  const int i = lane % rows, part = lane / rows;
  const int ky0 = kbase / kw, ky1 = (kbase + len - 1) / kw;
  for (int ky = ky0; ky <= ky1; ++ky) {
    const int lo = max(ky * kw, kbase) - kbase;
    const int hi = min((ky + 1) * kw, kbase + len) - kbase;
    const int piece = (hi - lo + parts - 1) / parts;
    const int a = min(lo + part * piece, hi), b = min(a + piece, hi);
    float sum = 0.f;
    for (int k = a; k < b; ++k) sum += ds[i * ld + k];
    for (int off = rows; off < 32; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) dr_s[i * rs + ky] += sum;
  }
}

// delta pre-pass and the fp32 (CUDA-core) backward, defined in
// relpos_global_bwd.cu and used for global and windowed blocks alike: the
// grid is (tiles of 64 rows, heads, images or windows).
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         long long rows, int n, int heads, int is_bf16,
                         cudaStream_t stream);
cudaError_t launch_bwd_f32(const float* qkv, const float* r,
                           const float* dout, const float* lse,
                           const float* delta, float* dqkv, float* dr, int b,
                           int n, int heads, int kh, int kw, float scale,
                           cudaStream_t stream);

// ---- bf16 on the tensor cores (mma.sync m16n8k16) ----------------------
namespace tcb {

using tc::kChunk;
using tc::kLd;
using tc::kRows;
using tc::kSteps;

constexpr int kDsLd = kChunk + 4;  // fp32 row stride of a warp's dS tile
constexpr int kQChunk = 32;        // queries per step of the dK / dV cut

// bf16 row stride of an r tile in shared memory: rows stay 8-byte aligned
__host__ __device__ inline int r_stride(int rr) { return ((rr + 3) & ~3) + 4; }

// A fragments of 16 rows of a kLd-strided bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[kSteps][4],
                                       const __nv_bfloat16* tile, int lane) {
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    a[ks][0] = t32[g * (kLd / 2) + ks * 8 + t];
    a[ks][1] = t32[(g + 8) * (kLd / 2) + ks * 8 + t];
    a[ks][2] = t32[g * (kLd / 2) + ks * 8 + 4 + t];
    a[ks][3] = t32[(g + 8) * (kLd / 2) + ks * 8 + 4 + t];
  }
}

template <int kTiles>
__device__ __forceinline__ void zero(float (&x)[kTiles][4]) {
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// acc (16 x 64) += A (16 x 16 * kk, as accumulator-layout tiles x[2kk],
// x[2kk + 1] packed to bf16) . B, with B the 16 * kk rows of a kLd-strided
// bf16 tile read through ldmatrix.trans (k = tile row, n = column).
template <int kK16>
__device__ __forceinline__ void mma_rows(float (&acc)[kDh / 8][4],
                                         const float (&x)[2 * kK16][4],
                                         const __nv_bfloat16* tile, int lane) {
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk) {
    const uint32_t a[4] = {tc::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           tc::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           tc::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           tc::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dd = 0; dd < kDh / 16; ++dd) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, tile + (kk * 16 + vrow) * kLd + dd * 16 + vcol);
      tc::mma_bf16(acc[2 * dd], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

// x (16 x 8 * kTiles) = A (16 x 64, fragments a) . B^T, B the 8 * kTiles
// rows of a kLd-strided bf16 tile.
template <int kTiles>
__device__ __forceinline__ void mma_nt(float (&x)[kTiles][4],
                                       const uint32_t (&a)[kSteps][4],
                                       const __nv_bfloat16* tile, int lane) {
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const uint32_t* row = t32 + (nt * 8 + g) * (kLd / 2) + ks * 8 + t;
      tc::mma_bf16(x[nt], a[ks], row[0], row[4]);
    }
}

// Writes 16 rows x 64 columns of fp32 accumulators, times `mul`, as bf16
// (row stride `stride`, rows >= n skipped).
__device__ __forceinline__ void store_rows(const float (&acc)[kDh / 8][4],
                                           float mul, __nv_bfloat16* dst,
                                           long long stride, int row0, int n,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ri = row0 + g + 8 * i;
    if (ri < n) {
      uint32_t* row = reinterpret_cast<uint32_t*>(dst + ri * stride);
#pragma unroll
      for (int dn = 0; dn < kDh / 8; ++dn)
        row[dn * 4 + t] = tc::pack_bf16(acc[dn][2 * i] * mul,
                                        acc[dn][2 * i + 1] * mul);
    }
  }
}

// The query cut: a warp's 16 query rows against one chunk of 64 keys.
struct DqRows {
  uint32_t qa[kSteps][4];  // q as A fragments
  uint32_t da[kSteps][4];  // dO as A fragments
  float lse[2], delta[2];  // of rows g, g + 8
  float dq[kDh / 8][4];
};

// k_s / v_s: the chunk's 64 key rows (zero past n); r_w: the warp's 16 r
// rows (stride rsb); ds_w: the warp's 16 x kDsLd fp32 scratch; dr_w: the
// warp's 16 x rs dr accumulators.
__device__ __forceinline__ void dq_chunk(DqRows& st, const __nv_bfloat16* k_s,
                                         const __nv_bfloat16* v_s,
                                         const __nv_bfloat16* r_w, int rsb,
                                         float* ds_w, float* dr_w, int rs,
                                         int kbase, int n, int kh, int kw,
                                         float qscale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[kChunk / 8][4], dp[kChunk / 8][4];
  zero(s);
  zero(dp);
  mma_nt(s, st.qa, k_s, lane);
  mma_nt(dp, st.da, v_s, lane);

  const __nv_bfloat16* r0 = r_w + g * rsb;
  const __nv_bfloat16* r1 = r_w + (g + 8) * rsb;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int e = nt * 8 + 2 * t + b, j = kbase + e;
      float ds0 = 0.f, ds1 = 0.f;
      if (j < n) {
        const int ky = j / kw, kx = kh + j - ky * kw;
        const float b0 = to_float(r0[ky]) + to_float(r0[kx]) - st.lse[0];
        const float b1 = to_float(r1[ky]) + to_float(r1[kx]) - st.lse[1];
        const float p0 = exp2f(fmaf(s[nt][b], qscale, b0));
        const float p1 = exp2f(fmaf(s[nt][2 + b], qscale, b1));
        ds0 = p0 * (dp[nt][b] - st.delta[0]);
        ds1 = p1 * (dp[nt][2 + b] - st.delta[1]);
      }
      s[nt][b] = ds0;
      s[nt][2 + b] = ds1;
    }
    *reinterpret_cast<float2*>(ds_w + g * kDsLd + nt * 8 + 2 * t) =
        make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(ds_w + (g + 8) * kDsLd + nt * 8 + 2 * t) =
        make_float2(s[nt][2], s[nt][3]);
  }
  __syncwarp();
  mma_rows<kChunk / 16>(st.dq, s, k_s, lane);
  accumulate_dr(ds_w, kDsLd, kRows, kbase, min(kChunk, n - kbase), kh, kw,
                dr_w, rs, lane);
  __syncwarp();  // ds_w is rewritten by the next chunk
}

__device__ __forceinline__ void dq_begin(DqRows& st) { zero(st.dq); }

// Writes the warp's dQ rows (x scale) and dr rows (/ log2 e) for queries
// row0 .. row0 + 15; dq_dst / dr_dst point at this (image, head)'s first
// row, with row strides dq_stride / dr_stride.
__device__ __forceinline__ void dq_end(const DqRows& st, float* dr_w, int rs,
                                       int rr, float scale,
                                       __nv_bfloat16* dq_dst,
                                       long long dq_stride,
                                       __nv_bfloat16* dr_dst,
                                       long long dr_stride, int row0, int n,
                                       int lane) {
  store_rows(st.dq, scale, dq_dst, dq_stride, row0, n, lane);
  __syncwarp();
  for (int idx = lane; idx < kRows * rr; idx += 32) {
    const int i = idx / rr, j = idx - i * rr, qi = row0 + i;
    if (qi < n)
      dr_dst[qi * dr_stride + j] =
          __float2bfloat16(dr_w[i * rs + j] * kInvLog2e);
  }
}

// The key cut: a warp's 16 key rows against one chunk of 32 queries. The
// warp computes S^T and dP^T (rows = keys, columns = queries), whose
// accumulator layout is the A-operand layout of dS^T . Q and P^T . dO.
struct DkvRows {
  uint32_t ka[kSteps][4];  // k as A fragments
  uint32_t va[kSteps][4];  // v as A fragments
  int ky[2], kx[2];        // bias columns of keys g, g + 8 (kx includes kh)
  bool ok[2];              // key < n
  float dk[kDh / 8][4];
  float dv[kDh / 8][4];
};

__device__ __forceinline__ void dkv_begin(DkvRows& st,
                                          const __nv_bfloat16* k_tile,
                                          const __nv_bfloat16* v_tile,
                                          int key0, int n, int kh, int kw,
                                          int lane) {
  load_a(st.ka, k_tile, lane);
  load_a(st.va, v_tile, lane);
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + g + 8 * i;
    st.ok[i] = j < n;
    st.ky[i] = st.ok[i] ? j / kw : 0;
    st.kx[i] = st.ok[i] ? kh + j - st.ky[i] * kw : 0;
  }
  zero(st.dk);
  zero(st.dv);
}

// q_s / do_s: the chunk's 32 query rows (zero past n); r_s: their r rows
// (stride rsb); lse_s / delta_s: their statistics.
__device__ __forceinline__ void dkv_chunk(DkvRows& st,
                                          const __nv_bfloat16* q_s,
                                          const __nv_bfloat16* do_s,
                                          const __nv_bfloat16* r_s, int rsb,
                                          const float* lse_s,
                                          const float* delta_s, int qbase,
                                          int n, float qscale, int lane) {
  const int t = lane & 3;
  float p[kQChunk / 8][4], ds[kQChunk / 8][4];
  zero(p);
  zero(ds);
  mma_nt(p, st.ka, q_s, lane);    // S^T, raw
  mma_nt(ds, st.va, do_s, lane);  // dP^T
#pragma unroll
  for (int nt = 0; nt < kQChunk / 8; ++nt)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int ql = nt * 8 + 2 * t + b;
      float p0 = 0.f, p1 = 0.f, d0 = 0.f, d1 = 0.f;
      if (qbase + ql < n) {
        const __nv_bfloat16* rrow = r_s + ql * rsb;
        const float lse = lse_s[ql], dl = delta_s[ql];
        if (st.ok[0]) {
          p0 = exp2f(fmaf(p[nt][b], qscale,
                          to_float(rrow[st.ky[0]]) + to_float(rrow[st.kx[0]])) -
                     lse);
          d0 = p0 * (ds[nt][b] - dl);
        }
        if (st.ok[1]) {
          p1 = exp2f(fmaf(p[nt][2 + b], qscale,
                          to_float(rrow[st.ky[1]]) + to_float(rrow[st.kx[1]])) -
                     lse);
          d1 = p1 * (ds[nt][2 + b] - dl);
        }
      }
      p[nt][b] = p0;
      p[nt][2 + b] = p1;
      ds[nt][b] = d0;
      ds[nt][2 + b] = d1;
    }
  mma_rows<kQChunk / 16>(st.dv, p, do_s, lane);
  mma_rows<kQChunk / 16>(st.dk, ds, q_s, lane);
}

// Starts the copy of `rows` r rows (row stride `stride`, first row row0,
// zero past n) into a shared tile of row stride r_stride(rr); a warp takes
// a row at a time, four values per lane by cp.async where rr allows
// (tc::cp_async_wait() completes those).
__device__ __forceinline__ void load_r_rows(const __nv_bfloat16* src,
                                            long long stride, int row0,
                                            int rows, int n, int rr,
                                            __nv_bfloat16* r_s, int tid,
                                            int nthreads) {
  const int rsb = r_stride(rr), lane = tid & 31;
  for (int row = tid >> 5; row < rows; row += nthreads >> 5) {
    const int qi = row0 + row;
    const bool valid = qi < n;
    const __nv_bfloat16* s = valid ? src + qi * stride : src;
    __nv_bfloat16* d = r_s + row * rsb;
    if (rr % 4 == 0) {
      for (int w = lane; w < rr / 4; w += 32)
        tc::cp_async_8(d + 4 * w, s + 4 * w, valid);
    } else {
      for (int j = lane; j < rr; j += 32)
        d[j] = valid ? s[j] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace tcb
}  // namespace bwd
}  // namespace relpos

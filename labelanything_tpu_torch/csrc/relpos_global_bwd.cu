// Backward of the global-block rel-pos attention (N = 64 x 64 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// _lanes_bwd -> _lanes_bwd_impl (Pallas body _lanes_bwd_kernel). The math
// is in relpos_bwd.cuh. The TPU kernel carries dK / dV in scratch memory
// along a sequential grid axis, rebuilds the softmax denominator from a
// bounded shift and takes the bias gradient as a one-hot matmul; none of
// that is carried over. Here the forward saves the exact log-sum-exp of
// every row, and the backward is three launches on one stream:
//   1. delta_kernel: delta = rowsum(dO * O);
//   2. a query cut, one block per (image, head, 64 query rows), walking
//      all key tiles: dQ and dr;
//   3. a key cut, one block per (image, head, 64 key rows), walking all
//      query tiles: dK and dV.
// Both cuts recompute P and dP (7 N^2 dh products instead of 5), which
// buys gradients without atomics. dqkv is written in place, channels
// (3, heads, 64).
//
// * bf16 (training): bwd_dq_tc_kernel / bwd_dkv_tc_kernel, four warps of
//   16 rows each on the tensor cores (mma.sync m16n8k16). 14 N^2 dh flops
//   per head against O(N dh) bytes: bound by operations. What holds it
//   below the tensor-core rate: mma.sync with four warps a block, every
//   warp waits at a barrier for each tile's cp.async copies, and tiles are
//   re-read from L2 by every block (copying the next tile during this
//   one's arithmetic was tried and was no faster: two stages cost a
//   resident block).
//   Where a row of the key grid is one chunk wide (kw = 64, the 1024-px
//   case) the bias gradient stays in registers; other grids send each dS
//   tile through shared memory (accumulate_dr). Next steps: larger tiles
//   per block, wgmma.
// * fp32 (parity): bwd_dq_f32_kernel / bwd_dkv_f32_kernel on the CUDA
//   cores, eight warps of 8 rows; operands transposed in shared memory
//   with an odd row stride so that a lane may own either a key or a
//   channel without bank conflicts.
#include <cmath>
#include <cstdint>

#include "relpos_bwd.cuh"

namespace relpos {
namespace bwd {

constexpr int kTile = 64;               // rows per block, both cuts
constexpr int kFRows = kTile / kWarps;  // rows per warp (fp32)
constexpr int kLdT = kTile + 1;         // row stride of transposed tiles

// ---- fp32 ---------------------------------------------------------------

__host__ __device__ inline size_t dq_f32_smem_floats(int rr) {
  return (size_t)2 * kTile * kDh     // q (pre-scaled), dO
         + (size_t)2 * kDh * kLdT    // K^T, V^T
         + (size_t)kTile * kLdT      // dS, per warp kFRows x kLdT
         + (size_t)2 * kTile * (rr + 1);  // r rows, dr accumulators
}

__global__ void __launch_bounds__(kThreads)
    bwd_dq_f32_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ r,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dqkv, float* __restrict__ dr, int n,
                      int heads, int kh, int kw, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rr = kh + kw, rs = rr + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * kDh;
  float* kt_s = do_s + kTile * kDh;
  float* vt_s = kt_s + kDh * kLdT;
  float* ds_s = vt_s + kDh * kLdT;
  float* r_s = ds_s + kTile * kLdT;
  float* dr_s = r_s + kTile * rs;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + b * n * row_stride + h * kDh;
  const float* dobase = dout + b * n * c + h * kDh;
  const float* rbase = r + b * n * heads * rr + h * rr;
  const float* lse_b = lse + (b * heads + h) * n;
  const float* delta_b = delta + (b * heads + h) * n;

  for (int idx = tid; idx < kTile * kDh; idx += kThreads) {
    const int i = idx / kDh, d = idx % kDh, qi = q0 + i;
    q_s[idx] = qi < n ? base[qi * row_stride + d] * qscale : 0.f;
    do_s[idx] = qi < n ? dobase[(long long)qi * c + d] : 0.f;
  }
  for (int idx = tid; idx < kTile * rr; idx += kThreads) {
    const int i = idx / rr, j = idx % rr, qi = q0 + i;
    r_s[i * rs + j] = qi < n ? rbase[(long long)qi * heads * rr + j] : 0.f;
    dr_s[i * rs + j] = 0.f;
  }

  float lse_i[kFRows], dl_i[kFRows], dq0[kFRows], dq1[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int qi = q0 + warp * kFRows + i;
    lse_i[i] = qi < n ? lse_b[qi] : 0.f;
    dl_i[i] = qi < n ? delta_b[qi] : 0.f;
    dq0[i] = 0.f;
    dq1[i] = 0.f;
  }
  const float* q_w = q_s + warp * kFRows * kDh;
  const float* do_w = do_s + warp * kFRows * kDh;
  const float* r_w = r_s + warp * kFRows * rs;
  float* dr_w = dr_s + warp * kFRows * rs;
  float* ds_w = ds_s + warp * kFRows * kLdT;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kTile * kDh; idx += kThreads) {
      const int j = idx / kDh, d = idx % kDh, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < n) {
        const float* row = base + kj * row_stride + d;
        kv = row[c];
        vv = row[2 * c];
      }
      kt_s[d * kLdT + j] = kv;
      vt_s[d * kLdT + j] = vv;
    }
    __syncthreads();

    float s0[kFRows], s1[kFRows], p0[kFRows], p1[kFRows];
#pragma unroll
    for (int i = 0; i < kFRows; ++i) s0[i] = s1[i] = p0[i] = p1[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; ++d) {
      const float ka = kt_s[d * kLdT + lane], kb = kt_s[d * kLdT + lane + 32];
      const float va = vt_s[d * kLdT + lane], vb = vt_s[d * kLdT + lane + 32];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const float qv = q_w[i * kDh + d], dv = do_w[i * kDh + d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kb, s1[i]);
        p0[i] = fmaf(dv, va, p0[i]);
        p1[i] = fmaf(dv, vb, p1[i]);
      }
    }

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
    const bool ok0 = kj0 < n, ok1 = kj1 < n;
    const int ky0 = kj0 / kw, kx0 = kh + kj0 - ky0 * kw;
    const int ky1 = kj1 / kw, kx1 = kh + kj1 - ky1 * kw;
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      const float* rrow = r_w + i * rs;
      float a = 0.f, bb = 0.f;
      if (ok0)
        a = exp2f(s0[i] + rrow[ky0] + rrow[kx0] - lse_i[i]) *
            (p0[i] - dl_i[i]);
      if (ok1)
        bb = exp2f(s1[i] + rrow[ky1] + rrow[kx1] - lse_i[i]) *
             (p1[i] - dl_i[i]);
      ds_w[i * kLdT + lane] = a;
      ds_w[i * kLdT + lane + 32] = bb;
    }
    __syncwarp();

    // dQ[i][d] += sum_j dS[i][j] K[j][d], lane owns d = lane, lane + 32
    for (int j = 0; j < kTile; ++j) {
      const float ka = kt_s[lane * kLdT + j];
      const float kb = kt_s[(lane + 32) * kLdT + j];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const float dsv = ds_w[i * kLdT + j];
        dq0[i] = fmaf(dsv, ka, dq0[i]);
        dq1[i] = fmaf(dsv, kb, dq1[i]);
      }
    }
    accumulate_dr(ds_w, kLdT, kFRows, k0, min(kTile, n - k0), kh, kw, dr_w,
                  rs, lane);
    __syncwarp();  // ds_w is rewritten for the next tile
  }

#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int qi = q0 + warp * kFRows + i;
    if (qi < n) {
      float* row = dqkv + (b * n + qi) * row_stride + h * kDh;
      row[lane] = dq0[i] * scale;
      row[lane + 32] = dq1[i] * scale;
    }
  }
  for (int idx = lane; idx < kFRows * rr; idx += 32) {
    const int i = idx / rr, j = idx - i * rr;
    const int qi = q0 + warp * kFRows + i;
    if (qi < n)
      dr[((b * n + qi) * heads + h) * rr + j] = dr_w[i * rs + j] * kInvLog2e;
  }
}

__host__ __device__ inline size_t dkv_f32_smem_floats(int rr) {
  return (size_t)2 * kTile * kDh        // K, V rows of the block
         + (size_t)2 * kDh * kLdT       // Q^T (pre-scaled), dO^T
         + (size_t)2 * kTile * kLdT     // P and dS, per warp kFRows x kLdT
         + (size_t)kTile * (rr + 1)     // r rows of the query tile
         + (size_t)2 * kTile;           // lse, delta of the query tile
}

__global__ void __launch_bounds__(kThreads)
    bwd_dkv_f32_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ r,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dqkv, int n, int heads, int kh,
                       int kw, float qscale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rr = kh + kw, rs = rr + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * kDh;
  float* qt_s = v_s + kTile * kDh;
  float* dot_s = qt_s + kDh * kLdT;
  float* p_s = dot_s + kDh * kLdT;
  float* ds_s = p_s + kTile * kLdT;
  float* r_s = ds_s + kTile * kLdT;
  float* lse_s = r_s + kTile * rs;
  float* dl_s = lse_s + kTile;

  const int key0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + b * n * row_stride + h * kDh;
  const float* dobase = dout + b * n * c + h * kDh;
  const float* rbase = r + b * n * heads * rr + h * rr;
  const float* lse_b = lse + (b * heads + h) * n;
  const float* delta_b = delta + (b * heads + h) * n;

  for (int idx = tid; idx < kTile * kDh; idx += kThreads) {
    const int j = idx / kDh, d = idx % kDh, kj = key0 + j;
    float kv = 0.f, vv = 0.f;
    if (kj < n) {
      const float* row = base + kj * row_stride + d;
      kv = row[c];
      vv = row[2 * c];
    }
    k_s[idx] = kv;
    v_s[idx] = vv;
  }

  float dk0[kFRows], dk1[kFRows], dv0[kFRows], dv1[kFRows];
  int ky[kFRows], kx[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    dk0[i] = dk1[i] = dv0[i] = dv1[i] = 0.f;
    const int kj = key0 + warp * kFRows + i;
    ky[i] = kj < n ? kj / kw : -1;
    kx[i] = kj < n ? kh + kj - ky[i] * kw : 0;
  }
  const float* k_w = k_s + warp * kFRows * kDh;
  const float* v_w = v_s + warp * kFRows * kDh;
  float* p_w = p_s + warp * kFRows * kLdT;
  float* ds_w = ds_s + warp * kFRows * kLdT;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and K / V loaded)
    for (int idx = tid; idx < kTile * kDh; idx += kThreads) {
      const int i = idx / kDh, d = idx % kDh, qi = q0 + i;
      qt_s[d * kLdT + i] = qi < n ? base[qi * row_stride + d] * qscale : 0.f;
      dot_s[d * kLdT + i] = qi < n ? dobase[(long long)qi * c + d] : 0.f;
    }
    for (int idx = tid; idx < kTile * rr; idx += kThreads) {
      const int i = idx / rr, j = idx % rr, qi = q0 + i;
      r_s[i * rs + j] = qi < n ? rbase[(long long)qi * heads * rr + j] : 0.f;
    }
    if (tid < kTile) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < n ? lse_b[qi] : 0.f;
      dl_s[tid] = qi < n ? delta_b[qi] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows = the warp's keys, lane owns queries lane, lane + 32
    float s0[kFRows], s1[kFRows], p0[kFRows], p1[kFRows];
#pragma unroll
    for (int i = 0; i < kFRows; ++i) s0[i] = s1[i] = p0[i] = p1[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; ++d) {
      const float qa = qt_s[d * kLdT + lane], qb = qt_s[d * kLdT + lane + 32];
      const float da = dot_s[d * kLdT + lane], db = dot_s[d * kLdT + lane + 32];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const float kv = k_w[i * kDh + d], vv = v_w[i * kDh + d];
        s0[i] = fmaf(kv, qa, s0[i]);
        s1[i] = fmaf(kv, qb, s1[i]);
        p0[i] = fmaf(vv, da, p0[i]);
        p1[i] = fmaf(vv, db, p1[i]);
      }
    }

    const bool okq0 = q0 + lane < n, okq1 = q0 + lane + 32 < n;
    const float* rrow0 = r_s + lane * rs;
    const float* rrow1 = r_s + (lane + 32) * rs;
    const float lse0 = lse_s[lane], lse1 = lse_s[lane + 32];
    const float dl0 = dl_s[lane], dl1 = dl_s[lane + 32];
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      float pa = 0.f, pb = 0.f;
      if (ky[i] >= 0) {
        if (okq0) pa = exp2f(s0[i] + rrow0[ky[i]] + rrow0[kx[i]] - lse0);
        if (okq1) pb = exp2f(s1[i] + rrow1[ky[i]] + rrow1[kx[i]] - lse1);
      }
      p_w[i * kLdT + lane] = pa;
      p_w[i * kLdT + lane + 32] = pb;
      ds_w[i * kLdT + lane] = pa * (p0[i] - dl0);
      ds_w[i * kLdT + lane + 32] = pb * (p1[i] - dl1);
    }
    __syncwarp();

    // dK[i][d] += sum_q dS[q][i] Q[q][d]; dV[i][d] += sum_q P[q][i] dO[q][d]
    for (int q = 0; q < kTile; ++q) {
      const float qa = qt_s[lane * kLdT + q], qb = qt_s[(lane + 32) * kLdT + q];
      const float da = dot_s[lane * kLdT + q];
      const float db = dot_s[(lane + 32) * kLdT + q];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const float dsv = ds_w[i * kLdT + q], pv = p_w[i * kLdT + q];
        dk0[i] = fmaf(dsv, qa, dk0[i]);
        dk1[i] = fmaf(dsv, qb, dk1[i]);
        dv0[i] = fmaf(pv, da, dv0[i]);
        dv1[i] = fmaf(pv, db, dv1[i]);
      }
    }
    __syncwarp();  // p_w / ds_w are rewritten for the next tile
  }

  // q was staged times scale * log2(e): dK = scale * dS^T . Q
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int kj = key0 + warp * kFRows + i;
    if (kj < n) {
      float* row = dqkv + (b * n + kj) * row_stride + h * kDh;
      row[c + lane] = dk0[i] * kInvLog2e;
      row[c + lane + 32] = dk1[i] * kInvLog2e;
      row[2 * c + lane] = dv0[i];
      row[2 * c + lane + 32] = dv1[i];
    }
  }
}

cudaError_t launch_bwd_f32(const float* qkv, const float* r,
                           const float* dout, const float* lse,
                           const float* delta, float* dqkv, float* dr, int b,
                           int n, int heads, int kh, int kw, float scale,
                           cudaStream_t stream) {
  const float qscale = scale * 1.4426950408889634f;
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  size_t smem = dq_f32_smem_floats(kh + kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dq_f32_kernel<<<grid, kThreads, smem, stream>>>(
      qkv, r, dout, lse, delta, dqkv, dr, n, heads, kh, kw, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkv_f32_smem_floats(kh + kw) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_dkv_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkv_f32_kernel<<<grid, kThreads, smem, stream>>>(
      qkv, r, dout, lse, delta, dqkv, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         long long rows, int n, int heads, int is_bf16,
                         cudaStream_t stream) {
  const long long warps = rows * heads;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (is_bf16)
    delta_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout), delta, rows, n, heads);
  else
    delta_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, rows, n, heads);
  return cudaGetLastError();
}

// ---- bf16, tensor cores -------------------------------------------------

__host__ __device__ inline size_t dq_tc_smem_bytes(int rr) {
  // the dS tiles take the place of q and dO once those are in registers
  return (size_t)(2 * tc::kChunk + 2 * kTile) * tc::kLd *
             sizeof(__nv_bfloat16)                                  // K, V, q, dO
         + (size_t)kTile * tcb::r_stride(rr) * sizeof(__nv_bfloat16)  // r
         + (size_t)kTile * (rr + 1) * sizeof(float);                // dr
}
static_assert(kTile * tcb::kDsLd * sizeof(float) <=
                  2 * kTile * tc::kLd * sizeof(__nv_bfloat16),
              "dS tiles must fit where q and dO were staged");

template <bool kRowChunk>
__global__ void __launch_bounds__(tc::kThreads)
    bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dqkv,
                     __nv_bfloat16* __restrict__ dr, int n, int heads, int kh,
                     int kw, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw, rs = rr + 1, rsb = tcb::r_stride(rr);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + tc::kTileElems;
  __nv_bfloat16* q_s = v_s + tc::kTileElems;
  __nv_bfloat16* do_s = q_s + kTile * tc::kLd;
  float* ds_s = reinterpret_cast<float*>(q_s);  // after the A fragments load
  __nv_bfloat16* r_s = do_s + kTile * tc::kLd;
  float* dr_s = reinterpret_cast<float*>(r_s + kTile * rsb);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + b * n * row_stride + h * kDh;
  const __nv_bfloat16* dobase = dout + b * n * c + h * kDh;
  const int q0 = blockIdx.x * kTile;
  const int row0 = q0 + warp * tc::kRows;

  tc::copy_rows_async(base, row_stride, q0, kTile, n, q_s, tid, tc::kThreads);
  tc::copy_rows_async(dobase, c, q0, kTile, n, do_s, tid, tc::kThreads);
  tcb::load_r_rows(r + b * n * heads * rr + h * rr, (long long)heads * rr, q0,
                   kTile, n, rr, r_s, tid, tc::kThreads);
  for (int i = tid; i < kTile * rs; i += tc::kThreads) dr_s[i] = 0.f;
  tc::cp_async_wait();
  __syncthreads();

  tcb::DqRows st;
  tcb::load_a(st.qa, q_s + warp * tc::kRows * tc::kLd, lane);
  tcb::load_a(st.da, do_s + warp * tc::kRows * tc::kLd, lane);
  tcb::dq_begin(st);
  {
    const int g = lane >> 2;
    const float* lse_b = lse + (b * heads + h) * n;
    const float* delta_b = delta + (b * heads + h) * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + g + 8 * i;
      st.lse[i] = qi < n ? lse_b[qi] : 0.f;
      st.delta[i] = qi < n ? delta_b[qi] : 0.f;
    }
  }
  const __nv_bfloat16* r_w = r_s + warp * tc::kRows * rsb;
  float* dr_w = dr_s + warp * tc::kRows * rs;
  float* ds_w = ds_s + warp * tc::kRows * tcb::kDsLd;

  for (int k0 = 0; k0 < n; k0 += tc::kChunk) {
    // previous tile fully consumed; q_s / do_s are free for the dS tiles
    __syncthreads();
    tc::copy_rows_async(base + c, row_stride, k0, tc::kChunk, n, k_s, tid,
                        tc::kThreads);
    tc::copy_rows_async(base + 2 * c, row_stride, k0, tc::kChunk, n, v_s, tid,
                        tc::kThreads);
    tc::cp_async_wait();
    __syncthreads();
    tcb::dq_chunk<kRowChunk>(st, k_s, v_s, r_w, rsb, ds_w, dr_w, rs, k0, n,
                             kh, kw, qscale, lane);
  }
  tcb::dq_end<kRowChunk>(st, dr_w, rs, rr, kh, scale,
                         dqkv + b * n * row_stride + h * kDh, row_stride,
                         dr + b * n * heads * rr + h * rr,
                         (long long)heads * rr, row0, n, lane);
}

__host__ __device__ inline size_t dkv_tc_smem_bytes(int rr) {
  return (size_t)4 * kTile * tc::kLd * sizeof(__nv_bfloat16)  // K, V, q, dO
         + (size_t)kTile * tcb::r_stride(rr) * sizeof(__nv_bfloat16)  // r
         + (size_t)2 * kTile * sizeof(float);                 // lse, delta
}

__global__ void __launch_bounds__(tc::kThreads, 3)
    bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ r,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                      int kh, int kw, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw, rsb = tcb::r_stride(rr);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + kTile * tc::kLd;
  __nv_bfloat16* q_s = v_s + kTile * tc::kLd;
  __nv_bfloat16* do_s = q_s + kTile * tc::kLd;
  __nv_bfloat16* r_s = do_s + kTile * tc::kLd;
  float* lse_s = reinterpret_cast<float*>(r_s + kTile * rsb);
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + b * n * row_stride + h * kDh;
  const __nv_bfloat16* dobase = dout + b * n * c + h * kDh;
  const __nv_bfloat16* rbase = r + b * n * heads * rr + h * rr;
  const float* lse_b = lse + (b * heads + h) * n;
  const float* delta_b = delta + (b * heads + h) * n;
  const int key0 = blockIdx.x * kTile;
  const int row0 = key0 + warp * tc::kRows;

  tc::copy_rows_async(base + c, row_stride, key0, kTile, n, k_s, tid,
                      tc::kThreads);
  tc::copy_rows_async(base + 2 * c, row_stride, key0, kTile, n, v_s, tid,
                      tc::kThreads);
  tc::cp_async_wait();
  __syncthreads();
  tcb::DkvRows st;
  tcb::dkv_begin(st, k_s + warp * tc::kRows * tc::kLd,
                 v_s + warp * tc::kRows * tc::kLd, row0, n, kh, kw, lane);

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    tc::copy_rows_async(base, row_stride, q0, kTile, n, q_s, tid,
                        tc::kThreads);
    tc::copy_rows_async(dobase, c, q0, kTile, n, do_s, tid, tc::kThreads);
    tcb::load_r_rows(rbase, (long long)heads * rr, q0, kTile, n, rr, r_s, tid,
                     tc::kThreads);
    if (tid < kTile) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < n ? lse_b[qi] : 0.f;
      dl_s[tid] = qi < n ? delta_b[qi] : 0.f;
    }
    tc::cp_async_wait();
    __syncthreads();
#pragma unroll 1
    for (int qc = 0; qc < kTile && q0 + qc < n; qc += tcb::kQChunk)
      tcb::dkv_chunk(st, q_s + qc * tc::kLd, do_s + qc * tc::kLd,
                     r_s + qc * rsb, rsb, lse_s + qc, dl_s + qc, q0 + qc, n,
                     qscale, lane);
  }
  __nv_bfloat16* dst = dqkv + b * n * row_stride + h * kDh;
  tcb::store_rows(st.dk, scale, dst + c, row_stride, row0, n, lane);
  tcb::store_rows(st.dv, 1.f, dst + 2 * c, row_stride, row0, n, lane);
}

cudaError_t launch_global_bwd_tc(const __nv_bfloat16* qkv,
                                 const __nv_bfloat16* r,
                                 const __nv_bfloat16* dout, const float* lse,
                                 const float* delta, __nv_bfloat16* dqkv,
                                 __nv_bfloat16* dr, int b, int n, int heads,
                                 int kh, int kw, float scale,
                                 cudaStream_t stream) {
  const float qscale = scale * 1.4426950408889634f;
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  size_t smem = dq_tc_smem_bytes(kh + kw);
  // a key grid whose rows are one chunk wide (64 x 64 at 1024 px) takes the
  // variant that keeps the bias gradient in registers
  auto dq_kernel = kw == tc::kChunk ? bwd_dq_tc_kernel<true>
                                    : bwd_dq_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, tc::kThreads, smem, stream>>>(
      qkv, r, dout, lse, delta, dqkv, dr, n, heads, kh, kw, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkv_tc_smem_bytes(kh + kw);
  err = cudaFuncSetAttribute(bwd_dkv_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkv_tc_kernel<<<grid, tc::kThreads, smem, stream>>>(
      qkv, r, dout, lse, delta, dqkv, n, heads, kh, kw, qscale, scale);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace relpos

// qkv (b, n, 3 * heads * 64), r (b, n, heads * (kh + kw)), out and dout
// (b, n, heads * 64) of one dtype (0 = fp32, 1 = bf16); lse (b, heads, n)
// fp32 as the forward wrote it; delta (b, heads, n) fp32 scratch. Writes
// dqkv and dr, shaped and typed as qkv and r. Everything contiguous and
// 16-byte aligned.
extern "C" int la_relpos_global_bwd(const void* qkv, const void* r,
                                    const void* out, const void* dout,
                                    const float* lse, float* delta,
                                    void* dqkv, void* dr, int b, int n,
                                    int heads, int kh, int kw, float scale,
                                    int is_bf16, void* stream) {
  namespace bw = relpos::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bw::launch_delta(out, dout, delta, (long long)b * n, n, heads, is_bf16, s);
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    err = bw::launch_global_bwd_tc(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(dr), b,
        n, heads, kh, kw, scale, s);
  else
    err = bw::launch_bwd_f32(
        static_cast<const float*>(qkv), static_cast<const float*>(r),
        static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dqkv), static_cast<float*>(dr), b, n, heads, kh,
        kw, scale, s);
  return (int)err;
}

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
//   2. a query cut, one block per (image, head, 64 query rows; 128 in the
//      wgmma kernels), walking
//      all key tiles: dQ and dr;
//   3. a key cut, one block per (image, head, 64 key rows; 128 in the
//      wgmma kernels), walking all query tiles: dK and dV.
// Both cuts recompute P and dP (7 N^2 dh products instead of 5), which
// buys gradients without atomics; FlashAttention-3's alternative, dQ summed
// across key tiles in a fixed order behind a semaphore, would also need
// dr_w (a sum over key-grid rows) reduced that way. dqkv is written in
// place, channels (3, heads, 64).
//
// * bf16 (training), key grids whose rows are 64 wide (the 1024-px case;
//   kh a multiple of 8 up to 64): dq_wgmma_kernel / dkv_wgmma_kernel in the
//   namespace hopper below. 14 N^2 dh flops per head against O(N dh)
//   bytes: bound by operations (10 N^2 dh of them at the least). Each block
//   is two consumer warpgroups of 64 rows (128 query rows in the query cut,
//   128 keys = two key-grid rows in the key cut) on wgmma: S and dP (S^T
//   and dP^T in the key cut) with both operands in shared memory, dQ += dS
//   K (dV += P^T dO, dK += dS^T Q) with the accumulators of the first
//   products as bf16 A fragments. The walked operands come through a
//   4-stage TMA ring (128-byte swizzle, the tensor maps of sm90.cuh over
//   the token-major strides), issued by thread 0 two tiles ahead; iteration
//   j issues tile j's first products beside tile j - 1's second ones, so the
//   exponentials of one run while the tensor cores finish the other. The
//   bias comes as a tile, not a gather: a walked key tile of the query cut
//   is one key-grid row, so rel_h - lse is one value a row and rel_w sits
//   in registers for the whole walk, and the key cut reads rel_w^T for its
//   64 keys from the swizzled r tile with ldmatrix.trans. One
//   ex2.approx.ftz an exponential, no bounds test (the tiles are full). No
//   atomics: dQ, dr in the query cut, dK, dV in the key cut, each written by
//   one block, so gradients are the same bits from run to run.
//   What holds it at about a quarter of the bound: two warpgroups an SM
//   (four live 64 x 64 fp32 tiles a warpgroup take some 200 registers a
//   thread), which issue about 500 instructions a tile at well under one a
//   clock; the tensor cores and the exponential units are each busy a
//   minority of the time.
// * bf16, other grids: bwd_dq_tc_kernel / bwd_dkv_tc_kernel, four warps of
//   16 rows each on mma.sync m16n8k16, a barrier and a synchronous cp.async
//   copy per 64-row tile; the query cut sends each dS tile through shared
//   memory for the bias gradient (accumulate_dr).
// * fp32 (parity): bwd_dq_f32_kernel / bwd_dkv_f32_kernel on the CUDA
//   cores, eight warps of 8 rows; operands transposed in shared memory
//   with an odd row stride so that a lane may own either a key or a
//   channel without bank conflicts.
#include <cmath>
#include <cstdint>

#include "relpos_bwd.cuh"
#include "sm90.cuh"

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
    tcb::dq_chunk(st, k_s, v_s, r_w, rsb, ds_w, dr_w, rs, k0, n, kh, kw,
                  qscale, lane);
  }
  tcb::dq_end(st, dr_w, rs, rr, scale, dqkv + b * n * row_stride + h * kDh,
              row_stride, dr + b * n * heads * rr + h * rr,
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

// ---- bf16, Hopper: wgmma fed by TMA (key grids whose rows are 64 wide) ---

namespace hopper {

using namespace sm90;

constexpr int kRowsWg = 64;                    // rows a consumer warpgroup owns
constexpr int kConsumers = 2;
constexpr int kBlockRows = kRowsWg * kConsumers;
constexpr int kWalk = 64;                      // rows of a walked tile: one
                                               // key-grid row in the query cut
constexpr int kStages = 4;                     // ring of walked tiles
constexpr int kThreads = 128 * kConsumers;
// A producer warp of its own would cost a warpgroup's share of the
// registers (ptxas allots them by warpgroups: 168 a thread with it, and the
// cuts spill at 168); thread 0 issues the copies instead, each tile's
// stages - 2 tiles ahead, refilling the stage of the tile two back so that
// the other warpgroup may lag a tile without stalling it.
static_assert((kStages & (kStages - 1)) == 0, "a power of two");
constexpr int kLead = kStages - 2;
constexpr int kMaxKh = 64;
constexpr int kHlLd = kMaxKh + 1;              // row stride of the hl tile
constexpr uint32_t kTileBytes = kWalk * kDh * 2;
// the distance of two stages of a walked operand, in the 16-byte units of a
// wgmma descriptor's address field
constexpr uint64_t kStageDesc = kTileBytes / 16;
constexpr int kConsumerWarps = kThreads / 32;

// The grids these kernels take: rows of the key grid 64 wide (a walked tile
// of the query cut is one key-grid row; a block's 128 keys are two), kh a
// multiple of 8 (r rows of 16-byte multiples for the TMA) up to 64.
__host__ __device__ inline bool grid_ok(int kh, int kw) {
  return kw == kWalk && kh % 8 == 0 && kh >= 8 && kh <= kMaxKh;
}

__device__ __forceinline__ float lo_bf16(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// x (64 x 64, this warpgroup's accumulators) = A . B^T over dh 64, both
// K-major 128-byte-swizzled tiles of 64-wide rows (descriptors da, db)
__device__ __forceinline__ void issue_nt(float (&x)[32], uint64_t da,
                                         uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < kDh / 16; ++ks)  // 16 columns = 32 bytes a step
    wgmma_m64n64k16_ss(x, da + 2 * ks, db + 2 * ks, ks > 0);
}

// acc (64 x 64) += A . B, A 64 x 64 as bf16 A fragments in registers (the
// accumulator layout of a 64 x 64 product, packed), B a 64-row tile read
// MN-major (descriptor db)
__device__ __forceinline__ void issue_rs(float (&acc)[32],
                                         const uint32_t (&a)[16],
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kWalk / 16; ++kk)  // 16 rows of 128 bytes a step
    wgmma_m64n64k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                       a[4 * kk + 3], db + kk * 128);
}

// accumulators as bf16 A fragments: p[2 nb] row g, p[2 nb + 1] row g + 8
__device__ __forceinline__ void pack(const float (&x)[32], uint32_t (&p)[16]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    p[2 * nb] = pack_bf16(x[4 * nb], x[4 * nb + 1]);
    p[2 * nb + 1] = pack_bf16(x[4 * nb + 2], x[4 * nb + 3]);
  }
}

// writes a warp's 16 rows of 64 accumulators (x mul) as bf16 pairs; `row`
// points at the thread's row g, rows g + 8 lie `stride` further
__device__ __forceinline__ void store_acc(const float (&x)[32], float mul,
                                          __nv_bfloat16* row,
                                          long long stride, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<uint32_t*>(row + i * 8 * stride + 8 * nb + 2 * t) =
          pack_bf16(x[4 * nb + 2 * i] * mul, x[4 * nb + 2 * i + 1] * mul);
}

// The block's shared memory from its first 1024-aligned byte (the swizzle
// patterns repeat every 1024 bytes). The offset is added to the shared array
// itself, so that the compiler still sees shared-memory addresses (LDS, not
// generic loads).
template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return *reinterpret_cast<Smem*>(raw + pad);
}

// The query cut: a block owns 128 query rows (two consumer warpgroups of
// 64) and walks every key-grid row (64 keys) of the image's head.
struct DqSmem {
  __nv_bfloat16 q[kBlockRows * kDh];
  __nv_bfloat16 dout[kBlockRows * kDh];
  __nv_bfloat16 k[kStages][kWalk * kDh];
  __nv_bfloat16 v[kStages][kWalk * kDh];
  // r[q, ky] - lse[q] of the block's rows; entry (q, ky) is replaced by
  // dr_h[q, ky] once key-grid row ky is done
  float hl[kBlockRows * kHlLd];
  uint64_t q_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __nv_bfloat16* __restrict__ r,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dqkv,
                    __nv_bfloat16* __restrict__ dr, int n, int heads, int kh,
                    float qscale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // uniform across the warp and keeps what derives from it in uniform
  // registers
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBlockRows;
  const int rr = kh + kWalk, tiles = kh;  // a key tile is a key-grid row
  const long long rs = (long long)heads * rr;  // token stride of r and dr
  const long long bh = (long long)b * heads + h;
  const __nv_bfloat16* r_b = r + ((long long)b * n + q0) * rs + h * rr;
  const float* lse_b = lse + bh * n + q0;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kBlockRows * kh; i += kThreads) {
    const int row = i / kh, ky = i - row * kh;
    sm.hl[row * kHlLd + ky] =
        __bfloat162float(r_b[row * rs + ky]) - lse_b[row];
  }
  __syncthreads();

  // thread 0 issues the copies: tile j into stage j % kStages once the
  // tile that held it is consumed
  auto issue = [&](int j) {
    const int st = j & (kStages - 1);
    if (j >= kStages) mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
    tma_load(sm.k[st], &tk, &sm.full[st], j * kWalk, h, b);
    tma_load(sm.v[st], &tv, &sm.full[st], j * kWalk, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&sm.q_full, 2 * kBlockRows * kDh * 2);
    tma_load(sm.q, &tq, &sm.q_full, q0, h, b);
    tma_load(sm.dout, &tdo, &sm.q_full, q0, h, b);
    for (int j = 0; j < kStages && j < tiles; ++j) issue(j);
  }

  const int lt = tid % 128, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = wg * kRowsWg + warp * 16 + g;  // block row of row g
  // rel_w of rows g, g + 8 at this thread's key columns 8 nb + 2 t, + 1:
  // the same in every key-grid row
  float rw[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(
          r_b + (row + 8 * i) * rs + kh + 8 * nb + 2 * t);
      rw[i][2 * nb] = lo_bf16(x);
      rw[i][2 * nb + 1] = hi_bf16(x);
    }
  const float* delta_b = delta + bh * n + q0;
  const float dl[2] = {delta_b[row], delta_b[row + 8]};
  float* hl[2] = {sm.hl + row * kHlLd, sm.hl + (row + 8) * kHlLd};

  float s[32], dp[32], dq[32], drw[32];
  uint32_t pa[16];
  zero(dq);
  zero(drw);
  mbar_wait(&sm.q_full, 0);
  const uint64_t dq_desc = make_desc<kDh>(sm.q + wg * kRowsWg * kDh, 16 * kDh);
  const uint64_t do_desc =
      make_desc<kDh>(sm.dout + wg * kRowsWg * kDh, 16 * kDh);
  const uint64_t k_desc = make_desc<kDh>(sm.k[0], 16 * kDh);
  const uint64_t v_desc = make_desc<kDh>(sm.v[0], 16 * kDh);

  // Iteration j issues S and dP of key tile j beside dQ += dS K of tile
  // j - 1, so that tile j's exponentials run while the tensor cores finish
  // tile j - 1's product; pa holds tile j - 1's dS until that product is
  // done. The first and last tiles are peeled, so that no product is
  // issued under a condition.
  auto wait_tile = [&](int j) {
    if (tid == 0 && j >= 2 && j + kLead < tiles) issue(j + kLead);
    __syncwarp();
    mbar_wait(&sm.full[j & (kStages - 1)], (j / kStages) & 1);
  };
  // S and dP in two commit groups: P's exponentials start while dP runs
  auto issue_s = [&](int st) {
    issue_nt(s, dq_desc, k_desc + st * kStageDesc);  // S = Q K^T
    wgmma_commit();
    issue_nt(dp, do_desc, v_desc + st * kStageDesc);  // dP = dO V^T
    wgmma_commit();
  };
  auto issue_dq = [&](int st) {  // dQ += dS K
    issue_rs(dq, pa, k_desc + st * kStageDesc);
    wgmma_commit();
  };
  // P = exp2(S c + rel_w + rel_h - lse) in s; the tile is key-grid row j,
  // so rel_h - lse is one value a row
  auto probs = [&](int j) {
    const float h0 = hl[0][j], h1 = hl[1][j];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i0 = 4 * nb + e, i1 = 4 * nb + 2 + e;
        s[i0] = ex2(fmaf(s[i0], qscale, rw[0][2 * nb + e] + h0));
        s[i1] = ex2(fmaf(s[i1], qscale, rw[1][2 * nb + e] + h1));
      }
  };
  // dS = P (dP - delta) in s, and the bias gradient
  auto grads = [&](int j) {
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i0 = 4 * nb + e, i1 = 4 * nb + 2 + e;
        s[i0] *= dp[i0] - dl[0];
        s[i1] *= dp[i1] - dl[1];
        drw[i0] += s[i0];
        drw[i1] += s[i1];
        sum0 += s[i0];
        sum1 += s[i1];
      }
    // dr_h of key-grid row j: a row lives in the 4 lanes of a quad
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    if (t == 0) {
      hl[0][j] = sum0 * kInvLog2e;
      hl[1][j] = sum1 * kInvLog2e;
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  };

  wait_tile(0);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<1>();
  fence_regs(s);
  probs(0);
  wgmma_wait<0>();
  fence_regs(dp);
  grads(0);
  pack(s, pa);
  for (int j = 1; j < tiles; ++j) {
    const int st = j & (kStages - 1), sp = (j - 1) & (kStages - 1);
    wait_tile(j);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dq);
    fence_regs(pa);
    wgmma_fence();
    issue_s(st);
    issue_dq(sp);
    wgmma_wait<2>();
    fence_regs(s);
    probs(j);
    wgmma_wait<1>();
    fence_regs(dp);
    grads(j);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(pa);
    release(sp);
    pack(s, pa);
  }
  fence_regs(dq);
  fence_regs(pa);
  wgmma_fence();
  issue_dq((tiles - 1) & (kStages - 1));
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(pa);
  release((tiles - 1) & (kStages - 1));

  const long long c3 = 3LL * heads * kDh;
  store_acc(dq, scale, dqkv + ((long long)b * n + q0 + row) * c3 + h * kDh,
            c3, t);
  __nv_bfloat16* dr_b = dr + ((long long)b * n + q0) * rs + h * rr;
  store_acc(drw, kInvLog2e, dr_b + row * rs + kh, rs, t);
  __syncwarp();  // the quads' dr_h entries landed
  const int row0 = wg * kRowsWg + warp * 16;
  for (int i = lane; i < 16 * kh; i += 32) {
    const int rl = row0 + i / kh, ky = i % kh;
    dr_b[rl * rs + ky] = __float2bfloat16(sm.hl[rl * kHlLd + ky]);
  }
}

// The key cut: a block owns 128 keys (two key-grid rows, one a consumer
// warpgroup) and walks every 64-query tile. It computes S^T and dP^T (rows
// = keys, columns = queries), whose accumulators are the A fragments of
// dV += P^T dO and dK += dS^T Q.
struct DkvSmem {
  __nv_bfloat16 k[kBlockRows * kDh];
  __nv_bfloat16 v[kBlockRows * kDh];
  __nv_bfloat16 q[kStages][kWalk * kDh];
  __nv_bfloat16 dout[kStages][kWalk * kDh];
  // r[q, kh + kx] and r[q, 0 .. 63] (rel_w, and rel_h at kh <= 64) of the
  // tile's queries, 128-byte swizzled
  __nv_bfloat16 rw[kStages][kWalk * kWalk];
  __nv_bfloat16 rh[kStages][kWalk * kWalk];
  float lse[kStages][kWalk];
  float delta[kStages][kWalk];
  uint64_t kv_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap trw,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                     int kh, float qscale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // uniform across the warp and keeps what derives from it in uniform
  // registers
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y, b = blockIdx.z, key0 = blockIdx.x * kBlockRows;
  const int tiles = n / kWalk, ky0 = key0 / kWalk;
  const long long bh = (long long)b * heads + h;

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {
    const int st = j & (kStages - 1);
    if (j >= kStages) mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.full[st], 4 * kTileBytes + 2 * kWalk * 4);
    tma_load(sm.q[st], &tq, &sm.full[st], j * kWalk, h, b);
    tma_load(sm.dout[st], &tdo, &sm.full[st], j * kWalk, h, b);
    tma_load(sm.rw[st], &trw, &sm.full[st], j * kWalk, h, b, kh);
    tma_load(sm.rh[st], &trw, &sm.full[st], j * kWalk, h, b, 0);
    bulk_load(sm.lse[st], lse + bh * n + j * kWalk, kWalk * 4, &sm.full[st]);
    bulk_load(sm.delta[st], delta + bh * n + j * kWalk, kWalk * 4,
              &sm.full[st]);
  };
  if (tid == 0) {
    mbar_expect_tx(&sm.kv_full, 2 * kBlockRows * kDh * 2);
    tma_load(sm.k, &tk, &sm.kv_full, key0, h, b);
    tma_load(sm.v, &tv, &sm.kv_full, key0, h, b);
    for (int j = 0; j < kStages && j < tiles; ++j) issue(j);
  }

  const int lt = tid % 128, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[32], dp[32], dk[32], dv[32];
  uint32_t pp[16], pd[16];
  zero(dk);
  zero(dv);
  mbar_wait(&sm.kv_full, 0);
  const uint64_t k_desc = make_desc<kDh>(sm.k + wg * kRowsWg * kDh, 16 * kDh);
  const uint64_t v_desc = make_desc<kDh>(sm.v + wg * kRowsWg * kDh, 16 * kDh);
  const uint64_t q_desc = make_desc<kDh>(sm.q[0], 16 * kDh);
  const uint64_t do_desc = make_desc<kDh>(sm.dout[0], 16 * kDh);
  // This thread's offsets into a stage's tiles, the same for every tile.
  // ldmatrix.trans of the rel_w tile: lane L addresses row L % 8 of 8 x 8
  // matrix L / 8, which is query block 2 a + L / 16 and key half (L / 8) % 2;
  // TMA wrote 16-byte piece c of row q at c ^ (q % 8)
  const int mrow = lane & 7, mq = lane >> 4, mx = (lane >> 3) & 1;
  const int rw_off = (8 * mq + mrow) * kWalk + ((2 * warp + mx) ^ mrow) * 8;
  // rel_h of this warpgroup's key-grid row ky0 + wg for queries 8 nb + 2 t
  // + e: row q's piece ky / 8 lies at (ky / 8) ^ (2 t + e)
  const int ky = ky0 + wg;
  int rh_off[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    rh_off[e] = (2 * t + e) * kWalk +
                ((((ky >> 3) ^ (2 * t + e)) << 3) | (ky & 7));

  auto wait_tile = [&](int j) {
    if (tid == 0 && j >= 2 && j + kLead < tiles) issue(j + kLead);
    __syncwarp();
    mbar_wait(&sm.full[j & (kStages - 1)], (j / kStages) & 1);
  };
  // S^T and dP^T in two commit groups: P's exponentials start while dP^T
  // runs
  auto issue_s = [&](int st) {
    issue_nt(s, k_desc, q_desc + st * kStageDesc);  // S^T = K Q^T
    wgmma_commit();
    issue_nt(dp, v_desc, do_desc + st * kStageDesc);  // dP^T = V dO^T
    wgmma_commit();
  };
  auto issue_dkv = [&](int st) {  // dV += P^T dO, dK += dS^T Q
    issue_rs(dv, pp, do_desc + st * kStageDesc);
    issue_rs(dk, pd, q_desc + st * kStageDesc);
    wgmma_commit();
  };
  // P^T in s
  auto probs = [&](int st) {
    const __nv_bfloat16* rw_t = sm.rw[st] + rw_off;
    const __nv_bfloat16* rh_t = sm.rh[st];
    const float* lse_t = sm.lse[st] + 2 * t;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      // rel_w[q, kx] for this thread's keys kx = 16 warp + g (+ 8) and
      // queries 8 nb + 2 t (+ 1), nb = 2 a, 2 a + 1, as bf16 pairs: the
      // tile's rows are queries, so ldmatrix.trans turns them into the
      // accumulators' layout
      uint32_t bw[4];
      tc::ldmatrix_x4_trans(bw, rw_t + 16 * a * kWalk);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nb = 2 * a + u;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * nb);
        // rel_h of this warpgroup's key-grid row less lse, per query
        const float hq[2] = {
            __bfloat162float(rh_t[8 * nb * kWalk + rh_off[0]]) - l2.x,
            __bfloat162float(rh_t[8 * nb * kWalk + rh_off[1]]) - l2.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i0 = 4 * nb + e, i1 = 4 * nb + 2 + e;
          const float w0 = e ? hi_bf16(bw[2 * u]) : lo_bf16(bw[2 * u]);
          const float w1 =
              e ? hi_bf16(bw[2 * u + 1]) : lo_bf16(bw[2 * u + 1]);
          s[i0] = ex2(fmaf(s[i0], qscale, w0 + hq[e]));
          s[i1] = ex2(fmaf(s[i1], qscale, w1 + hq[e]));
        }
      }
    }
  };
  // dS^T = P^T (dP^T - delta) in dp
  auto grads = [&](int st) {
    const float* delta_t = sm.delta[st] + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * nb);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = e ? d2.y : d2.x;
        dp[4 * nb + e] = s[4 * nb + e] * (dp[4 * nb + e] - dl);
        dp[4 * nb + 2 + e] = s[4 * nb + 2 + e] * (dp[4 * nb + 2 + e] - dl);
      }
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  };

  wait_tile(0);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<1>();
  fence_regs(s);
  probs(0);
  wgmma_wait<0>();
  fence_regs(dp);
  grads(0);
  pack(s, pp);
  pack(dp, pd);
  for (int j = 1; j < tiles; ++j) {
    const int st = j & (kStages - 1), sp = (j - 1) & (kStages - 1);
    wait_tile(j);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pp);
    fence_regs(pd);
    wgmma_fence();
    issue_s(st);
    issue_dkv(sp);
    wgmma_wait<2>();
    fence_regs(s);
    probs(st);
    wgmma_wait<1>();
    fence_regs(dp);
    grads(st);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pp);
    fence_regs(pd);
    release(sp);
    pack(s, pp);
    pack(dp, pd);
  }
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pp);
  fence_regs(pd);
  wgmma_fence();
  issue_dkv((tiles - 1) & (kStages - 1));
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pp);
  fence_regs(pd);
  release((tiles - 1) & (kStages - 1));

  const long long c = (long long)heads * kDh, c3 = 3 * c;
  __nv_bfloat16* row = dqkv +
                       ((long long)b * n + key0 + wg * kRowsWg + warp * 16 +
                        g) * c3 + h * kDh;
  store_acc(dk, scale, row + c, c3, t);
  store_acc(dv, 1.f, row + 2 * c, c3, t);
}

cudaError_t launch(const __nv_bfloat16* qkv, const __nv_bfloat16* r,
                   const __nv_bfloat16* dout, const float* lse,
                   const float* delta, __nv_bfloat16* dqkv,
                   __nv_bfloat16* dr, int b, int n, int heads, int kh,
                   float scale, cudaStream_t stream) {
  const float qscale = scale * 1.4426950408889634f;
  const long long c = (long long)heads * kDh, rr = kh + kWalk;
  const long long sq[3] = {n * 3 * c, kDh, 3 * c};
  const long long sdo[3] = {n * c, kDh, c};
  const long long sr[3] = {n * heads * rr, rr, heads * rr};
  const dim3 grid(n / kBlockRows, heads, b);
  {
    CUtensorMap tq, tdo, tk, tv;
    if (!make_map<kDh>(&tq, qkv, b, heads, n, sq, kBlockRows) ||
        !make_map<kDh>(&tdo, dout, b, heads, n, sdo, kBlockRows) ||
        !make_map<kDh>(&tk, qkv + c, b, heads, n, sq, kWalk) ||
        !make_map<kDh>(&tv, qkv + 2 * c, b, heads, n, sq, kWalk))
      return cudaErrorInvalidValue;
    const size_t smem = sizeof(DqSmem) + 1024;
    cudaError_t err = cudaFuncSetAttribute(
        dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    dq_wgmma_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tdo, tk, tv, r, lse, delta, dqkv, dr, n, heads, kh, qscale,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap tq, tdo, tk, tv, trw;
  if (!make_map<kDh>(&tq, qkv, b, heads, n, sq, kWalk) ||
      !make_map<kDh>(&tdo, dout, b, heads, n, sdo, kWalk) ||
      !make_map<kDh>(&tk, qkv + c, b, heads, n, sq, kBlockRows) ||
      !make_map<kDh>(&tv, qkv + 2 * c, b, heads, n, sq, kBlockRows) ||
      !encode_map(&trw, r, b, heads, n, (int)rr, sr, kWalk, kWalk,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(DkvSmem) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dkv_wgmma_kernel<<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, trw, lse, delta, dqkv, n, heads, kh, qscale, scale);
  return cudaGetLastError();
}

}  // namespace hopper

cudaError_t launch_global_bwd_tc(const __nv_bfloat16* qkv,
                                 const __nv_bfloat16* r,
                                 const __nv_bfloat16* dout, const float* lse,
                                 const float* delta, __nv_bfloat16* dqkv,
                                 __nv_bfloat16* dr, int b, int n, int heads,
                                 int kh, int kw, float scale,
                                 cudaStream_t stream) {
  if (hopper::grid_ok(kh, kw))
    return hopper::launch(qkv, r, dout, lse, delta, dqkv, dr, b, n, heads, kh,
                          scale, stream);
  const float qscale = scale * 1.4426950408889634f;
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  size_t smem = dq_tc_smem_bytes(kh + kw);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dq_tc_kernel<<<grid, tc::kThreads, smem, stream>>>(
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

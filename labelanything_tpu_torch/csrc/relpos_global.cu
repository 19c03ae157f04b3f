// Global-block rel-pos attention (SAM ViT global layers, N = 64 x 64 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// flash_attention_relpos_lanes -> _lanes_fwd_impl (Pallas bodies
// _relpos_lanes_kernel_vpu and _relpos_lanes_kernel).
//
// Both kernels here take one block per (image, head, 64-row query tile)
// and walk the keys in tiles of 64 with an online softmax (exact running
// max, rescaled fp32 accumulators), so no N x N array reaches device
// memory. The factored bias is read straight from r: key j has
// ky = j / kw, kx = j % kw. The TPU kernel's one-hot bias matmul, bounded
// (Cauchy-Schwarz) softmax shift and ones-column denominator were devices
// of the TPU's matrix unit and are not carried over.
//
// * bf16: relpos_global_tc_kernel, four warps of 16 query rows each on the
//   tensor cores (mma.sync m16n8k16, see relpos_mma.cuh), for key grids
//   off the Hopper route: at 1024 px (rows 64 wide, kh even) the wrapper
//   launches la_relpos_global_wgmma (relpos_packed_sm90.cu) instead, by
//   the rule ops/flash_attention.py global_kernel. The work is 4 N^2 dh
//   flops per head against 6 N dh bytes of q, K and V, 2 N / 3 flops per
//   byte (about 2700 at N = 4096):
//   bound by operations, not by device memory. What holds it below the
//   tensor-core rate: mma.sync with four warps a block, and every warp
//   waits at a barrier for each K/V tile (copied with cp.async, all of a
//   thread's 16-byte copies in flight at once), which each of the N/64
//   query tiles re-reads from L2. Copying the next tile during this one's
//   arithmetic (two stages) was tried and was no faster: it costs a third
//   of the resident blocks. The wgmma kernel took both next steps.
// * fp32: relpos_global_kernel on the CUDA cores. Each key tile sits in
//   shared memory (K transposed, V row-major); warp w owns query rows
//   8w..8w+7, lane l owns keys l and l+32 of the tile for the scores and
//   output columns l and l+32 for P.V; shared-memory operand reads are
//   float4 broadcasts to keep them below the FMA rate.
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kRows = kQTile / kWarps;  // query rows per warp
constexpr int kLdk = kKTile + 1;        // padded row of transposed K

__host__ __device__ inline size_t global_smem_floats(int rr) {
  return (size_t)kQTile * kDh      // q (pre-scaled)
         + (size_t)kDh * kLdk      // K^T tile
         + (size_t)kKTile * kDh    // V tile
         + (size_t)kQTile * kKTile // P, per warp kRows x kKTile
         + (size_t)kQTile * rr;    // r rows of the query tile
}

__global__ void __launch_bounds__(kThreads)
    relpos_global_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ r, float* __restrict__ out,
                         float* __restrict__ lse, int n, int heads, int kh,
                         int kw, float qscale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rr = kh + kw;
  float* q_s = smem;
  float* kt_s = q_s + kQTile * kDh;
  float* v_s = kt_s + kDh * kLdk;
  float* p_s = v_s + kKTile * kDh;
  float* r_s = p_s + kQTile * kKTile;

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + (long long)b * n * row_stride;
  const float* rbase = r + (long long)b * n * heads * rr;

  for (int idx = tid; idx < kQTile * kDh; idx += kThreads) {
    const int i = idx / kDh, d = idx % kDh, qi = q0 + i;
    q_s[idx] = qi < n ? base[qi * row_stride + h * kDh + d] * qscale : 0.f;
  }
  for (int idx = tid; idx < kQTile * rr; idx += kThreads) {
    const int i = idx / rr, j = idx % rr, qi = q0 + i;
    r_s[idx] = qi < n ? rbase[((long long)qi * heads + h) * rr + j] : 0.f;
  }

  float m[kRows], l[kRows], o0[kRows], o1[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    o0[i] = 0.f;
    o1[i] = 0.f;
  }
  const float* q_w = q_s + warp * kRows * kDh;
  const float* r_w = r_s + warp * kRows * rr;
  float* p_w = p_s + warp * kRows * kKTile;

  for (int k0 = 0; k0 < n; k0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kKTile * kDh; idx += kThreads) {
      const int j = idx / kDh, d = idx % kDh, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < n) {
        const float* row = base + kj * row_stride + h * kDh + d;
        kv = row[c];
        vv = row[2 * c];
      }
      kt_s[d * kLdk + j] = kv;
      v_s[j * kDh + d] = vv;
    }
    __syncthreads();

    float s0[kRows], s1[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s0[i] = 0.f;
      s1[i] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      const float a0 = kt_s[(d + 0) * kLdk + lane];
      const float a1 = kt_s[(d + 1) * kLdk + lane];
      const float a2 = kt_s[(d + 2) * kLdk + lane];
      const float a3 = kt_s[(d + 3) * kLdk + lane];
      const float b0 = kt_s[(d + 0) * kLdk + lane + 32];
      const float b1 = kt_s[(d + 1) * kLdk + lane + 32];
      const float b2 = kt_s[(d + 2) * kLdk + lane + 32];
      const float b3 = kt_s[(d + 3) * kLdk + lane + 32];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + i * kDh + d);
        s0[i] = fmaf(qv.x, a0, fmaf(qv.y, a1, fmaf(qv.z, a2, fmaf(qv.w, a3, s0[i]))));
        s1[i] = fmaf(qv.x, b0, fmaf(qv.y, b1, fmaf(qv.z, b2, fmaf(qv.w, b3, s1[i]))));
      }
    }

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
    const bool ok0 = kj0 < n, ok1 = kj1 < n;
    const int ky0 = kj0 / kw, kx0 = kj0 - ky0 * kw;
    const int ky1 = kj1 / kw, kx1 = kj1 - ky1 * kw;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* rrow = r_w + i * rr;
      const float a = ok0 ? s0[i] + rrow[ky0] + rrow[kh + kx0] : -INFINITY;
      const float bb = ok1 ? s1[i] + rrow[ky1] + rrow[kh + kx1] : -INFINITY;
      // key k0 < n is always valid, so the tile max is finite
      const float m_new = fmaxf(m[i], warp_max(fmaxf(a, bb)));
      const float alpha = exp2f(m[i] - m_new);
      const float pa = exp2f(a - m_new);
      const float pb = exp2f(bb - m_new);
      l[i] = l[i] * alpha + warp_sum(pa + pb);
      m[i] = m_new;
      o0[i] *= alpha;
      o1[i] *= alpha;
      p_w[i * kKTile + lane] = pa;
      p_w[i * kKTile + lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kKTile; j += 4) {
      const float a0 = v_s[(j + 0) * kDh + lane];
      const float a1 = v_s[(j + 1) * kDh + lane];
      const float a2 = v_s[(j + 2) * kDh + lane];
      const float a3 = v_s[(j + 3) * kDh + lane];
      const float b0 = v_s[(j + 0) * kDh + lane + 32];
      const float b1 = v_s[(j + 1) * kDh + lane + 32];
      const float b2 = v_s[(j + 2) * kDh + lane + 32];
      const float b3 = v_s[(j + 3) * kDh + lane + 32];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + i * kKTile + j);
        o0[i] = fmaf(pv.x, a0, fmaf(pv.y, a1, fmaf(pv.z, a2, fmaf(pv.w, a3, o0[i]))));
        o1[i] = fmaf(pv.x, b0, fmaf(pv.y, b1, fmaf(pv.z, b2, fmaf(pv.w, b3, o1[i]))));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + warp * kRows + i;
    if (qi < n) {
      const float inv = 1.f / l[i];
      float* orow = out + ((long long)b * n + qi) * c + h * kDh;
      orow[lane] = o0[i] * inv;
      orow[lane + 32] = o1[i] * inv;
      if (lse != nullptr && lane == 0)
        lse[((long long)b * heads + h) * n + qi] = m[i] + log2f(l[i]);
    }
  }
}

cudaError_t launch_global(const void* qkv, const void* r, void* out,
                          float* lse, int b, int n, int heads, int kh, int kw,
                          float qscale, cudaStream_t stream) {
  const size_t smem = global_smem_floats(kh + kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile - 1) / kQTile, heads, b);
  relpos_global_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(r),
      static_cast<float*>(out), lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

template <bool kRowChunk>
__global__ void __launch_bounds__(tc::kThreads)
    relpos_global_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ r,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int n, int heads, int kh,
                            int kw, float qscale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + tc::kTileElems;
  __nv_bfloat16* q_s = v_s + tc::kTileElems;
  float* r_s = reinterpret_cast<float*>(q_s + tc::kWarps * tc::kRows * tc::kLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride + h * kDh;
  const int row0 = (blockIdx.x * tc::kWarps + warp) * tc::kRows;
  float* r_w = r_s + warp * tc::kRows * (rr + 1);

  tc::Rows st;
  tc::begin_rows(st, base, row_stride, row0, n,
                 q_s + warp * tc::kRows * tc::kLd, lane);
  tc::load_r(r + (long long)b * n * heads * rr + h * rr,
             (long long)heads * rr, row0, n, rr, r_w, lane);
  for (int k0 = 0; k0 < n; k0 += tc::kChunk) {
    __syncthreads();  // previous tile fully consumed
    tc::copy_rows_async(base + c, row_stride, k0, tc::kChunk, n, k_s, tid,
                        tc::kThreads);
    tc::copy_rows_async(base + 2 * c, row_stride, k0, tc::kChunk, n, v_s, tid,
                        tc::kThreads);
    tc::cp_async_wait();
    __syncthreads();
    tc::chunk<kRowChunk>(st, k_s, v_s, r_w, rr + 1, k0, n, kh, kw, qscale,
                         lane);
  }
  tc::end_rows(st, out + (long long)b * n * c + h * kDh, c, row0, n, lane,
               lse == nullptr ? nullptr
                              : lse + ((long long)b * heads + h) * n);
}

cudaError_t launch_global_tc(const void* qkv, const void* r, void* out,
                             float* lse, int b, int n, int heads, int kh,
                             int kw, float qscale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * tc::kChunk + tc::kWarps * tc::kRows) * tc::kLd *
          sizeof(__nv_bfloat16) +
      (size_t)tc::kWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  // a key grid whose rows are one chunk wide (64 x 64 at 1024 px) takes
  // the variant that reads the bias without a division
  auto kernel = kw == tc::kChunk ? relpos_global_tc_kernel<true>
                                 : relpos_global_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = tc::kWarps * tc::kRows;
  const dim3 grid((n + rows - 1) / rows, heads, b);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

}  // namespace relpos

// qkv (b, n, 3 * heads * 64), r (b, n, heads * (kh + kw)) and out
// (b, n, heads * 64), contiguous and 16-byte aligned, all of one dtype
// (0 = fp32, 1 = bf16). scale is the plain score scale; log2(e) is folded
// in here. lse is null, or (b, heads, n) fp32 that receives every row's
// log-sum-exp in the log2 domain for the backward kernels.
extern "C" int la_relpos_global(const void* qkv, const void* r, void* out,
                                float* lse, int b, int n, int heads, int kh,
                                int kw, float scale, int is_bf16,
                                void* stream) {
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? relpos::launch_global_tc(qkv, r, out, lse, b, n, heads, kh,
                                         kw, qscale, s)
              : relpos::launch_global(qkv, r, out, lse, b, n, heads, kh, kw,
                                      qscale, s);
  return (int)err;
}

extern "C" const char* la_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Windowed-block rel-pos attention (SAM ViT windowed layers, 14 x 14
// windows of N = 196 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// flash_attention_relpos_lanes_batched -> _lanes_batched_fwd_impl (Pallas
// body _relpos_lanes_batched_kernel).
//
// Both kernels here take one block per (window, head) and keep the whole
// window's K and V in shared memory for the block's life, so they are read
// from device memory once. Zero-padded tokens of a padded window are real
// keys (they carry qkv = bias) and are attended, as in the reference; only
// keys past N are masked. The TPU kernel's operand augmentation (bias
// folded into the score matmul through one-hot columns) and bounded
// softmax shift were matrix-unit devices and are not carried over. N is
// capped at 256 keys.
//
// * bf16 (the serving path): relpos_window_tc_kernel. K and V (rows padded
//   to a multiple of 64 with zeros, ~74 KB at N = 196) stay resident; each
//   of four warps takes 16-row query tiles in turn and runs the
//   tensor-core online softmax of relpos_mma.cuh over the resident keys
//   in chunks of 64. The padding costs 256 / 196 of the arithmetic. At
//   N = 196 a (window, head) does 4 N^2 dh flops on 6 N dh bytes, about
//   130 flops per byte, under the card's ratio of tensor-core rate to
//   memory bandwidth, so the K/V reads matter as much as the mma; each is
//   read once. With 2 blocks per SM the slice's 300 blocks (25 windows x
//   12 heads) fill the card about 1.1 times, which leaves SMs idle in the
//   second wave.
// * fp32: relpos_window_kernel on the CUDA cores. Warps take query rows
//   four at a time; lane l holds the scores of keys l, l+32, ..., l+224 in
//   registers, which gives an exact softmax (max, exp2, sum) without an
//   online rescale. P goes through a per-warp shared buffer for the P.V
//   product, where lane l owns output columns l and l+32. About 155 KB of
//   shared memory (fp32 K, V, P) allows one block per SM.
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {

constexpr int kWRows = 4;                    // query rows per warp per pass
constexpr int kWPass = kWarps * kWRows;      // 32 query rows per pass
constexpr int kWSlots = 8;                   // keys per lane
constexpr int kWMaxN = 32 * kWSlots;         // 256

__host__ __device__ inline int window_np(int n) { return (n + 31) & ~31; }

__host__ __device__ inline size_t window_smem_floats(int n, int rr) {
  const int np = window_np(n);
  return (size_t)kDh * (np + 1)     // K^T
         + (size_t)np * kDh         // V
         + (size_t)kWPass * kDh     // q rows of the pass (pre-scaled)
         + (size_t)kWPass * np      // P, per warp kWRows x np
         + (size_t)kWPass * rr;     // r rows of the pass
}

__global__ void __launch_bounds__(kThreads)
    relpos_window_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ r, float* __restrict__ out,
                         float* __restrict__ lse, int n, int heads, int kh,
                         int kw, float qscale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int np = window_np(n);
  const int ldk = np + 1;
  const int rr = kh + kw;
  float* kt_s = smem;
  float* v_s = kt_s + kDh * ldk;
  float* q_s = v_s + np * kDh;
  float* p_s = q_s + kWPass * kDh;
  float* r_s = p_s + kWPass * np;

  const int h = blockIdx.x;
  const long long g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + g * n * row_stride;
  const float* rbase = r + g * n * heads * rr;

  for (int idx = tid; idx < np * kDh; idx += kThreads) {
    const int j = idx / kDh, d = idx % kDh;
    float kv = 0.f, vv = 0.f;
    if (j < n) {
      const float* row = base + j * row_stride + h * kDh + d;
      kv = row[c];
      vv = row[2 * c];
    }
    kt_s[d * ldk + j] = kv;
    v_s[j * kDh + d] = vv;
  }

  const float* q_w = q_s + warp * kWRows * kDh;
  const float* r_w = r_s + warp * kWRows * rr;
  float* p_w = p_s + warp * kWRows * np;

  for (int q0 = 0; q0 < n; q0 += kWPass) {
    __syncthreads();  // K/V loaded; previous pass done with q_s / r_s
    for (int idx = tid; idx < kWPass * kDh; idx += kThreads) {
      const int i = idx / kDh, d = idx % kDh, qi = q0 + i;
      q_s[idx] = qi < n ? base[qi * row_stride + h * kDh + d] * qscale : 0.f;
    }
    for (int idx = tid; idx < kWPass * rr; idx += kThreads) {
      const int i = idx / rr, j = idx % rr, qi = q0 + i;
      r_s[idx] = qi < n ? rbase[((long long)qi * heads + h) * rr + j] : 0.f;
    }
    __syncthreads();

    float s[kWRows][kWSlots];
#pragma unroll
    for (int i = 0; i < kWRows; ++i)
#pragma unroll
      for (int t = 0; t < kWSlots; ++t) s[i][t] = 0.f;

    for (int d = 0; d < kDh; d += 4) {
      float4 qv[kWRows];
#pragma unroll
      for (int i = 0; i < kWRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_w + i * kDh + d);
#pragma unroll
      for (int t = 0; t < kWSlots; ++t) {
        if (32 * t < np) {  // warp-uniform
          const int j = lane + 32 * t;
          const float k0 = kt_s[(d + 0) * ldk + j];
          const float k1 = kt_s[(d + 1) * ldk + j];
          const float k2 = kt_s[(d + 2) * ldk + j];
          const float k3 = kt_s[(d + 3) * ldk + j];
#pragma unroll
          for (int i = 0; i < kWRows; ++i)
            s[i][t] = fmaf(qv[i].x, k0, fmaf(qv[i].y, k1,
                      fmaf(qv[i].z, k2, fmaf(qv[i].w, k3, s[i][t]))));
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const float* rrow = r_w + i * rr;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kWSlots; ++t) {
        const int j = lane + 32 * t;
        if (j < n) {
          const int ky = j / kw, kx = j - ky * kw;
          s[i][t] += rrow[ky] + rrow[kh + kx];
        } else {
          s[i][t] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][t]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kWSlots; ++t) {
        s[i][t] = exp2f(s[i][t] - mx);
        sum += s[i][t];
      }
      sum = warp_sum(sum);
      const float inv = 1.f / sum;
#pragma unroll
      for (int t = 0; t < kWSlots; ++t)
        if (32 * t < np) p_w[i * np + lane + 32 * t] = s[i][t] * inv;
      const int qi = q0 + warp * kWRows + i;
      if (lse != nullptr && lane == 0 && qi < n)
        lse[(g * heads + h) * n + qi] = mx + log2f(sum);
    }
    __syncwarp();

    float o0[kWRows], o1[kWRows];
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      o0[i] = 0.f;
      o1[i] = 0.f;
    }
    for (int j = 0; j < np; j += 4) {
      const float a0 = v_s[(j + 0) * kDh + lane];
      const float a1 = v_s[(j + 1) * kDh + lane];
      const float a2 = v_s[(j + 2) * kDh + lane];
      const float a3 = v_s[(j + 3) * kDh + lane];
      const float b0 = v_s[(j + 0) * kDh + lane + 32];
      const float b1 = v_s[(j + 1) * kDh + lane + 32];
      const float b2 = v_s[(j + 2) * kDh + lane + 32];
      const float b3 = v_s[(j + 3) * kDh + lane + 32];
#pragma unroll
      for (int i = 0; i < kWRows; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + i * np + j);
        o0[i] = fmaf(pv.x, a0, fmaf(pv.y, a1, fmaf(pv.z, a2, fmaf(pv.w, a3, o0[i]))));
        o1[i] = fmaf(pv.x, b0, fmaf(pv.y, b1, fmaf(pv.z, b2, fmaf(pv.w, b3, o1[i]))));
      }
    }

#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const int qi = q0 + warp * kWRows + i;
      if (qi < n) {
        float* orow = out + (g * n + qi) * c + h * kDh;
        orow[lane] = o0[i];
        orow[lane + 32] = o1[i];
      }
    }
    __syncwarp();  // p_w is rewritten by the next pass
  }
}

cudaError_t launch_window(const void* qkv, const void* r, void* out,
                          float* lse, int g, int n, int heads, int kh, int kw,
                          float qscale, cudaStream_t stream) {
  const size_t smem = window_smem_floats(n, kh + kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g);
  relpos_window_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(r),
      static_cast<float*>(out), lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

__host__ __device__ inline int window_tc_np(int n) {
  return (n + tc::kChunk - 1) / tc::kChunk * tc::kChunk;
}

__global__ void __launch_bounds__(tc::kThreads)
    relpos_window_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ r,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int n, int heads, int kh,
                            int kw, float qscale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw;
  const int np = window_tc_np(n);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + np * tc::kLd;
  __nv_bfloat16* q_s = v_s + np * tc::kLd;
  float* r_s = reinterpret_cast<float*>(q_s + tc::kWarps * tc::kRows * tc::kLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const long long g = blockIdx.y;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + g * n * row_stride + h * kDh;
  const __nv_bfloat16* rbase = r + g * n * heads * rr + h * rr;
  __nv_bfloat16* q_w = q_s + warp * tc::kRows * tc::kLd;
  float* r_w = r_s + warp * tc::kRows * (rr + 1);

  tc::copy_rows_async(base + c, row_stride, 0, np, n, k_s, tid, tc::kThreads);
  tc::copy_rows_async(base + 2 * c, row_stride, 0, np, n, v_s, tid,
                      tc::kThreads);
  tc::cp_async_wait();
  __syncthreads();

  for (int row0 = warp * tc::kRows; row0 < n;
       row0 += tc::kWarps * tc::kRows) {
    tc::Rows st;
    tc::begin_rows(st, base, row_stride, row0, n, q_w, lane);
    tc::load_r(rbase, (long long)heads * rr, row0, n, rr, r_w, lane);
    for (int k0 = 0; k0 < n; k0 += tc::kChunk)
      tc::chunk<false>(st, k_s + k0 * tc::kLd, v_s + k0 * tc::kLd, r_w,
                       rr + 1, k0, n, kh, kw, qscale, lane);
    tc::end_rows(st, out + g * n * c + h * kDh, c, row0, n, lane,
                 lse == nullptr ? nullptr : lse + (g * heads + h) * n);
    __syncwarp();  // q_w and r_w are restaged for the next tile
  }
}

cudaError_t launch_window_tc(const void* qkv, const void* r, void* out,
                             float* lse, int g, int n, int heads, int kh,
                             int kw, float qscale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * window_tc_np(n) + tc::kWarps * tc::kRows) * tc::kLd *
          sizeof(__nv_bfloat16) +
      (size_t)tc::kWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_window_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g);
  relpos_window_tc_kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

}  // namespace relpos

// qkv (g, n, 3 * heads * 64), r (g, n, heads * (kh + kw)) and out
// (g, n, heads * 64), contiguous and 16-byte aligned, one dtype (0 = fp32,
// 1 = bf16), n <= 256. lse as for la_relpos_global, (g, heads, n).
extern "C" int la_relpos_window(const void* qkv, const void* r, void* out,
                                float* lse, int g, int n, int heads, int kh,
                                int kw, float scale, int is_bf16,
                                void* stream) {
  if (n > relpos::kWMaxN) return (int)cudaErrorInvalidValue;
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? relpos::launch_window_tc(qkv, r, out, lse, g, n, heads, kh,
                                         kw, qscale, s)
              : relpos::launch_window(qkv, r, out, lse, g, n, heads, kh, kw,
                                      qscale, s);
  return (int)err;
}

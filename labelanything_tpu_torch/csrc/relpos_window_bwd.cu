// Backward of the windowed-block rel-pos attention (14 x 14 windows of
// N = 196 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// _lanes_batched_bwd -> _lanes_batched_bwd_impl (Pallas body
// _lanes_batched_bwd_kernel). The math is in relpos_bwd.cuh; the softmax
// is rebuilt from the forward's saved log-sum-exp, and the bias gradient is
// a binned sum, not the TPU's one-hot matmul.
//
// * bf16 (training): relpos_window_bwd_tc_kernel, one block of eight warps
//   (four where eight warps' scratch does not fit, as at N = 256) per
//   (window, head). q, K, V and dO of the window (rows padded to a
//   multiple of 64 with zeros), its r rows, lse and delta stay in shared
//   memory (about 205 KB at N = 196), so each is read from device memory
//   once and nothing needs a second block: first the warps take 16-row
//   query tiles in turn (dQ, dr), then 16-row key tiles (dK, dV), on the
//   tensor cores. A window does 14 N^2 dh flops on about 12 N dh bytes, 57
//   flops per byte: bound by bytes, not by operations. One block per SM
//   (eight warps) hides little latency; splitting the two cuts into two
//   kernels with half the shared memory each is the next step.
//   Zero-padded tokens of a padded window are real keys and queries and
//   get real gradients; only rows past N are masked.
// * fp32 (parity): the CUDA-core kernels of relpos_global_bwd.cu, whose
//   grid of 64-row tiles tiles the window's queries and keys.
#include <cmath>
#include <cstdint>

#include "relpos_bwd.cuh"

namespace relpos {
namespace bwd {

constexpr int kWMaxN = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may ask for

__host__ __device__ inline int window_np(int n) {
  return (n + tc::kChunk - 1) / tc::kChunk * tc::kChunk;
}

__host__ __device__ inline size_t window_bwd_smem_bytes(int n, int rr,
                                                        int kWWarps) {
  const int np = window_np(n);
  return (size_t)4 * np * tc::kLd * sizeof(__nv_bfloat16)  // q, K, V, dO
         + (size_t)np * tcb::r_stride(rr) * sizeof(__nv_bfloat16)  // r rows
         + (size_t)2 * np * sizeof(float)                  // lse, delta
         + (size_t)kWWarps * tc::kRows * tcb::kDsLd * sizeof(float)  // dS
         + (size_t)kWWarps * tc::kRows * (rr + 1) * sizeof(float);   // dr
}

template <int kWWarps>
__global__ void __launch_bounds__(32 * kWWarps)
    relpos_window_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ r,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dqkv,
                                __nv_bfloat16* __restrict__ dr, int n,
                                int heads, int kh, int kw, float qscale,
                                float scale) {
  extern __shared__ float4 smem4[];
  constexpr int kWThreads = 32 * kWWarps;
  const int rr = kh + kw, rs = rr + 1, rsb = tcb::r_stride(rr);
  const int np = window_np(n);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* k_s = q_s + np * tc::kLd;
  __nv_bfloat16* v_s = k_s + np * tc::kLd;
  __nv_bfloat16* do_s = v_s + np * tc::kLd;
  float* ds_s = reinterpret_cast<float*>(do_s + np * tc::kLd);
  float* dr_s = ds_s + kWWarps * tc::kRows * tcb::kDsLd;
  float* lse_s = dr_s + kWWarps * tc::kRows * rs;
  float* dl_s = lse_s + np;
  __nv_bfloat16* r_s = reinterpret_cast<__nv_bfloat16*>(dl_s + np);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const long long g = blockIdx.y;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + g * n * row_stride + h * kDh;
  __nv_bfloat16* dst = dqkv + g * n * row_stride + h * kDh;

  tc::copy_rows_async(base, row_stride, 0, np, n, q_s, tid, kWThreads);
  tc::copy_rows_async(base + c, row_stride, 0, np, n, k_s, tid, kWThreads);
  tc::copy_rows_async(base + 2 * c, row_stride, 0, np, n, v_s, tid, kWThreads);
  tc::copy_rows_async(dout + g * n * c + h * kDh, c, 0, np, n, do_s, tid,
                      kWThreads);
  tcb::load_r_rows(r + g * n * heads * rr + h * rr, (long long)heads * rr, 0,
                   np, n, rr, r_s, tid, kWThreads);
  for (int i = tid; i < np; i += kWThreads) {
    lse_s[i] = i < n ? lse[(g * heads + h) * n + i] : 0.f;
    dl_s[i] = i < n ? delta[(g * heads + h) * n + i] : 0.f;
  }
  tc::cp_async_wait();
  __syncthreads();

  // the query cut: dQ and dr of 16-row query tiles
  float* ds_w = ds_s + warp * tc::kRows * tcb::kDsLd;
  float* dr_w = dr_s + warp * tc::kRows * rs;
  for (int row0 = warp * tc::kRows; row0 < n; row0 += kWWarps * tc::kRows) {
    tcb::DqRows st;
    tcb::load_a(st.qa, q_s + row0 * tc::kLd, lane);
    tcb::load_a(st.da, do_s + row0 * tc::kLd, lane);
    tcb::dq_begin(st);
    const int gq = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st.lse[i] = lse_s[row0 + gq + 8 * i];
      st.delta[i] = dl_s[row0 + gq + 8 * i];
    }
    for (int i = lane; i < tc::kRows * rs; i += 32) dr_w[i] = 0.f;
    __syncwarp();
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += tc::kChunk)
      tcb::dq_chunk(st, k_s + k0 * tc::kLd, v_s + k0 * tc::kLd,
                    r_s + row0 * rsb, rsb, ds_w, dr_w, rs, k0, n, kh, kw,
                    qscale, lane);
    tcb::dq_end(st, dr_w, rs, rr, scale, dst, row_stride,
                dr + g * n * heads * rr + h * rr, (long long)heads * rr, row0,
                n, lane);
    __syncwarp();  // dr_w is cleared for the next tile
  }

  // the key cut: dK and dV of 16-row key tiles
  for (int row0 = warp * tc::kRows; row0 < n; row0 += kWWarps * tc::kRows) {
    tcb::DkvRows st;
    tcb::dkv_begin(st, k_s + row0 * tc::kLd, v_s + row0 * tc::kLd, row0, n, kh,
                   kw, lane);
#pragma unroll 1
    for (int q0 = 0; q0 < n; q0 += tcb::kQChunk)
      tcb::dkv_chunk(st, q_s + q0 * tc::kLd, do_s + q0 * tc::kLd,
                     r_s + q0 * rsb, rsb, lse_s + q0, dl_s + q0, q0, n, qscale,
                     lane);
    tcb::store_rows(st.dk, scale, dst + c, row_stride, row0, n, lane);
    tcb::store_rows(st.dv, 1.f, dst + 2 * c, row_stride, row0, n, lane);
  }
}

cudaError_t launch_window_bwd_tc(const __nv_bfloat16* qkv,
                                 const __nv_bfloat16* r,
                                 const __nv_bfloat16* dout, const float* lse,
                                 const float* delta, __nv_bfloat16* dqkv,
                                 __nv_bfloat16* dr, int g, int n, int heads,
                                 int kh, int kw, float scale,
                                 cudaStream_t stream) {
  const int warps = window_bwd_smem_bytes(n, kh + kw, 8) <= kMaxSmem ? 8 : 4;
  const size_t smem = window_bwd_smem_bytes(n, kh + kw, warps);
  auto kernel = warps == 8 ? relpos_window_bwd_tc_kernel<8>
                           : relpos_window_bwd_tc_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      qkv, r, dout, lse, delta, dqkv, dr, n, heads, kh, kw,
      scale * 1.4426950408889634f, scale);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace relpos

// As la_relpos_global_bwd, over g windows of n <= 256 tokens.
extern "C" int la_relpos_window_bwd(const void* qkv, const void* r,
                                    const void* out, const void* dout,
                                    const float* lse, float* delta,
                                    void* dqkv, void* dr, int g, int n,
                                    int heads, int kh, int kw, float scale,
                                    int is_bf16, void* stream) {
  namespace bw = relpos::bwd;
  if (n > bw::kWMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bw::launch_delta(out, dout, delta, (long long)g * n, n, heads, is_bf16, s);
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    err = bw::launch_window_bwd_tc(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(dr), g,
        n, heads, kh, kw, scale, s);
  else
    err = bw::launch_bwd_f32(
        static_cast<const float*>(qkv), static_cast<const float*>(r),
        static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dqkv), static_cast<float*>(dr), g, n, heads, kh,
        kw, scale, s);
  return (int)err;
}

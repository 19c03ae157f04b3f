// Shared pieces of the decomposed relative-position attention kernels.
//
// Both kernels compute, per (image or window, head):
//   out[q] = sum_j softmax_j(q.k_j * scale + rel_h[q, ky(j)] + rel_w[q, kx(j)]) v_j
// on the token-major qkv projection (rows of 3C channels laid out
// (3, heads, 64)) and the factored bias r (rows of heads * (kh + kw)
// values, per head [rel_h (kh) | rel_w (kw)], pre-multiplied by log2(e)).
// Scores are kept in the log2 domain, so the softmax uses exp2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace relpos {

constexpr int kDh = 64;        // head width the kernels are written for
constexpr int kThreads = 256;  // 8 warps per block (fp32 kernels)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace relpos

// The whole TwoWayTransformer in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel labelanything_tpu/ops/fused_twoway.py,
// fused_twoway_transformer (body _twoway_kernel, math _twoway_math): both
// TwoWayAttentionBlocks (token self-attention, token-to-image attention,
// MLP, image-to-token attention, four LayerNorms each) and the final
// token-to-image attention with its norm, for G instances of S image tokens
// (900 on the decode path) against N <= 8 sparse or class tokens at width
// 256, 8 heads, cross-attention internal width 128, ReLU. It computes what
// the plain PyTorch version labelanything_tpu_torch/ops/fused_twoway.py,
// twoway_plain, computes; it is not the TPU kernel carried over: there is
// no block-diagonal operand expansion and no bounded softmax shift, heads
// are ordinary 16-wide k-steps of mma.sync and every softmax is exact.
//
// What bounds it on this card: operations. An instance is about 0.59 GFLOP,
// nearly all in the image-side projections (900 x 256 by 256 x 128, three a
// block and two at the end, and the 900 x 128 by 128 x 256 out projection);
// 96 instances are 57 GFLOP against some 100 MB of keys in and out, so the
// tensor cores' time is about twice the memory's. As separate modules the
// same work is about 50 launches a call whose intermediates all pass
// through device memory.
//
// The design (bf16, fused_twoway_tc.cuh):
// * One block of 8 warps per instance. At G = 96 that is one wave on 96 of
//   the 132 SMs; several instances a block would share the token side's
//   weight traffic (about 5.8 MB an instance, read from L2) but leave SMs
//   idle at this G, so each block streams the token-side weights itself.
// * The keys of an instance (900 x 256 bf16 = 461 KB) do not fit a block's
//   227 KB of shared memory. The block walks them in device memory, which at
//   96 instances is 44 MB and stays in the 50 MB L2: five passes a call
//   (token-to-image of each block and of the end read them, image-to-token
//   of each block reads them and writes the new keys into the output
//   buffer, in place from the second block on; the input is never written).
//   A warp takes 16 rows at a time through its own staging slice; the two
//   weight matrices of a pass (128 KB) sit in shared memory, loaded once a
//   pass with cp.async. __syncthreads() separates the stages.
// * Token-to-image reduces over all S rows: each warp keeps an exact running
//   maximum and sum (log2 domain) for its rows, and the eight partial states
//   are merged once a pass through shared memory. The tokens are the low 8
//   rows of the 16-row mma tile; the high rows are zero operands.
// * Image-to-token is independent by row: Q projection, scores against the 8
//   projected tokens (padding masked out of the softmax), P . V, the out
//   projection, residual and LayerNorm all stay in registers; the new keys
//   are written once.
// * The token side (self-attention, MLP, the small projections) multiplies
//   8 x 256 rows by weights read straight from device memory, 16 bytes a
//   thread, with the k index permuted to fit the mma fragment.
//
// The fp32 instance (fused_twoway_fp32.cuh) is plain CUDA-core code for
// parity with the plain version, generic in its widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_twoway_fp32.cuh"
#include "fused_twoway_tc.cuh"

namespace twoway {

cudaError_t launch_tc(const void* keys, const void* queries,
                      const void* key_pe, const void* params, void* q_out,
                      void* k_out, int g, int s, int n, int d, int heads,
                      int mlp, int depth, int downsample,
                      cudaStream_t stream) {
  if (d != tc::kD || heads != tc::kHeads || downsample != tc::kD / tc::kI ||
      n < 1 || n > tc::kTok || mlp % 32 != 0 || mlp < 32 ||
      mlp > tc::kMaxMlp)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tc::twoway_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  tc::twoway_tc_kernel<<<g, tc::kThreads, tc::kSmemBytes, stream>>>(
      static_cast<const tc::bf16*>(keys),
      static_cast<const tc::bf16*>(queries),
      static_cast<const tc::bf16*>(key_pe),
      static_cast<const tc::bf16*>(params), static_cast<tc::bf16*>(q_out),
      static_cast<tc::bf16*>(k_out), s, n, mlp, depth);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const void* keys, const void* queries,
                        const void* key_pe, const void* params, void* q_out,
                        void* k_out, void* scratch, int g, int s, int n,
                        int d, int heads, int mlp, int depth, int downsample,
                        cudaStream_t stream) {
  if (scratch == nullptr || n < 1 || n > f32::kMaxTok || d % 32 != 0 ||
      d > 512 || downsample < 1 || d % downsample != 0 || heads < 1)
    return cudaErrorInvalidValue;
  const int inner = d / downsample;
  if (d % heads != 0 || inner % heads != 0 || d / heads > f32::kMaxDh ||
      inner > f32::kThreads || f32::kThreads % inner != 0)
    return cudaErrorInvalidValue;
  const size_t smem = f32::smem_bytes(n, d, mlp);
  cudaError_t err = cudaFuncSetAttribute(
      f32::twoway_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  f32::twoway_fp32_kernel<<<g, f32::kThreads, smem, stream>>>(
      static_cast<const float*>(keys), static_cast<const float*>(queries),
      static_cast<const float*>(key_pe), static_cast<const float*>(params),
      static_cast<float*>(q_out), static_cast<float*>(k_out),
      static_cast<float*>(scratch), s, n, d, heads, mlp, depth, downsample);
  return cudaGetLastError();
}

}  // namespace twoway

// keys (g, s, d), queries (g, n, d), key_pe (s, d), q_out (g, n, d) and k_out
// (g, s, d) contiguous, of one dtype (0 = fp32, 1 = bf16), 16-byte aligned;
// params the flat parameter buffer of ops/fused_twoway.py pack_params in the
// same dtype (bf16: matrices (out, in); fp32: matrices (in, out)); scratch
// (g, 2, s, d / downsample) fp32 for the fp32 instance, unused in bf16.
extern "C" int la_fused_twoway(const void* keys, const void* queries,
                               const void* key_pe, const void* params,
                               void* q_out, void* k_out, void* scratch, int g,
                               int s, int n, int d, int heads, int mlp,
                               int depth, int downsample, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || s < 1 || depth < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)twoway::launch_tc(keys, queries, key_pe, params, q_out, k_out,
                                  g, s, n, d, heads, mlp, depth, downsample,
                                  st);
  return (int)twoway::launch_fp32(keys, queries, key_pe, params, q_out, k_out,
                                  scratch, g, s, n, d, heads, mlp, depth,
                                  downsample, st);
}

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
// The design (bf16, fused_twoway_tc.cuh): one instance is a thread-block
// cluster of C blocks of 8 warps (C a power of two up to 8, chosen by the
// caller so that the G clusters fit on the card at once:
// ops/fused_twoway.py, twoway_cluster, from the occupancy calculator's
// count of resident clusters, la_fused_twoway_max_clusters).
// * The image rows are cut into 16-row tiles, tile i to block i mod C and
//   there to warp (i / C) mod 8. The warps walk their tiles in device
//   memory (at G = 96, 44 MB that stay in the 50 MB L2), image-to-token
//   writing the new keys into the output, in place from the second block
//   on. A pass's weights and a warp's 16-row slice fill the block's shared
//   memory, so a tile is staged again for every pass. The kernel is
//   compiled twice, for clusters of one block (kSolo: the cluster's
//   branches fold away) and for larger ones, chosen here by C.
// * Each pass's two image-side weight matrices (128 KB) are read once for
//   the cluster: every block copies its share of the rows with
//   cp.async.bulk and multicasts them into all the cluster's blocks (a
//   cluster of one block copies with cp.async).
// * Token-to-image reduces over all S rows: each warp keeps an exact
//   running maximum and sum (log2 domain) for its rows; the warps' states
//   are merged in the block, and the C block states in every block through
//   distributed shared memory; a cluster of one block merges its warps'
//   states once. The tokens are the low 8 rows of the 16-row mma tile; the
//   high rows are zero operands. A tile stages keys + pe, then the keys,
//   and its V goes through the slice to ldmatrix.trans.
// * Image-to-token is independent by row: Q projection, scores against the 8
//   projected tokens (padding masked out of the softmax), P . V, the out
//   projection, residual and LayerNorm all stay in registers.
// * The token side (self-attention, MLP, the small projections) multiplies
//   8 x 256 rows by weights read straight from device memory, 16 bytes a
//   thread, with the k index permuted to fit the mma fragment. Its output
//   columns are cut across the cluster's 8 C warps, and each result is
//   stored into every block's copy; softmaxes, norms and the residual stream
//   are computed alike in every block. A cluster barrier separates stages
//   that exchange data.
// * The image-side products stay on mma.sync: a block holds at most 8 tiles
//   of 16 rows, a warp one each, and wgmma's 64-row tiles would need the
//   weights in a swizzled layout and a warpgroup's worth of rows a pass.
//
// The fp32 instance (fused_twoway_fp32.cuh) is plain CUDA-core code for
// parity with the plain version, generic in its widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "fused_twoway_fp32.cuh"
#include "fused_twoway_tc.cuh"

namespace twoway {

cudaError_t launch_tc(const void* keys, const void* queries,
                      const void* key_pe, const void* params, void* q_out,
                      void* k_out, int g, int s, int n, int d, int heads,
                      int mlp, int depth, int downsample, int cluster,
                      cudaStream_t stream) {
  if (d != tc::kD || heads != tc::kHeads || downsample != tc::kD / tc::kI ||
      n < 1 || n > tc::kTok || mlp % 32 != 0 || mlp < 32 ||
      mlp > tc::kMaxMlp || cluster < 1 || cluster > tc::kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || (long long)g * cluster > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = cluster == 1 ? tc::twoway_cluster_kernel<true>
                            : tc::twoway_cluster_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g * cluster);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = tc::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const tc::bf16*>(keys),
      static_cast<const tc::bf16*>(queries),
      static_cast<const tc::bf16*>(key_pe),
      static_cast<const tc::bf16*>(params), static_cast<tc::bf16*>(q_out),
      static_cast<tc::bf16*>(k_out), s, n, mlp, depth);
  if (err != cudaSuccess) return err;
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

// The most clusters of `cluster` blocks of the bf16 kernel that the card
// holds at once (cudaOccupancyMaxActiveClusters: its GPCs, not only its SM
// count, decide it), or minus a CUDA error.
extern "C" int la_fused_twoway_max_clusters(int cluster) {
  using namespace twoway;
  if (cluster < 1 || cluster > tc::kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  // both instances of the kernel take the same threads and shared memory
  auto kernel = tc::twoway_cluster_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = tc::kSmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(
      &count, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// keys (g, s, d), queries (g, n, d), key_pe (s, d), q_out (g, n, d) and k_out
// (g, s, d) contiguous, of one dtype (0 = fp32, 1 = bf16), 16-byte aligned;
// params the flat parameter buffer of ops/fused_twoway.py pack_params in the
// same dtype (bf16: matrices (out, in); fp32: matrices (in, out)); scratch
// (g, 2, s, d / downsample) fp32 for the fp32 instance, unused in bf16;
// cluster the blocks an instance in bf16 (1, 2, 4 or 8), unused in fp32.
extern "C" int la_fused_twoway(const void* keys, const void* queries,
                               const void* key_pe, const void* params,
                               void* q_out, void* k_out, void* scratch, int g,
                               int s, int n, int d, int heads, int mlp,
                               int depth, int downsample, int is_bf16,
                               int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || s < 1 || depth < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)twoway::launch_tc(keys, queries, key_pe, params, q_out, k_out,
                                  g, s, n, d, heads, mlp, depth, downsample,
                                  cluster, st);
  return (int)twoway::launch_fp32(keys, queries, key_pe, params, q_out, k_out,
                                  scratch, g, s, n, d, heads, mlp, depth,
                                  downsample, st);
}

// Plain flash attention for Hopper, out = softmax(q . k^T * scale) . v per
// (batch, head), bf16, heads 32 or 64 wide: the affinity decoder's
// AffinityTransformer (4096 query tokens against M x 4096 support tokens,
// heads 32 wide).
//
// Replaces the TPU kernel of labelanything_tpu/ops/flash_attention.py:
// flash_attention -> _run_flash (Pallas bodies _attn_kernel and
// _attn_kernel_batched); the widths 128 and 256 and fp32 stay with
// flash_attention.cu.
//
// What bounds it: at dh 32 a score costs 4 dh = 128 tensor-core flops and
// one exponential, and the special-function units start 16 exponentials a
// clock on an SM against about 4096 bf16 flops on its tensor cores, so the
// exponentials bound the work (bytes are far below both). The design keeps
// the exponential units busy:
//
// * Warp specialisation. One producer warp keeps TMA loads of K and V tiles
//   (112 keys at dh 32, 128 at dh 64) in flight through a ring of kStages
//   stages, each tracked by a full and an empty mbarrier; K and V have
//   barriers of their own, so the scores of a tile start before its V
//   lands. The tensor maps cover the
//   (batch, head, token, dh) views with their strides, so the head-split
//   views of token-major projections are read as they lie. TMA writes each
//   tile with the 64-byte (dh 32) or 128-byte (dh 64) swizzle that the
//   wgmma descriptors name.
// * Consumer warpgroups of 64 query rows each (three at dh 32, two at dh
//   64; see Tile) run wgmma: S = q . k^T as m64n{keys}k16 with both
//   operands in shared memory, O += P . V as m64n{dh}k16 with P as bf16 A
//   fragments in registers (the accumulator layout of S is the A layout
//   of P) and V read MN-major.
// * Ping-pong: named barriers hand the tensor cores from one consumer
//   warpgroup to the next in turn, so the others' exponentials run while
//   one's products do. Inside a warpgroup the products of tile j + 1 (S)
//   and tile j (P . V) are issued together and the softmax of tile j + 1
//   runs while P . V of tile j is still in flight.
// * Little work around each exponential: the score scale and the row
//   maximum fold into one FFMA (s c - m c, c = scale log2 e) and the
//   exponential is one ex2.approx.ftz (exp2f's subnormal handling costs
//   instructions a score); only a ragged last tile is masked (keys past
//   nk: -inf); O is rescaled only where a row's maximum moved.
//
// Tried on the card and not kept, each slower or no faster: a share of the
// exponentials as a polynomial on the FMA pipe (the special-function units
// are not what saturates here), two consumer warpgroups of 128-key tiles
// at dh 32, four of 64- to 96-key tiles (at 102 registers a thread the
// wider ones spill), row sums from a column of ones appended to V, and
// four independent max / sum chains a row; nor is the kernel without the
// ping-pong.
//
// Softmax state is fp32 with an exact running maximum (online softmax in
// the log2 domain); the row sums add the fp32 exponentials, P enters the
// product rounded to bf16, and the output is normalised at the end.
// Query rows past nq are zero-filled by the TMA and not written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace flash_sm90 {

constexpr int kRows = 64;                      // query rows a warpgroup
constexpr int kStages = 4;                     // K / V ring depth
// named barriers of the ping-pong (0 is __syncthreads')
constexpr int kSchedBarrier = 8;

// The tile of each head width: consumer warpgroups and keys a tile. A block
// of kConsumers + 1 warpgroups gets 65536 / (128 (kConsumers + 1)) registers
// a thread: at
// dh 32 three consumer warpgroups hold 112-key tiles (56 score, 28 P and
// 16 output registers a thread) without spilling at 128 registers, where
// 128-key tiles spill; at dh 64 the output doubles, so two warpgroups of
// 128-key tiles at 168 registers.
template <int DH>
struct Tile {
  static constexpr int kConsumers = DH == 32 ? 3 : 2;
  static constexpr int kBlockN = DH == 32 ? 112 : 128;  // keys a tile
  static constexpr int kBlockM = kRows * kConsumers;    // query rows a block
};

template <int DH>
struct Smem {
  static constexpr int kBlockM = Tile<DH>::kBlockM;
  static constexpr int kBlockN = Tile<DH>::kBlockN;
  // each tile is a multiple of 1024 bytes and starts 1024-aligned, as the
  // swizzle patterns repeat every 512 (64-byte) or 1024 (128-byte) bytes
  __nv_bfloat16 q[kBlockM * DH];
  __nv_bfloat16 k[kStages][kBlockN * DH];
  __nv_bfloat16 v[kStages][kBlockN * DH];
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

using namespace sm90;

// the ping-pong's barriers: the owning warpgroup syncs, the one before it
// arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}


// Softmax of one tile's scores s (row g: s[4 nb], s[4 nb + 1]; row g + 8:
// s[4 nb + 2], s[4 nb + 3]; key 8 nb + 2 t + e of the tile) in place: the
// running maxima m (raw scores), the scale factors alpha of O and the
// partial row sums l are updated; s then holds exp2(s c - m c). Keys at or
// past `valid` are masked (valid >= kBlockN: none).
template <int kBlockN>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             int valid, int t) {
  constexpr int kBlocks = kBlockN / 8;
  if (valid < kBlockN) {
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * nb + 2 * t + e >= valid) {
          s[4 * nb + e] = -INFINITY;
          s[4 * nb + 2 + e] = -INFINITY;
        }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * nb], s[4 * nb + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
  }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // a row lives in the 4 lanes of a quad; the tile's first key is valid,
    // so the maximum is finite
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = mx[i] > m[i] ? ex2((m[i] - mx[i]) * c) : 1.f;
    m[i] = mx[i];
    mc[i] = mx[i] * c;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * nb + e] = ex2(fmaf(s[4 * nb + e], c, -mc[e >> 1]));
      ls[e >> 1] += s[4 * nb + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
}

// P as bf16 A fragments: fragment kk (keys 16 kk .. 16 kk + 15) is
// {row g keys +0-7, row g + 8 keys +0-7, row g keys +8-15, row g + 8 keys
// +8-15} = p[4 kk .. 4 kk + 3]
template <int kBlockN>
__device__ __forceinline__ void pack_p(const float (&s)[kBlockN / 2],
                                       uint32_t (&p)[kBlockN / 4]) {
#pragma unroll
  for (int nb = 0; nb < kBlockN / 8; ++nb) {
    p[2 * nb] = pack_bf16(s[4 * nb], s[4 * nb + 1]);
    p[2 * nb + 1] = pack_bf16(s[4 * nb + 2], s[4 * nb + 3]);
  }
}

// O += P . V over one tile, V read MN-major
template <int DH, int kBlockN>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&p)[kBlockN / 4],
                                         const __nv_bfloat16* v_s) {
  const uint64_t dv = make_desc<DH>(v_s, 16 * DH);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    pv_mma<DH>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               dv + kk * 2 * DH);  // 16 keys of 2 DH bytes, in 16-byte units
}

template <int DH, int kBlockN>
__device__ __forceinline__ void issue_s(float (&s)[kBlockN / 2], uint64_t dq,
                                        const __nv_bfloat16* k_s) {
  const uint64_t dk = make_desc<DH>(k_s, 16 * DH);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {  // 16 columns = 32 bytes a step
    if constexpr (kBlockN == 128)
      wgmma_m64n128k16_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
    else
      wgmma_m64n112k16_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(128 * (Tile<DH>::kConsumers + 1), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int nq, int nk,
                       float c, long long ob, long long oh, long long ot) {
  extern __shared__ unsigned char smem_raw[];
  using Sm = Smem<DH>;
  constexpr int kConsumers = Tile<DH>::kConsumers, kBlockM = Sm::kBlockM;
  constexpr int kBlockN = Sm::kBlockN;
  Sm& sm = *reinterpret_cast<Sm*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBlockM;
  const int tiles = (nk + kBlockN - 1) / kBlockN;
  constexpr uint32_t kTileBytes = kBlockN * DH * 2;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      // one arrival from each consumer warp
      mbar_init(&sm.k_empty[s], 4 * kConsumers);
      mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    if (tid == 0) {
      mbar_expect_tx(&sm.q_full, kBlockM * DH * 2);
      tma_load(sm.q, &tq, &sm.q_full, q0, h, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages, parity = ((j / kStages) & 1) ^ 1;
        if (j >= kStages) mbar_wait(&sm.k_empty[s], parity);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load(sm.k[s], &tk, &sm.k_full[s], j * kBlockN, h, b);
        if (j >= kStages) mbar_wait(&sm.v_empty[s], parity);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load(sm.v[s], &tv, &sm.v_full[s], j * kBlockN, h, b);
      }
    }
    return;
  }

  // consumers
  const int cw = wg - 1, next = kSchedBarrier + (cw + 1) % kConsumers;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int last_valid = nk - (tiles - 1) * kBlockN;
  float s[kBlockN / 2];
  uint32_t p[kBlockN / 4];
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  // the consumer warpgroups take the tensor cores in turn, the first first
  if (cw == kConsumers - 1) named_arrive(kSchedBarrier);
  mbar_wait(&sm.q_full, 0);
  const uint64_t dq = make_desc<DH>(sm.q + cw * kRows * DH, 16 * DH);

  // tile 0: scores only
  mbar_wait(&sm.k_full[0], 0);
  named_sync(kSchedBarrier + cw);
  wgmma_fence();
  issue_s<DH, kBlockN>(s, dq, sm.k[0]);
  wgmma_commit();
  named_arrive(next);
  wgmma_wait<0>();
  fence_regs(s);
  __syncwarp();
  if (lane == 0) mbar_arrive(&sm.k_empty[0]);
  softmax_tile<kBlockN>(s, m, l, alpha, c, tiles == 1 ? last_valid : kBlockN,
                     t);
  pack_p<kBlockN>(s, p);

  for (int j = 1; j < tiles; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(&sm.k_full[st], (j / kStages) & 1);
    named_sync(kSchedBarrier + cw);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_s<DH, kBlockN>(s, dq, sm.k[st]);
    wgmma_commit();
    mbar_wait(&sm.v_full[prev], ((j - 1) / kStages) & 1);
    issue_pv<DH, kBlockN>(o, p, sm.v[prev]);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();  // the scores of tile j
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.k_empty[st]);
    softmax_tile<kBlockN>(s, m, l, alpha, c,
                       j == tiles - 1 ? last_valid : kBlockN, t);
    wgmma_wait<0>();  // P . V of tile j - 1
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.v_empty[prev]);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb) {
        o[4 * nb] *= alpha[0];
        o[4 * nb + 1] *= alpha[0];
        o[4 * nb + 2] *= alpha[1];
        o[4 * nb + 3] *= alpha[1];
      }
    }
    pack_p<kBlockN>(s, p);
  }

  // P . V of the last tile
  const int st = (tiles - 1) % kStages;
  mbar_wait(&sm.v_full[st], ((tiles - 1) / kStages) & 1);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<DH, kBlockN>(o, p, sm.v[st]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  // the last warpgroup's arrival before the first turn is matched here, so
  // every barrier ends complete
  if (cw == 0) named_sync(kSchedBarrier);

  // normalise and write rows < nq
  const int row0 = q0 + cw * kRows + warp * 16 + g;
  __nv_bfloat16* o_g = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / li;
    const int qi = row0 + 8 * i;
    if (qi < nq) {
      uint32_t* row = reinterpret_cast<uint32_t*>(o_g + qi * ot);
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb)
        row[nb * 4 + t] =
            pack_bf16(o[4 * nb + 2 * i] * inv, o[4 * nb + 2 * i + 1] * inv);
    }
  }
}

template <int DH>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int batch, int heads, int nq, int nk,
                          float c, const long long* s, cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(&tq, q, batch, heads, nq, s, T::kBlockM) ||
      !make_map<DH>(&tk, k, batch, heads, nk, s + 3, T::kBlockN) ||
      !make_map<DH>(&tv, v, batch, heads, nk, s + 6, T::kBlockN))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<DH>) + 1024;
  auto kernel = flash_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + T::kBlockM - 1) / T::kBlockM, heads, batch);
  kernel<<<grid, 128 * (T::kConsumers + 1), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), nq, nk, c, s[9], s[10],
      s[11]);
  return cudaGetLastError();
}

}  // namespace flash_sm90

// bf16 q (batch, heads, nq, dh), k and v (batch, heads, nk, dh) and out
// (batch, heads, nq, dh), each with its last axis contiguous and its batch,
// head and token strides (in elements) in strides[0..2] (q), [3..5] (k),
// [6..8] (v), [9..11] (out); q, k, v 16-byte aligned with strides that are
// multiples of 8, out rows 4-byte aligned. dh is 32 or 64; nq, nk >= 1.
// scale is the plain score scale; log2(e) is folded in here.
extern "C" int la_flash_wgmma(const void* q, const void* k, const void* v,
                              void* out, int batch, int heads, int nq, int nk,
                              int dh, float scale, const long long* strides,
                              void* stream) {
  if (nq < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  const float c = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)flash_sm90::launch<32>(q, k, v, out, batch, heads, nq, nk,
                                         c, strides, st);
    case 64:
      return (int)flash_sm90::launch<64>(q, k, v, out, batch, heads, nq, nk,
                                         c, strides, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

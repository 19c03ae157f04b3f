// The packed rel-pos attention's global kernel on Hopper: TMA-fed wgmma for
// key grids whose rows are 64 wide (SAM ViT-H's global blocks at 1024 px,
// 64 x 64 tokens), a template on the head width (instantiated at 80 in
// relpos_packed_sm90.cu).
//
// Replaces, on that route, the mma.sync kernel of relpos_packed.cuh
// (packed_global_tc_kernel) for the TPU kernel of
// labelanything_tpu/ops/flash_attention.py: flash_attention_relpos_packed
// -> _packed_fwd_impl. Per (image, head):
//   out[q] = sum_j softmax_j(q.k_j scale + rel_h[q, ky(j)] + rel_w[q, kx(j)]) v_j
// with r = [rel_h (kh) | rel_w (64)] x log2(e) and an exact running max in
// the log2 domain.
//
// What bounds it: 4 N^2 dh tensor-core flops a head against N^2
// exponentials and 6 N dh bytes; at N = 4096, dh = 80 the tensor cores
// (about 320 flops a score against 16 exponentials a clock an SM) set the
// bound, with the exponentials close behind. The design (PERF.md holds the
// figures of the choices it was probed against):
//
// * K6's shape (flash_wgmma.cu): one block of two consumer warpgroups of 64
//   query rows (128 a block); thread 0 keeps TMA loads of the K and V tiles
//   in flight through an mbarrier ring (K3's producer: a producer
//   warpgroup of its own would cut the consumers' registers to 168 a
//   thread, and a key tile of 128 needs some 195). The loads read the
//   strided (B, 3 heads, N, dh) view of the qkv projection as the encoder
//   hands it over, no relayout copy. S = Q K^T by wgmma from shared memory
//   (dh / 16 k-steps), O += P V with P as bf16 A fragments in registers and
//   V read MN-major; inside a warpgroup the scores of tile j + 1 are issued
//   beside P V of tile j.
// * A key tile is two key-grid rows (128 keys: twice the work a tile for
//   the same waits, fences and shuffles as one row, and an n128 score
//   product), in a 4-stage ring, each tile issued two ahead into the stage
//   of the tile two back. Thread 0 waits there for the other warpgroup to
//   release that stage, so a ring that made it wait on the tile just
//   behind would tie the warpgroups together. K6's ping-pong (the
//   warpgroups taking the tensor cores in turn) made this kernel slower.
// * The bias as a tile (K3's): each key-grid row ky of a tile has one
//   rel_h[q, ky] a row, read from a shared fp32 copy of the block's rel_h
//   rows, and rel_w[q, kx] sits in registers for the whole walk (16 values
//   a row, 32 a thread). A score costs one FFMA (scale and rel_w), a max,
//   one FADD (the row's shift minus rel_h) and one ex2.approx.ftz; the
//   maxima and sums run in four chains a row, and O is rescaled only where
//   a row's max moved.
// * Rows of dh bf16 are not a span of one swizzle at dh 80 (160 bytes).
//   Boxes<DH> cuts every tile's columns into TMA boxes of 64 columns at the
//   128-byte swizzle and one of the rest (16 columns at the 32-byte
//   swizzle), so that P V is an n64 and an n16 product a k-step (five
//   16-column boxes and one n80 product were slower).
//
// The grid takes full tiles only: kw = 64 and kh even up to 64, so N is a
// multiple of the block's 128 rows and of a tile, and no key or row is
// masked.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "relpos_packed.cuh"
#include "sm90.cuh"

namespace relpos {
namespace packed_sm90 {

using namespace sm90;
using packed::Strides;

constexpr int kRows = 64;                  // query rows a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBlockM = kRows * kConsumers;
constexpr int kGridRow = 64;               // keys a key-grid row
constexpr int kThreads = 128 * kConsumers;
constexpr int kConsumerWarps = kThreads / 32;
constexpr int kMaxKh = 64;
constexpr int kHLd = kMaxKh + 1;           // row stride of the rel_h copy
constexpr int kKeyRows = 2;                // key-grid rows a key tile
constexpr int kTileN = kGridRow * kKeyRows;
// ring stages, and tiles issued ahead: tile j + kLead at the top of
// iteration j goes into the stage of tile j + kLead - kStages, which both
// warpgroups must have released
constexpr int kStages = 4;
constexpr int kLead = 2;
static_assert((kStages & (kStages - 1)) == 0, "a power of two");
static_assert(kLead >= 1 && kLead + 2 <= kStages, "a lead the ring holds");

// The key grids the kernel takes: rows 64 wide, kh even (N a multiple of
// the block's rows, and of a tile of two key-grid rows).
__host__ __device__ inline bool grid_ok(int kh, int kw) {
  return kw == kGridRow && kh % 2 == 0 && kh >= 2 && kh <= kMaxKh;
}

// How a tile's DH columns are cut into TMA boxes (see the header).
template <int DH>
struct Boxes {
  static_assert(DH % 16 == 0, "head width a multiple of 16");
  static constexpr int kWide = DH / 64;  // 64-column boxes
  static constexpr int kRestCols = DH % 64;
  static constexpr int kRest = DH % 64 ? 1 : 0;
  static constexpr int kCount = kWide + kRest;
  static constexpr int kRestSwizzle = 2 * kRestCols;  // bytes a box row
  static_assert(kWide == 1, "one 64-column box a row");
  static_assert(kRest == 0 || kRestCols == 16,
                "the rest of a row is one 16-column box");
  // first column and byte offset of box i in a tile of `rows` rows
  __host__ __device__ static constexpr int col(int i) {
    return i < kWide ? 64 * i : 64 * kWide + (i - kWide) * kRestCols;
  }
  __host__ __device__ static constexpr int offset(int i, int rows) {
    return i < kWide ? i * rows * 128
                     : kWide * rows * 128 + (i - kWide) * rows * 2 * kRestCols;
  }
};

template <int DH>
struct Smem {
  // every tile is a multiple of 1024 bytes and starts 1024-aligned
  __nv_bfloat16 q[kBlockM * DH];
  __nv_bfloat16 k[kStages][kTileN * DH];
  __nv_bfloat16 v[kStages][kTileN * DH];
  float hl[kBlockM * kHLd];  // rel_h of the block's rows
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

// The block's shared memory from its first 1024-aligned byte.
template <typename Sm>
__device__ __forceinline__ Sm& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return *reinterpret_cast<Sm*>(raw + pad);
}

// Descriptor of k-step ks (columns 16 ks .. 16 ks + 15) of rows row0 ..
// row0 + 63 of a K-major tile of `rows` rows.
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(const __nv_bfloat16* tile,
                                                int rows, int row0, int ks) {
  using B = Boxes<DH>;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
  const int c = 16 * ks;
  if constexpr (B::kRest > 0) {
    if (c >= 64 * B::kWide) {  // a 16-column box: one k-step
      const int i = B::kWide + (c - 64 * B::kWide) / B::kRestCols;
      return make_desc_sw<B::kRestSwizzle>(
          base + B::offset(i, rows) + row0 * B::kRestSwizzle, 16,
          8 * B::kRestSwizzle);
    }
  }
  // a 64-column box, 32 bytes a k-step inside the 128-byte swizzle
  return make_desc_sw<128>(base + B::offset(c / 64, rows) + row0 * 128, 16,
                           1024) +
         ((c % 64) * 2 >> 4);
}

// S (64 x kTileN) = Q K^T over DH / 16 k-steps, both from shared memory
template <int DH>
__device__ __forceinline__ void issue_s(float (&s)[kTileN / 2],
                                        const __nv_bfloat16* q, int row0,
                                        const __nv_bfloat16* k) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_m64n128k16_ss(s, kmajor_desc<DH>(q, kBlockM, row0, ks),
                        kmajor_desc<DH>(k, kTileN, 0, ks), ks > 0);
}

// O += P V over one tile, V read MN-major box by box
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&p)[kTileN / 4],
                                         const __nv_bfloat16* v) {
  using B = Boxes<DH>;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(v);
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    const uint32_t a0 = p[4 * kk], a1 = p[4 * kk + 1], a2 = p[4 * kk + 2],
                   a3 = p[4 * kk + 3];
    wgmma_m64n64k16_rs_at<0>(o, a0, a1, a2, a3,
                             make_desc_sw<128>(base + kk * 16 * 128, 16, 1024));
    if constexpr (B::kRest == 1)
      wgmma_m64n16k16_rs_at<32>(
          o, a0, a1, a2, a3,
          make_desc_sw<32>(base + B::offset(1, kTileN) + kk * 16 * 32, 16,
                           256));
  }
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// P as bf16 A fragments: fragment kk (keys 16 kk .. 16 kk + 15) is
// p[4 kk .. 4 kk + 3]
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N],
                                       uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int nb = 0; nb < N / 4; ++nb) {
    p[2 * nb] = pack_bf16(s[4 * nb], s[4 * nb + 1]);
    p[2 * nb + 1] = pack_bf16(s[4 * nb + 2], s[4 * nb + 3]);
  }
}

// One (128-row block, head, image): q, k, v of head h are slots h,
// heads + h, 2 heads + h of the qkv map; tq0 / tkv0 are the maps of the
// 64-column boxes with 128 / kTileN-row boxes, tq1 / tkv1 of the 16-column
// rest (unused where DH is 64).
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    packed_global_wgmma_kernel(const __grid_constant__ CUtensorMap tq0,
                               const __grid_constant__ CUtensorMap tq1,
                               const __grid_constant__ CUtensorMap tkv0,
                               const __grid_constant__ CUtensorMap tkv1,
                               const __nv_bfloat16* __restrict__ r,
                               __nv_bfloat16* __restrict__ out, int heads,
                               int kh, float c, Strides sr, Strides so) {
  using B = Boxes<DH>;
  extern __shared__ unsigned char smem_raw[];
  Smem<DH>& sm = aligned_smem<Smem<DH>>(smem_raw);
  const int tid = threadIdx.x;
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // uniform across the warp
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBlockM;
  const int tiles = kh / kKeyRows;
  constexpr uint32_t kTileBytes = kTileN * DH * 2;
  const __nv_bfloat16* r_b = r + b * sr.b + h * sr.h + q0 * sr.t;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    // rel_h of the block's rows, two threads a row, the loads batched
    static_assert(kThreads == 2 * kBlockM, "two threads a row");
    const __nv_bfloat16* src = r_b + (tid >> 1) * sr.t;
    float* dst = sm.hl + (tid >> 1) * kHLd;
#pragma unroll 8
    for (int ky = tid & 1; ky < kh; ky += 2) dst[ky] = bf2f(src[ky]);
  }
  __syncthreads();

  // one tile (rows `rows` from token `row` of slot `slot`) box by box
  auto load = [&](__nv_bfloat16* dst, const CUtensorMap* m0,
                  const CUtensorMap* m1, uint64_t* bar, int rows, int row,
                  int slot) {
    unsigned char* base = reinterpret_cast<unsigned char*>(dst);
#pragma unroll
    for (int i = 0; i < B::kCount; ++i)
      tma_load(base + B::offset(i, rows), i < B::kWide ? m0 : m1, bar, row,
               slot, b, B::col(i));
  };
  // thread 0 issues the copies: tile j into stage j % kStages once both
  // warpgroups have released the tile that held it
  auto issue = [&](int j) {
    const int st = j & (kStages - 1);
    if (j >= kStages) mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.k_full[st], kTileBytes);
    load(sm.k[st], &tkv0, &tkv1, &sm.k_full[st], kTileN, j * kTileN,
         heads + h);
    mbar_expect_tx(&sm.v_full[st], kTileBytes);
    load(sm.v[st], &tkv0, &tkv1, &sm.v_full[st], kTileN, j * kTileN,
         2 * heads + h);
  };
  if (tid == 0) {
    mbar_expect_tx(&sm.q_full, kBlockM * DH * 2);
    load(sm.q, &tq0, &tq1, &sm.q_full, kBlockM, q0, h);
    for (int j = 0; j < kLead + 2 && j < tiles; ++j) issue(j);
  }

  const int lt = tid % 128, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = cw * kRows + warp * 16 + g;  // block row of row g
  // rel_w of rows g, g + 8 at this thread's key columns 8 nb + 2 t, + 1 of
  // a key-grid row: the same in every key-grid row
  float rw[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rw[i][2 * nb + e] =
            bf2f(r_b[(row + 8 * i) * sr.t + kh + 8 * nb + 2 * t + e]);
  const float* hl0 = sm.hl + row * kHLd;
  const float* hl1 = hl0 + 8 * kHLd;

  float s[kTileN / 2], o[DH / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[kTileN / 4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  const __nv_bfloat16* q_s = sm.q;
  const int q_row0 = cw * kRows;

  // Softmax of tile j's raw scores in s (row g: s[4 nb + e], row g + 8:
  // s[4 nb + 2 + e]; key 8 nb + 2 t + e of the tile, in key-grid row
  // kKeyRows j + nb / 8): running maxima m of the full scores, O's factors
  // alpha, row sums l; s then holds P.
  auto softmax = [&](int j) {
    // the maxima and sums are taken in four interleaved chains a row
    float hj[kKeyRows][2], mx[kKeyRows][2][4];
#pragma unroll
    for (int kr = 0; kr < kKeyRows; ++kr) {
      hj[kr][0] = hl0[kKeyRows * j + kr];
      hj[kr][1] = hl1[kKeyRows * j + kr];
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[kr][0][u] = mx[kr][1][u] = -INFINITY;
    }
#pragma unroll
    for (int nb = 0; nb < kTileN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kr = nb / 8, u = (nb & 1) * 2 + (e & 1);
        s[4 * nb + e] =
            fmaf(s[4 * nb + e], c, rw[i][2 * (nb % 8) + (e & 1)]);
        mx[kr][i][u] = fmaxf(mx[kr][i][u], s[4 * nb + e]);
      }
    float shift[kKeyRows][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float top = -INFINITY;
#pragma unroll
      for (int kr = 0; kr < kKeyRows; ++kr)
        top = fmaxf(top, fmaxf(fmaxf(mx[kr][i][0], mx[kr][i][1]),
                               fmaxf(mx[kr][i][2], mx[kr][i][3])) +
                             hj[kr][i]);
      // a row lives in the 4 lanes of a quad
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
      const float mn = fmaxf(m[i], top);
      alpha[i] = mn > m[i] ? ex2(m[i] - mn) : 1.f;
      m[i] = mn;
#pragma unroll
      for (int kr = 0; kr < kKeyRows; ++kr) shift[kr][i] = mn - hj[kr][i];
    }
    float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nb = 0; nb < kTileN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * nb + e] = ex2(s[4 * nb + e] - shift[nb / 8][e >> 1]);
        ls[e >> 1][(nb & 1) * 2 + (e & 1)] += s[4 * nb + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * alpha[i] + ((ls[i][0] + ls[i][1]) + (ls[i][2] + ls[i][3]));
  };

  mbar_wait(&sm.q_full, 0);

  // tile 0: scores only
  mbar_wait(&sm.k_full[0], 0);
  wgmma_fence();
  issue_s<DH>(s, q_s, q_row0, sm.k[0]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack_p(s, p);

  for (int j = 1; j < tiles; ++j) {
    const int st = j & (kStages - 1), sp = (j - 1) & (kStages - 1);
    if (tid == 0 && j >= 2 && j + kLead < tiles) issue(j + kLead);
    __syncwarp();
    mbar_wait(&sm.k_full[st], (j / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_s<DH>(s, q_s, q_row0, sm.k[st]);
    wgmma_commit();
    mbar_wait(&sm.v_full[sp], ((j - 1) / kStages) & 1);
    issue_pv<DH>(o, p, sm.v[sp]);
    wgmma_commit();
    wgmma_wait<1>();  // the scores of tile j
    fence_regs(s);
    softmax(j);
    wgmma_wait<0>();  // P V of tile j - 1
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[sp]);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb) {
        o[4 * nb] *= alpha[0];
        o[4 * nb + 1] *= alpha[0];
        o[4 * nb + 2] *= alpha[1];
        o[4 * nb + 3] *= alpha[1];
      }
    }
    pack_p(s, p);
  }

  // P V of the last tile
  const int st = (tiles - 1) & (kStages - 1);
  mbar_wait(&sm.v_full[st], ((tiles - 1) / kStages) & 1);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<DH>(o, p, sm.v[st]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // normalise and write the rows, token stride so.t
  __nv_bfloat16* o_g = out + b * so.b + h * so.h + (q0 + row) * so.t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / li;
    uint32_t* dst = reinterpret_cast<uint32_t*>(o_g + 8 * i * so.t);
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      dst[nb * 4 + t] =
          pack_bf16(o[4 * nb + 2 * i] * inv, o[4 * nb + 2 * i + 1] * inv);
  }
}

// bf16 qkv (b, 3 heads, n, DH) and r (b, heads, n, kh + 64), strides s[0]
// (qkv), s[1] (r), s[2] (out) as packed::launch takes them; the qkv view
// must satisfy the TMA (16-byte aligned base and strides), else the maps
// fail to encode and the launch returns cudaErrorInvalidValue.
template <int DH>
cudaError_t launch_global_wgmma(const void* qkv, const void* r, void* out,
                                int b, int n, int heads, int kh, int kw,
                                float qscale, const Strides* s,
                                cudaStream_t stream) {
  using B = Boxes<DH>;
  if (!grid_ok(kh, kw) || n != kh * kw) return cudaErrorInvalidValue;
  const long long* sq = reinterpret_cast<const long long*>(&s[0]);
  CUtensorMap tq0, tq1, tkv0, tkv1;
  bool ok = encode_map(&tq0, qkv, b, 3 * heads, n, DH, sq, 64, kBlockM,
                       CU_TENSOR_MAP_SWIZZLE_128B) &&
            encode_map(&tkv0, qkv, b, 3 * heads, n, DH, sq, 64, kTileN,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (B::kRest == 1)
    ok = ok &&
         encode_map(&tq1, qkv, b, 3 * heads, n, DH, sq, B::kRestCols,
                    kBlockM, CU_TENSOR_MAP_SWIZZLE_32B) &&
         encode_map(&tkv1, qkv, b, 3 * heads, n, DH, sq, B::kRestCols,
                    kTileN, CU_TENSOR_MAP_SWIZZLE_32B);
  else {
    tq1 = tq0;
    tkv1 = tkv0;
  }
  if (!ok) return cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<DH>) + 1024;
  auto kernel = packed_global_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kBlockM, heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq0, tq1, tkv0, tkv1, static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(out), heads, kh, qscale, s[1], s[2]);
  return cudaGetLastError();
}

}  // namespace packed_sm90
}  // namespace relpos

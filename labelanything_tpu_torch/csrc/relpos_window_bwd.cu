// Backward of the windowed-block rel-pos attention (14 x 14 windows of
// N = 196 tokens; windows up to 16 x 16).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// _lanes_batched_bwd -> _lanes_batched_bwd_impl (Pallas body
// _lanes_batched_bwd_kernel). The math is in relpos_bwd.cuh; the softmax
// is rebuilt from the forward's saved log-sum-exp, and the bias gradient is
// a binned sum, not the TPU's one-hot matmul.
//
// * bf16 (training): three launches, as the global backward's: the delta
//   pre-pass (delta_kernel), a query cut (window_dq_kernel: dQ, dr) and a
//   key cut (window_dkv_kernel: dK, dV). A window does 14 N^2 dh flops on
//   about 12 N dh bytes, 57 flops a byte: bound by bytes, and what keeps a
//   kernel from the bound is latency, so each cut is shaped as the windowed
//   forward (relpos_window.cuh) is: blocks of 7 warps, a warp a 16-row
//   tile on mma.sync m16n8k16, about 100 KB of shared memory a block, two
//   blocks an SM.
//   Keys lie in slots by key-grid row, as the forward lays them out
//   (Slots<KWP>: key (ky, kx) in slot ky * KWP + kx, KWP = kw rounded up to
//   8 or 16; 14 x 16 = 224 slots at 14 x 14), with zero K and V and a -inf
//   bias in empty slots, so that P = dS = 0 there without a compare. A
//   16-slot group is one key-grid row (two at KWP = 8), and (ky, kx) of a
//   slot is a shift and a mask.
//   - Query cut, two blocks a (window, head): K and V of the window are
//     copied into their slots once a block; a warp holds its 16 rows' q and
//     dO as A fragments and walks the groups: S and dP (16 x 16), P from
//     the saved log-sum-exp, dS, dQ += dS K. The bias gradient never leaves
//     registers: dr_w[q, kx] accumulates across key-grid rows in KWP / 4
//     registers a row and thread, dr_h[q, ky] is one group's sum, taken with
//     quad shuffles (rel_h - lse is read from a per-warp copy, which the
//     sums then overwrite).
//   - Key cut, a warp a group (one key-grid row of 16 slots; 14 warps in
//     two blocks at 14 x 14): q, dO, the bias rows transposed (rel_h - lse
//     and rel_w, one row per ky or kx, queries along the row, -inf past N
//     or kw) and delta of the window are staged once a block; a warp holds
//     its slots' K and V as A fragments and walks 16-query tiles: S^T and
//     dP^T, P^T, dV += P^T dO, dK += dS^T Q. The bias of a score is two
//     fp32 reads, by query pairs.
//   No atomics: dQ, dr in the query cut, dK, dV in the key cut, each
//   written by one warp, so gradients are the same bits from run to run.
//   Zero-padded tokens of a padded window are real keys and queries and get
//   real gradients; only rows past N are masked.
// * fp32 (parity): the CUDA-core kernels of relpos_global_bwd.cu, whose
//   grid of 64-row tiles tiles the window's queries and keys.
#include <cmath>
#include <cstdint>

#include "relpos_bwd.cuh"
#include "relpos_window.cuh"
#include "sm90.cuh"

namespace relpos {
namespace bwd {

constexpr int kWMaxN = 256;
constexpr int kCutWarps = 7;                 // a 16-row tile or group a warp
constexpr int kCutThreads = 32 * kCutWarps;
constexpr int kDqSplit = 2;                  // query-cut blocks a (window, head)
constexpr int kHs = 17;                      // row stride of a warp's dr_h
                                             // sums: kh <= 16, and ky = kh
constexpr int kRsb = 36;                     // r_stride(rr) for rr <= 32
using tc::kLd;
using tc::kRows;
// bf16 elements of a query-cut warp's staging: q and dO rows (kLd a row;
// later its dr_h sums), r rows (kRsb a row)
constexpr int kDqWarpElems = 2 * kRows * kLd + kRows * kRsb;

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(smem)));
}

// x (16 x 16, two n8 tiles) += A (16 x 64, fragments a) . B^T, B the 16
// rows of a kLd-strided bf16 tile, its fragments by ldmatrix: lane l
// addresses row 8 (l / 16) + l % 8, columns 8 ((l / 8) % 2) of a k-step,
// so that the four matrices are tile 0's low and high k-halves, then tile
// 1's
__device__ __forceinline__ void mma_nt16(float (&x)[2][4],
                                         const uint32_t (&a)[tc::kSteps][4],
                                         const __nv_bfloat16* tile,
                                         int lane) {
  const __nv_bfloat16* base =
      tile + ((lane >> 4) * 8 + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < tc::kSteps; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, base + ks * 16);
    tc::mma_bf16(x[0], a[ks], b[0], b[1]);
    tc::mma_bf16(x[1], a[ks], b[2], b[3]);
  }
}

// row stride (floats) of the key cut's transposed bias rows: at least the
// padded query count, 8 mod 32, so that the float2 reads of a half-warp
// (rows g, query pairs 2 t) fall on distinct banks
__host__ __device__ inline int bias_ld(int n) {
  const int np = (n + kRows - 1) / kRows * kRows;
  return (np + 23) / 32 * 32 + 8;
}

// 16-slot groups of a window (Slots<KWP>::blocks counts n8 blocks)
template <int KWP>
__host__ __device__ inline int groups(int kh) {
  return Slots<KWP>::blocks(kh) / 2;
}

__host__ inline size_t dq_smem_bytes(int slots) {
  // K and V slots, then each warp's staging
  return ((size_t)2 * slots * kLd + (size_t)kCutWarps * kDqWarpElems) *
         sizeof(__nv_bfloat16);
}

__host__ inline size_t dkv_smem_bytes(int n, int kh, int kwp) {
  const int np = (n + kRows - 1) / kRows * kRows;
  return (size_t)2 * np * kLd * sizeof(__nv_bfloat16)       // q, dO
         + (size_t)(kh + 1 + kwp + 1) * bias_ld(n) * sizeof(float)  // bias
                                                            // rows, delta
         + (size_t)np * sizeof(float)                       // lse
         + (size_t)np * kRsb * sizeof(__nv_bfloat16);       // r rows
}

// The query cut: block (z, h, window) takes query tiles z * 7 + warp,
// + 14, ...; the split is the grid's fastest axis, so that both blocks of a
// (window, head) run together and the second reads the window from L2
template <int KWP>
__global__ void __launch_bounds__(kCutThreads, 2)
    window_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dqkv,
                     __nv_bfloat16* __restrict__ dr, int n, int heads, int kh,
                     int kw, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int kW = KWP / 4;  // rel_w columns a row and thread
  const int ngroups = groups<KWP>(kh), slots = 16 * ngroups;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + slots * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long long win = blockIdx.z;
  const int c = heads * kDh, rr = kh + kw;
  const long long s3 = 3LL * c, srr = (long long)heads * rr;
  const __nv_bfloat16* base = qkv + win * n * s3 + h * kDh;
  const __nv_bfloat16* r_g = r + win * n * srr + h * rr;
  __nv_bfloat16* dr_g = dr + win * n * srr + h * rr;
  const float* lse_g = lse + (win * heads + h) * n;
  const float* dl_g = delta + (win * heads + h) * n;
  __nv_bfloat16* q_w = v_s + slots * kLd + warp * kDqWarpElems;
  __nv_bfloat16* do_w = q_w + kRows * kLd;
  __nv_bfloat16* r_w = do_w + kRows * kLd;
  float* drh_w = reinterpret_cast<float*>(q_w);  // once q is in registers
  const int rsb = tcb::r_stride(rr);
  const int tiles = (n + kRows - 1) / kRows;

  copy_kv_slots<KWP, kDh>(base + c, base + 2 * c, s3, slots, kh, kw, k_s,
                          v_s, kLd, kLd, tid, kCutThreads);
  tc::cp_async_wait();
  __syncthreads();  // K and V landed

  for (int tile = blockIdx.x * kCutWarps + warp; tile < tiles;
       tile += kDqSplit * kCutWarps) {
    const int row0 = tile * kRows;
    tc::copy_rows_async(base, s3, row0, kRows, n, q_w, lane, 32);
    tc::copy_rows_async(dout + win * n * c + h * kDh, c, row0, kRows, n, do_w,
                        lane, 32);
    tcb::load_r_rows(r_g, srr, row0, kRows, n, rr, r_w, lane, 32);
    // lse and delta of rows g, g + 8 (0 past n)
    float lse[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + g + 8 * i;
      lse[i] = qi < n ? lse_g[qi] : 0.f;
      dl[i] = qi < n ? dl_g[qi] : 0.f;
    }
    tc::cp_async_wait();
    __syncwarp();
    uint32_t qa[tc::kSteps][4], da[tc::kSteps][4];
    tcb::load_a(qa, q_w, lane);
    tcb::load_a(da, do_w, lane);
    // rel_w of rows g, g + 8 at this thread's columns kx = 8 (j / 2) + 2 t
    // + j % 2 (-inf past kw; rows past n are zero)
    const __nv_bfloat16* r0 = r_w + g * rsb;
    const __nv_bfloat16* r1 = r0 + 8 * rsb;
    float w[2][kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int kx = 8 * (j >> 1) + 2 * t + (j & 1);
      w[0][j] = kx < kw ? bf2f(r0[kh + kx]) : -INFINITY;
      w[1][j] = kx < kw ? bf2f(r1[kh + kx]) : -INFINITY;
    }
    __syncwarp();  // q_w becomes the dr_h sums

    float dq[kDh / 8][4], drw[2][kW];
    tcb::zero(dq);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kW; ++j) drw[i][j] = 0.f;

#pragma unroll 1
    for (int gr = 0; gr < ngroups; ++gr) {
      const __nv_bfloat16* kg = k_s + 16 * gr * kLd;
      float s[2][4], dp[2][4];
      tcb::zero(s);
      tcb::zero(dp);
      mma_nt16(s, qa, kg, lane);                    // S = q K^T
      mma_nt16(dp, da, v_s + 16 * gr * kLd, lane);  // dP = dO V^T
      // n8 block nb is key-grid row gr (KWP 16: columns 8 nb + 2 t + e) or
      // 2 gr + nb (KWP 8: columns 2 t + e)
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [key row][row g, g + 8]
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int ky = KWP == 16 ? gr : 2 * gr + nb;
        const int kr = KWP == 16 ? 0 : nb;
        // rel_h - lse of rows g, g + 8; -inf for the padding row ky = kh
        const float h0 = ky < kh ? bf2f(r0[ky]) - lse[0] : -INFINITY;
        const float h1 = ky < kh ? bf2f(r1[ky]) - lse[1] : -INFINITY;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = KWP == 16 ? 2 * nb + e : e;
          const float p0 = sm90::ex2(fmaf(s[nb][e], qscale, w[0][j] + h0));
          const float p1 =
              sm90::ex2(fmaf(s[nb][2 + e], qscale, w[1][j] + h1));
          const float ds0 = p0 * (dp[nb][e] - dl[0]);
          const float ds1 = p1 * (dp[nb][2 + e] - dl[1]);
          s[nb][e] = ds0;
          s[nb][2 + e] = ds1;
          drw[0][j] += ds0;
          drw[1][j] += ds1;
          sum[kr][0] += ds0;
          sum[kr][1] += ds1;
        }
      }
      // dr_h of the group's key-grid rows: a row lives in a quad
#pragma unroll
      for (int kr = 0; kr < (KWP == 16 ? 1 : 2); ++kr) {
        const int ky = KWP == 16 ? gr : 2 * gr + kr;
        const float s0 = quad_sum(sum[kr][0]), s1 = quad_sum(sum[kr][1]);
        if (t == 0) {
          drh_w[g * kHs + ky] = s0;
          drh_w[(g + 8) * kHs + ky] = s1;
        }
      }
      tcb::mma_rows<1>(dq, s, kg, lane);  // dQ += dS K
    }

    tcb::store_rows(dq, scale, dqkv + win * n * s3 + h * kDh, s3, row0, n,
                    lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + g + 8 * i;
      if (qi < n) {
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          const int kx = 8 * (j >> 1) + 2 * t + (j & 1);
          if (kx < kw)
            dr_g[qi * srr + kh + kx] = __float2bfloat16(drw[i][j] * kInvLog2e);
        }
      }
    }
    __syncwarp();  // the quads' dr_h sums landed
    for (int i = lane; i < kRows * kh; i += 32) {
      const int row = i / kh, ky = i - row * kh, qi = row0 + row;
      if (qi < n)
        dr_g[qi * srr + ky] =
            __float2bfloat16(drh_w[row * kHs + ky] * kInvLog2e);
    }
    __syncwarp();  // the warp's rows are restaged for a next tile
  }
}

// The key cut: warp w of block (z, h, window) takes group z * 7 + w (the
// split again the fastest axis).
template <int KWP>
__global__ void __launch_bounds__(kCutThreads, 2)
    window_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ r,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                      int kh, int kw, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  const int np = (n + kRows - 1) / kRows * kRows, ld = bias_ld(n);
  const int rows_b = kh + 1 + KWP;  // rel_h - lse (kh + 1), rel_w (KWP)
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* do_s = q_s + np * kLd;
  float* bias_s = reinterpret_cast<float*>(do_s + np * kLd);
  float* dl_s = bias_s + rows_b * ld;
  float* lse_s = dl_s + ld;
  __nv_bfloat16* r_s = reinterpret_cast<__nv_bfloat16*>(lse_s + np);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long long win = blockIdx.z;
  const int c = heads * kDh, rr = kh + kw;
  const long long s3 = 3LL * c, srr = (long long)heads * rr;
  const __nv_bfloat16* base = qkv + win * n * s3 + h * kDh;
  const __nv_bfloat16* r_g = r + win * n * srr + h * rr;
  const float* lse_g = lse + (win * heads + h) * n;
  const float* dl_g = delta + (win * heads + h) * n;

  tc::copy_rows_async(base, s3, 0, np, n, q_s, tid, kCutThreads);
  tc::copy_rows_async(dout + win * n * c + h * kDh, c, 0, np, n, do_s, tid,
                      kCutThreads);
  tcb::load_r_rows(r_g, srr, 0, np, n, rr, r_s, tid, kCutThreads);
  for (int q = tid; q < np; q += kCutThreads) {
    dl_s[q] = q < n ? dl_g[q] : 0.f;
    lse_s[q] = q < n ? lse_g[q] : 0.f;
  }
  tc::cp_async_wait();
  __syncthreads();
  // the bias rows, transposed: row ky < kh holds rel_h[q, ky] - lse[q]
  // (-inf for queries past n), row kh -inf, row kh + 1 + kx rel_w[q, kx]
  // (-inf past kw)
  const int rsb = tcb::r_stride(rr);
  for (int j = warp; j < rows_b; j += kCutWarps) {
    const int col = j < kh ? j : j - 1;  // r column of the row
    const bool real = j < kh || (j > kh && j - kh - 1 < kw);
    for (int q = lane; q < np; q += 32)
      bias_s[j * ld + q] =
          real && q < n ? bf2f(r_s[q * rsb + col]) - (j < kh ? lse_s[q] : 0.f)
                        : -INFINITY;
  }
  __syncthreads();
  const int grp = blockIdx.x * kCutWarps + warp;
  if (grp >= groups<KWP>(kh)) return;

  // this thread's slots g and g + 8 of the group: key (ky, kx), its token
  // and its bias rows (offsets into bias_s)
  bool ok[2];
  int tok[2], hoff[2], woff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = 16 * grp + g + 8 * i;
    const int ky = slot / KWP, kx = slot % KWP;  // KWP is a power of two
    ok[i] = ky < kh && kx < kw;
    tok[i] = ok[i] ? ky * kw + kx : 0;
    hoff[i] = ky * ld;
    woff[i] = (kh + 1 + kx) * ld;
  }
  // K and V of the slots as A fragments (rows g, g + 8; zero in empty
  // slots)
  uint32_t ka[tc::kSteps][4], va[tc::kSteps][4];
#pragma unroll
  for (int ks = 0; ks < tc::kSteps; ++ks)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = a & 1, col = ks * 16 + 8 * (a >> 1) + 2 * t;
      const __nv_bfloat16* row = base + (long long)tok[i] * s3 + col;
      ka[ks][a] = ok[i] ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
      va[ks][a] = ok[i] ? *reinterpret_cast<const uint32_t*>(row + 2 * c) : 0u;
    }
  float dk[kDh / 8][4], dv[kDh / 8][4];
  tcb::zero(dk);
  tcb::zero(dv);

#pragma unroll 1
  for (int q0 = 0; q0 < np; q0 += kRows) {
    float p[2][4], ds[2][4];
    tcb::zero(p);
    tcb::zero(ds);
    mma_nt16(p, ka, q_s + q0 * kLd, lane);    // S^T: slots x queries
    mma_nt16(ds, va, do_s + q0 * kLd, lane);  // dP^T
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int qq = q0 + 8 * nb + 2 * t;  // queries qq, qq + 1
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + qq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // slot g, then g + 8
        const float2 hb =
            *reinterpret_cast<const float2*>(bias_s + hoff[i] + qq);
        const float2 wb =
            *reinterpret_cast<const float2*>(bias_s + woff[i] + qq);
        const float p0 = sm90::ex2(fmaf(p[nb][2 * i], qscale, hb.x + wb.x));
        const float p1 =
            sm90::ex2(fmaf(p[nb][2 * i + 1], qscale, hb.y + wb.y));
        ds[nb][2 * i] = p0 * (ds[nb][2 * i] - dl.x);
        ds[nb][2 * i + 1] = p1 * (ds[nb][2 * i + 1] - dl.y);
        p[nb][2 * i] = p0;
        p[nb][2 * i + 1] = p1;
      }
    }
    tcb::mma_rows<1>(dv, p, do_s + q0 * kLd, lane);  // dV += P^T dO
    tcb::mma_rows<1>(dk, ds, q_s + q0 * kLd, lane);  // dK += dS^T Q
  }

  // q was not pre-scaled: dK = scale * dS^T . Q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    __nv_bfloat16* row = dqkv + (win * n + tok[i]) * s3 + h * kDh;
    uint32_t* rk = reinterpret_cast<uint32_t*>(row + c);
    uint32_t* rv = reinterpret_cast<uint32_t*>(row + 2 * c);
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn) {
      rk[dn * 4 + t] = tc::pack_bf16(dk[dn][2 * i] * scale,
                                     dk[dn][2 * i + 1] * scale);
      rv[dn * 4 + t] = tc::pack_bf16(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

template <int KWP>
cudaError_t launch_cuts(const __nv_bfloat16* qkv, const __nv_bfloat16* r,
                        const __nv_bfloat16* dout, const float* lse,
                        const float* delta, __nv_bfloat16* dqkv,
                        __nv_bfloat16* dr, int g, int n, int heads, int kh,
                        int kw, float scale, cudaStream_t stream) {
  const float qscale = scale * 1.4426950408889634f;
  const int ngroups = groups<KWP>(kh);
  size_t smem = dq_smem_bytes(16 * ngroups);
  cudaError_t err = cudaFuncSetAttribute(
      window_dq_kernel<KWP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  window_dq_kernel<KWP><<<dim3(kDqSplit, heads, g), kCutThreads, smem,
                          stream>>>(qkv, r, dout, lse, delta, dqkv, dr, n,
                                    heads, kh, kw, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkv_smem_bytes(n, kh, KWP);
  err = cudaFuncSetAttribute(window_dkv_kernel<KWP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (ngroups + kCutWarps - 1) / kCutWarps;
  window_dkv_kernel<KWP><<<dim3(blocks, heads, g), kCutThreads, smem,
                           stream>>>(qkv, r, dout, lse, delta, dqkv, n, heads,
                                     kh, kw, qscale, scale);
  return cudaGetLastError();
}

// the grids of the slot layout: windows up to 16 x 16
cudaError_t launch_window_bwd_tc(const __nv_bfloat16* qkv,
                                 const __nv_bfloat16* r,
                                 const __nv_bfloat16* dout, const float* lse,
                                 const float* delta, __nv_bfloat16* dqkv,
                                 __nv_bfloat16* dr, int g, int n, int heads,
                                 int kh, int kw, float scale,
                                 cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > 16 || kw > 16 || n != kh * kw)
    return cudaErrorInvalidValue;
  return kw <= 8 ? launch_cuts<8>(qkv, r, dout, lse, delta, dqkv, dr, g, n,
                                  heads, kh, kw, scale, stream)
                 : launch_cuts<16>(qkv, r, dout, lse, delta, dqkv, dr, g, n,
                                   heads, kh, kw, scale, stream);
}

}  // namespace bwd
}  // namespace relpos

// As la_relpos_global_bwd, over g windows of n <= 256 tokens; in bf16 the
// key grid is at most 16 x 16.
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

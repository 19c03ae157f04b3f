// The windowed rel-pos attention's slot layout and its bf16 kernel, one
// template on the head width for both windowed kernels: K2 (heads 64 wide,
// relpos_window.cu, on the contiguous token-major qkv) and the packed
// windowed kernel (heads 64 or 80 wide, relpos_packed.cu, on any strided
// view of the packed (B, 3 heads, N, dh) layout, as ViT-H's encoder hands
// over its qkv projection).
//
// What bounds it: a (window, head) does 4 N^2 dh flops and N^2
// exponentials on about 6 N dh bytes; at 300 to 400 (window, head) items a
// call the card's bound is the bytes, some 0.01 to 0.02 ms, and what keeps
// a kernel from it is latency: too few warps on the card, and warps that
// wait on copies, on long chains of dependent products, or on a second
// round of blocks. The design:
//
// * Key slots. The keys of a window are laid out by rows of the key grid:
//   key (ky, kx) sits in slot ky * KWP + kx, with KWP = kw rounded up to 8
//   or 16, and the slot count rounded up to 16. Then n8 block nb of the
//   score accumulators covers key row ky = nb / (KWP / 8), a constant of
//   the unrolled loop, and a thread's columns are kx = 8 (nb % (KWP / 8)) +
//   2 t + e: the bias rel_h[ky] + rel_w[kx] takes no division, rel_w lives
//   in KWP / 4 registers a row and rel_h in one shared-memory read per key
//   row. Slots with kx >= kw or ky >= kh hold zero K and V rows and a bias
//   of -inf, which masks them without a compare per score. At 14 x 14 the
//   slots are 14 x 16 = 224 (28 n8 blocks), against 256 keys when keys are
//   padded to a multiple of 64.
// * Every 16-row query tile has a warp of its own, and the window's K and
//   V are copied once into shared memory beside each warp's q and r rows,
//   with one barrier between the copies and the math. A (window, head) is
//   cut into two blocks of 7 warps, two blocks an SM.
// * A warp takes the slots in parts with one online rescale between parts:
//   its 16 rows' scores over all 224 slots would be 112 fp32 registers a
//   thread, which with the fragments spill at the 128 registers a thread
//   that two blocks of 7 warps an SM allow. At dh 64 two halves keep 56
//   score registers beside the output's 32; at dh 80 the output takes 40,
//   and two halves spill; four parts (8 / 8 / 8 / 4 n8 blocks) keep 32
//   score registers beside it, and ran no slower than three (window_parts).
// * Zero-padded tokens of a padded window are real keys (they carry
//   qkv = bias) and are attended, as in the reference. The TPU kernel's
//   operand augmentation (bias folded into the score matmul through
//   one-hot columns) and bounded softmax shift were matrix-unit devices
//   and are not carried over: the row maximum is exact.
#pragma once

#include <cstdint>
#include <type_traits>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"
#include "relpos_packed.cuh"

namespace relpos {

using packed::Strides;

template <int KWP>
struct Slots {
  static_assert(KWP == 8 || KWP == 16, "key-grid rows of 8 or 16 slots");
  static constexpr int kPerRow = KWP / 8;  // n8 blocks a key-grid row
  __host__ __device__ static int blocks(int kh) {
    return (kh * KWP / 8 + 1) & ~1;       // n8 blocks, rounded to 16 keys
  }
};

// rel_w of this thread's columns kx = 8 (j / 2) + 2 t + j % 2 of one r row
// (fp32, [rel_h (kh) | rel_w (kw)]); -inf past kw
template <int KWP>
__device__ __forceinline__ void load_rel_w(float (&w)[KWP / 4],
                                           const float* r_row, int kh,
                                           int kw, int t) {
#pragma unroll
  for (int j = 0; j < KWP / 4; ++j) {
    const int kx = 8 * (j >> 1) + 2 * t + (j & 1);
    w[j] = kx < kw ? r_row[kh + kx] : -INFINITY;
  }
}

// Scales the scores of n8 blocks NB0 .. NB0 + NBH - 1 (s[i] is block NB0 +
// i; rows g and g + 8 of the warp's tile) and adds the bias, rows r0 / r1
// and their rel_w registers w0 / w1; raises mx0 / mx1 to the rows' maxima
// over this thread's columns. Blocks at or past nb_used are skipped.
template <int KWP, int NB0, int NBH>
__device__ __forceinline__ void bias_max(float (&s)[NBH][4], const float* r0,
                                         const float* r1,
                                         const float (&w0)[KWP / 4],
                                         const float (&w1)[KWP / 4], int kh,
                                         int nb_used, float qscale,
                                         float& mx0, float& mx1) {
  constexpr int kPer = Slots<KWP>::kPerRow;
#pragma unroll
  for (int i = 0; i < NBH; ++i) {
    const int nb = NB0 + i;
    if (nb < nb_used) {
      const int ky = nb / kPer, j = 2 * (nb % kPer);
      const float h0 = ky < kh ? r0[ky] : -INFINITY;
      const float h1 = ky < kh ? r1[ky] : -INFINITY;
      s[i][0] = fmaf(s[i][0], qscale, h0 + w0[j]);
      s[i][1] = fmaf(s[i][1], qscale, h0 + w0[j + 1]);
      s[i][2] = fmaf(s[i][2], qscale, h1 + w1[j]);
      s[i][3] = fmaf(s[i][3], qscale, h1 + w1[j + 1]);
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
  }
}

// the maximum of a row over the 4 lanes of its quad
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Starts the copy of the window's K and V rows (DH elements of T a row,
// token stride `stride`) into their slots (kLdK / kLdV elements a slot
// row), empty slots zeroed.
template <int KWP, int DH, typename T>
__device__ __forceinline__ void copy_kv_slots(const T* k_g, const T* v_g,
                                              long long stride, int slots,
                                              int kh, int kw, T* k_s, T* v_s,
                                              int kLdK, int kLdV, int tid,
                                              int nthreads) {
  constexpr int kPieces = DH * sizeof(T) / 16;  // 16-byte copies a row
  constexpr int kPer16 = 16 / sizeof(T);
  for (int i = tid; i < slots * kPieces; i += nthreads) {
    const int slot = i / kPieces, piece = i % kPieces;
    const int ky = slot / KWP, kx = slot % KWP;  // KWP is a power of two
    const bool valid = ky < kh && kx < kw;
    const long long off = (ky * kw + kx) * stride + piece * kPer16;
    tc::cp_async_16(k_s + slot * kLdK + piece * kPer16,
                    valid ? k_g + off : k_g, valid);
    tc::cp_async_16(v_s + slot * kLdV + piece * kPer16,
                    valid ? v_g + off : v_g, valid);
  }
}

// ---- bf16: window_tc_kernel ----------------------------------------------

constexpr int kWinWarps = 7;         // one 16-row query tile a warp
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinSplit = 2;         // blocks a (window, head) is cut into

// parts a warp takes the slots in, by head width (see the header)
__host__ __device__ constexpr int window_parts(int dh) {
  return dh == 64 ? 2 : 4;
}

// One part of the slots, n8 blocks NB0 .. NB0 + NBH - 1 (NB0 and NBH even):
// scores from the q fragments of the warp's rows (q_w, DH + 8 apart), bias,
// online softmax (O and l rescaled where the maximum moved) and P . V from
// registers.
template <int DH, int KWP, int NB0, int NBH>
__device__ __forceinline__ void window_part(
    float (&o)[DH / 8][4], float (&m)[2], float (&l)[2],
    const __nv_bfloat16* q_w, const __nv_bfloat16* k_s,
    const __nv_bfloat16* v_s, const float* r0, const float* r1,
    const float (&w0)[KWP / 4], const float (&w1)[KWP / 4], int kh,
    int nb_used, float qscale, int lane) {
  constexpr int kLd = DH + 8;
  if (NB0 >= nb_used) return;
  const int g = lane >> 2, t = lane & 3;
  float s[NBH][4];
#pragma unroll
  for (int i = 0; i < NBH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_w);
  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k_s);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint32_t qa[4] = {q32[g * (kLd / 2) + ks * 8 + t],
                            q32[(g + 8) * (kLd / 2) + ks * 8 + t],
                            q32[g * (kLd / 2) + ks * 8 + 4 + t],
                            q32[(g + 8) * (kLd / 2) + ks * 8 + 4 + t]};
#pragma unroll
    for (int i = 0; i < NBH; ++i)
      if (NB0 + i < nb_used) {
        const uint32_t* row =
            k32 + ((NB0 + i) * 8 + g) * (kLd / 2) + ks * 8 + t;
        tc::mma_bf16(s[i], qa, row[0], row[4]);
      }
  }
  float mx[2] = {m[0], m[1]};
  bias_max<KWP, NB0, NBH>(s, r0, r1, w0, w1, kh, nb_used, qscale, mx[0],
                          mx[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // key 0 lies in the first part, so the running maxima are finite
    mx[i] = quad_max(mx[i]);
    const float alpha = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      o[dn][2 * i] *= alpha;
      o[dn][2 * i + 1] *= alpha;
    }
  }
  // P . V, 16 slots a step; ldmatrix.trans gives the B fragments of two
  // 8-column tiles a call (see relpos_mma.cuh's softmax_pv)
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NBH / 2; ++kk)
    if (NB0 + 2 * kk < nb_used) {
      uint32_t pa[4];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 2 * kk + b;
        const float e0 = exp2f(s[i][0] - m[0]), e1 = exp2f(s[i][1] - m[0]);
        const float e2 = exp2f(s[i][2] - m[1]), e3 = exp2f(s[i][3] - m[1]);
        l[0] += e0 + e1;
        l[1] += e2 + e3;
        pa[2 * b] = tc::pack_bf16(e0, e1);      // row g
        pa[2 * b + 1] = tc::pack_bf16(e2, e3);  // row g + 8
      }
      const __nv_bfloat16* vk = v_s + ((NB0 + 2 * kk) * 8 + vrow) * kLd;
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, vk + dp * 16 + vcol);
        tc::mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
}

// The parts from n8 block NB0 on, NBP blocks each (the last the rest).
template <int DH, int KWP, int NB, int NBP, int NB0>
__device__ __forceinline__ void window_parts_from(
    float (&o)[DH / 8][4], float (&m)[2], float (&l)[2],
    const __nv_bfloat16* q_w, const __nv_bfloat16* k_s,
    const __nv_bfloat16* v_s, const float* r0, const float* r1,
    const float (&w0)[KWP / 4], const float (&w1)[KWP / 4], int kh,
    int nb_used, float qscale, int lane) {
  if constexpr (NB0 < NB) {
    constexpr int kH = NB - NB0 < NBP ? NB - NB0 : NBP;
    window_part<DH, KWP, NB0, kH>(o, m, l, q_w, k_s, v_s, r0, r1, w0, w1,
                                  kh, nb_used, qscale, lane);
    window_parts_from<DH, KWP, NB, NBP, NB0 + NBP>(
        o, m, l, q_w, k_s, v_s, r0, r1, w0, w1, kh, nb_used, qscale, lane);
  }
}

// One block takes query tiles [half * kWinWarps, ...) of one (window,
// head), a warp a 16-row tile (tiles past 2 kWinWarps loop); two blocks
// share an SM. q, k, v of head h are slots h, heads + h, 2 heads + h of
// qkv (strides sq), r has strides sr, out so; lse (windows, heads, n) is
// written where it is not null.
template <int DH, int KWP, int NB>
__global__ void __launch_bounds__(kWinThreads, 2)
    window_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ r,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int n, int heads, int kh, int kw, float qscale,
                     Strides sq, Strides sr, Strides so) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = DH + 8;
  // n8 blocks a part, rounded up to even
  constexpr int kParts = window_parts(DH);
  constexpr int kNbp = ((NB + kParts - 1) / kParts + 1) & ~1;
  const int nb_used = Slots<KWP>::blocks(kh), slots = 8 * nb_used;
  const int rr = kh + kw, rs = rr + 1;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + slots * kLd;
  __nv_bfloat16* q_s = v_s + slots * kLd;
  float* r_s = reinterpret_cast<float*>(q_s + kWinWarps * tc::kRows * kLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, half = blockIdx.z;
  const long long win = blockIdx.y;
  const __nv_bfloat16* q_g = qkv + win * sq.b + h * sq.h;
  const __nv_bfloat16* k_g = q_g + heads * sq.h;
  const __nv_bfloat16* v_g = k_g + heads * sq.h;
  const __nv_bfloat16* r_g = r + win * sr.b + h * sr.h;
  __nv_bfloat16* q_w = q_s + warp * tc::kRows * kLd;
  float* r_w = r_s + warp * tc::kRows * rs;
  const int tiles = (n + tc::kRows - 1) / tc::kRows;

  copy_kv_slots<KWP, DH>(k_g, v_g, sq.t, slots, kh, kw, k_s, v_s, kLd, kLd,
                         tid, kWinThreads);
  // each warp's q and r rows; a tile past the first restages them
  const int first = half * kWinWarps + warp;
  auto stage = [&](int row0) {
    packed::copy_rows_async<DH>(q_g, sq.t, row0, tc::kRows, n, q_w, lane,
                                32);
    tc::load_r(r_g, sr.t, row0, n, rr, r_w, lane);
  };
  if (first < tiles) stage(first * tc::kRows);
  tc::cp_async_wait();
  __syncthreads();  // K and V landed

  for (int tile = first; tile < tiles; tile += kWinSplit * kWinWarps) {
    const int row0 = tile * tc::kRows;
    if (tile != first) {
      stage(row0);
      tc::cp_async_wait();
      __syncwarp();
    }
    const float* r0 = r_w + g * rs;
    const float* r1 = r_w + (g + 8) * rs;
    float w0[KWP / 4], w1[KWP / 4];
    load_rel_w<KWP>(w0, r0, kh, kw, t);
    load_rel_w<KWP>(w1, r1, kh, kw, t);
    float o[DH / 8][4];
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    window_parts_from<DH, KWP, NB, kNbp, 0>(o, m, l, q_w, k_s, v_s, r0, r1,
                                            w0, w1, kh, nb_used, qscale,
                                            lane);

    // normalise, write rows < n and their log-sum-exp
    __nv_bfloat16* o_g = out + win * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]), inv = 1.f / li;
      const int qi = row0 + g + 8 * i;
      if (qi < n) {
        uint32_t* row = reinterpret_cast<uint32_t*>(o_g + qi * so.t);
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn)
          row[dn * 4 + t] =
              tc::pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
        if (lse != nullptr && t == 0)
          lse[(win * heads + h) * n + qi] = m[i] + log2f(li);
      }
    }
    __syncwarp();  // q_w and r_w are restaged for a next tile
  }
}

template <int DH, int KWP, int NB>
cudaError_t launch_window_tc(const void* qkv, const void* r, void* out,
                             float* lse, int g, int n, int heads, int kh,
                             int kw, float qscale, const Strides* s,
                             cudaStream_t stream) {
  const int slots = 8 * Slots<KWP>::blocks(kh);
  const size_t smem =
      (size_t)(2 * slots + kWinWarps * tc::kRows) * (DH + 8) *
          sizeof(__nv_bfloat16) +
      (size_t)kWinWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  auto kernel = window_tc_kernel<DH, KWP, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g, kWinSplit);
  kernel<<<grid, kWinThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      lse, n, heads, kh, kw, qscale, s[0], s[1], s[2]);
  return cudaGetLastError();
}

// The slot layouts compiled, for windows up to 16 x 16: key-grid rows up
// to 8 wide, or up to 16 wide (14 x 14 windows have their own instance,
// whose 28 n8 blocks are the serving path's). `as` is called with the
// layout's KWP and NB as integral constants.
template <typename F>
cudaError_t with_slot_layout(int kh, int kw, F as) {
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  if (kh < 1 || kw < 1 || kh > 16 || kw > 16) return cudaErrorInvalidValue;
  if (kw <= 8) return as(I8{}, I16{});
  if (kh <= 14) return as(I16{}, std::integral_constant<int, 28>{});
  return as(I16{}, std::integral_constant<int, 32>{});
}

}  // namespace relpos

// Windowed-block rel-pos attention (SAM ViT windowed layers, 14 x 14
// windows of N = 196 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// flash_attention_relpos_lanes_batched -> _lanes_batched_fwd_impl (Pallas
// body _relpos_lanes_batched_kernel).
//
// What bounds it: a (window, head) does 4 N^2 dh flops and N^2
// exponentials on about 6 N dh bytes; at 300 (window, head) items a
// request (25 windows x 12 heads) the card's bound is the bytes, some
// 0.01 ms, and what keeps a kernel from it is latency: too few warps on
// the card, and warps that wait on copies, on long chains of dependent
// products, or on a second round of blocks. The design:
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
//   with one barrier between the copies and the math.
// * Zero-padded tokens of a padded window are real keys (they carry
//   qkv = bias) and are attended, as in the reference. The TPU kernel's
//   operand augmentation (bias folded into the score matmul through
//   one-hot columns) and bounded softmax shift were matrix-unit devices
//   and are not carried over: the row maximum is exact.
//
// * A warp takes the slots in two halves with one online rescale between
//   them: its 16 rows' scores over all 224 slots would be 112 fp32
//   registers a thread, which with the fragments spill at the 128 a thread
//   that two blocks of 7 warps an SM allow; a half keeps 56 beside the
//   output's 32, and the second half's single rescale costs 2 exponentials
//   and 32 products a thread.
//
// * bf16 (the serving path): relpos_window_tc_kernel, mma.sync m16n8k16.
//   A (window, head) is cut into two blocks of 7 warps (two blocks an SM:
//   the 600 blocks of a request fill the card 2.3 times, in half-window
//   steps). P stays in registers as bf16 A fragments for P . V.
// * fp32 (parity, the fp32 configurations): relpos_window_f32_kernel on
//   the tensor cores in TF32 with the three-product split (x = hi + lo,
//   both TF32; hi hi' + hi lo' + lo hi', error about 2^-21 of a product,
//   near fp32's own), mma.sync m16n8k8. One block of 13 warps a (window,
//   head); P is moved from the accumulator layout into A fragments by warp
//   shuffles.
//
// Both write the log-sum-exp (log2 domain) of every row where lse is not
// null; relpos_window_bwd.cu reads it.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {

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

// Starts the copy of the window's K and V rows (token-major rows of
// row_stride elements of T; K at +c, V at +2c from `base`, 64 wide) into
// their slots (kLd elements a slot row), empty slots zeroed.
template <int KWP, typename T>
__device__ __forceinline__ void copy_kv_slots(const T* base,
                                              long long row_stride, int c,
                                              int slots, int kh, int kw,
                                              T* k_s, T* v_s, int kLdK,
                                              int kLdV, int tid,
                                              int nthreads) {
  constexpr int kPieces = kDh * sizeof(T) / 16;  // 16-byte copies a row
  constexpr int kPer16 = 16 / sizeof(T);
  for (int i = tid; i < slots * kPieces; i += nthreads) {
    const int slot = i / kPieces, piece = i % kPieces;
    const int ky = slot / KWP, kx = slot % KWP;  // KWP is a power of two
    const bool valid = ky < kh && kx < kw;
    const T* src = base + (ky * kw + kx) * row_stride + piece * kPer16;
    tc::cp_async_16(k_s + slot * kLdK + piece * kPer16,
                    valid ? src + c : base, valid);
    tc::cp_async_16(v_s + slot * kLdV + piece * kPer16,
                    valid ? src + 2 * c : base, valid);
  }
}

// ---- bf16: relpos_window_tc_kernel ---------------------------------------

constexpr int kWinWarps = 7;         // one 16-row query tile a warp
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinSplit = 2;         // blocks a (window, head) is cut into

// One half of the slots for the bf16 kernel, n8 blocks NB0 .. NB0 + NBH - 1
// (NB0 and NBH even): scores from the q fragments of the warp's rows (q_w,
// kLd apart), bias, online softmax (O and l rescaled where the maximum
// moved) and P . V from registers.
template <int KWP, int NB0, int NBH>
__device__ __forceinline__ void tc_half(
    float (&o)[kDh / 8][4], float (&m)[2], float (&l)[2],
    const __nv_bfloat16* q_w, const __nv_bfloat16* k_s,
    const __nv_bfloat16* v_s, const float* r0, const float* r1,
    const float (&w0)[KWP / 4], const float (&w1)[KWP / 4], int kh,
    int nb_used, float qscale, int lane) {
  constexpr int kLd = tc::kLd;
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
  for (int ks = 0; ks < tc::kSteps; ++ks) {
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
    // key 0 lies in the first half, so the running maxima are finite
    mx[i] = quad_max(mx[i]);
    const float alpha = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn) {
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
      for (int dp = 0; dp < kDh / 16; ++dp) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, vk + dp * 16 + vcol);
        tc::mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
}

// One block takes query tiles [half * kWinWarps, ...) of one (window,
// head), a warp a 16-row tile (tiles past 2 kWinWarps loop); two blocks
// share an SM.
template <int KWP, int NB>
__global__ void __launch_bounds__(kWinThreads, 2)
    relpos_window_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ r,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int n, int heads, int kh,
                            int kw, float qscale) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = tc::kLd;
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
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + win * n * row_stride + h * kDh;
  const __nv_bfloat16* rbase = r + win * n * heads * rr + h * rr;
  __nv_bfloat16* q_w = q_s + warp * tc::kRows * kLd;
  float* r_w = r_s + warp * tc::kRows * rs;
  const int tiles = (n + tc::kRows - 1) / tc::kRows;

  copy_kv_slots<KWP>(base, row_stride, c, slots, kh, kw, k_s, v_s, kLd, kLd,
                     tid, kWinThreads);
  // each warp's q and r rows; a tile past the first restages them
  const int first = half * kWinWarps + warp;
  auto stage = [&](int row0) {
    tc::copy_rows_async(base, row_stride, row0, tc::kRows, n, q_w, lane, 32);
    tc::load_r(rbase, (long long)heads * rr, row0, n, rr, r_w, lane);
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
    float o[kDh / 8][4];
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    tc_half<KWP, 0, NB / 2>(o, m, l, q_w, k_s, v_s, r0, r1, w0, w1, kh,
                            nb_used, qscale, lane);
    tc_half<KWP, NB / 2, NB / 2>(o, m, l, q_w, k_s, v_s, r0, r1, w0, w1, kh,
                                 nb_used, qscale, lane);

    // normalise, write rows < n and their log-sum-exp
    __nv_bfloat16* o_g = out + win * n * c + h * kDh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]), inv = 1.f / li;
      const int qi = row0 + g + 8 * i;
      if (qi < n) {
        uint32_t* row = reinterpret_cast<uint32_t*>(o_g + qi * (long long)c);
#pragma unroll
        for (int dn = 0; dn < kDh / 8; ++dn)
          row[dn * 4 + t] =
              tc::pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
        if (lse != nullptr && t == 0)
          lse[(win * heads + h) * n + qi] = m[i] + log2f(li);
      }
    }
    __syncwarp();  // q_w and r_w are restaged for a next tile
  }
}

template <int KWP, int NB>
cudaError_t launch_window_tc(const void* qkv, const void* r, void* out,
                             float* lse, int g, int n, int heads, int kh,
                             int kw, float qscale, cudaStream_t stream) {
  const int slots = 8 * Slots<KWP>::blocks(kh);
  const size_t smem =
      (size_t)(2 * slots + kWinWarps * tc::kRows) * tc::kLd *
          sizeof(__nv_bfloat16) +
      (size_t)kWinWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_window_tc_kernel<KWP, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g, kWinSplit);
  relpos_window_tc_kernel<KWP, NB><<<grid, kWinThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

// ---- fp32: relpos_window_f32_kernel (TF32, three products) ----------------

constexpr int kF32Warps = 13;        // one 16-row query tile a warp
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kLdK = kDh + 4;        // fp32 slot rows: fragment loads of K
constexpr int kLdV = kDh + 8;        // (4 g + t) and V (8 t + g) hit 32 banks
constexpr int kLdQ = kDh + 4;

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in fp32 accuracy from TF32 products: a_lo b_hi + a_hi b_lo +
// a_hi b_hi (a_lo b_lo, about 2^-22 of the product, is left out)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// One half of the slots, n8 blocks NB0 .. NB0 + NBH - 1: scores, bias,
// online softmax (m, l, O rescaled where the maximum moved) and P . V.
// q_w: the warp's 16 fp32 q rows (kLdQ apart); r0 / r1 the rows' r.
template <int KWP, int NB0, int NBH>
__device__ __forceinline__ void f32_half(
    float (&o)[kDh / 8][4], float (&m)[2], float (&l)[2], const float* q_w,
    const float* k_s, const float* v_s, const float* r0, const float* r1,
    const float (&w0)[KWP / 4], const float (&w1)[KWP / 4], int kh,
    int nb_used, float qscale, int lane) {
  if (NB0 >= nb_used) return;
  const int g = lane >> 2, t = lane & 3;
  float s[NBH][4];
#pragma unroll
  for (int i = 0; i < NBH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kDh / 8; ++ks) {
    const float qa[4] = {q_w[g * kLdQ + 8 * ks + t],
                         q_w[(g + 8) * kLdQ + 8 * ks + t],
                         q_w[g * kLdQ + 8 * ks + t + 4],
                         q_w[(g + 8) * kLdQ + 8 * ks + t + 4]};
#pragma unroll
    for (int i = 0; i < NBH; ++i)
      if (NB0 + i < nb_used) {
        const float* krow = k_s + ((NB0 + i) * 8 + g) * kLdK + 8 * ks + t;
        mma_3xtf32(s[i], qa, krow[0], krow[4]);
      }
  }
  float mx[2] = {m[0], m[1]};
  bias_max<KWP, NB0, NBH>(s, r0, r1, w0, w1, kh, nb_used, qscale, mx[0],
                          mx[1]);
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // key 0 lies in the first half, so the running maxima are finite
    mx[i] = quad_max(mx[i]);
    const float alpha = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn) {
      o[dn][2 * i] *= alpha;
      o[dn][2 * i + 1] *= alpha;
    }
  }
  // P . V a k-step (8 slots) at a time. The A fragment wants columns t and
  // t + 4 of rows g and g + 8; the accumulator layout holds columns 2 t and
  // 2 t + 1, so column j comes from lane 4 g + j / 2, element j % 2.
  const int src0 = 4 * g + (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < NBH; ++i)
    if (NB0 + i < nb_used) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(s[i][e] - m[e >> 1]);
        ls[e >> 1] += s[i][e];
      }
      float pa[4];
#pragma unroll
      for (int row = 0; row < 2; ++row) {  // rows g, g + 8: s[i][2 row + e]
        const float x0 = __shfl_sync(0xffffffffu, s[i][2 * row], src0);
        const float x1 = __shfl_sync(0xffffffffu, s[i][2 * row + 1], src0);
        const float y0 = __shfl_sync(0xffffffffu, s[i][2 * row], src1);
        const float y1 = __shfl_sync(0xffffffffu, s[i][2 * row + 1], src1);
        pa[row] = odd ? x1 : x0;      // a0 / a1: column t
        pa[2 + row] = odd ? y1 : y0;  // a2 / a3: column t + 4
      }
      const float* vrow = v_s + (NB0 + i) * 8 * kLdV;
#pragma unroll
      for (int dn = 0; dn < kDh / 8; ++dn)
        mma_3xtf32(o[dn], pa, vrow[t * kLdV + 8 * dn + g],
                   vrow[(t + 4) * kLdV + 8 * dn + g]);
    }
  l[0] += ls[0];
  l[1] += ls[1];
}

template <int KWP, int NB>
__global__ void __launch_bounds__(kF32Threads, 1)
    relpos_window_f32_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ r,
                             float* __restrict__ out, float* __restrict__ lse,
                             int n, int heads, int kh, int kw, float qscale) {
  extern __shared__ float4 smem4[];
  const int nb_used = Slots<KWP>::blocks(kh), slots = 8 * nb_used;
  const int rr = kh + kw, rs = rr + 1;
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + slots * kLdK;
  float* q_s = v_s + slots * kLdV;
  float* r_s = q_s + kF32Warps * tc::kRows * kLdQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const long long win = blockIdx.y;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + win * n * row_stride + h * kDh;
  const float* rbase = r + win * n * heads * rr + h * rr;
  float* q_w = q_s + warp * tc::kRows * kLdQ;
  float* r_w = r_s + warp * tc::kRows * rs;
  const int tiles = (n + tc::kRows - 1) / tc::kRows;

  copy_kv_slots<KWP>(base, row_stride, c, slots, kh, kw, k_s, v_s, kLdK,
                     kLdV, tid, kF32Threads);
  auto stage = [&](int row0) {
    for (int i = lane; i < tc::kRows * (kDh / 4); i += 32) {
      const int row = i / (kDh / 4), c4 = i % (kDh / 4), qi = row0 + row;
      tc::cp_async_16(q_w + row * kLdQ + 4 * c4,
                      qi < n ? base + qi * row_stride + 4 * c4 : base,
                      qi < n);
    }
    for (int i = lane; i < tc::kRows * rr; i += 32) {
      const int row = i / rr, j = i - row * rr, qi = row0 + row;
      r_w[row * rs + j] = qi < n ? rbase[qi * (long long)heads * rr + j] : 0.f;
    }
  };
  if (warp < tiles) stage(warp * tc::kRows);
  tc::cp_async_wait();
  __syncthreads();  // K, V, q and r landed

  for (int tile = warp; tile < tiles; tile += kF32Warps) {
    const int row0 = tile * tc::kRows;
    if (tile != warp) {
      __syncwarp();
      stage(row0);
      tc::cp_async_wait();
      __syncwarp();
    }
    const float* r0 = r_w + g * rs;
    const float* r1 = r_w + (g + 8) * rs;
    float w0[KWP / 4], w1[KWP / 4];
    load_rel_w<KWP>(w0, r0, kh, kw, t);
    load_rel_w<KWP>(w1, r1, kh, kw, t);
    float o[kDh / 8][4];
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    f32_half<KWP, 0, NB / 2>(o, m, l, q_w, k_s, v_s, r0, r1, w0, w1, kh,
                             nb_used, qscale, lane);
    f32_half<KWP, NB / 2, NB / 2>(o, m, l, q_w, k_s, v_s, r0, r1, w0, w1, kh,
                                  nb_used, qscale, lane);

    float* o_g = out + win * n * c + h * kDh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]), inv = 1.f / li;
      const int qi = row0 + g + 8 * i;
      if (qi < n) {
        float* row = o_g + qi * (long long)c;
#pragma unroll
        for (int dn = 0; dn < kDh / 8; ++dn)
          *reinterpret_cast<float2*>(row + 8 * dn + 2 * t) =
              make_float2(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
        if (lse != nullptr && t == 0)
          lse[(win * heads + h) * n + qi] = m[i] + log2f(li);
      }
    }
  }
}

template <int KWP, int NB>
cudaError_t launch_window_f32(const void* qkv, const void* r, void* out,
                              float* lse, int g, int n, int heads, int kh,
                              int kw, float qscale, cudaStream_t stream) {
  const int slots = 8 * Slots<KWP>::blocks(kh);
  const size_t smem =
      ((size_t)slots * (kLdK + kLdV) + (size_t)kF32Warps * tc::kRows * kLdQ +
       (size_t)kF32Warps * tc::kRows * (kh + kw + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_window_f32_kernel<KWP, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, g);
  relpos_window_f32_kernel<KWP, NB><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(r),
      static_cast<float*>(out), lse, n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

// The slot layouts compiled, for windows up to 16 x 16: key-grid rows up
// to 8 wide, or up to 16 wide (14 x 14 windows have their own instance,
// whose 28 n8 blocks are the serving path's).
template <bool kBf16>
cudaError_t launch_window(const void* qkv, const void* r, void* out,
                          float* lse, int g, int n, int heads, int kh, int kw,
                          float qscale, cudaStream_t stream) {
  auto as = [&](auto kwp, auto nb) {
    constexpr int KWP = decltype(kwp)::value, NB = decltype(nb)::value;
    return kBf16 ? launch_window_tc<KWP, NB>(qkv, r, out, lse, g, n, heads,
                                             kh, kw, qscale, stream)
                 : launch_window_f32<KWP, NB>(qkv, r, out, lse, g, n, heads,
                                              kh, kw, qscale, stream);
  };
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  if (kh > 16 || kw > 16) return cudaErrorInvalidValue;
  if (kw <= 8) return as(I8{}, I16{});
  if (kh <= 14) return as(I16{}, std::integral_constant<int, 28>{});
  return as(I16{}, std::integral_constant<int, 32>{});
}

}  // namespace relpos

// qkv (g, n, 3 * heads * 64), r (g, n, heads * (kh + kw)) and out
// (g, n, heads * 64), contiguous and 16-byte aligned, one dtype (0 = fp32,
// 1 = bf16); key grids up to 16 x 16. lse as for la_relpos_global, (g,
// heads, n).
extern "C" int la_relpos_window(const void* qkv, const void* r, void* out,
                                float* lse, int g, int n, int heads, int kh,
                                int kw, float scale, int is_bf16,
                                void* stream) {
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? relpos::launch_window<true>(qkv, r, out, lse, g, n, heads, kh,
                                            kw, qscale, s)
              : relpos::launch_window<false>(qkv, r, out, lse, g, n, heads,
                                             kh, kw, qscale, s);
  return (int)err;
}

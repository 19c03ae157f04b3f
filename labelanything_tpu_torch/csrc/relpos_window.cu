// Windowed-block rel-pos attention (SAM ViT windowed layers, 14 x 14
// windows of N = 196 tokens).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// flash_attention_relpos_lanes_batched -> _lanes_batched_fwd_impl (Pallas
// body _relpos_lanes_batched_kernel).
//
// The bf16 kernel is relpos_window.cuh's window_tc_kernel at head width 64
// on the contiguous token-major layout (the design is described there: key
// slots by key-grid row, rel_w in registers, one warp per 16-row query
// tile, two blocks of 7 warps a (window, head), the slots in two halves).
// The same template serves the packed windowed kernel at head width 80
// (relpos_packed.cu).
//
// * fp32 (parity, the fp32 configurations): relpos_window_f32_kernel on
//   the tensor cores in TF32 with the three-product split (x = hi + lo,
//   both TF32; hi hi' + hi lo' + lo hi', error about 2^-21 of a product,
//   near fp32's own), mma.sync m16n8k8, in the same slot layout and
//   halves. One block of 13 warps a (window, head); P is moved from the
//   accumulator layout into A fragments by warp shuffles.
//
// Both write the log-sum-exp (log2 domain) of every row where lse is not
// null; relpos_window_bwd.cu reads it.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"
#include "relpos_window.cuh"

namespace relpos {

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

  copy_kv_slots<KWP, kDh>(base + c, base + 2 * c, row_stride, slots, kh, kw,
                          k_s, v_s, kLdK, kLdV, tid, kF32Threads);
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

// bf16 through window_tc_kernel on the contiguous token-major layout,
// fp32 through relpos_window_f32_kernel
template <bool kBf16>
cudaError_t launch_window(const void* qkv, const void* r, void* out,
                          float* lse, int g, int n, int heads, int kh, int kw,
                          float qscale, cudaStream_t stream) {
  const long long c = (long long)heads * kDh, rr = kh + kw;
  const Strides s[3] = {{n * 3 * c, kDh, 3 * c},           // qkv
                        {n * heads * rr, rr, heads * rr},  // r
                        {n * c, kDh, c}};                  // out
  return with_slot_layout(kh, kw, [&](auto kwp, auto nb) {
    constexpr int KWP = decltype(kwp)::value, NB = decltype(nb)::value;
    return kBf16 ? launch_window_tc<kDh, KWP, NB>(qkv, r, out, lse, g, n,
                                                  heads, kh, kw, qscale, s,
                                                  stream)
                 : launch_window_f32<KWP, NB>(qkv, r, out, lse, g, n, heads,
                                              kh, kw, qscale, stream);
  });
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

// Global-block rel-pos attention with the q . k scores taken in int8 (the
// opt-in int8 branch of K1).
//
// Replaces the TPU kernel labelanything_tpu/ops/flash_attention.py:
// _bias_loop_vpu(int8_scores=True) inside _relpos_lanes_kernel_vpu, reached
// through flash_attention_relpos_lanes -> _lanes_fwd_impl when the flag is
// set and vpu_bias_ok holds.
//
// The function, as the TPU kernel quantizes: q is fp32(q) * scale * log2(e);
// each query row and each key row (unscaled fp32 k) of a head is quantized
// symmetrically, scale s = max|row| / 127, code round(x / max(s, 1e-30)),
// half to even; the score is float(sum q8 k8) * sq * sk, to which the
// factored bias is added; exp2, the online softmax and P . V follow as in
// relpos_global.cu. With dh = 64, |sum q8 k8| <= 64 * 127^2 < 2^24, so the
// integer sums are exact in any order.
//
// One block per (image, head, 64-row query tile), keys walked in tiles of
// 64, as the bf16 / fp32 kernels of relpos_global.cu. A key row's scale
// depends on that row alone, so each tile is quantized as it lands in
// shared memory: every query tile re-quantizes the keys (N / 64 times
// over), which costs one pass over a 64 x 64 tile per 64 x 64 block of
// scores.
//
// * bf16: relpos_global_int8_tc_kernel, four warps of 16 query rows. The
//   warp quantizes its q rows once (a warp max per row) into an int8 tile
//   and holds them as mma.sync.m16n8k32 s8 A fragments; the scores come from
//   mma.m16n8k32.row.col.s32.s8.s8.s32 (int32 accumulators). In bytes the
//   s8 fragments of m16n8k32 lie exactly as the bf16 fragments of m16n8k16
//   (a register holds bytes 4t..4t+3 of row g, or of row g + 8, or 16 bytes
//   further), so the fragment loads are relpos_mma.cuh's on a 32-byte
//   k-step. Dequantize, bias and exp2 in fp32, P . V with bf16 mma.sync
//   (relpos_mma.cuh's softmax_pv).
//   Bound: the exponentials (one a score) and the P . V products, as for
//   the bf16 kernel; the int8 products halve only the score half of the
//   tensor-core work, so the branch cannot be much faster than the bf16
//   kernel on this card.
// * fp32: relpos_global_int8_kernel on the CUDA cores, the layout of
//   relpos_global_kernel with the scores from __dp4a on packed int8 codes
//   (K^T packed four channels a word).
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {

namespace {

constexpr int kQTile8 = 64;
constexpr int kKTile8 = 64;
constexpr int kLd8 = kDh + 16;  // bytes a row of an int8 tile: the word
                                // stride 20 keeps fragment loads
                                // conflict-free
constexpr int kWords8 = kDh / 4;  // packed words a row of codes (fp32 kernel)
constexpr int kLdk8 = kKTile8 + 1;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round(x / max(s, 1e-30)) half to even, as an int8 code (|code| <= 127)
__device__ __forceinline__ int quantize(float x, float s) {
  return static_cast<int>(rintf(x / fmaxf(s, 1e-30f)));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

}  // namespace

// ---------------------------------------------------------------- bf16

template <bool kRowChunk>
__global__ void __launch_bounds__(tc::kThreads)
    relpos_global_int8_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ r,
                                 __nv_bfloat16* __restrict__ out, int n,
                                 int heads, int kh, int kw, float qscale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + tc::kTileElems;
  __nv_bfloat16* q_s = v_s + tc::kTileElems;
  int8_t* k8_s = reinterpret_cast<int8_t*>(q_s + tc::kWarps * tc::kRows *
                                                     tc::kLd);
  int8_t* q8_s = k8_s + kKTile8 * kLd8;
  float* sk_s = reinterpret_cast<float*>(q8_s + tc::kWarps * tc::kRows * kLd8);
  float* r_s = sk_s + kKTile8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride + h * kDh;
  const int row0 = (blockIdx.x * tc::kWarps + warp) * tc::kRows;
  float* r_w = r_s + warp * tc::kRows * (rr + 1);
  __nv_bfloat16* q_w = q_s + warp * tc::kRows * tc::kLd;
  int8_t* q8_w = q8_s + warp * tc::kRows * kLd8;

  // the warp's q rows: stage, scale, quantize row by row (lane l holds
  // channels 2l, 2l + 1), then load the codes as A fragments
  tc::copy_rows(base, row_stride, row0, tc::kRows, n, q_w, lane, 32);
  __syncwarp();
  float sq0 = 0.f, sq1 = 0.f;  // the scales of rows g and g + 8
  for (int i = 0; i < tc::kRows; ++i) {
    const __nv_bfloat162 pair =
        reinterpret_cast<const __nv_bfloat162*>(q_w + i * tc::kLd)[lane];
    const float x0 = __bfloat162float(pair.x) * qscale;
    const float x1 = __bfloat162float(pair.y) * qscale;
    const float sq = warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f;
    if (i == g) sq0 = sq;
    if (i == g + 8) sq1 = sq;
    reinterpret_cast<uint16_t*>(q8_w + i * kLd8)[lane] =
        (uint16_t)((quantize(x0, sq) & 0xff) | ((quantize(x1, sq) & 0xff) << 8));
  }
  __syncwarp();
  uint32_t qa[kDh / 32][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q8_w);
    constexpr int ldw = kLd8 / 4;
#pragma unroll
    for (int ks = 0; ks < kDh / 32; ++ks) {
      qa[ks][0] = q32[g * ldw + ks * 8 + t];
      qa[ks][1] = q32[(g + 8) * ldw + ks * 8 + t];
      qa[ks][2] = q32[g * ldw + ks * 8 + 4 + t];
      qa[ks][3] = q32[(g + 8) * ldw + ks * 8 + 4 + t];
    }
  }
  tc::load_r(r + (long long)b * n * heads * rr + h * rr,
             (long long)heads * rr, row0, n, rr, r_w, lane);

  tc::Rows st;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[dn][e] = 0.f;

  const float* r0 = r_w + g * (rr + 1);
  const float* r1 = r_w + (g + 8) * (rr + 1);
  for (int k0 = 0; k0 < n; k0 += kKTile8) {
    __syncthreads();  // previous tile fully consumed
    tc::copy_rows_async(base + c, row_stride, k0, kKTile8, n, k_s, tid,
                        tc::kThreads);
    tc::copy_rows_async(base + 2 * c, row_stride, k0, kKTile8, n, v_s, tid,
                        tc::kThreads);
    tc::cp_async_wait();
    __syncthreads();
    {
      // quantize the key tile: two threads a row, 32 channels each (rows
      // past n are zero and stay zero)
      const int row = tid >> 1, half = tid & 1;
      const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
          k_s + row * tc::kLd + half * 32);
      float x[32];
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[2 * i] = __bfloat162float(src[i].x);
        x[2 * i + 1] = __bfloat162float(src[i].y);
        mx = fmaxf(mx, fmaxf(fabsf(x[2 * i]), fabsf(x[2 * i + 1])));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float sk = mx / 127.f;
      uint32_t* dst = reinterpret_cast<uint32_t*>(k8_s + row * kLd8 + half * 32);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = pack4(quantize(x[4 * i], sk), quantize(x[4 * i + 1], sk),
                       quantize(x[4 * i + 2], sk), quantize(x[4 * i + 3], sk));
      if (half == 0) sk_s[row] = sk;
    }
    __syncthreads();

    int acc[tc::kChunk / 8][4];
#pragma unroll
    for (int nt = 0; nt < tc::kChunk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k8_s);
#pragma unroll
    for (int ks = 0; ks < kDh / 32; ++ks)
#pragma unroll
      for (int nt = 0; nt < tc::kChunk / 8; ++nt) {
        const uint32_t* row = k32 + (nt * 8 + g) * (kLd8 / 4) + ks * 8 + t;
        mma_s8(acc[nt], qa[ks], row[0], row[4]);
      }

    float s[tc::kChunk / 8][4];
    float mx0 = st.m[0], mx1 = st.m[1];
    const float h0 = kRowChunk ? r0[k0 / tc::kChunk] : 0.f;
    const float h1 = kRowChunk ? r1[k0 / tc::kChunk] : 0.f;
#pragma unroll
    for (int nt = 0; nt < tc::kChunk / 8; ++nt)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int e = nt * 8 + 2 * t + bb, j = k0 + e;
        if (j < n) {
          const float sk = sk_s[e];
          float b0, b1;
          if constexpr (kRowChunk) {
            b0 = h0 + r0[kh + e];
            b1 = h1 + r1[kh + e];
          } else {
            const int ky = j / kw, kx = kh + j - ky * kw;
            b0 = r0[ky] + r0[kx];
            b1 = r1[ky] + r1[kx];
          }
          s[nt][bb] = (float)acc[nt][bb] * (sq0 * sk) + b0;
          s[nt][2 + bb] = (float)acc[nt][2 + bb] * (sq1 * sk) + b1;
        } else {
          s[nt][bb] = -INFINITY;
          s[nt][2 + bb] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][bb]);
        mx1 = fmaxf(mx1, s[nt][2 + bb]);
      }
    tc::softmax_pv(st, s, mx0, mx1, v_s, lane);
  }
  tc::end_rows(st, out + (long long)b * n * c + h * kDh, c, row0, n, lane,
               nullptr);
}

cudaError_t launch_global_int8_tc(const void* qkv, const void* r, void* out,
                                  int b, int n, int heads, int kh, int kw,
                                  float qscale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * tc::kChunk + tc::kWarps * tc::kRows) * tc::kLd *
          sizeof(__nv_bfloat16) +
      (size_t)(kKTile8 + tc::kWarps * tc::kRows) * kLd8 +
      (size_t)kKTile8 * sizeof(float) +
      (size_t)tc::kWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  auto kernel = kw == tc::kChunk ? relpos_global_int8_tc_kernel<true>
                                 : relpos_global_int8_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = tc::kWarps * tc::kRows;
  const dim3 grid((n + rows - 1) / rows, heads, b);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32

constexpr int kRows8 = kQTile8 / kWarps;  // query rows a warp

__global__ void __launch_bounds__(kThreads)
    relpos_global_int8_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ r,
                              float* __restrict__ out, int n, int heads,
                              int kh, int kw, float qscale) {
  extern __shared__ float4 smem4[];
  const int rr = kh + kw;
  uint32_t* q8_s = reinterpret_cast<uint32_t*>(smem4);  // [row][word]
  uint32_t* kt8_s = q8_s + kQTile8 * kWords8;           // [word][key]
  float* v_s = reinterpret_cast<float*>(kt8_s + kWords8 * kLdk8);
  float* p_s = v_s + kKTile8 * kDh;
  float* r_s = p_s + kQTile8 * kKTile8;
  float* sq_s = r_s + kQTile8 * rr;
  float* sk_s = sq_s + kQTile8;

  const int q0 = blockIdx.x * kQTile8;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = heads * kDh;
  const long long row_stride = 3LL * c;
  const float* base = qkv + (long long)b * n * row_stride;
  const float* rbase = r + (long long)b * n * heads * rr;

  // q rows: warp w quantizes rows kRows8 w .. + kRows8 - 1; lane l holds
  // channels l and l + 32
  int8_t* q8b = reinterpret_cast<int8_t*>(q8_s);
  for (int i = 0; i < kRows8; ++i) {
    const int row = warp * kRows8 + i, qi = q0 + row;
    const float* src = base + (long long)qi * row_stride + h * kDh;
    const float x0 = qi < n ? src[lane] * qscale : 0.f;
    const float x1 = qi < n ? src[lane + 32] * qscale : 0.f;
    const float sq = warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f;
    q8b[row * kDh + lane] = (int8_t)quantize(x0, sq);
    q8b[row * kDh + lane + 32] = (int8_t)quantize(x1, sq);
    if (lane == 0) sq_s[row] = sq;
  }
  for (int idx = tid; idx < kQTile8 * rr; idx += kThreads) {
    const int i = idx / rr, j = idx % rr, qi = q0 + i;
    r_s[idx] = qi < n ? rbase[((long long)qi * heads + h) * rr + j] : 0.f;
  }

  float m[kRows8], l[kRows8], o0[kRows8], o1[kRows8];
#pragma unroll
  for (int i = 0; i < kRows8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    o0[i] = 0.f;
    o1[i] = 0.f;
  }
  const uint32_t* q_w = q8_s + warp * kRows8 * kWords8;
  const float* r_w = r_s + warp * kRows8 * rr;
  const float* sq_w = sq_s + warp * kRows8;
  float* p_w = p_s + warp * kRows8 * kKTile8;

  for (int k0 = 0; k0 < n; k0 += kKTile8) {
    __syncthreads();  // previous tile fully consumed; q codes written
    {
      // key tile: four threads a row (neighbouring lanes), 16 channels each
      const int j = tid >> 2, part = tid & 3, kj = k0 + j;
      const float* krow = base + (long long)kj * row_stride + c + h * kDh +
                          part * 16;
      float x[16];
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[i] = kj < n ? krow[i] : 0.f;
        mx = fmaxf(mx, fabsf(x[i]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float sk = mx / 127.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        kt8_s[(part * 4 + w) * kLdk8 + j] =
            pack4(quantize(x[4 * w], sk), quantize(x[4 * w + 1], sk),
                  quantize(x[4 * w + 2], sk), quantize(x[4 * w + 3], sk));
      if (part == 0) sk_s[j] = sk;
    }
    for (int idx = tid; idx < kKTile8 * kDh; idx += kThreads) {
      const int j = idx / kDh, d = idx % kDh, kj = k0 + j;
      v_s[j * kDh + d] =
          kj < n ? base[(long long)kj * row_stride + 2 * c + h * kDh + d] : 0.f;
    }
    __syncthreads();

    int s0[kRows8], s1[kRows8];
#pragma unroll
    for (int i = 0; i < kRows8; ++i) {
      s0[i] = 0;
      s1[i] = 0;
    }
#pragma unroll 4
    for (int w = 0; w < kWords8; ++w) {
      const int a = (int)kt8_s[w * kLdk8 + lane];
      const int bb = (int)kt8_s[w * kLdk8 + lane + 32];
#pragma unroll
      for (int i = 0; i < kRows8; ++i) {
        const int qv = (int)q_w[i * kWords8 + w];
        s0[i] = __dp4a(qv, a, s0[i]);
        s1[i] = __dp4a(qv, bb, s1[i]);
      }
    }

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
    const bool ok0 = kj0 < n, ok1 = kj1 < n;
    const int ky0 = kj0 / kw, kx0 = kj0 - ky0 * kw;
    const int ky1 = kj1 / kw, kx1 = kj1 - ky1 * kw;
    const float sk0 = sk_s[lane], sk1 = sk_s[lane + 32];
#pragma unroll
    for (int i = 0; i < kRows8; ++i) {
      const float* rrow = r_w + i * rr;
      const float a = ok0 ? (float)s0[i] * (sq_w[i] * sk0) + rrow[ky0] +
                                rrow[kh + kx0]
                          : -INFINITY;
      const float bb = ok1 ? (float)s1[i] * (sq_w[i] * sk1) + rrow[ky1] +
                                 rrow[kh + kx1]
                           : -INFINITY;
      // key k0 < n is always valid, so the tile max is finite
      const float m_new = fmaxf(m[i], warp_max(fmaxf(a, bb)));
      const float alpha = exp2f(m[i] - m_new);
      const float pa = exp2f(a - m_new);
      const float pb = exp2f(bb - m_new);
      l[i] = l[i] * alpha + warp_sum(pa + pb);
      m[i] = m_new;
      o0[i] *= alpha;
      o1[i] *= alpha;
      p_w[i * kKTile8 + lane] = pa;
      p_w[i * kKTile8 + lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kKTile8; j += 4) {
      const float a0 = v_s[(j + 0) * kDh + lane];
      const float a1 = v_s[(j + 1) * kDh + lane];
      const float a2 = v_s[(j + 2) * kDh + lane];
      const float a3 = v_s[(j + 3) * kDh + lane];
      const float b0 = v_s[(j + 0) * kDh + lane + 32];
      const float b1 = v_s[(j + 1) * kDh + lane + 32];
      const float b2 = v_s[(j + 2) * kDh + lane + 32];
      const float b3 = v_s[(j + 3) * kDh + lane + 32];
#pragma unroll
      for (int i = 0; i < kRows8; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_w + i * kKTile8 + j);
        o0[i] = fmaf(pv.x, a0, fmaf(pv.y, a1, fmaf(pv.z, a2, fmaf(pv.w, a3, o0[i]))));
        o1[i] = fmaf(pv.x, b0, fmaf(pv.y, b1, fmaf(pv.z, b2, fmaf(pv.w, b3, o1[i]))));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows8; ++i) {
    const int qi = q0 + warp * kRows8 + i;
    if (qi < n) {
      const float inv = 1.f / l[i];
      float* orow = out + ((long long)b * n + qi) * c + h * kDh;
      orow[lane] = o0[i] * inv;
      orow[lane + 32] = o1[i] * inv;
    }
  }
}

cudaError_t launch_global_int8(const void* qkv, const void* r, void* out,
                               int b, int n, int heads, int kh, int kw,
                               float qscale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kQTile8 * kWords8 + kWords8 * kLdk8) * sizeof(uint32_t) +
      ((size_t)kKTile8 * kDh + (size_t)kQTile8 * kKTile8 +
       (size_t)kQTile8 * (kh + kw) + kQTile8 + kKTile8) *
          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_global_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile8 - 1) / kQTile8, heads, b);
  relpos_global_int8_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(r),
      static_cast<float*>(out), n, heads, kh, kw, qscale);
  return cudaGetLastError();
}

}  // namespace relpos

// qkv (b, n, 3 * heads * 64), r (b, n, heads * (kh + kw)) and out
// (b, n, heads * 64), contiguous and 16-byte aligned, all of one dtype
// (0 = fp32, 1 = bf16). qscale is scale * log2(e) as the caller rounds it
// to fp32, so that the codes are those of the plain twin. No log-sum-exp:
// the gradient takes the full-precision one from the bf16 / fp32 kernel.
extern "C" int la_relpos_global_int8(const void* qkv, const void* r,
                                     void* out, int b, int n, int heads,
                                     int kh, int kw, float qscale,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? relpos::launch_global_int8_tc(qkv, r, out, b, n, heads, kh,
                                              kw, qscale, s)
              : relpos::launch_global_int8(qkv, r, out, b, n, heads, kh, kw,
                                           qscale, s);
  return (int)err;
}

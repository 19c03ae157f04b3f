// bf16 tensor-core step and kernels of the packed rel-pos attention, for any
// head width DH that is a multiple of 16 (compiled for 64 and 80).
//
// The packed layout keeps q, k and v of head h in slots h, heads + h and
// 2 heads + h of one (B, 3 heads, N, DH) tensor and the factored bias in
// (B, heads, N, kh + kw). The kernels are handed each operand's batch, slot
// and token strides, so the same code reads the contiguous slot-major tensor
// and the qkv projection viewed token-major (no relayout copy), and writes
// the output in either order.
//
// The warp step is relpos_mma.cuh's (16 query rows a warp as mma.sync
// m16n8k16 fragments, keys in chunks of 64, exact online softmax in the log2
// domain, P's accumulators reused as A fragments), with the head width a
// template parameter: DH / 16 k-steps for q . k^T and DH / 8 output tiles
// for P . V (5 and 10 at DH = 80). A shared row holds DH + 8 bf16: the word
// stride (DH + 8) / 2 is 4 mod 8 for every DH that is a multiple of 16, so
// the eight rows of a fragment load fall on distinct banks, and the eight
// 16-byte rows of an ldmatrix on distinct 16-byte slots of a 128-byte line.
//
// kVariant selects how the bias and the exponentials are computed:
//   kBiasFromRow  the shipped path: bias added from the query row's r values
//                 in shared memory, exponentials in fp32;
//   kBiasOneHot   bias expanded by a one-hot mma into the score
//                 accumulators: r (16 x rr, A fragments) times a 0/1 matrix
//                 (rr x 64 keys) whose B fragments are made in registers;
//   kExpBf16      the shipped bias, exponentials two at a time in bf16
//                 (ex2.approx.ftz.bf16x2) straight into P's A fragments, P
//                 never held in fp32; the row sums come from one more mma of
//                 P against a column of ones.
// The last two are launched by the score-dtype microbench only.
#pragma once

#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace relpos {
namespace packed {

// element strides of one operand: batch, slot (head), token; the last axis
// is contiguous
struct Strides {
  long long b, h, t;
};

enum : int { kBiasFromRow = 0, kBiasOneHot = 1, kExpBf16 = 2 };

constexpr int kOneHotSteps = 8;  // kBiasOneHot: kh + kw <= 16 * 8
constexpr int kWindowMaxN = 256;

template <int DH>
struct Rows {
  uint32_t qa[DH / 16][4];  // q as A fragments
  float m[2];               // running max of rows g, g + 8 (log2 domain)
  float l[2];               // row sums: this thread's part, or with
                            // kExpBf16 the whole row's
  float o[DH / 8][4];       // output accumulators
};

// Starts the copy of `rows` rows of DH bf16 (row stride `stride` elements,
// first row `row0`, rows >= n zero) into a (DH + 8)-strided shared tile.
template <int DH>
__device__ __forceinline__ void copy_rows_async(const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int rows, int n,
                                                __nv_bfloat16* dst, int tid,
                                                int nthreads) {
  constexpr int kVec = DH / 8;  // 16-byte pieces a row
  for (int i = tid; i < rows * kVec; i += nthreads) {
    const int row = i / kVec, c8 = i - row * kVec, gi = row0 + row;
    const bool valid = gi < n;
    tc::cp_async_16(dst + row * (DH + 8) + c8 * 8,
                    valid ? src + gi * stride + c8 * 8 : src, valid);
  }
}

template <int DH>
__device__ __forceinline__ void begin_rows(Rows<DH>& st,
                                           const __nv_bfloat16* q_src,
                                           long long stride, int row0, int n,
                                           __nv_bfloat16* q_w, int lane) {
  constexpr int kLdw = (DH + 8) / 2;
  copy_rows_async<DH>(q_src, stride, row0, tc::kRows, n, q_w, lane, 32);
  tc::cp_async_wait();
  __syncwarp();
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_w);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    st.qa[ks][0] = q32[g * kLdw + ks * 8 + t];
    st.qa[ks][1] = q32[(g + 8) * kLdw + ks * 8 + t];
    st.qa[ks][2] = q32[g * kLdw + ks * 8 + 4 + t];
    st.qa[ks][3] = q32[(g + 8) * kLdw + ks * 8 + 4 + t];
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[dn][e] = 0.f;
}

// kBiasOneHot: the warp's r rows (fp32 in shared memory, row stride rs,
// rr valid values a row) as bf16 A fragments, zero past rr. Exact: r came
// from bf16.
__device__ __forceinline__ void r_fragments(uint32_t (&ra)[kOneHotSteps][4],
                                            const float* r_w, int rs, int rr,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto pair = [&](int row, int c) {
    const float lo = c < rr ? r_w[row * rs + c] : 0.f;
    const float hi = c + 1 < rr ? r_w[row * rs + c + 1] : 0.f;
    return tc::pack_bf16(lo, hi);
  };
#pragma unroll
  for (int kc = 0; kc < kOneHotSteps; ++kc) {
    const int c = kc * 16 + 2 * t;
    ra[kc][0] = pair(g, c);
    ra[kc][1] = pair(g + 8, c);
    ra[kc][2] = pair(g, c + 8);
    ra[kc][3] = pair(g + 8, c + 8);
  }
}

// Two rows c, c + 1 of the 0/1 expansion matrix for one key, as a bf16
// pair: row c is 1 where c is the key's ky or kh + kx.
__device__ __forceinline__ uint32_t onehot_pair(int c, int ky, int kxh) {
  return ((c == ky || c == kxh) ? 0x00003f80u : 0u) |
         ((c + 1 == ky || c + 1 == kxh) ? 0x3f800000u : 0u);
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One chunk of 64 keys; arguments as relpos::tc::chunk. ra is read by
// kBiasOneHot only.
template <int DH, bool kRowChunk, int kVariant>
__device__ __forceinline__ void chunk(Rows<DH>& st, const __nv_bfloat16* k_s,
                                      const __nv_bfloat16* v_s,
                                      const float* r_w, int rs,
                                      const uint32_t (&ra)[kOneHotSteps][4],
                                      int kbase, int n, int kh, int kw,
                                      float qscale, int lane) {
  constexpr int kLd = DH + 8, kLdw = kLd / 2, kTiles = tc::kChunk / 8;
  const int g = lane >> 2, t = lane & 3;
  float s[kTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k_s);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const uint32_t* row = k32 + (nt * 8 + g) * kLdw + ks * 8 + t;
      tc::mma_bf16(s[nt], st.qa[ks], row[0], row[4]);
    }

  float mx0 = st.m[0], mx1 = st.m[1];
  if constexpr (kVariant == kBiasOneHot) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= qscale;
      // this thread's column of the B fragments is key nt * 8 + g
      const int j = kbase + nt * 8 + g;
      const int ky = kRowChunk ? kbase / tc::kChunk : j / kw;
      const int kxh = kh + (kRowChunk ? nt * 8 + g : j - ky * kw);
#pragma unroll
      for (int kc = 0; kc < kOneHotSteps; ++kc) {
        const int c = kc * 16 + 2 * t;
        tc::mma_bf16(s[nt], ra[kc], onehot_pair(c, ky, kxh),
                     onehot_pair(c + 8, ky, kxh));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (kbase + nt * 8 + 2 * t + b >= n) {
          s[nt][b] = -INFINITY;
          s[nt][2 + b] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][b]);
        mx1 = fmaxf(mx1, s[nt][2 + b]);
      }
  } else {
    const float* r0 = r_w + g * rs;
    const float* r1 = r_w + (g + 8) * rs;
    const float h0 = kRowChunk ? r0[kbase / tc::kChunk] : 0.f;
    const float h1 = kRowChunk ? r1[kbase / tc::kChunk] : 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int e = nt * 8 + 2 * t + b, j = kbase + e;
        if (j < n) {
          if constexpr (kRowChunk) {
            s[nt][b] = fmaf(s[nt][b], qscale, h0 + r0[kh + e]);
            s[nt][2 + b] = fmaf(s[nt][2 + b], qscale, h1 + r1[kh + e]);
          } else {
            const int ky = j / kw, kx = kh + j - ky * kw;
            s[nt][b] = fmaf(s[nt][b], qscale, r0[ky] + r0[kx]);
            s[nt][2 + b] = fmaf(s[nt][2 + b], qscale, r1[ky] + r1[kx]);
          }
        } else {
          s[nt][b] = -INFINITY;
          s[nt][2 + b] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][b]);
        mx1 = fmaxf(mx1, s[nt][2 + b]);
      }
  }
  // a row lives in the 4 lanes of a quad; the chunk's first key is valid,
  // so both maxima are finite
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float a0 = exp2f(st.m[0] - mx0), a1 = exp2f(st.m[1] - mx1);
  st.m[0] = mx0;
  st.m[1] = mx1;

  // P as bf16 pairs: p[nt][0] row g, p[nt][1] row g + 8, columns 2t, 2t + 1
  uint32_t p[kTiles][2];
  if constexpr (kVariant == kExpBf16) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      p[nt][0] = ex2_bf16x2(tc::pack_bf16(s[nt][0] - mx0, s[nt][1] - mx0));
      p[nt][1] = ex2_bf16x2(tc::pack_bf16(s[nt][2] - mx1, s[nt][3] - mx1));
    }
  } else {
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const float e0 = exp2f(s[nt][0] - mx0), e1 = exp2f(s[nt][1] - mx0);
      const float e2 = exp2f(s[nt][2] - mx1), e3 = exp2f(s[nt][3] - mx1);
      ls0 += e0 + e1;
      ls1 += e2 + e3;
      p[nt][0] = tc::pack_bf16(e0, e1);
      p[nt][1] = tc::pack_bf16(e2, e3);
    }
    st.l[0] = st.l[0] * a0 + ls0;
    st.l[1] = st.l[1] * a1 + ls1;
  }
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    st.o[dn][0] *= a0;
    st.o[dn][1] *= a0;
    st.o[dn][2] *= a1;
    st.o[dn][3] *= a1;
  }

  // P . V: ldmatrix.trans gives the B fragments (k = key, n = column) of
  // two 8-column tiles per call; lanes 0-7 / 8-15 / 16-23 / 24-31 address
  // the rows of keys +0-7 / +8-15 of column tile 2dp / 2dp + 1
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
  // kExpBf16: every column of P . ones is the row's sum of the rounded P
  float lsum[4] = {st.l[0] * a0, 0.f, st.l[1] * a1, 0.f};
#pragma unroll
  for (int kk = 0; kk < tc::kChunk / 16; ++kk) {
    const uint32_t pa[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                            p[2 * kk + 1][1]};
    if constexpr (kVariant == kExpBf16)
      tc::mma_bf16(lsum, pa, 0x3f803f80u, 0x3f803f80u);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, v_s + (kk * 16 + vrow) * kLd + dp * 16 + vcol);
      tc::mma_bf16(st.o[2 * dp], pa, b[0], b[1]);
      tc::mma_bf16(st.o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
  if constexpr (kVariant == kExpBf16) {
    st.l[0] = lsum[0];
    st.l[1] = lsum[2];
  }
}

// Normalizes and writes the warp's rows < n (bf16, row stride `stride`).
// kWholeSum: st.l already holds the whole row's sum in every lane.
template <int DH, bool kWholeSum>
__device__ __forceinline__ void end_rows(Rows<DH>& st, __nv_bfloat16* dst,
                                         long long stride, int row0, int n,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    if constexpr (!kWholeSum) {
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
    }
    const float inv = 1.f / l;
    const int qi = row0 + g + 8 * i;
    if (qi < n) {
      uint32_t* row = reinterpret_cast<uint32_t*>(dst + qi * stride);
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn)
        row[dn * 4 + t] = tc::pack_bf16(st.o[dn][2 * i] * inv,
                                        st.o[dn][2 * i + 1] * inv);
    }
  }
}

// Global blocks: one block per (image, head, 64-row query tile), four warps
// of 16 rows, keys walked in tiles of 64 through shared memory.
template <int DH, bool kRowChunk, int kVariant>
__global__ void __launch_bounds__(tc::kThreads)
    packed_global_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ r,
                            __nv_bfloat16* __restrict__ out, int n, int heads,
                            int kh, int kw, float qscale, Strides sq,
                            Strides sr, Strides so) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = DH + 8;
  const int rr = kh + kw;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + tc::kChunk * kLd;
  __nv_bfloat16* q_s = v_s + tc::kChunk * kLd;
  float* r_s = reinterpret_cast<float*>(q_s + tc::kWarps * tc::kRows * kLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* q_g = qkv + b * sq.b + h * sq.h;
  const __nv_bfloat16* k_g = q_g + heads * sq.h;
  const __nv_bfloat16* v_g = k_g + heads * sq.h;
  const int row0 = (blockIdx.x * tc::kWarps + warp) * tc::kRows;
  float* r_w = r_s + warp * tc::kRows * (rr + 1);

  Rows<DH> st;
  begin_rows<DH>(st, q_g, sq.t, row0, n, q_s + warp * tc::kRows * kLd, lane);
  tc::load_r(r + b * sr.b + h * sr.h, sr.t, row0, n, rr, r_w, lane);
  uint32_t ra[kOneHotSteps][4];
  if constexpr (kVariant == kBiasOneHot) r_fragments(ra, r_w, rr + 1, rr, lane);
  for (int k0 = 0; k0 < n; k0 += tc::kChunk) {
    __syncthreads();  // previous tile fully consumed
    copy_rows_async<DH>(k_g, sq.t, k0, tc::kChunk, n, k_s, tid, tc::kThreads);
    copy_rows_async<DH>(v_g, sq.t, k0, tc::kChunk, n, v_s, tid, tc::kThreads);
    tc::cp_async_wait();
    __syncthreads();
    chunk<DH, kRowChunk, kVariant>(st, k_s, v_s, r_w, rr + 1, ra, k0, n, kh,
                                   kw, qscale, lane);
  }
  end_rows<DH, kVariant == kExpBf16>(st, out + b * so.b + h * so.h, so.t,
                                     row0, n, lane);
}

template <int DH, bool kRowChunk, int kVariant>
cudaError_t launch_global_tc(const void* qkv, const void* r, void* out, int b,
                             int n, int heads, int kh, int kw, float qscale,
                             const Strides* s, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * tc::kChunk + tc::kWarps * tc::kRows) * (DH + 8) *
          sizeof(__nv_bfloat16) +
      (size_t)tc::kWarps * tc::kRows * (kh + kw + 1) * sizeof(float);
  auto kernel = packed_global_tc_kernel<DH, kRowChunk, kVariant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = tc::kWarps * tc::kRows;
  const dim3 grid((n + rows - 1) / rows, heads, b);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      n, heads, kh, kw, qscale, s[0], s[1], s[2]);
  return cudaGetLastError();
}

}  // namespace packed
}  // namespace relpos

// bf16 tensor-core step shared by the global and windowed rel-pos kernels.
//
// A warp owns 16 query rows. Their q rows sit in registers as mma.sync
// m16n8k16 A fragments; the keys come in chunks of 64 rows of a shared
// K / V tile (row-major, kLd bf16 per row). For each chunk the warp
//   1. computes S = q . k^T with 32 bf16 mma.sync (fp32 accumulators),
//   2. scales S, adds the factored bias rel_h[q, ky] + rel_w[q, kx] read
//      from the warp's fp32 r rows, and masks keys past n with -inf,
//   3. runs the online softmax in the log2 domain (exact running max,
//      rescaled fp32 output and per-thread partial row sums),
//   4. converts P to bf16 in registers - the accumulator layout of S is
//      the A-operand layout of P - and adds P . V with 32 more mma.sync,
//      reading V through ldmatrix.trans.
// The fragment layouts are PTX's for mma.m16n8k16 with .row.col operands:
// lane = 4 g + t holds rows g and g + 8 and columns 2t, 2t + 1 (+ 8).
#pragma once

#include <cstdint>

#include "relpos_common.cuh"

namespace relpos {
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;        // query rows per warp tile
constexpr int kChunk = 64;       // keys per softmax step
constexpr int kLd = kDh + 8;     // bf16 row stride of q / K / V tiles:
                                 // 144 B keeps fragment loads conflict-free
constexpr int kSteps = kDh / 16; // k-steps of q . k^T
constexpr int kTileElems = kChunk * kLd;  // one 64-row tile in shared memory

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Asynchronous copies from device to shared memory (cp.async): a thread
// starts all its copies before it waits, so a tile costs one trip to L2 and
// not one per 16 bytes. With src_bytes = 0 the destination is zero-filled
// and the source is not read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes));
}

// Waits for every copy this thread has started; a barrier (__syncthreads or
// __syncwarp) then makes them visible to the other threads.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of `rows` rows of bf16 (64 wide, row stride `stride`
// elements, first row `row0`, rows >= n zero) into a kLd-strided shared
// tile; cp_async_wait() completes it.
__device__ __forceinline__ void copy_rows_async(const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int rows, int n,
                                                __nv_bfloat16* dst, int tid,
                                                int nthreads) {
  for (int i = tid; i < rows * (kDh / 8); i += nthreads) {
    const int row = i >> 3, c8 = i & 7, gi = row0 + row;
    const bool valid = gi < n;
    cp_async_16(dst + row * kLd + c8 * 8,
                valid ? src + gi * stride + c8 * 8 : src, valid);
  }
}

__device__ __forceinline__ void copy_rows(const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows, int n,
                                          __nv_bfloat16* dst, int tid,
                                          int nthreads) {
  copy_rows_async(src, stride, row0, rows, n, dst, tid, nthreads);
  cp_async_wait();
}

// Per-warp running state of 16 query rows.
struct Rows {
  uint32_t qa[kSteps][4];  // q as A fragments
  float m[2];              // running max of rows g, g + 8 (log2 domain)
  float l[2];              // this thread's partial row sums
  float o[kDh / 8][4];     // output accumulators, 8 column tiles
};

// Stages the warp's q rows (row0 .. row0 + 15 of the sequence, via the
// per-warp shared slice q_w) into A fragments and resets the state.
__device__ __forceinline__ void begin_rows(Rows& st,
                                           const __nv_bfloat16* q_src,
                                           long long stride, int row0, int n,
                                           __nv_bfloat16* q_w, int lane) {
  copy_rows(q_src, stride, row0, kRows, n, q_w, lane, 32);
  __syncwarp();
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_w);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    st.qa[ks][0] = q32[g * (kLd / 2) + ks * 8 + t];
    st.qa[ks][1] = q32[(g + 8) * (kLd / 2) + ks * 8 + t];
    st.qa[ks][2] = q32[g * (kLd / 2) + ks * 8 + 4 + t];
    st.qa[ks][3] = q32[(g + 8) * (kLd / 2) + ks * 8 + 4 + t];
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[dn][e] = 0.f;
}

// The second half of a chunk, shared with the int8 score path
// (relpos_global_int8.cu): s holds the chunk's scores in the log2 domain,
// biased and masked, mx0 / mx1 their maxima over this thread's columns and
// the running max. Runs the online softmax and adds P . V.
__device__ __forceinline__ void softmax_pv(Rows& st, float (&s)[kChunk / 8][4],
                                           float mx0, float mx1,
                                           const __nv_bfloat16* v_s,
                                           int lane) {
  // a row lives in the 4 lanes of a quad; the chunk's first key is valid,
  // so both maxima are finite
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float a0 = exp2f(st.m[0] - mx0), a1 = exp2f(st.m[1] - mx1);
  st.m[0] = mx0;
  st.m[1] = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - mx0);
    s[nt][1] = exp2f(s[nt][1] - mx0);
    s[nt][2] = exp2f(s[nt][2] - mx1);
    s[nt][3] = exp2f(s[nt][3] - mx1);
    ls0 += s[nt][0] + s[nt][1];
    ls1 += s[nt][2] + s[nt][3];
  }
  st.l[0] = st.l[0] * a0 + ls0;
  st.l[1] = st.l[1] * a1 + ls1;
#pragma unroll
  for (int dn = 0; dn < kDh / 8; ++dn) {
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
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kDh / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (kk * 16 + vrow) * kLd + dp * 16 + vcol);
      mma_bf16(st.o[2 * dp], pa, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// One chunk of 64 keys: k_s / v_s point at the chunk's first key row,
// kbase is that key's index in the sequence, r_w the warp's 16 fp32 r
// rows (row stride rs), r = [rel_h (kh) | rel_w (kw)] x log2(e).
// kRowChunk: kw == kChunk, so the chunk is one row ky of the key grid and
// key e of the chunk has kx = e: the bias needs no division.
template <bool kRowChunk>
__device__ __forceinline__ void chunk(Rows& st, const __nv_bfloat16* k_s,
                                      const __nv_bfloat16* v_s,
                                      const float* r_w, int rs, int kbase,
                                      int n, int kh, int kw, float qscale,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[kChunk / 8][4];
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k_s);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const uint32_t* row = k32 + (nt * 8 + g) * (kLd / 2) + ks * 8 + t;
      mma_bf16(s[nt], st.qa[ks], row[0], row[4]);
    }

  const float* r0 = r_w + g * rs;
  const float* r1 = r_w + (g + 8) * rs;
  float mx0 = st.m[0], mx1 = st.m[1];
  const float h0 = kRowChunk ? r0[kbase / kChunk] : 0.f;
  const float h1 = kRowChunk ? r1[kbase / kChunk] : 0.f;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt)
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
  softmax_pv(st, s, mx0, mx1, v_s, lane);
}

// Normalizes and writes the warp's rows < n (bf16, row stride `stride`);
// where lse is not null it also receives each row's log-sum-exp (log2
// domain), which the backward kernels read.
__device__ __forceinline__ void end_rows(Rows& st, __nv_bfloat16* dst,
                                         long long stride, int row0, int n,
                                         int lane, float* lse) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int qi = row0 + g + 8 * i;
    if (qi < n) {
      uint32_t* row = reinterpret_cast<uint32_t*>(dst + qi * stride);
#pragma unroll
      for (int dn = 0; dn < kDh / 8; ++dn)
        row[dn * 4 + t] = pack_bf16(st.o[dn][2 * i] * inv,
                                    st.o[dn][2 * i + 1] * inv);
      if (lse != nullptr && t == 0) lse[qi] = st.m[i] + log2f(l);
    }
  }
}

// Loads the warp's 16 r rows (bf16, row stride `stride`) as fp32 with row
// stride rr + 1; rows >= n are zero.
__device__ __forceinline__ void load_r(const __nv_bfloat16* src,
                                       long long stride, int row0, int n,
                                       int rr, float* r_w, int lane) {
  for (int i = lane; i < kRows * rr; i += 32) {
    const int row = i / rr, j = i - row * rr, qi = row0 + row;
    r_w[row * (rr + 1) + j] =
        qi < n ? __bfloat162float(src[qi * stride + j]) : 0.f;
  }
  __syncwarp();
}

}  // namespace tc
}  // namespace relpos

// The attention half of a windowed ViT block in one launch (K8).
//
// Replaces the TPU kernel labelanything_tpu/ops/fused_window.py:
// fused_window_attention -> _fused_window_impl (Pallas body
// _fused_window_kernel).
//
// out[p] = x[p] + b_proj + W_proj . concat_h softmax_j(q_h[p] . k_h[j] * scale
//          + rel_h[p, ky(j)] + rel_w[p, kx(j)]) v_h[j]
// for every position p of a map padded to windows of ws x ws, the keys j
// being the positions of p's window. The operands lie as the model has
// them: x and out (B, Hp, Wp, C), the qkv projection (B, Hp, Wp, 3C) with
// channels (3, heads, dh), the factored bias r (B, heads, Hp, Wp, 2 ws) by
// strides (batch, head, position), pre-multiplied by log2(e), and
// W_proj (C_out, C_in) as nn.Linear keeps it.
//
// One block per (window, query tile). The block reads its window's q, k,
// v and bias rows straight from the spatial maps by index - a window's
// token i = (y, x) is the map's position (wy ws + y, wx ws + x) - so no
// partitioned copy exists. For each head in turn it runs the rel-pos
// attention of its query rows against the window's keys, walked in chunks
// of 64 through shared memory with an exact online softmax, and writes the
// normalized head output into a shared tile of the query rows' joined
// heads (rows x C). The TPU kernel's Cauchy-Schwarz shift on the
// concatenated operands [q | r] . [k | E] is not carried over: it can lie
// far above the scores and underflow every exponential (ROADMAP C7).
// Then the block multiplies that tile by W_proj^T in its own body, a
// column block of 64 outputs at a time with W streamed in 64-wide k-chunks,
// adds the bias and the residual and writes the output rows to their map
// positions. Pad positions are computed and written like the others; the
// caller crops them.
//
// * bf16: fused_window_tc_kernel<DH>, four warps of 16 query rows (64-row
//   tiles). The attention is relpos_packed.cuh's warp step (mma.sync
//   m16n8k16, exact running max in the log2 domain, P's accumulators reused
//   as A fragments); the projection is mma.sync too, A fragments from the
//   joined-heads tile (row stride C + 8: conflict-free), B fragments from
//   W's chunk, double-buffered by cp.async. Shared memory: the tile, 64 x
//   (C + 8) bf16 (ViT-H's 1280: 165 KB), and one region that holds the
//   attention's K / V chunk, q rows and bias rows, then W's two chunks
//   (ViT-H in all: 207 KB of the 227 KB a block may have).
// * fp32: fused_window_kernel<DH> on the CUDA cores, eight warps of four
//   query rows (32-row tiles, the fp32 tile of ViT-H's 1280 channels being
//   164 KB); lane l owns the keys l, l + 32 of a chunk for the scores and
//   the output columns l + 32 i for P . V and for the projection (W's chunk
//   held transposed).
//
// Bound (ViT-B, one 1024-px image: 25 windows of 196 tokens, C 768, 12
// heads): about 8.7 GFLOP, 5.8 of them the projection, against about 41 MB
// moved (qkv, x, out, r, W): set by the bytes on this card. What holds the
// kernel above it: the 256 / 196 padding of the query tiles, each query
// tile re-reading its window's K and V per head from L2, one block an SM
// at ViT-H's shared memory, and mma.sync rather than wgmma.
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"
#include "relpos_packed.cuh"

namespace fused_window {

using relpos::kWarps;
using relpos::warp_max;
using relpos::warp_sum;
namespace tc = relpos::tc;
namespace packed = relpos::packed;

constexpr int kTcRows = tc::kWarps * tc::kRows;  // 64 query rows (bf16)
constexpr int kNCols = 64;     // output columns a projection pass
constexpr int kKChunk = 64;    // input channels a W chunk
constexpr int kWLd = kKChunk + 8;  // bf16 row of a W chunk
constexpr int kF32Rows = 32;   // query rows (fp32)
constexpr int kF32RowsWarp = kF32Rows / kWarps;  // 4
constexpr int kKeys = 64;      // keys a chunk (fp32)
constexpr int kLdk = kKeys + 1;

// element strides of r: batch, head, position
struct RStrides {
  long long b, h, p;
};

// The map geometry of one block's window.
struct Window {
  long long pos0;  // map position (row-major over B, Hp, Wp) of the origin
  int wp, ws, n;   // map width, window size, tokens

  __device__ __forceinline__ long long pos(int i) const {
    const int y = i / ws;
    return pos0 + (long long)y * wp + (i - y * ws);
  }
};

__device__ __forceinline__ Window window_of(int w, int hp, int wp, int ws) {
  const int nwx = wp / ws, nwy = hp / ws;
  const int b = w / (nwy * nwx), rem = w - b * (nwy * nwx);
  const int wy = rem / nwx, wx = rem - wy * nwx;
  Window win;
  win.pos0 = ((long long)b * hp + wy * ws) * wp + wx * ws;
  win.wp = wp;
  win.ws = ws;
  win.n = ws * ws;
  return win;
}

// ---------------------------------------------------------------- bf16

// Starts the copy of `rows` window tokens from row0 (DH bf16 each, channel
// offset already in `src`, a map position's row `row_len` elements; tokens
// >= n zero) into a (DH + 8)-strided shared tile.
template <int DH>
__device__ __forceinline__ void copy_tokens_async(const __nv_bfloat16* src,
                                                  long long row_len,
                                                  const Window& win, int row0,
                                                  int rows,
                                                  __nv_bfloat16* dst, int tid,
                                                  int nthreads) {
  constexpr int kVec = DH / 8;  // 16-byte pieces a row
  for (int i = tid; i < rows * kVec; i += nthreads) {
    const int row = i / kVec, c8 = i - row * kVec, gi = row0 + row;
    const bool valid = gi < win.n;
    tc::cp_async_16(dst + row * (DH + 8) + c8 * 8,
                    valid ? src + win.pos(gi) * row_len + c8 * 8 : src, valid);
  }
}

// The warp's 16 bias rows of one head (rr = 2 ws values, position stride
// rs_p) as fp32 with row stride rr + 1; tokens >= n zero.
__device__ __forceinline__ void load_bias_rows(const __nv_bfloat16* src,
                                               long long rs_p,
                                               const Window& win, int row0,
                                               int rows, int rr, float* r_w,
                                               int lane) {
  for (int i = lane; i < rows * rr; i += 32) {
    const int row = i / rr, j = i - row * rr, gi = row0 + row;
    r_w[row * (rr + 1) + j] =
        gi < win.n ? __bfloat162float(src[win.pos(gi) * rs_p + j]) : 0.f;
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of W[n0 .. n0 + 63][k0 .. k0 + 63] (row stride c) into a
// kWLd-strided shared chunk.
__device__ __forceinline__ void copy_w_async(const __nv_bfloat16* w, int c,
                                             int n0, int k0,
                                             __nv_bfloat16* dst, int tid) {
  for (int i = tid; i < kNCols * (kKChunk / 8); i += tc::kThreads) {
    const int row = i >> 3, c8 = i & 7;
    tc::cp_async_16(dst + row * kWLd + c8 * 8,
                    w + (long long)(n0 + row) * c + k0 + c8 * 8, true);
  }
}

template <int DH>
__host__ __device__ inline size_t tc_region_bytes(int rr) {
  const size_t attn =
      (size_t)(2 * tc::kChunk + kTcRows) * (DH + 8) * sizeof(__nv_bfloat16) +
      (size_t)kTcRows * (rr + 1) * sizeof(float);
  const size_t proj = (size_t)2 * kNCols * kWLd * sizeof(__nv_bfloat16);
  return attn > proj ? attn : proj;
}

template <int DH>
__global__ void __launch_bounds__(tc::kThreads)
    fused_window_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ qkv,
                           const __nv_bfloat16* __restrict__ r,
                           const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int hp, int wp,
                           int heads, int ws, float qscale, RStrides rs) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = DH + 8;
  const int c = heads * DH;
  const int ldc = c + 8;
  const int rr = 2 * ws;
  __nv_bfloat16* att_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* region = att_s + kTcRows * ldc;
  __nv_bfloat16* k_s = region;
  __nv_bfloat16* v_s = k_s + tc::kChunk * kLd;
  __nv_bfloat16* q_s = v_s + tc::kChunk * kLd;
  float* r_s = reinterpret_cast<float*>(q_s + kTcRows * kLd);
  __nv_bfloat16* w_s = region;  // the projection's two W chunks

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Window win = window_of(blockIdx.y, hp, wp, ws);
  const int q0 = blockIdx.x * kTcRows;
  const int rows_valid = min(kTcRows, win.n - q0);
  const int row0 = q0 + warp * tc::kRows;  // the warp's first token
  const long long row_len = 3LL * c;
  __nv_bfloat16* q_w = q_s + warp * tc::kRows * kLd;
  float* r_w = r_s + warp * tc::kRows * (rr + 1);
  const long long batch = win.pos0 / ((long long)hp * wp);
  uint32_t ra[packed::kOneHotSteps][4] = {};  // read by the one-hot variant
  // the window within its image, for r's per-image position index
  const Window win_img{win.pos0 - batch * hp * wp, wp, ws, win.n};

  for (int h = 0; h < heads; ++h) {
    const __nv_bfloat16* q_g = qkv + h * DH;
    packed::Rows<DH> st;
    // the warp's q rows as A fragments (packed::begin_rows, gathered)
    copy_tokens_async<DH>(q_g, row_len, win, row0, tc::kRows, q_w, lane, 32);
    tc::cp_async_wait();
    __syncwarp();
    {
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_w);
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        st.qa[ks][0] = q32[g * (kLd / 2) + ks * 8 + t];
        st.qa[ks][1] = q32[(g + 8) * (kLd / 2) + ks * 8 + t];
        st.qa[ks][2] = q32[g * (kLd / 2) + ks * 8 + 4 + t];
        st.qa[ks][3] = q32[(g + 8) * (kLd / 2) + ks * 8 + 4 + t];
      }
    }
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[dn][e] = 0.f;
    load_bias_rows(r + batch * rs.b + h * rs.h, rs.p, win_img, row0,
                   tc::kRows, rr, r_w, lane);

    for (int k0 = 0; k0 < win.n; k0 += tc::kChunk) {
      __syncthreads();  // previous chunk fully consumed
      copy_tokens_async<DH>(q_g + c, row_len, win, k0, tc::kChunk, k_s, tid,
                            tc::kThreads);
      copy_tokens_async<DH>(q_g + 2 * c, row_len, win, k0, tc::kChunk, v_s,
                            tid, tc::kThreads);
      tc::cp_async_wait();
      __syncthreads();
      packed::chunk<DH, false, packed::kBiasFromRow>(
          st, k_s, v_s, r_w, rr + 1, ra, k0, win.n, ws, ws, qscale, lane);
    }
    // this head's normalized output into the joined-heads tile
    packed::end_rows<DH, false>(st, att_s + h * DH, ldc, warp * tc::kRows,
                                rows_valid, lane);
  }
  __syncthreads();  // the tile is whole; the region is free for W

  // projection: out rows = tile . W^T + bias + x, 64 output columns a pass
  const int kchunks = c / kKChunk;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(att_s);
  for (int n0 = 0; n0 < c; n0 += kNCols) {
    float acc[kNCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kNCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    copy_w_async(w, c, n0, 0, w_s, tid);
    cp_async_commit();
    for (int kc = 0; kc < kchunks; ++kc) {
      __nv_bfloat16* cur = w_s + (kc & 1) * kNCols * kWLd;
      if (kc + 1 < kchunks) {
        copy_w_async(w, c, n0, (kc + 1) * kKChunk,
                     w_s + ((kc + 1) & 1) * kNCols * kWLd, tid);
        cp_async_commit();
        cp_async_wait_pending<1>();
      } else {
        cp_async_wait_pending<0>();
      }
      __syncthreads();
      const uint32_t* w32 = reinterpret_cast<const uint32_t*>(cur);
#pragma unroll
      for (int ks = 0; ks < kKChunk / 16; ++ks) {
        const int col = (kc * kKChunk + ks * 16) / 2;  // word column
        const uint32_t* ar = a32 + (warp * tc::kRows + g) * (ldc / 2) + col + t;
        const uint32_t a[4] = {ar[0], ar[8 * (ldc / 2)], ar[4],
                               ar[8 * (ldc / 2) + 4]};
#pragma unroll
        for (int nt = 0; nt < kNCols / 8; ++nt) {
          const uint32_t* br = w32 + (nt * 8 + g) * (kWLd / 2) + ks * 8 + t;
          tc::mma_bf16(acc[nt], a, br[0], br[4]);
        }
      }
      __syncthreads();  // this chunk consumed before it is overwritten
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int li = warp * tc::kRows + g + 8 * i;
      if (li < rows_valid) {
        const long long p = win.pos(q0 + li);
        const __nv_bfloat162* xr =
            reinterpret_cast<const __nv_bfloat162*>(x + p * c + n0);
        __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out + p * c + n0);
        const __nv_bfloat162* br =
            reinterpret_cast<const __nv_bfloat162*>(bias + n0);
#pragma unroll
        for (int nt = 0; nt < kNCols / 8; ++nt) {
          const int e = nt * 4 + t;  // pair index: columns 2e, 2e + 1
          const __nv_bfloat162 xv = xr[e], bv = br[e];
          orow[e] = __floats2bfloat162_rn(
              acc[nt][2 * i] + __bfloat162float(bv.x) + __bfloat162float(xv.x),
              acc[nt][2 * i + 1] + __bfloat162float(bv.y) +
                  __bfloat162float(xv.y));
        }
      }
    }
  }
}

template <int DH>
cudaError_t launch_tc(const void* x, const void* qkv, const void* r,
                      const void* w, const void* bias, void* out, int b,
                      int hp, int wp, int heads, int ws, float qscale,
                      RStrides rs, cudaStream_t stream) {
  const int c = heads * DH;
  const size_t smem = (size_t)kTcRows * (c + 8) * sizeof(__nv_bfloat16) +
                      tc_region_bytes<DH>(2 * ws);
  auto kernel = fused_window_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ws * ws + kTcRows - 1) / kTcRows,
                  b * (hp / ws) * (wp / ws));
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), hp, wp, heads, ws, qscale, rs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32

template <int DH>
__host__ __device__ inline size_t f32_region_floats(int rr) {
  const size_t attn = (size_t)kF32Rows * DH     // q rows (pre-scaled)
                      + (size_t)DH * kLdk       // K^T chunk
                      + (size_t)kKeys * DH      // V chunk
                      + (size_t)kF32Rows * kKeys  // P
                      + (size_t)kF32Rows * rr;  // bias rows
  const size_t proj = (size_t)kKChunk * kLdk;   // W chunk, transposed
  return attn > proj ? attn : proj;
}

template <int DH>
__global__ void __launch_bounds__(relpos::kThreads)
    fused_window_kernel(const float* __restrict__ x,
                        const float* __restrict__ qkv,
                        const float* __restrict__ r,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int hp, int wp, int heads,
                        int ws, float qscale, RStrides rs) {
  constexpr int kCols = (DH + 31) / 32;  // output columns a lane
  extern __shared__ float4 smem4[];
  const int c = heads * DH;
  const int rr = 2 * ws;
  float* att_s = reinterpret_cast<float*>(smem4);  // [row][c]
  float* region = att_s + kF32Rows * c;
  float* q_s = region;
  float* kt_s = q_s + kF32Rows * DH;
  float* v_s = kt_s + DH * kLdk;
  float* p_s = v_s + kKeys * DH;
  float* r_s = p_s + kF32Rows * kKeys;
  float* wt_s = region;  // the projection's W chunk, [k][n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Window win = window_of(blockIdx.y, hp, wp, ws);
  const int q0 = blockIdx.x * kF32Rows;
  const long long row_len = 3LL * c;
  const long long batch = win.pos0 / ((long long)hp * wp);
  const Window win_img{win.pos0 - batch * hp * wp, wp, ws, win.n};
  const float* q_w = q_s + warp * kF32RowsWarp * DH;
  const float* r_w = r_s + warp * kF32RowsWarp * rr;
  float* p_w = p_s + warp * kF32RowsWarp * kKeys;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // previous head done with q_s / r_s
    for (int idx = tid; idx < kF32Rows * DH; idx += relpos::kThreads) {
      const int i = idx / DH, d = idx - i * DH, qi = q0 + i;
      q_s[idx] = qi < win.n ? qkv[win.pos(qi) * row_len + h * DH + d] * qscale
                            : 0.f;
    }
    const float* rh = r + batch * rs.b + h * rs.h;
    for (int idx = tid; idx < kF32Rows * rr; idx += relpos::kThreads) {
      const int i = idx / rr, j = idx - i * rr, qi = q0 + i;
      r_s[idx] = qi < win.n ? rh[win_img.pos(qi) * rs.p + j] : 0.f;
    }
    float m[kF32RowsWarp], l[kF32RowsWarp], o[kF32RowsWarp][kCols];
#pragma unroll
    for (int i = 0; i < kF32RowsWarp; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) o[i][cc] = 0.f;
    }

    for (int k0 = 0; k0 < win.n; k0 += kKeys) {
      __syncthreads();  // previous chunk consumed; q_s / r_s written
      for (int idx = tid; idx < kKeys * DH; idx += relpos::kThreads) {
        const int j = idx / DH, d = idx - j * DH, kj = k0 + j;
        float kv = 0.f, vv = 0.f;
        if (kj < win.n) {
          const float* row = qkv + win.pos(kj) * row_len + h * DH + d;
          kv = row[c];
          vv = row[2 * c];
        }
        kt_s[d * kLdk + j] = kv;
        v_s[j * DH + d] = vv;
      }
      __syncthreads();

      float s0[kF32RowsWarp], s1[kF32RowsWarp];
#pragma unroll
      for (int i = 0; i < kF32RowsWarp; ++i) {
        s0[i] = 0.f;
        s1[i] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float a0 = kt_s[(d + 0) * kLdk + lane];
        const float a1 = kt_s[(d + 1) * kLdk + lane];
        const float a2 = kt_s[(d + 2) * kLdk + lane];
        const float a3 = kt_s[(d + 3) * kLdk + lane];
        const float b0 = kt_s[(d + 0) * kLdk + lane + 32];
        const float b1 = kt_s[(d + 1) * kLdk + lane + 32];
        const float b2 = kt_s[(d + 2) * kLdk + lane + 32];
        const float b3 = kt_s[(d + 3) * kLdk + lane + 32];
#pragma unroll
        for (int i = 0; i < kF32RowsWarp; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(q_w + i * DH + d);
          s0[i] = fmaf(qv.x, a0, fmaf(qv.y, a1, fmaf(qv.z, a2, fmaf(qv.w, a3, s0[i]))));
          s1[i] = fmaf(qv.x, b0, fmaf(qv.y, b1, fmaf(qv.z, b2, fmaf(qv.w, b3, s1[i]))));
        }
      }

      const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
      const bool ok0 = kj0 < win.n, ok1 = kj1 < win.n;
      const int ky0 = kj0 / ws, kx0 = kj0 - ky0 * ws;
      const int ky1 = kj1 / ws, kx1 = kj1 - ky1 * ws;
#pragma unroll
      for (int i = 0; i < kF32RowsWarp; ++i) {
        const float* rrow = r_w + i * rr;
        const float a = ok0 ? s0[i] + rrow[ky0] + rrow[ws + kx0] : -INFINITY;
        const float bb = ok1 ? s1[i] + rrow[ky1] + rrow[ws + kx1] : -INFINITY;
        // key k0 < n is always valid, so the chunk max is finite
        const float m_new = fmaxf(m[i], warp_max(fmaxf(a, bb)));
        const float alpha = exp2f(m[i] - m_new);
        const float pa = exp2f(a - m_new);
        const float pb = exp2f(bb - m_new);
        l[i] = l[i] * alpha + warp_sum(pa + pb);
        m[i] = m_new;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) o[i][cc] *= alpha;
        p_w[i * kKeys + lane] = pa;
        p_w[i * kKeys + lane + 32] = pb;
      }
      __syncwarp();

#pragma unroll 2
      for (int j = 0; j < kKeys; j += 4) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int d = lane + 32 * cc;
          if (d < DH) {
            const float v0 = v_s[(j + 0) * DH + d];
            const float v1 = v_s[(j + 1) * DH + d];
            const float v2 = v_s[(j + 2) * DH + d];
            const float v3 = v_s[(j + 3) * DH + d];
#pragma unroll
            for (int i = 0; i < kF32RowsWarp; ++i) {
              const float4 pv =
                  *reinterpret_cast<const float4*>(p_w + i * kKeys + j);
              o[i][cc] = fmaf(pv.x, v0, fmaf(pv.y, v1, fmaf(pv.z, v2,
                              fmaf(pv.w, v3, o[i][cc]))));
            }
          }
        }
      }
    }
    // this head's normalized output into the joined-heads tile
#pragma unroll
    for (int i = 0; i < kF32RowsWarp; ++i) {
      const float inv = 1.f / l[i];
      float* arow = att_s + (warp * kF32RowsWarp + i) * c + h * DH;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = lane + 32 * cc;
        if (d < DH) arow[d] = o[i][cc] * inv;
      }
    }
  }

  // projection: 64 output columns a pass, lane l owns n0 + l and n0 + l + 32
  for (int n0 = 0; n0 < c; n0 += kNCols) {
    float acc[kF32RowsWarp][2];
#pragma unroll
    for (int i = 0; i < kF32RowsWarp; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k0 = 0; k0 < c; k0 += kKChunk) {
      __syncthreads();  // the tile is whole / the previous chunk consumed
      for (int idx = tid; idx < kNCols * kKChunk; idx += relpos::kThreads) {
        const int nn = idx / kKChunk, kk = idx - nn * kKChunk;
        wt_s[kk * kLdk + nn] = w[(long long)(n0 + nn) * c + k0 + kk];
      }
      __syncthreads();
      const float* a_w = att_s + warp * kF32RowsWarp * c + k0;
#pragma unroll 4
      for (int k = 0; k < kKChunk; k += 4) {
        float b0[4], b1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          b0[e] = wt_s[(k + e) * kLdk + lane];
          b1[e] = wt_s[(k + e) * kLdk + lane + 32];
        }
#pragma unroll
        for (int i = 0; i < kF32RowsWarp; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(a_w + i * c + k);
          acc[i][0] = fmaf(av.x, b0[0], fmaf(av.y, b0[1], fmaf(av.z, b0[2],
                           fmaf(av.w, b0[3], acc[i][0]))));
          acc[i][1] = fmaf(av.x, b1[0], fmaf(av.y, b1[1], fmaf(av.z, b1[2],
                           fmaf(av.w, b1[3], acc[i][1]))));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kF32RowsWarp; ++i) {
      const int qi = q0 + warp * kF32RowsWarp + i;
      if (qi < win.n) {
        const long long p = win.pos(qi) * c + n0;
        out[p + lane] = acc[i][0] + bias[n0 + lane] + x[p + lane];
        out[p + lane + 32] = acc[i][1] + bias[n0 + lane + 32] + x[p + lane + 32];
      }
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* x, const void* qkv, const void* r,
                       const void* w, const void* bias, void* out, int b,
                       int hp, int wp, int heads, int ws, float qscale,
                       RStrides rs, cudaStream_t stream) {
  const int c = heads * DH;
  const size_t smem =
      ((size_t)kF32Rows * c + f32_region_floats<DH>(2 * ws)) * sizeof(float);
  auto kernel = fused_window_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ws * ws + kF32Rows - 1) / kF32Rows,
                  b * (hp / ws) * (wp / ws));
  kernel<<<grid, relpos::kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(qkv),
      static_cast<const float*>(r), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), hp, wp,
      heads, ws, qscale, rs);
  return cudaGetLastError();
}

}  // namespace fused_window

// x, out (b, hp, wp, heads * dh), qkv (b, hp, wp, 3 heads dh), w_proj
// (C, C), b_proj (C) contiguous, 16-byte aligned, one dtype (0 = fp32,
// 1 = bf16); r (b, heads, hp, wp, 2 ws) by element strides r_strides =
// (batch, head, position), its last axis contiguous. dh is 64 or 80, C a
// multiple of 64 up to 1280, ws * ws <= 256, hp and wp multiples of ws.
// qscale is scale * log2(e).
extern "C" int la_fused_window(const void* x, const void* qkv, const void* r,
                               const void* w_proj, const void* b_proj,
                               void* out, int b, int hp, int wp, int heads,
                               int dh, int ws, float qscale, int is_bf16,
                               const long long* r_strides, void* stream) {
  const int c = heads * dh;
  if ((dh != 64 && dh != 80) || c % 64 || c > 1280 || ws * ws > 256 ||
      ws < 1 || hp % ws || wp % ws)
    return (int)cudaErrorInvalidValue;
  const fused_window::RStrides rs{r_strides[0], r_strides[1], r_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = dh == 64 ? fused_window::launch_tc<64>(x, qkv, r, w_proj, b_proj,
                                                 out, b, hp, wp, heads, ws,
                                                 qscale, rs, s)
                   : fused_window::launch_tc<80>(x, qkv, r, w_proj, b_proj,
                                                 out, b, hp, wp, heads, ws,
                                                 qscale, rs, s);
  else
    err = dh == 64 ? fused_window::launch_f32<64>(x, qkv, r, w_proj, b_proj,
                                                  out, b, hp, wp, heads, ws,
                                                  qscale, rs, s)
                   : fused_window::launch_f32<80>(x, qkv, r, w_proj, b_proj,
                                                  out, b, hp, wp, heads, ws,
                                                  qscale, rs, s);
  return (int)err;
}

// Plain flash attention, out = softmax(q . k^T * scale) . v, per (batch,
// head), over any query and key lengths: heads 128 or 256 wide in bf16, and
// every head width in fp32. Heads 32 or 64 wide in bf16 (the affinity
// decoder's AffinityTransformer: queries the query image's 64 x 64 map,
// keys and values every support image's map, heads 32 wide) take the
// Hopper kernel of flash_wgmma.cu.
//
// Replaces the TPU kernel of labelanything_tpu/ops/flash_attention.py:
// flash_attention -> _run_flash (Pallas bodies _attn_kernel and
// _attn_kernel_batched), which ops/attention.py's dot_product_attention
// takes for unbiased attention with both lengths >= 1024 and 128-aligned
// and a head width of 32, 64, 128 or 256.
//
// The TPU kernel's devices are not carried over: its Cauchy-Schwarz bound
// on the row maximum (_shift_bound) becomes an exact running maximum in the
// log2 domain (online softmax); its ones column appended to v (_augment_v)
// becomes row sums kept in registers; its whole K and V resident in VMEM
// become 64-key tiles streamed through shared memory. One kernel covers both
// TPU bodies: the last query tile and the last key tile may be ragged (rows
// past the length are zero-filled on load, keys past it masked with -inf,
// rows past it not written). Every operand is read and the output written
// by its batch, head and token strides (last axis contiguous), so the
// attention's head-split views of the projections need no copy.
//
// * bf16 (flash_tc_kernel, dh 128 and 256): tensor cores by mma.sync
//   m16n8k16 with fp32 accumulators and fp32 softmax state. One block of 4
//   warps takes 64 query rows of one (batch, head), 16 rows a warp as A
//   fragments; K and V come in 64-key tiles, double-buffered by cp.async so
//   the next tile loads while this one is used. Per key a row does 4 dh
//   flops in the two products and one exponential, which bounds the work
//   by operations, not bytes (about 4 dh / 2 flops a byte even at one pass
//   over K and V per query tile). At dh 128 a warp's q
//   fragments stay in registers; at dh = 256 they are read from shared
//   memory at each tile, which keeps the 128 output accumulators a thread
//   within the register file.
// * fp32 (flash_fp32_kernel): CUDA cores, for parity runs only. One block
//   of 8 warps per 64 query rows walks the keys in tiles of 64 (K
//   transposed, V row-major in shared memory); warp w owns rows 8w..8w+7,
//   lane l the keys l and l + 32 of a tile and the output columns l + 32 c.
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"

namespace flash {

// element strides of one operand: batch, head, token; the last axis is
// contiguous
struct Strides {
  long long b, h, t;
};

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRows = 16;                  // query rows a warp (bf16)
constexpr int kQTile = kTcWarps * kRows;   // query rows a block
constexpr int kKTile = 64;                 // keys a tile

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of 64 rows of DH bf16 (row stride `stride` elements,
// first row `row0`, rows >= n zero) into a (DH + 8)-strided shared tile.
template <int DH>
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* src,
                                          long long stride, int row0, int n,
                                          __nv_bfloat16* dst, int tid) {
  constexpr int kVec = DH / 8;  // 16-byte pieces a row
  for (int i = tid; i < kKTile * kVec; i += kTcThreads) {
    const int row = i / kVec, c8 = i - row * kVec, gi = row0 + row;
    const bool valid = gi < n;
    relpos::tc::cp_async_16(dst + row * (DH + 8) + c8 * 8,
                            valid ? src + gi * stride + c8 * 8 : src, valid);
  }
}

// q rows as A fragments (16 rows of the warp's shared slice, word stride
// kLdw, k-step ks)
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const uint32_t* q32, int kLdw,
                                           int ks, int g, int t) {
  a[0] = q32[g * kLdw + ks * 8 + t];
  a[1] = q32[(g + 8) * kLdw + ks * 8 + t];
  a[2] = q32[g * kLdw + ks * 8 + 4 + t];
  a[3] = q32[(g + 8) * kLdw + ks * 8 + 4 + t];
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int nq, int nk,
                    float qscale, Strides sq, Strides sk, Strides sv,
                    Strides so) {
  constexpr int kLd = DH + 8, kLdw = kLd / 2, kTiles = kKTile / 8;
  constexpr int kSteps = DH / 16;
  constexpr bool kQInRegs = DH <= 128;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  // two stages of (K tile, V tile)
  __nv_bfloat16* kv_s = q_s + kQTile * kLd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile;
  const __nv_bfloat16* q_g = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* k_g = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* v_g = v + b * sv.b + h * sv.h;

  copy_tile<DH>(q_g, sq.t, q0, nq, q_s, tid);
  copy_tile<DH>(k_g, sk.t, 0, nk, kv_s, tid);
  copy_tile<DH>(v_g, sv.t, 0, nk, kv_s + kKTile * kLd, tid);
  commit();

  const uint32_t* q32 =
      reinterpret_cast<const uint32_t*>(q_s + warp * kRows * kLd);
  uint32_t qa[kQInRegs ? kSteps : 1][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
  float o[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  // P . V: ldmatrix.trans gives the B fragments (k = key, n = column) of
  // two 8-column tiles per call; lanes 0-7 / 8-15 / 16-23 / 24-31 address
  // the rows of keys +0-7 / +8-15 of column tile 2dp / 2dp + 1
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
  const int tiles = (nk + kKTile - 1) / kKTile;
  for (int it = 0; it < tiles; ++it) {
    const __nv_bfloat16* k_s = kv_s + (it & 1) * 2 * kKTile * kLd;
    const __nv_bfloat16* v_s = k_s + kKTile * kLd;
    if (it + 1 < tiles) {
      // the other stage was consumed in the previous iteration
      __nv_bfloat16* next = kv_s + ((it + 1) & 1) * 2 * kKTile * kLd;
      copy_tile<DH>(k_g, sk.t, (it + 1) * kKTile, nk, next, tid);
      copy_tile<DH>(v_g, sv.t, (it + 1) * kKTile, nk, next + kKTile * kLd,
                    tid);
      commit();
      wait_pending<1>();
    } else {
      wait_pending<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
          a_fragment(qa[ks], q32, kLdw, ks, g, t);
      }
    }

    // S = q . k^T for 16 rows x 64 keys
    float s[kTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k_s);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
      } else {
        a_fragment(a, q32, kLdw, ks, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const uint32_t* row = k32 + (nt * 8 + g) * kLdw + ks * 8 + t;
        relpos::tc::mma_bf16(s[nt], a, row[0], row[4]);
      }
    }

    // scale into the log2 domain, mask keys past nk, running max
    const int kbase = it * kKTile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (kbase + nt * 8 + 2 * t + c < nk) {
          s[nt][c] *= qscale;
          s[nt][2 + c] *= qscale;
        } else {
          s[nt][c] = -INFINITY;
          s[nt][2 + c] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][c]);
        mx1 = fmaxf(mx1, s[nt][2 + c]);
      }
    // a row lives in the 4 lanes of a quad; the tile's first key is valid,
    // so both maxima are finite
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P as bf16 pairs: the accumulator layout of S is the A layout of P
    uint32_t p[kTiles][2];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const float e0 = exp2f(s[nt][0] - mx0), e1 = exp2f(s[nt][1] - mx0);
      const float e2 = exp2f(s[nt][2] - mx1), e3 = exp2f(s[nt][3] - mx1);
      ls0 += e0 + e1;
      ls1 += e2 + e3;
      p[nt][0] = relpos::tc::pack_bf16(e0, e1);
      p[nt][1] = relpos::tc::pack_bf16(e2, e3);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      const uint32_t pa[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                              p[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bf[4];
        relpos::tc::ldmatrix_x4_trans(
            bf, v_s + (kk * 16 + vrow) * kLd + dp * 16 + vcol);
        relpos::tc::mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        relpos::tc::mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }

  // normalize and write rows < nq
  __nv_bfloat16* o_g = out + b * so.b + h * so.h;
  const float ls[2] = {l0, l1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = ls[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int qi = q0 + warp * kRows + g + 8 * i;
    if (qi < nq) {
      uint32_t* row = reinterpret_cast<uint32_t*>(o_g + qi * so.t);
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn)
        row[dn * 4 + t] = relpos::tc::pack_bf16(o[dn][2 * i] * inv,
                                                o[dn][2 * i + 1] * inv);
    }
  }
}

template <int DH>
size_t tc_smem_bytes() {
  // the q tile and two stages of K and V tiles
  return (size_t)(kQTile + 4 * kKTile) * (DH + 8) * sizeof(__nv_bfloat16);
}

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32QRows = kQTile / kF32Warps;  // query rows a warp
constexpr int kLdk = kKTile + 1;               // padded row of transposed K

template <int DH>
size_t fp32_smem_bytes() {
  return ((size_t)kQTile * DH      // q, times qscale
          + (size_t)DH * kLdk      // K^T tile
          + (size_t)kKTile * DH    // V tile
          + (size_t)kQTile * kKTile)  // P, kF32QRows x kKTile a warp
         * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads)
    flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int nq, int nk, float qscale, Strides sq, Strides sk,
                      Strides sv, Strides so) {
  extern __shared__ float4 smem4[];
  constexpr int kCols = DH / 32;  // output columns a lane
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kt_s = q_s + kQTile * DH;
  float* v_s = kt_s + DH * kLdk;
  float* p_s = v_s + kKTile * DH;

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q_g = q + b * sq.b + h * sq.h;
  const float* k_g = k + b * sk.b + h * sk.h;
  const float* v_g = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < kQTile * DH; idx += kF32Threads) {
    const int i = idx / DH, d = idx - i * DH, qi = q0 + i;
    q_s[idx] = qi < nq ? q_g[qi * sq.t + d] * qscale : 0.f;
  }

  float m[kF32QRows], l[kF32QRows], o[kF32QRows][kCols];
#pragma unroll
  for (int i = 0; i < kF32QRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }
  const float* q_w = q_s + warp * kF32QRows * DH;
  float* p_w = p_s + warp * kF32QRows * kKTile;

  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kKTile * DH; idx += kF32Threads) {
      const int j = idx / DH, d = idx - j * DH, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < nk) {
        kv = k_g[kj * sk.t + d];
        vv = v_g[kj * sv.t + d];
      }
      kt_s[d * kLdk + j] = kv;
      v_s[j * DH + d] = vv;
    }
    __syncthreads();

    float s0[kF32QRows], s1[kF32QRows];
#pragma unroll
    for (int i = 0; i < kF32QRows; ++i) {
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
      for (int i = 0; i < kF32QRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + i * DH + d);
        s0[i] = fmaf(qv.x, a0, fmaf(qv.y, a1, fmaf(qv.z, a2, fmaf(qv.w, a3, s0[i]))));
        s1[i] = fmaf(qv.x, b0, fmaf(qv.y, b1, fmaf(qv.z, b2, fmaf(qv.w, b3, s1[i]))));
      }
    }

    const bool ok0 = k0 + lane < nk, ok1 = k0 + lane + 32 < nk;
#pragma unroll
    for (int i = 0; i < kF32QRows; ++i) {
      const float a = ok0 ? s0[i] : -INFINITY;
      const float bb = ok1 ? s1[i] : -INFINITY;
      // key k0 < nk is always valid, so the tile max is finite
      const float m_new = fmaxf(m[i], relpos::warp_max(fmaxf(a, bb)));
      const float alpha = exp2f(m[i] - m_new);
      const float pa = exp2f(a - m_new);
      const float pb = exp2f(bb - m_new);
      l[i] = l[i] * alpha + relpos::warp_sum(pa + pb);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
      p_w[i * kKTile + lane] = pa;
      p_w[i * kKTile + lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kKTile; j += 4) {
      float vv[kCols][4];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[c][u] = v_s[(j + u) * DH + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kF32QRows; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + i * kKTile + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          o[i][c] = fmaf(pv.x, vv[c][0], fmaf(pv.y, vv[c][1],
                    fmaf(pv.z, vv[c][2], fmaf(pv.w, vv[c][3], o[i][c]))));
      }
    }
  }

  float* o_g = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < kF32QRows; ++i) {
    const int qi = q0 + warp * kF32QRows + i;
    if (qi < nq) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) o_g[qi * so.t + lane + 32 * c] = o[i][c] * inv;
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int heads, int nq, int nk, float qscale,
                   bool is_bf16, const Strides* s, cudaStream_t stream) {
  const dim3 grid((nq + kQTile - 1) / kQTile, heads, batch);
  if (is_bf16) {
    // bf16 at dh 32 and 64 is flash_wgmma.cu's
    if constexpr (DH < 128) {
      return cudaErrorInvalidValue;
    } else {
      const size_t smem = tc_smem_bytes<DH>();
      cudaError_t err = cudaFuncSetAttribute(
          flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
      flash_tc_kernel<DH><<<grid, kTcThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), nq, nk, qscale, s[0], s[1], s[2],
          s[3]);
    }
  } else {
    const size_t smem = fp32_smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fp32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    flash_fp32_kernel<DH><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), nq, nk,
        qscale, s[0], s[1], s[2], s[3]);
  }
  return cudaGetLastError();
}

}  // namespace flash

// q (batch, heads, nq, dh), k and v (batch, heads, nk, dh) and out (batch,
// heads, nq, dh) of one dtype (0 = fp32, 1 = bf16), each with its last axis
// contiguous and its batch, head and token strides (in elements) in
// strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (out); bf16 rows of
// q, k, v 16-byte aligned, of out 4-byte aligned. dh is 32, 64, 128 or 256
// in fp32, 128 or 256 in bf16; nq, nk >= 1. scale is the plain score scale;
// log2(e) is folded in here.
extern "C" int la_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int batch, int heads, int nq,
                                  int nk, int dh, float scale, int is_bf16,
                                  const long long* strides, void* stream) {
  if (nq < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const flash::Strides* s = reinterpret_cast<const flash::Strides*>(strides);
  const bool bf16 = is_bf16 != 0;
  switch (dh) {
    case 32:
      return (int)flash::launch<32>(q, k, v, out, batch, heads, nq, nk,
                                    qscale, bf16, s, st);
    case 64:
      return (int)flash::launch<64>(q, k, v, out, batch, heads, nq, nk,
                                    qscale, bf16, s, st);
    case 128:
      return (int)flash::launch<128>(q, k, v, out, batch, heads, nq, nk,
                                     qscale, bf16, s, st);
    case 256:
      return (int)flash::launch<256>(q, k, v, out, batch, heads, nq, nk,
                                     qscale, bf16, s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Packed rel-pos attention: what every attention block of SAM ViT-H runs
// (head width 1280 / 16 = 80), global blocks (N = 64 x 64 tokens) and
// windowed blocks (14 x 14 windows of N = 196).
//
// Replaces the TPU kernels of labelanything_tpu/ops/flash_attention.py:
// flash_attention_relpos_packed / flash_attention_relpos -> _packed_fwd_impl
// (Pallas bodies _relpos_kernel_packed, _relpos_kernel_packed_vpu and
// _relpos_kernel_packed_batched).
//
// Per (image or window, head), with q, k, v in slots h, heads + h and
// 2 heads + h of the packed qkv tensor:
//   out[q] = sum_j softmax_j(q.k_j scale + rel_h[q, ky(j)] + rel_w[q, kx(j)]) v_j
// with the factored bias r = [rel_h (kh) | rel_w (kw)] x log2(e) read from
// the query row and an exact running max in the log2 domain. The TPU
// kernel's slot-major relayout, bounded (Cauchy-Schwarz) softmax shift,
// ones-column denominator, one-hot bias matmul and operand augmentation were
// devices of the TPU's lanes and matrix unit and are not carried over: the
// kernels take strides, so the encoder hands them the qkv projection as it
// is (relpos_packed.cuh).
//
// * bf16, global (packed_global_tc_kernel in relpos_packed.cuh): 4 N^2 dh
//   flops a head against 6 N dh bytes, bound by operations at N = 4096. At
//   dh = 80 a thread holds 40 output and 32 score accumulators and 20 q
//   fragments; the K / V tiles cost 2 x 11 KB and the fp32 r rows 33 KB a
//   block, three blocks an SM. As in relpos_global.cu, mma.sync and a
//   barrier per 64-key tile keep it under the tensor-core rate. A key grid
//   whose rows are 64 wide takes the instance that reads the bias without
//   a division; in bf16 at dh 80 such grids (kh even up to 64: ViT-H at
//   1024 px) go to the wgmma kernel of relpos_packed_sm90.cu instead
//   (ops/flash_attention.py's packed_global_kernel chooses the entry).
// * bf16, windowed: relpos_window.cuh's window_tc_kernel, the design of
//   the 64-wide windowed kernel (relpos_window.cu) as a template on the head
//   width, on these strides: keys in slots by key-grid row (14 x 16 = 224
//   at 14 x 14) with zero K / V and a -inf bias in empty slots, rel_w in
//   registers and rel_h read once per key row, one warp per 16-row query
//   tile, two blocks of 7 warps a (window, head), K and V copied once into
//   shared memory (2 x 224 x 176 B = 79 KB at dh 80, 109 KB with the q and
//   r staging: two blocks an SM). At dh 80 a warp takes the slots in four
//   parts with three rescales, so that the 40 output registers leave room
//   for the scores. Windows up to 16 x 16; bound by bytes.
// * fp32 (packed_kernel, both entry points): CUDA cores, for parity runs.
//   One block per (image or window, head, 64-row query tile) walks the keys
//   in tiles of 64 (K transposed, V row-major in shared memory); warp w owns
//   query rows 8w..8w+7, lane l the keys l and l + 32 of a tile for the
//   scores and the output columns l, l + 32, l + 64 (< dh) for P . V.
#include <cmath>
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"
#include "relpos_packed.cuh"
#include "relpos_window.cuh"

namespace relpos {
namespace packed {

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kQRows = kQTile / kWarps;  // query rows per warp
constexpr int kLdk = kKTile + 1;         // padded row of transposed K

template <int DH>
__host__ __device__ constexpr int v_stride() {
  return (DH + 31) / 32 * 32;  // V rows padded with zero columns
}

template <int DH>
size_t fp32_smem_floats(int rr) {
  return (size_t)kQTile * DH              // q (pre-scaled)
         + (size_t)DH * kLdk              // K^T tile
         + (size_t)kKTile * v_stride<DH>()  // V tile
         + (size_t)kQTile * kKTile        // P, per warp kQRows x kKTile
         + (size_t)kQTile * rr;           // r rows of the query tile
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    packed_kernel(const float* __restrict__ qkv, const float* __restrict__ r,
                  float* __restrict__ out, int n, int heads, int kh, int kw,
                  float qscale, Strides sq, Strides sr, Strides so) {
  extern __shared__ float4 smem4[];
  constexpr int kCols = (DH + 31) / 32;  // output columns per lane
  constexpr int kLdv = v_stride<DH>();
  float* smem = reinterpret_cast<float*>(smem4);
  const int rr = kh + kw;
  float* q_s = smem;
  float* kt_s = q_s + kQTile * DH;
  float* v_s = kt_s + DH * kLdk;
  float* p_s = v_s + kKTile * kLdv;
  float* r_s = p_s + kQTile * kKTile;

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q_g = qkv + b * sq.b + h * sq.h;
  const float* k_g = q_g + heads * sq.h;
  const float* v_g = k_g + heads * sq.h;
  const float* r_g = r + b * sr.b + h * sr.h;

  for (int idx = tid; idx < kQTile * DH; idx += kThreads) {
    const int i = idx / DH, d = idx - i * DH, qi = q0 + i;
    q_s[idx] = qi < n ? q_g[qi * sq.t + d] * qscale : 0.f;
  }
  for (int idx = tid; idx < kQTile * rr; idx += kThreads) {
    const int i = idx / rr, j = idx - i * rr, qi = q0 + i;
    r_s[idx] = qi < n ? r_g[qi * sr.t + j] : 0.f;
  }
  if constexpr (kLdv > DH) {  // zero columns that pad V's rows
    for (int idx = tid; idx < kKTile * (kLdv - DH); idx += kThreads) {
      const int j = idx / (kLdv - DH), d = DH + idx - j * (kLdv - DH);
      v_s[j * kLdv + d] = 0.f;
    }
  }

  float m[kQRows], l[kQRows], o[kQRows][kCols];
#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }
  const float* q_w = q_s + warp * kQRows * DH;
  const float* r_w = r_s + warp * kQRows * rr;
  float* p_w = p_s + warp * kQRows * kKTile;

  for (int k0 = 0; k0 < n; k0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kKTile * DH; idx += kThreads) {
      const int j = idx / DH, d = idx - j * DH, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < n) {
        kv = k_g[kj * sq.t + d];
        vv = v_g[kj * sq.t + d];
      }
      kt_s[d * kLdk + j] = kv;
      v_s[j * kLdv + d] = vv;
    }
    __syncthreads();

    float s0[kQRows], s1[kQRows];
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
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
      for (int i = 0; i < kQRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + i * DH + d);
        s0[i] = fmaf(qv.x, a0, fmaf(qv.y, a1, fmaf(qv.z, a2, fmaf(qv.w, a3, s0[i]))));
        s1[i] = fmaf(qv.x, b0, fmaf(qv.y, b1, fmaf(qv.z, b2, fmaf(qv.w, b3, s1[i]))));
      }
    }

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
    const bool ok0 = kj0 < n, ok1 = kj1 < n;
    const int ky0 = kj0 / kw, kx0 = kj0 - ky0 * kw;
    const int ky1 = kj1 / kw, kx1 = kj1 - ky1 * kw;
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
      const float* rrow = r_w + i * rr;
      const float a = ok0 ? s0[i] + rrow[ky0] + rrow[kh + kx0] : -INFINITY;
      const float bb = ok1 ? s1[i] + rrow[ky1] + rrow[kh + kx1] : -INFINITY;
      // key k0 < n is always valid, so the tile max is finite
      const float m_new = fmaxf(m[i], warp_max(fmaxf(a, bb)));
      const float alpha = exp2f(m[i] - m_new);
      const float pa = exp2f(a - m_new);
      const float pb = exp2f(bb - m_new);
      l[i] = l[i] * alpha + warp_sum(pa + pb);
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
        for (int u = 0; u < 4; ++u)
          vv[c][u] = v_s[(j + u) * kLdv + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kQRows; ++i) {
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
  for (int i = 0; i < kQRows; ++i) {
    const int qi = q0 + warp * kQRows + i;
    if (qi < n) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < DH) o_g[qi * so.t + lane + 32 * c] = o[i][c] * inv;
    }
  }
}

template <int DH>
cudaError_t launch_fp32(const void* qkv, const void* r, void* out, int b,
                        int n, int heads, int kh, int kw, float qscale,
                        const Strides* s, cudaStream_t stream) {
  const size_t smem = fp32_smem_floats<DH>(kh + kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      packed_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile - 1) / kQTile, heads, b);
  packed_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(r),
      static_cast<float*>(out), n, heads, kh, kw, qscale, s[0], s[1], s[2]);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(bool windowed, const void* qkv, const void* r, void* out,
                   int b, int n, int heads, int kh, int kw, float qscale,
                   bool is_bf16, const Strides* s, cudaStream_t stream) {
  if (!is_bf16)
    return launch_fp32<DH>(qkv, r, out, b, n, heads, kh, kw, qscale, s,
                           stream);
  if (windowed)
    return with_slot_layout(kh, kw, [&](auto kwp, auto nb) {
      return launch_window_tc<DH, decltype(kwp)::value, decltype(nb)::value>(
          qkv, r, out, nullptr, b, n, heads, kh, kw, qscale, s, stream);
    });
  // a key grid whose rows are one chunk wide (64 x 64 at 1024 px) takes the
  // instance that reads the bias without a division
  return kw == tc::kChunk
             ? launch_global_tc<DH, true, kBiasFromRow>(
                   qkv, r, out, b, n, heads, kh, kw, qscale, s, stream)
             : launch_global_tc<DH, false, kBiasFromRow>(
                   qkv, r, out, b, n, heads, kh, kw, qscale, s, stream);
}

int launch_any(bool windowed, const void* qkv, const void* r, void* out,
               int b, int n, int heads, int kh, int kw, int dh, float scale,
               int is_bf16, const long long* strides, void* stream) {
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  if (dh == 64)
    return (int)launch<64>(windowed, qkv, r, out, b, n, heads, kh, kw, qscale,
                           is_bf16 != 0, s, st);
  if (dh == 80)
    return (int)launch<80>(windowed, qkv, r, out, b, n, heads, kh, kw, qscale,
                           is_bf16 != 0, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace packed
}  // namespace relpos

// qkv (b, 3 heads, n, dh), r (b, heads, n, kh + kw) and out (b, heads, n, dh)
// of one dtype (0 = fp32, 1 = bf16), each with its last axis contiguous and
// its batch, slot and token strides (in elements) in strides[0..2] (qkv),
// [3..5] (r), [6..8] (out); bf16 rows of qkv 16-byte aligned, of out 4-byte
// aligned. dh is 64 or 80. scale is the plain score scale; log2(e) is folded
// in here.
extern "C" int la_relpos_packed_global(const void* qkv, const void* r,
                                       void* out, int b, int n, int heads,
                                       int kh, int kw, int dh, float scale,
                                       int is_bf16, const long long* strides,
                                       void* stream) {
  return relpos::packed::launch_any(false, qkv, r, out, b, n, heads, kh, kw,
                                    dh, scale, is_bf16, strides, stream);
}

// As la_relpos_packed_global over g windows of n <= 256 tokens; in bf16
// the key grid is at most 16 x 16.
extern "C" int la_relpos_packed_window(const void* qkv, const void* r,
                                       void* out, int g, int n, int heads,
                                       int kh, int kw, int dh, float scale,
                                       int is_bf16, const long long* strides,
                                       void* stream) {
  if (n > relpos::packed::kWindowMaxN) return (int)cudaErrorInvalidValue;
  return relpos::packed::launch_any(true, qkv, r, out, g, n, heads, kh, kw,
                                    dh, scale, is_bf16, strides, stream);
}

// bf16 tensor-core instance of the fused TwoWayTransformer kernel (see
// fused_twoway.cu for the design): one instance is a thread-block cluster
// of C blocks. Width 256, 8 heads, cross-attention internal width 128 (head
// width 16), at most 8 tokens an instance.
//
// Fragment layouts are PTX's for mma.m16n8k16 (.row.col): lane = 4 g + t
// holds rows g and g + 8; of A the columns 2t, 2t + 1 (a0, a1) and 2t + 8,
// 2t + 9 (a2, a3); of B the rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of
// column g; of C the columns 2t, 2t + 1 of rows g (c0, c1) and g + 8 (c2, c3).
//
// Where it rounds to bf16: every operand of a tensor-core product (keys + pe,
// the projected K, V, Q, the softmax probabilities, attention outputs, the
// tokens and the MLP's hidden layer). The token residual stream, every
// LayerNorm, every softmax and every accumulator are fp32; the image tokens
// are rounded once a block, when the new keys are written.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "relpos_common.cuh"
#include "sm90.cuh"

namespace twoway {
namespace tc {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kD = 256;          // transformer width
constexpr int kHeads = 8;
constexpr int kI = 128;          // cross-attention internal width
constexpr int kDh = kI / kHeads;       // 16: one k-step a head
constexpr int kDhSelf = kD / kHeads;   // 32
constexpr int kTok = 8;          // token rows (the low half of an mma tile)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;        // image rows of a tile: one a warp at a time
constexpr int kLdD = kD + 8;     // bf16 row stride of 256-wide tiles: 528 B
constexpr int kLdI = kI + 8;     // of 128-wide tiles: 272 B; both keep
                                 // ldmatrix rows on distinct banks
constexpr int kLdTok = kD + 32;  // token operand rows: 16-byte loads of two
                                 // rows a quarter warp stay conflict-free
constexpr int kMaxMlp = 2048;
constexpr int kMaxCluster = 8;   // blocks an instance (portable clusters)
constexpr float kEps = 1e-5f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory map (bytes)
constexpr int kWBytes = kI * kLdD * 2 + kD * kLdI * 2;   // 137,216: two
                                 // weight matrices of a pass, or the token
                                 // stages' temporaries
constexpr int kSliceBytes = kWarps * kRows * kLdD * 2;    // 67,584: a warp's
                                 // 16 image rows each
constexpr int kQueriesBytes = kTok * kD * 4;              // 8,192
constexpr int kTokBytes = kTok * kLdTok * 2;              // 4,608
constexpr int kQtBytes = kTok * kLdI * 2;                 // 2,176
constexpr int kVtBytes = kI * kTok * 2;                   // 2,048
constexpr int kSmemBytes = kWBytes + kSliceBytes + kQueriesBytes +
                           2 * kTokBytes + kQtBytes + kVtBytes + 16;
// inside the weight region: four fp32 (8, 256) token temporaries, the MLP's
// hidden layer, and after a token-to-image walk the block's merged softmax
// state, past the temporaries that other blocks write into; a warp's own
// partial state goes to its slice
constexpr int kTmpF = kTok * kD;                          // floats each
constexpr int kHiddenOff = 4 * kTmpF * 4;                 // bytes
static_assert(kHiddenOff + kTok * (kMaxMlp + 32) * 2 <= kWBytes, "hidden");
constexpr int kRedFloats = 2 * kHeads * kTok + kTok * kI;  // m, l, o
static_assert(kRedFloats * 4 <= kRows * kLdD * 2, "a warp's state");
constexpr int kBlockOff = 40960;                          // bytes
static_assert(kBlockOff >= kHiddenOff, "block's state");
static_assert(kBlockOff + kRedFloats * 4 <= kWBytes, "block's state");

struct Attn {
  const bf16 *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
};

struct Cursor {
  const bf16* p;
  __device__ const bf16* take(int n) {
    const bf16* out = p;
    p += n;
    return out;
  }
  __device__ Attn attn(int inner) {
    Attn a;
    a.wq = take(kD * inner); a.bq = take(inner);
    a.wk = take(kD * inner); a.bk = take(inner);
    a.wv = take(kD * inner); a.bv = take(inner);
    a.wo = take(inner * kD); a.bo = take(kD);
    return a;
  }
};

// What a block knows of its cluster and its instance.
struct Ctx {
  int rank, csize;   // the block's rank in the cluster, the cluster's size
  int s, n, tiles;   // image rows, tokens, 16-row tiles of the image rows
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t add_pairs(uint32_t a, uint32_t b) {
  const float2 x = unpack(a), y = unpack(b);
  return pack(x.x + y.x, x.y + y.y);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^(m - top) as a merge factor; 0 for a state that saw no rows
__device__ __forceinline__ float merge_factor(float m, float top) {
  return m == -INFINITY ? 0.f : exp2f(m - top);
}

// The block's context with the cluster size a constant where the kernel is
// compiled for clusters of one block, so that the cluster's branches fold
// away there.
template <bool kSolo>
__device__ __forceinline__ Ctx fold(Ctx cx) {
  if (kSolo) {
    cx.rank = 0;
    cx.csize = 1;
  }
  return cx;
}

// v into `local` and into the same place in every other block of the
// cluster (distributed shared memory)
template <typename T>
__device__ __forceinline__ void put_all(T* local, T v, int csize) {
  if (csize == 1) {
    *local = v;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int r = 0; r < csize; ++r) *cl.map_shared_rank(local, r) = v;
}

// A warp stages its 16 image rows (row0 .. row0 + 15 of the s rows of x,
// width 256) into its slice: x + pe rounded to bf16 when pe is given, else
// x as it is. Rows past s are zero.
__device__ __forceinline__ void stage_rows(bf16* slice, const bf16* x,
                                           const bf16* pe, int row0, int s,
                                           int lane) {
  // lane l takes columns 8 l .. 8 l + 7 of every row; the loads of eight
  // rows are in flight together
  const int c = lane * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint4 v[8], p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gi = row0 + half * 8 + j;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      p[j] = v[j];
      if (gi < s) {
        v[j] = *reinterpret_cast<const uint4*>(x + (long long)gi * kD + c);
        if (pe != nullptr)
          p[j] = __ldg(
              reinterpret_cast<const uint4*>(pe + (long long)gi * kD + c));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (pe != nullptr) {
        v[j].x = add_pairs(v[j].x, p[j].x);
        v[j].y = add_pairs(v[j].y, p[j].y);
        v[j].z = add_pairs(v[j].z, p[j].z);
        v[j].w = add_pairs(v[j].w, p[j].w);
      }
      *reinterpret_cast<uint4*>(slice + (half * 8 + j) * kLdD + c) = v[j];
    }
  }
  __syncwarp();
}

// acc (16 rows x 128 columns, 16 column tiles) = slice (16 x 256) . w^T + b
// with w (128, 256) in shared memory, row stride kLdD.
__device__ __forceinline__ void project_rows(float (&acc)[kI / 8][4],
                                             const bf16* slice,
                                             const bf16* w_s, const bf16* b,
                                             int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kI / 8; ++nt) {
    const float2 bias = unpack(
        __ldg(reinterpret_cast<const uint32_t*>(b + nt * 8 + 2 * t)));
    acc[nt][0] = acc[nt][2] = bias.x;
    acc[nt][1] = acc[nt][3] = bias.y;
  }
  const bf16* a_ptr = slice + (lane & 15) * kLdD + (lane >> 4) * 8;
  const bf16* b_ptr =
      w_s + ((lane >> 4) * 8 + (lane & 7)) * kLdD + ((lane >> 3) & 1) * 8;
  // the asm statements keep their order: all fragment loads of a k-step are
  // started before its products, so one load's latency is paid a step and not
  // eight
#pragma unroll 2
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t a[4], b4[kI / 16][4];
    ldmatrix_x4(a, a_ptr + ks * 16);
#pragma unroll
    for (int np = 0; np < kI / 16; ++np)
      ldmatrix_x4(b4[np], b_ptr + np * 16 * kLdD + ks * 16);
#pragma unroll
    for (int np = 0; np < kI / 16; ++np) {
      mma(acc[2 * np], a, b4[np][0], b4[np][1]);
      mma(acc[2 * np + 1], a, b4[np][2], b4[np][3]);
    }
  }
}

// How a token dense stage stores its results: fp32 rows, bf16 rows, or bf16
// transposed (out[col * kTok + row], rows past n zero: the token values as
// the image-to-token product's B operand).
enum OutMode { kOutF32, kOutBf16, kOutBf16T };

// out[i][o] = act(sum_k a_s[i][k] w[o][k] + b[o]) for the 8 token rows; a_s
// bf16 in shared memory (row stride lda, the same in every block), w (n_out,
// n_in) bf16 in device memory as nn.Linear keeps it. The output is cut
// across the cluster by columns: pair p of 16 columns goes to the
// cluster's warp (p + skew) mod 8C, the warps numbered warp C + rank, and
// every result is stored into the same place in each block. The k index of
// the products is permuted so that a thread reads 16 contiguous bytes of a
// weight row: lane t of a quad takes k = 32 kb + 8 t .. + 7 in two mma
// steps.
__device__ __forceinline__ void tok_dense(const Ctx& cx, const bf16* a_s,
                                          int lda, const bf16* w,
                                          const bf16* b, int n_in, int n_out,
                                          void* out, int ld, OutMode mode,
                                          bool relu, int skew) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warps = kWarps * cx.csize;
  const int gw = warp * cx.csize + cx.rank;
  const uint4* a4 = reinterpret_cast<const uint4*>(a_s + g * lda) + t;
  for (int pair = ((gw - skew) % warps + warps) % warps; pair < n_out / 16;
       pair += warps) {
    const int n0 = pair * 16;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    const uint4* w0 =
        reinterpret_cast<const uint4*>(w + (long long)(n0 + g) * n_in) + t;
    const uint4* w1 =
        reinterpret_cast<const uint4*>(w + (long long)(n0 + 8 + g) * n_in) + t;
#pragma unroll 8
    for (int kb = 0; kb < n_in / 32; ++kb) {
      const uint4 av = a4[kb * 4];
      const uint4 b0 = __ldg(w0 + kb * 4), b1 = __ldg(w1 + kb * 4);
      const uint32_t lo[4] = {av.x, 0u, av.y, 0u};
      const uint32_t hi[4] = {av.z, 0u, av.w, 0u};
      mma(c0, lo, b0.x, b0.y);
      mma(c1, lo, b1.x, b1.y);
      mma(c0, hi, b0.z, b0.w);
      mma(c1, hi, b1.z, b1.w);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float(&c)[4] = half == 0 ? c0 : c1;
      const int col = n0 + half * 8 + 2 * t;
      const float2 bias =
          unpack(__ldg(reinterpret_cast<const uint32_t*>(b + col)));
      float v0 = c[0] + bias.x, v1 = c[1] + bias.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (mode == kOutF32) {
        put_all(reinterpret_cast<float2*>(static_cast<float*>(out) + g * ld +
                                          col),
                make_float2(v0, v1), cx.csize);
      } else if (mode == kOutBf16) {
        put_all(reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + g * ld +
                                            col),
                pack(v0, v1), cx.csize);
      } else {
        bf16* o = static_cast<bf16*>(out);
        put_all(o + col * kTok + g, __float2bfloat16(g < cx.n ? v0 : 0.f),
                cx.csize);
        put_all(o + (col + 1) * kTok + g,
                __float2bfloat16(g < cx.n ? v1 : 0.f), cx.csize);
      }
    }
  }
}

// dst (bf16, 8 rows of stride ld) = a + b (b may be null) for the first n
// token rows of width `width`; the other rows are zero.
__device__ __forceinline__ void tok_stage(bf16* dst, int ld, const float* a,
                                          int lda, const bf16* b, int n,
                                          int width) {
  for (int idx = threadIdx.x; idx < kTok * width; idx += kThreads) {
    const int i = idx / width, c = idx - i * width;
    float v = 0.f;
    if (i < n) {
      v = a[i * lda + c];
      if (b != nullptr) v += __bfloat162float(b[i * width + c]);
    }
    dst[i * ld + c] = __float2bfloat16(v);
  }
}

// queries[i] = LayerNorm(queries[i] + add[i]) * w + b; warp i takes row i.
// With replace the sum is add alone (the first block's self-attention).
__device__ __forceinline__ void tok_add_norm(float* queries, const float* add,
                                             bool replace, const bf16* w,
                                             const bf16* b, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= n) return;
  float v[kD / 32];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kD / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = add[warp * kD + c] + (replace ? 0.f : queries[warp * kD + c]);
    sum += v[j];
  }
  const float mean = relpos::warp_sum(sum) * (1.f / kD);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kD / 32; ++j) q += (v[j] - mean) * (v[j] - mean);
  const float rstd = rsqrtf(relpos::warp_sum(q) * (1.f / kD) + kEps);
#pragma unroll
  for (int j = 0; j < kD / 32; ++j) {
    const int c = lane + 32 * j;
    queries[warp * kD + c] = (v[j] - mean) * rstd * __bfloat162float(w[c]) +
                             __bfloat162float(b[c]);
  }
}

// Self-attention among the n tokens, heads 32 wide: q, k, v (8, 256) fp32 in
// shared memory; four threads a (head, token), eight columns each; the
// output, rounded, is the out-projection's operand.
__device__ __forceinline__ void tok_attention(bf16* out, int ldo,
                                              const float* q, const float* k,
                                              const float* v, int n) {
  const int tid = threadIdx.x;
  const int part = tid & 3, i = (tid >> 2) & 7, h = tid >> 5;
  if (i >= n) return;
  const float scale = rsqrtf((float)kDhSelf);
  float p[kTok];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    float s = 0.f;
    if (j < n) {
      for (int c = 0; c < kDhSelf; ++c)
        s = fmaf(q[i * kD + h * kDhSelf + c], k[j * kD + h * kDhSelf + c], s);
      s *= scale;
      mx = fmaxf(mx, s);
    }
    p[j] = s;
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    p[j] = j < n ? __expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int c = 0; c < kDhSelf / 4; ++c) {
    const int col = h * kDhSelf + part * (kDhSelf / 4) + c;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < n) acc = fmaf(p[j], v[j * kD + col], acc);
    out[i * ldo + col] = __float2bfloat16(acc * inv);
  }
}

struct Smem {
  bf16* w;          // weight region / token temporaries
  bf16* slice;      // kWarps slices of (16, kLdD): image rows
  float* queries;   // (8, 256) token residual stream
  bf16* ta;         // (8, kLdTok) token operand
  bf16* tb;         // (8, kLdTok) second token operand
  bf16* qt;         // (8, kLdI) projected tokens of a cross-attention
  bf16* vt;         // (128, 8) projected token values, transposed
  uint64_t* bar;    // the weight copies' barrier
  __device__ float* tmp(int i) const {
    return reinterpret_cast<float*>(w) + i * kTmpF;
  }
  __device__ bf16* hidden() const {
    return reinterpret_cast<bf16*>(reinterpret_cast<char*>(w) + kHiddenOff);
  }
  __device__ float* red(int warp) const {   // in the warp's slice
    return reinterpret_cast<float*>(slice + warp * kRows * kLdD);
  }
  __device__ float* block_state() const {
    return reinterpret_cast<float*>(reinterpret_cast<char*>(w) + kBlockOff);
  }
};

// Starts bringing the two weight matrices of a pass into the weight
// region, w0 (rows0, cols0) at row stride ld0, then w1 (rows1, cols1) at
// ld1, each row read once from device memory for the whole cluster: block
// `rank` copies rows rank, rank + C, ... of the two together and
// multicasts them to every block, and each block's barrier awaits all the
// bytes (wait_weights). A cluster of one block, which shares nothing, has
// its threads copy 16 bytes each with cp.async. Every block of the cluster
// must be done with its weight region.
__device__ __forceinline__ void load_weights(const Ctx& cx, const Smem& sm,
                                             const bf16* w0, int rows0,
                                             int cols0, int ld0,
                                             const bf16* w1, int rows1,
                                             int cols1, int ld1) {
  if (cx.csize == 1) {
    for (int m = 0; m < 2; ++m) {
      const int rows = m ? rows1 : rows0, cols = m ? cols1 : cols0;
      const int ld = m ? ld1 : ld0, per_row = cols / 8;
      bf16* dst = m ? sm.w + rows0 * ld0 : sm.w;
      const bf16* src = m ? w1 : w0;
      for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
        const int r = i / per_row, c = (i - r * per_row) * 8;
        cp_async_16(dst + r * ld + c, src + (long long)r * cols + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    return;
  }
  if (threadIdx.x == 0)
    sm90::mbar_expect_tx(sm.bar, (rows0 * cols0 + rows1 * cols1) * 2);
  const uint16_t mask = (uint16_t)((1u << cx.csize) - 1);
  for (int i = cx.rank + cx.csize * threadIdx.x; i < rows0 + rows1;
       i += cx.csize * kThreads) {
    const bool first = i < rows0;
    const int row = first ? i : i - rows0;
    bf16* dst = first ? sm.w + row * ld0 : sm.w + rows0 * ld0 + row * ld1;
    const bf16* src = first ? w0 + (long long)row * cols0
                            : w1 + (long long)row * cols1;
    const uint32_t bytes = (first ? cols0 : cols1) * 2;
    sm90::bulk_load_multicast(dst, src, bytes, sm.bar, mask);
  }
}

// Waits for the weights of the pass that load_weights started (`phase`
// counts the passes).
__device__ __forceinline__ void wait_weights(const Ctx& cx, const Smem& sm,
                                             uint32_t& phase) {
  if (cx.csize == 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  } else {
    sm90::mbar_wait(sm.bar, phase & 1);
  }
  ++phase;
}

// Everything this block's threads did to shared memory, their own or the
// cluster's, is done and seen by every block of the cluster; the weight
// region may then take the next copies (the async proxy after the generic
// one). A cluster of one block needs only the block's barrier.
__device__ __forceinline__ void cluster_sync(const Ctx& cx) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (cx.csize == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// The out projection's operand ta (8 token rows, zero past n) from `count`
// partial softmax states, state(k) each laid out as the warps' (maxima,
// sums, numerators): every numerator and sum scaled to the states' common
// maximum, the numerators' total over the sums' total.
template <typename State>
__device__ __forceinline__ void merge_states(bf16* ta, State state, int count,
                                             int n) {
  for (int idx = threadIdx.x; idx < kTok * kI; idx += kThreads) {
    const int i = idx / kI, c = idx - i * kI, h = c / kDh;
    float top = -INFINITY;
    for (int k = 0; k < count; ++k)
      top = fmaxf(top, state(k)[h * kTok + i]);
    float den = 0.f, num = 0.f;
    for (int k = 0; k < count; ++k) {
      const float* x = state(k);
      const float f = merge_factor(x[h * kTok + i], top);
      den = fmaf(x[kHeads * kTok + h * kTok + i], f, den);
      num = fmaf(x[2 * kHeads * kTok + idx], f, num);
    }
    ta[i * kLdTok + c] = __float2bfloat16(i < n ? num / den : 0.f);
  }
}

// A cluster's token-to-image states merged: the warps' states into the
// block's (maxima, sums and numerators to the block's maxima), then the C
// block states, read through distributed shared memory, into ta in every
// block alike.
__device__ __forceinline__ void merge_cluster(const Ctx& cx, const Smem& sm,
                                              int n) {
  float* bs = sm.block_state();
  for (int idx = threadIdx.x; idx < kTok * kI + kHeads * kTok;
       idx += kThreads) {
    const bool sums = idx >= kTok * kI;
    const int j = sums ? idx - kTok * kI : idx;
    const int i = sums ? j % kTok : j / kI;
    const int h = sums ? j / kTok : (j - i * kI) / kDh;
    float top = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      top = fmaxf(top, sm.red(w)[h * kTok + i]);
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* r = sm.red(w);
      acc = fmaf(sums ? r[kHeads * kTok + h * kTok + i]
                      : r[2 * kHeads * kTok + j],
                 merge_factor(r[h * kTok + i], top), acc);
    }
    if (sums) {
      bs[h * kTok + i] = top;
      bs[kHeads * kTok + h * kTok + i] = acc;
    } else {
      bs[2 * kHeads * kTok + j] = acc;
    }
  }
  cluster_sync(cx);   // every block's state is complete
  cg::cluster_group cl = cg::this_cluster();
  merge_states(sm.ta,
               [&](int r) -> const float* {
                 return cl.map_shared_rank(bs, r);
               },
               cx.csize, n);
}

// Token-to-image attention and its norm: queries = LayerNorm(queries +
// attention(queries + q0, keys + pe, keys)). Each warp walks its tiles of 16
// image rows staged from cur, projects K and V with the weights held in
// shared memory, scores them against the 8 projected tokens (one k-step a
// head) and keeps an exact running maximum and sum (log2 domain). The
// partial states are merged in the block, then across the cluster through
// distributed shared memory.
template <bool kSolo>
__device__ void token_to_image(const Ctx& ctx, const Smem& sm, const Attn& a,
                               const bf16* nw, const bf16* nb, const bf16* cur,
                               const bf16* key_pe, const bf16* q0,
                               uint32_t& phase) {
  const Ctx cx = fold<kSolo>(ctx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = cx.s, n = cx.n;
  // tokens: qt = bf16((queries + q0) wq^T + bq), cut across the cluster
  // while the weights arrive
  tok_stage(sm.ta, kLdTok, sm.queries, kD, q0, n, kD);
  cluster_sync(cx);   // the cluster's weight regions are free
  bf16* wk_s = sm.w;
  bf16* wv_s = sm.w + kI * kLdD;
  load_weights(cx, sm, a.wk, kI, kD, kLdD, a.wv, kI, kD, kLdD);
  tok_dense(cx, sm.ta, kLdTok, a.wq, a.bq, kD, kI, sm.qt, kLdI, kOutBf16,
            false, 0);
  cluster_sync(cx);   // qt complete in every block
  wait_weights(cx, sm, phase);

  bf16* slice = sm.slice + warp * kRows * kLdD;
  const float qscale = rsqrtf((float)kDh) * kLog2e;
  float o[kI / 8][2];   // rows g (the tokens) of the output's column tiles
  float m[kHeads], l[kHeads];
#pragma unroll
  for (int nt = 0; nt < kI / 8; ++nt) o[nt][0] = o[nt][1] = 0.f;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
  const uint32_t* qt32 =
      reinterpret_cast<const uint32_t*>(sm.qt + g * kLdI) + t;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;

  for (int tile = cx.rank + cx.csize * warp; tile < cx.tiles;
       tile += kWarps * cx.csize) {
    const int row0 = tile * kRows;
    uint32_t kf[kHeads][2][2];   // K as B fragments: head, row half, k half
    {
      // K from keys + pe, V from the keys alone
      float acc[kI / 8][4];
      stage_rows(slice, cur, key_pe, row0, s, lane);
      project_rows(acc, slice, wk_s, a.bk, lane);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        kf[h][0][0] = pack(acc[2 * h][0], acc[2 * h][1]);
        kf[h][0][1] = pack(acc[2 * h + 1][0], acc[2 * h + 1][1]);
        kf[h][1][0] = pack(acc[2 * h][2], acc[2 * h][3]);
        kf[h][1][1] = pack(acc[2 * h + 1][2], acc[2 * h + 1][3]);
      }
      __syncwarp();
      stage_rows(slice, cur, nullptr, row0, s, lane);
      project_rows(acc, slice, wv_s, a.bv, lane);
      // V, rounded, back into the slice as (16, kLdI) for ldmatrix.trans
      __syncwarp();
      uint32_t* v32 = reinterpret_cast<uint32_t*>(slice);
#pragma unroll
      for (int nt = 0; nt < kI / 8; ++nt) {
        v32[g * (kLdI / 2) + nt * 4 + t] = pack(acc[nt][0], acc[nt][1]);
        v32[(g + 8) * (kLdI / 2) + nt * 4 + t] = pack(acc[nt][2], acc[nt][3]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const uint32_t qa[4] = {qt32[h * 8], 0u, qt32[h * 8 + 4], 0u};
      float sc[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sc[half][0] = sc[half][1] = sc[half][2] = sc[half][3] = 0.f;
        mma(sc[half], qa, kf[h][half][0], kf[h][half][1]);
      }
      // row g = token g; columns = image rows row0 + 8 half + 2t, + 1
      float mx = m[h];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + half * 8 + 2 * t + e;
          sc[half][e] = r < s ? sc[half][e] * qscale : -INFINITY;
          mx = fmaxf(mx, sc[half][e]);
        }
      mx = quad_max(mx);   // row0 < s: finite
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      float part = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[half][e] = exp2f(sc[half][e] - mx);
          part += sc[half][e];
        }
      l[h] = l[h] * alpha + part;
      const uint32_t pa[4] = {pack(sc[0][0], sc[0][1]), 0u,
                              pack(sc[1][0], sc[1][1]), 0u};
      uint32_t v4[4];
      ldmatrix_x4_trans(v4, slice + vrow * kLdI + h * kDh + vcol);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float c[4] = {o[2 * h + e][0] * alpha, o[2 * h + e][1] * alpha, 0.f,
                      0.f};
        mma(c, pa, v4[2 * e], v4[2 * e + 1]);
        o[2 * h + e][0] = c[0];
        o[2 * h + e][1] = c[1];
      }
    }
    __syncwarp();   // the slice is staged again
  }

  // each warp's state into its slice
  float* red = sm.red(warp);
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const float lsum = quad_sum(l[h]);
    if (t == 0) {
      red[h * kTok + g] = m[h];
      red[kHeads * kTok + h * kTok + g] = lsum;
    }
  }
#pragma unroll
  for (int nt = 0; nt < kI / 8; ++nt)
    *reinterpret_cast<float2*>(red + 2 * kHeads * kTok + g * kI + nt * 8 +
                               2 * t) = make_float2(o[nt][0], o[nt][1]);
  __syncthreads();
  if (kSolo) {
    // one block: the warps' states merged into the out projection's operand
    merge_states(sm.ta, [&](int w) -> const float* { return sm.red(w); },
                 kWarps, n);
  } else {
    merge_cluster(cx, sm, n);
  }
  // out projection (128 -> 256), residual, norm; its results land outside
  // the block states, and the barrier after it also ends every read of them
  __syncthreads();
  tok_dense(cx, sm.ta, kLdTok, a.wo, a.bo, kI, kD, sm.tmp(3), kD, kOutF32,
            false, 0);
  cluster_sync(cx);
  tok_add_norm(sm.queries, sm.tmp(3), false, nw, nb, n);
  __syncthreads();
}

// Image-to-token attention and its norm: keys_out = LayerNorm(keys +
// attention(keys + pe, queries + q0, queries)), rows independent. A warp
// takes a tile of 16 rows at a time: Q projection, scores against the 8
// projected tokens, softmax over them, P . V, the out projection (128 ->
// 256, its 16 x 256 result in registers), residual, LayerNorm, and the new
// rows into kout.
template <bool kSolo>
__device__ void image_to_token(const Ctx& ctx, const Smem& sm, const Attn& a,
                               const bf16* nw, const bf16* nb, const bf16* cur,
                               bf16* kout, const bf16* key_pe, const bf16* q0,
                               uint32_t& phase) {
  const Ctx cx = fold<kSolo>(ctx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = cx.s, n = cx.n;
  // tokens: kt = (queries + q0) wk^T + bk, vt = queries wv^T + bv
  tok_stage(sm.ta, kLdTok, sm.queries, kD, q0, n, kD);
  tok_stage(sm.tb, kLdTok, sm.queries, kD, nullptr, n, kD);
  cluster_sync(cx);   // the cluster's weight regions are free
  bf16* wq_s = sm.w;
  bf16* wo_s = sm.w + kI * kLdD;
  load_weights(cx, sm, a.wq, kI, kD, kLdD, a.wo, kD, kI, kLdI);
  tok_dense(cx, sm.ta, kLdTok, a.wk, a.bk, kD, kI, sm.qt, kLdI, kOutBf16,
            false, 0);
  tok_dense(cx, sm.tb, kLdTok, a.wv, a.bv, kD, kI, sm.vt, 0, kOutBf16T,
            false, kI / 16);
  cluster_sync(cx);   // kt and vt complete in every block
  wait_weights(cx, sm, phase);

  bf16* slice = sm.slice + warp * kRows * kLdD;
  const float qscale = rsqrtf((float)kDh) * kLog2e;
  const uint32_t* kt32 =
      reinterpret_cast<const uint32_t*>(sm.qt + g * kLdI) + t;
  const uint32_t* vt32 = reinterpret_cast<const uint32_t*>(sm.vt) + t;
  const bf16* wo_ptr =
      wo_s + ((lane >> 4) * 8 + (lane & 7)) * kLdI + ((lane >> 3) & 1) * 8;

  for (int tile = cx.rank + cx.csize * warp; tile < cx.tiles;
       tile += kWarps * cx.csize) {
    const int row0 = tile * kRows;
    uint32_t oa[kHeads][4];   // attention output as the out projection's A
    {
      // Q from keys + pe
      float acc[kI / 8][4];
      stage_rows(slice, cur, key_pe, row0, s, lane);
      project_rows(acc, slice, wq_s, a.bq, lane);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const uint32_t qa[4] = {pack(acc[2 * h][0], acc[2 * h][1]),
                                pack(acc[2 * h][2], acc[2 * h][3]),
                                pack(acc[2 * h + 1][0], acc[2 * h + 1][1]),
                                pack(acc[2 * h + 1][2], acc[2 * h + 1][3])};
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        mma(sc, qa, kt32[h * 8], kt32[h * 8 + 4]);
        // rows g, g + 8 of the image; columns = tokens 2t, 2t + 1
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s0 = 2 * t < n ? sc[2 * half] * qscale : -INFINITY;
          float s1 = 2 * t + 1 < n ? sc[2 * half + 1] * qscale : -INFINITY;
          const float mx = quad_max(fmaxf(s0, s1));   // token 0 is valid
          s0 = exp2f(s0 - mx);
          s1 = exp2f(s1 - mx);
          const float inv = 1.f / quad_sum(s0 + s1);
          pa[half] = pack(s0 * inv, s1 * inv);
        }
        pa[2] = pa[3] = 0u;   // tokens 8 .. 15 do not exist
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma(c, pa, vt32[((2 * h + e) * 8 + g) * (kTok / 2)], 0u);
          oa[h][2 * e] = pack(c[0], c[1]);
          oa[h][2 * e + 1] = pack(c[2], c[3]);
        }
      }
    }
    // y = out . wo^T: 32 column tiles of the 16 rows
    float y[kD / 8][4];
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
#pragma unroll
      for (int nq = 0; nq < kD / 64; ++nq) {
        uint32_t b4[4][4];   // four loads in flight, then their products
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldmatrix_x4(b4[j], wo_ptr + (nq * 4 + j) * 16 * kLdI + h * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(y[2 * (nq * 4 + j)], oa[h], b4[j][0], b4[j][1]);
          mma(y[2 * (nq * 4 + j) + 1], oa[h], b4[j][2], b4[j][3]);
        }
      }
    // + bias + residual, LayerNorm over the 256 columns of rows g, g + 8
    const int r0 = row0 + g, r1 = row0 + g + 8;
    const uint32_t* x0 = reinterpret_cast<const uint32_t*>(
        cur + (long long)min(r0, s - 1) * kD);
    const uint32_t* x1 = reinterpret_cast<const uint32_t*>(
        cur + (long long)min(r1, s - 1) * kD);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const float2 bias = unpack(
          __ldg(reinterpret_cast<const uint32_t*>(a.bo + nt * 8 + 2 * t)));
      const float2 xa = unpack(x0[nt * 4 + t]), xb = unpack(x1[nt * 4 + t]);
      y[nt][0] += bias.x + xa.x;
      y[nt][1] += bias.y + xa.y;
      y[nt][2] += bias.x + xb.x;
      y[nt][3] += bias.y + xb.y;
      sum0 += y[nt][0] + y[nt][1];
      sum1 += y[nt][2] + y[nt][3];
    }
    const float mean0 = quad_sum(sum0) * (1.f / kD);
    const float mean1 = quad_sum(sum1) * (1.f / kD);
    float var0 = 0.f, var1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      var0 += (y[nt][0] - mean0) * (y[nt][0] - mean0) +
              (y[nt][1] - mean0) * (y[nt][1] - mean0);
      var1 += (y[nt][2] - mean1) * (y[nt][2] - mean1) +
              (y[nt][3] - mean1) * (y[nt][3] - mean1);
    }
    const float rstd0 = rsqrtf(quad_sum(var0) * (1.f / kD) + kEps);
    const float rstd1 = rsqrtf(quad_sum(var1) * (1.f / kD) + kEps);
    // each lane writes back only the words it read: in place is safe; rows
    // past s stay as they are
    __syncwarp();
    uint32_t* d0 = reinterpret_cast<uint32_t*>(kout + (long long)r0 * kD);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(kout + (long long)r1 * kD);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float2 w2 =
          unpack(__ldg(reinterpret_cast<const uint32_t*>(nw + col)));
      const float2 b2 =
          unpack(__ldg(reinterpret_cast<const uint32_t*>(nb + col)));
      if (r0 < s)
        d0[nt * 4 + t] = pack((y[nt][0] - mean0) * rstd0 * w2.x + b2.x,
                              (y[nt][1] - mean0) * rstd0 * w2.y + b2.y);
      if (r1 < s)
        d1[nt * 4 + t] = pack((y[nt][2] - mean1) * rstd1 * w2.x + b2.x,
                              (y[nt][3] - mean1) * rstd1 * w2.y + b2.y);
    }
    __syncwarp();
  }
  __syncthreads();
  cluster_sync(cx);   // the cluster is done with the weights and the new keys
}

// One instance a cluster of C blocks (grid G C, cluster dims C): block rank
// r takes the image-row tiles r, r + C, ... (warp w those of w C + r),
// walked in device memory. kSolo compiles it for clusters of one block.
template <bool kSolo>
__global__ void __launch_bounds__(kThreads, 1)
    twoway_cluster_kernel(const bf16* keys_in, const bf16* queries_in,
                          const bf16* key_pe, const bf16* params, bf16* q_out,
                          bf16* k_out, int s, int n, int mlp, int depth) {
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  Smem sm;
  sm.w = reinterpret_cast<bf16*>(base);
  sm.slice = reinterpret_cast<bf16*>(base + kWBytes);
  sm.queries = reinterpret_cast<float*>(base + kWBytes + kSliceBytes);
  sm.ta = reinterpret_cast<bf16*>(base + kWBytes + kSliceBytes +
                                  kQueriesBytes);
  sm.tb = sm.ta + kTok * kLdTok;
  sm.qt = sm.tb + kTok * kLdTok;
  sm.vt = sm.qt + kTok * kLdI;
  sm.bar = reinterpret_cast<uint64_t*>(sm.vt + kI * kTok);

  cg::cluster_group cl = cg::this_cluster();
  Ctx cx;
  cx.rank = (int)cl.block_rank();
  cx.csize = (int)cl.num_blocks();
  cx.s = s;
  cx.n = n;
  cx.tiles = (s + kRows - 1) / kRows;
  cx = fold<kSolo>(cx);

  const long long inst = blockIdx.x / cx.csize;
  const bf16* q0 = queries_in + inst * n * kD;
  const bf16* cur = keys_in + inst * s * kD;
  bf16* kout = k_out + inst * s * kD;
  for (int idx = threadIdx.x; idx < kTok * kD; idx += kThreads)
    sm.queries[idx] = idx < n * kD ? __bfloat162float(q0[idx]) : 0.f;
  if (threadIdx.x == 0) {
    sm90::mbar_init(sm.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync(cx);   // every block's barrier is ready for the multicasts
  uint32_t phase = 0;

  Cursor cu{params};
  const int ld_hidden = mlp + 32;
  for (int layer = 0; layer < depth; ++layer) {
    const Attn self = cu.attn(kD);
    const bf16 *n1w = cu.take(kD), *n1b = cu.take(kD);
    const Attn t2i = cu.attn(kI);
    const bf16 *n2w = cu.take(kD), *n2b = cu.take(kD);
    const bf16 *w1 = cu.take(kD * mlp), *b1 = cu.take(mlp);
    const bf16 *w2 = cu.take(mlp * kD), *b2 = cu.take(kD);
    const bf16 *n3w = cu.take(kD), *n3b = cu.take(kD);
    const Attn i2t = cu.attn(kI);
    const bf16 *n4w = cu.take(kD), *n4b = cu.take(kD);

    // token self-attention; the first block has no positional term and
    // replaces the queries
    tok_stage(sm.ta, kLdTok, sm.queries, kD, layer == 0 ? nullptr : q0, n, kD);
    tok_stage(sm.tb, kLdTok, sm.queries, kD, nullptr, n, kD);
    __syncthreads();
    tok_dense(cx, sm.ta, kLdTok, self.wq, self.bq, kD, kD, sm.tmp(0), kD,
              kOutF32, false, 0);
    tok_dense(cx, sm.ta, kLdTok, self.wk, self.bk, kD, kD, sm.tmp(1), kD,
              kOutF32, false, kD / 16);
    tok_dense(cx, sm.tb, kLdTok, self.wv, self.bv, kD, kD, sm.tmp(2), kD,
              kOutF32, false, 2 * kD / 16);
    cluster_sync(cx);
    tok_attention(sm.ta, kLdTok, sm.tmp(0), sm.tmp(1), sm.tmp(2), n);
    __syncthreads();
    tok_dense(cx, sm.ta, kLdTok, self.wo, self.bo, kD, kD, sm.tmp(3), kD,
              kOutF32, false, 0);
    cluster_sync(cx);
    tok_add_norm(sm.queries, sm.tmp(3), layer == 0, n1w, n1b, n);
    __syncthreads();

    token_to_image<kSolo>(cx, sm, t2i, n2w, n2b, cur, key_pe, q0,
                              phase);

    // MLP
    tok_stage(sm.ta, kLdTok, sm.queries, kD, nullptr, n, kD);
    __syncthreads();
    tok_dense(cx, sm.ta, kLdTok, w1, b1, kD, mlp, sm.hidden(), ld_hidden,
              kOutBf16, true, 0);
    cluster_sync(cx);
    tok_dense(cx, sm.hidden(), ld_hidden, w2, b2, mlp, kD, sm.tmp(0), kD,
              kOutF32, false, 0);
    cluster_sync(cx);
    tok_add_norm(sm.queries, sm.tmp(0), false, n3w, n3b, n);
    __syncthreads();

    image_to_token<kSolo>(cx, sm, i2t, n4w, n4b, cur, kout, key_pe, q0,
                              phase);
    cur = kout;
  }
  const Attn fin = cu.attn(kI);
  const bf16 *nfw = cu.take(kD), *nfb = cu.take(kD);
  token_to_image<kSolo>(cx, sm, fin, nfw, nfb, cur, key_pe, q0, phase);
  if (cx.rank == 0)
    for (int idx = threadIdx.x; idx < n * kD; idx += kThreads)
      q_out[inst * n * kD + idx] = __float2bfloat16(sm.queries[idx]);
  // with no block the keys are copied as they came
  if (depth == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(cur);
    uint4* dst = reinterpret_cast<uint4*>(kout);
    const long long words = (long long)s * kD / 8;
    for (long long i = cx.rank * kThreads + threadIdx.x; i < words;
         i += cx.csize * kThreads)
      dst[i] = src[i];
  }
  cluster_sync(cx);   // no block leaves while another may read its memory
}

}  // namespace tc
}  // namespace twoway

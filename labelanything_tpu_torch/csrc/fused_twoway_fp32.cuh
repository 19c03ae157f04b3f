// fp32 instance of the fused TwoWayTransformer kernel (see fused_twoway.cu):
// plain CUDA-core code, one block per instance, for parity with the plain
// PyTorch version. It is generic in the width, the head count and the MLP
// width; the weights arrive transposed, (in, out), so that neighbouring
// threads read neighbouring outputs. The two image-side projections of a
// stage live in a scratch buffer in device memory that the wrapper allocates.
#pragma once

#include <cuda_runtime.h>

#include "relpos_common.cuh"

namespace twoway {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTok = 8;     // tokens an instance
constexpr int kMaxDh = 64;     // head width of any attention
constexpr int kRowTile = 4;    // image rows a thread carries in a projection
constexpr float kEps = 1e-5f;

struct Attn {
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
};

// Walks the flat parameter buffer in the order of ops/fused_twoway.py.
struct Cursor {
  const float* p;
  __device__ const float* take(int n) {
    const float* out = p;
    p += n;
    return out;
  }
  __device__ Attn attn(int d, int inner) {
    Attn a;
    a.wq = take(d * inner); a.bq = take(inner);
    a.wk = take(d * inner); a.bk = take(inner);
    a.wv = take(d * inner); a.bv = take(inner);
    a.wo = take(inner * d); a.bo = take(d);
    return a;
  }
};

// out[i][o] = act(sum_k in[i][k] wt[k][o] + b[o]) for the n token rows;
// in, out in shared memory with row strides ldi, ldo.
__device__ void tok_dense(float* out, int ldo, const float* in, int ldi,
                          const float* wt, const float* b, int n, int n_in,
                          int n_out, bool relu) {
  for (int idx = threadIdx.x; idx < n * n_out; idx += kThreads) {
    const int i = idx / n_out, o = idx - i * n_out;
    float acc = b[o];
    for (int k = 0; k < n_in; ++k) acc = fmaf(in[i * ldi + k], wt[k * n_out + o], acc);
    out[i * ldo + o] = relu ? fmaxf(acc, 0.f) : acc;
  }
}

// dst[i][:] = a[i][:] (+ b[i][:]) for the n token rows of width d.
__device__ void tok_sum(float* dst, const float* a, const float* b, int n,
                        int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads)
    dst[idx] = a[idx] + (b != nullptr ? b[idx] : 0.f);
}

// x[i][:] = LayerNorm(x[i][:] + add[i][:]) * w + b, a warp per token row;
// add may be null.
__device__ void tok_add_norm(float* x, const float* add, const float* w,
                             const float* b, int n, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kWarps) {
    float s = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = x[i * d + c] + (add != nullptr ? add[i * d + c] : 0.f);
      x[i * d + c] = v;
      s += v;
    }
    const float mean = relpos::warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = x[i * d + c] - mean;
      q += v * v;
    }
    const float rstd = rsqrtf(relpos::warp_sum(q) / d + kEps);
    for (int c = lane; c < d; c += 32)
      x[i * d + c] = (x[i * d + c] - mean) * rstd * w[c] + b[c];
  }
}

// Attention among the n tokens: q, k, v (n, width) in shared memory, heads
// of dh = width / heads; out may alias none of them.
__device__ void tok_attention(float* out, const float* q, const float* k,
                              const float* v, int n, int width, int heads) {
  const int dh = width / heads;
  const float scale = rsqrtf((float)dh);
  for (int idx = threadIdx.x; idx < heads * n; idx += kThreads) {
    const int h = idx / n, i = idx - h * n;
    float p[kMaxTok];
    float mx = -INFINITY;
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
      for (int c = 0; c < dh; ++c)
        s = fmaf(q[i * width + h * dh + c], k[j * width + h * dh + c], s);
      p[j] = s * scale;
      mx = fmaxf(mx, p[j]);
    }
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      p[j] = __expf(p[j] - mx);
      sum += p[j];
    }
    const float inv = 1.f / sum;
    for (int c = 0; c < dh; ++c) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], v[j * width + h * dh + c], acc);
      out[i * width + h * dh + c] = acc * inv;
    }
  }
}

// out[r][o] = sum_k (x[r][k] + pe[r][k]) wt[k][o] + b[o] over the s image
// rows; pe may be null; out (s, n_out) in device memory. A thread carries
// kRowTile rows of one output column.
__device__ void image_dense(float* out, const float* x, const float* pe,
                            const float* wt, const float* b, int s, int d,
                            int n_out) {
  const int per_pass = kThreads / n_out;   // row tiles in flight
  const int o = threadIdx.x % n_out, lane_tile = threadIdx.x / n_out;
  if (lane_tile >= per_pass) return;
  for (int r0 = lane_tile * kRowTile; r0 < s; r0 += per_pass * kRowTile) {
    float acc[kRowTile];
#pragma unroll
    for (int j = 0; j < kRowTile; ++j) acc[j] = b[o];
    for (int k = 0; k < d; ++k) {
      const float w = wt[k * n_out + o];
#pragma unroll
      for (int j = 0; j < kRowTile; ++j) {
        const int r = min(r0 + j, s - 1);
        const float v = x[r * d + k] + (pe != nullptr ? pe[r * d + k] : 0.f);
        acc[j] = fmaf(v, w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowTile; ++j)
      if (r0 + j < s) out[(r0 + j) * n_out + o] = acc[j];
  }
}

// Token-to-image attention core: tq (n, inner) in shared memory against the
// projected keys kp and values vp (s, inner) in device memory; a warp per
// (head, token), two passes over the s image rows. out (n, inner) shared.
__device__ void t2i_core(float* out, const float* tq, const float* kp,
                         const float* vp, int n, int s, int inner,
                         int heads) {
  const int dh = inner / heads;
  const float scale = rsqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pair = warp; pair < heads * n; pair += kWarps) {
    const int h = pair / n, i = pair - h * n;
    const float* q = tq + i * inner + h * dh;
    float mx = -INFINITY;
    for (int r = lane; r < s; r += 32) {
      float sc = 0.f;
      for (int c = 0; c < dh; ++c) sc = fmaf(q[c], kp[r * inner + h * dh + c], sc);
      mx = fmaxf(mx, sc * scale);
    }
    mx = relpos::warp_max(mx);
    float acc[kMaxDh];
#pragma unroll
    for (int c = 0; c < kMaxDh; ++c) acc[c] = 0.f;
    float sum = 0.f;
    for (int r = lane; r < s; r += 32) {
      float sc = 0.f;
      for (int c = 0; c < dh; ++c) sc = fmaf(q[c], kp[r * inner + h * dh + c], sc);
      const float p = __expf(sc * scale - mx);
      sum += p;
#pragma unroll
      for (int c = 0; c < kMaxDh; ++c)
        if (c < dh) acc[c] = fmaf(p, vp[r * inner + h * dh + c], acc[c]);
    }
    const float inv = 1.f / relpos::warp_sum(sum);
#pragma unroll
    for (int c = 0; c < kMaxDh; ++c)
      if (c < dh) {
        const float v = relpos::warp_sum(acc[c]);
        if (lane == 0) out[i * inner + h * dh + c] = v * inv;
      }
  }
}

// Image-to-token attention core: qp (s, inner) in device memory against the
// tokens' tk, tv (n, inner) in shared memory; a thread per (image row,
// head); out (s, inner) in device memory.
__device__ void i2t_core(float* out, const float* qp, const float* tk,
                         const float* tv, int n, int s, int inner,
                         int heads) {
  const int dh = inner / heads;
  const float scale = rsqrtf((float)dh);
  for (int idx = threadIdx.x; idx < s * heads; idx += kThreads) {
    const int r = idx / heads, h = idx - r * heads;
    const float* q = qp + r * inner + h * dh;
    float p[kMaxTok];
    float mx = -INFINITY;
    for (int j = 0; j < n; ++j) {
      float sc = 0.f;
      for (int c = 0; c < dh; ++c) sc = fmaf(q[c], tk[j * inner + h * dh + c], sc);
      p[j] = sc * scale;
      mx = fmaxf(mx, p[j]);
    }
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      p[j] = __expf(p[j] - mx);
      sum += p[j];
    }
    const float inv = 1.f / sum;
    for (int c = 0; c < dh; ++c) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], tv[j * inner + h * dh + c], acc);
      out[r * inner + h * dh + c] = acc * inv;
    }
  }
}

// dst[r][:] = LayerNorm(src[r][:] + a[r][:] wot + bo) * w + b over the s
// image rows, a warp per row; a (s, inner) in device memory. dst may be src.
__device__ void image_out_norm(float* dst, const float* src, const float* a,
                               const float* wot, const float* bo,
                               const float* w, const float* b, int s, int d,
                               int inner) {
  constexpr int kMaxPerLane = 16;   // d <= 512
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_lane = d / 32;
  for (int r = warp; r < s; r += kWarps) {
    float y[kMaxPerLane];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j)
      y[j] = j < per_lane ? bo[lane + 32 * j] + src[r * d + lane + 32 * j] : 0.f;
    for (int k = 0; k < inner; ++k) {
      const float v = a[r * inner + k];
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j)
        if (j < per_lane) y[j] = fmaf(v, wot[k * d + lane + 32 * j], y[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) sum += y[j];
    const float mean = relpos::warp_sum(sum) / d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j)
      if (j < per_lane) q += (y[j] - mean) * (y[j] - mean);
    const float rstd = rsqrtf(relpos::warp_sum(q) / d + kEps);
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j)
      if (j < per_lane) {
        const int c = lane + 32 * j;
        dst[r * d + c] = (y[j] - mean) * rstd * w[c] + b[c];
      }
  }
}

// Shared memory: q0, queries, four (n, d) temporaries and one (n, max(d,
// mlp)) temporary, all fp32.
inline size_t smem_bytes(int n, int d, int mlp) {
  return sizeof(float) * (size_t)n * (6 * d + (mlp > d ? mlp : d));
}

__global__ void __launch_bounds__(kThreads)
    twoway_fp32_kernel(const float* keys_in, const float* queries_in,
                       const float* key_pe, const float* params, float* q_out,
                       float* k_out, float* scratch, int s, int n, int d,
                       int heads, int mlp, int depth, int downsample) {
  extern __shared__ float smem[];
  const int inner = d / downsample;
  const long long inst = blockIdx.x;
  float* q0 = smem;
  float* qs = q0 + n * d;        // the token residual stream
  float* t1 = qs + n * d;
  float* t2 = t1 + n * d;
  float* t3 = t2 + n * d;
  float* t4 = t3 + n * d;
  float* wide = t4 + n * d;      // (n, max(d, mlp))
  const float* cur = keys_in + inst * s * d;
  float* kout = k_out + inst * s * d;
  float* pa = scratch + inst * 2 * s * inner;   // first image-side projection
  float* pb = pa + (long long)s * inner;        // second

  for (int idx = threadIdx.x; idx < n * d; idx += kThreads)
    q0[idx] = qs[idx] = queries_in[inst * n * d + idx];
  __syncthreads();

  Cursor cu{params};
  // tokens attend to the image, then LayerNorm(queries + out) by (nw, nb)
  auto token_to_image = [&](const Attn& a, const float* nw, const float* nb) {
    tok_sum(t1, qs, q0, n, d);
    __syncthreads();
    tok_dense(t2, inner, t1, d, a.wq, a.bq, n, d, inner, false);
    image_dense(pa, cur, key_pe, a.wk, a.bk, s, d, inner);
    image_dense(pb, cur, nullptr, a.wv, a.bv, s, d, inner);
    __syncthreads();
    t2i_core(t3, t2, pa, pb, n, s, inner, heads);
    __syncthreads();
    tok_dense(t1, d, t3, inner, a.wo, a.bo, n, inner, d, false);
    __syncthreads();
    tok_add_norm(qs, t1, nw, nb, n, d);
    __syncthreads();
  };

  for (int layer = 0; layer < depth; ++layer) {
    const Attn self = cu.attn(d, d);
    const float *n1w = cu.take(d), *n1b = cu.take(d);
    const Attn t2i = cu.attn(d, inner);
    const float *n2w = cu.take(d), *n2b = cu.take(d);
    const float *w1 = cu.take(d * mlp), *b1 = cu.take(mlp);
    const float *w2 = cu.take(mlp * d), *b2 = cu.take(d);
    const float *n3w = cu.take(d), *n3b = cu.take(d);
    const Attn i2t = cu.attn(d, inner);
    const float *n4w = cu.take(d), *n4b = cu.take(d);

    // token self-attention; the first block has no positional term and
    // replaces the queries
    tok_sum(t1, qs, layer == 0 ? nullptr : q0, n, d);
    __syncthreads();
    tok_dense(t2, d, t1, d, self.wq, self.bq, n, d, d, false);
    tok_dense(t3, d, t1, d, self.wk, self.bk, n, d, d, false);
    tok_dense(t4, d, qs, d, self.wv, self.bv, n, d, d, false);
    __syncthreads();
    tok_attention(t1, t2, t3, t4, n, d, heads);
    __syncthreads();
    tok_dense(t2, d, t1, d, self.wo, self.bo, n, d, d, false);
    __syncthreads();
    if (layer == 0) {
      tok_sum(qs, t2, nullptr, n, d);
      __syncthreads();
      tok_add_norm(qs, nullptr, n1w, n1b, n, d);
    } else {
      tok_add_norm(qs, t2, n1w, n1b, n, d);
    }
    __syncthreads();

    token_to_image(t2i, n2w, n2b);

    // MLP
    tok_dense(wide, mlp, qs, d, w1, b1, n, d, mlp, true);
    __syncthreads();
    tok_dense(t1, d, wide, mlp, w2, b2, n, mlp, d, false);
    __syncthreads();
    tok_add_norm(qs, t1, n3w, n3b, n, d);
    __syncthreads();

    // the image attends to the tokens
    tok_sum(t1, qs, q0, n, d);
    __syncthreads();
    tok_dense(t2, inner, t1, d, i2t.wk, i2t.bk, n, d, inner, false);
    tok_dense(t3, inner, qs, d, i2t.wv, i2t.bv, n, d, inner, false);
    image_dense(pa, cur, key_pe, i2t.wq, i2t.bq, s, d, inner);
    __syncthreads();
    i2t_core(pb, pa, t2, t3, n, s, inner, heads);
    __syncthreads();
    image_out_norm(kout, cur, pb, i2t.wo, i2t.bo, n4w, n4b, s, d, inner);
    cur = kout;
    __syncthreads();
  }

  const Attn fin = cu.attn(d, inner);
  const float *nfw = cu.take(d), *nfb = cu.take(d);
  token_to_image(fin, nfw, nfb);
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads)
    q_out[inst * n * d + idx] = qs[idx];
  // depth 0: the keys pass through
  if (depth == 0)
    for (int idx = threadIdx.x; idx < s * d; idx += kThreads)
      kout[idx] = cur[idx];
}

}  // namespace f32
}  // namespace twoway

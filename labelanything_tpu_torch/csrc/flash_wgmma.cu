// Plain flash attention for Hopper, out = softmax(q . k^T * scale) . v per
// (batch, head), bf16, heads 32 or 64 wide: the affinity decoder's
// AffinityTransformer (4096 query tokens against M x 4096 support tokens,
// heads 32 wide).
//
// Replaces the TPU kernel of labelanything_tpu/ops/flash_attention.py:
// flash_attention -> _run_flash (Pallas bodies _attn_kernel and
// _attn_kernel_batched); the widths 128 and 256 and fp32 stay with
// flash_attention.cu.
//
// What bounds it: at dh 32 a score costs 4 dh = 128 tensor-core flops and
// one exponential, and the special-function units start 16 exponentials a
// clock on an SM against about 4096 bf16 flops on its tensor cores, so the
// exponentials bound the work (bytes are far below both). The design keeps
// the exponential units busy:
//
// * Warp specialisation. One producer warp keeps TMA loads of K and V tiles
//   (112 keys at dh 32, 128 at dh 64) in flight through a ring of kStages
//   stages, each tracked by a full and an empty mbarrier; K and V have
//   barriers of their own, so the scores of a tile start before its V
//   lands. The tensor maps cover the
//   (batch, head, token, dh) views with their strides, so the head-split
//   views of token-major projections are read as they lie. TMA writes each
//   tile with the 64-byte (dh 32) or 128-byte (dh 64) swizzle that the
//   wgmma descriptors name.
// * Consumer warpgroups of 64 query rows each (three at dh 32, two at dh
//   64; see Tile) run wgmma: S = q . k^T as m64n{keys}k16 with both
//   operands in shared memory, O += P . V as m64n{dh}k16 with P as bf16 A
//   fragments in registers (the accumulator layout of S is the A layout
//   of P) and V read MN-major.
// * Ping-pong: named barriers hand the tensor cores from one consumer
//   warpgroup to the next in turn, so the others' exponentials run while
//   one's products do. Inside a warpgroup the products of tile j + 1 (S)
//   and tile j (P . V) are issued together and the softmax of tile j + 1
//   runs while P . V of tile j is still in flight.
// * Little work around each exponential: the score scale and the row
//   maximum fold into one FFMA (s c - m c, c = scale log2 e) and the
//   exponential is one ex2.approx.ftz (exp2f's subnormal handling costs
//   instructions a score); only a ragged last tile is masked (keys past
//   nk: -inf); O is rescaled only where a row's maximum moved.
//
// Tried on the card and not kept, each slower or no faster: a share of the
// exponentials as a polynomial on the FMA pipe (the special-function units
// are not what saturates here), two consumer warpgroups of 128-key tiles
// at dh 32, four of 64- to 96-key tiles (at 102 registers a thread the
// wider ones spill), row sums from a column of ones appended to V, and
// four independent max / sum chains a row; nor is the kernel without the
// ping-pong.
//
// Softmax state is fp32 with an exact running maximum (online softmax in
// the log2 domain); the row sums add the fp32 exponentials, P enters the
// product rounded to bf16, and the output is normalised at the end.
// Query rows past nq are zero-filled by the TMA and not written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace flash_sm90 {

constexpr int kRows = 64;                      // query rows a warpgroup
constexpr int kStages = 4;                     // K / V ring depth
// named barriers of the ping-pong (0 is __syncthreads')
constexpr int kSchedBarrier = 8;

// The tile of each head width: consumer warpgroups and keys a tile. A block
// of kConsumers + 1 warpgroups gets 65536 / (128 (kConsumers + 1)) registers
// a thread: at
// dh 32 three consumer warpgroups hold 112-key tiles (56 score, 28 P and
// 16 output registers a thread) without spilling at 128 registers, where
// 128-key tiles spill; at dh 64 the output doubles, so two warpgroups of
// 128-key tiles at 168 registers.
template <int DH>
struct Tile {
  static constexpr int kConsumers = DH == 32 ? 3 : 2;
  static constexpr int kBlockN = DH == 32 ? 112 : 128;  // keys a tile
  static constexpr int kBlockM = kRows * kConsumers;    // query rows a block
};

template <int DH>
struct Smem {
  static constexpr int kBlockM = Tile<DH>::kBlockM;
  static constexpr int kBlockN = Tile<DH>::kBlockN;
  // each tile is a multiple of 1024 bytes and starts 1024-aligned, as the
  // swizzle patterns repeat every 512 (64-byte) or 1024 (128-byte) bytes
  __nv_bfloat16 q[kBlockM * DH];
  __nv_bfloat16 k[kStages][kBlockN * DH];
  __nv_bfloat16 v[kStages][kBlockN * DH];
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// the producer's arrival that also announces the bytes the TMA will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the barrier's phase of the given parity has completed; a
// wait that outlasts any tile's work by orders of magnitude traps, so a
// fault in the pipeline ends the launch with an error instead of a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (int spin = 0; !done; ++spin) {
    if (spin == (1 << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one TMA load of a (dh, rows, 1, 1) box at coordinates (0, row, h, b)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(h), "r"(b)
      : "memory");
}

// the ping-pong's barriers: the owning warpgroup syncs, the one before it
// arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, wait or issue around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a wgmma operand whose rows are DH
// bf16 (2 DH bytes) wide, swizzled by the TMA at that width: 64-byte
// swizzle for dh 32, 128-byte for dh 64. `sbo` is the byte stride between
// groups of 8 rows; the leading offset is unused by these layouts (an
// operand is one swizzle row wide).
template <int DH>
__device__ __forceinline__ uint64_t make_desc(const void* smem,
                                              uint32_t sbo) {
  constexpr uint64_t kLayout = DH == 32 ? 2 : 1;  // 64B : 128B swizzle
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;
  d |= uint64_t(sbo >> 4) << 32;
  d |= kLayout << 62;
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 112, fp32) += A (64 x 16) . B (112 x 16)^T, both from shared
// memory, K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n112k16_ss(float (&d)[56], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void pv_mma(float (&o)[DH / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  if constexpr (DH == 32)
    wgmma_m64n32k16_rs(o, a0, a1, a2, a3, db);
  else
    wgmma_m64n64k16_rs(o, a0, a1, a2, a3, db);
}

// Softmax of one tile's scores s (row g: s[4 nb], s[4 nb + 1]; row g + 8:
// s[4 nb + 2], s[4 nb + 3]; key 8 nb + 2 t + e of the tile) in place: the
// running maxima m (raw scores), the scale factors alpha of O and the
// partial row sums l are updated; s then holds exp2(s c - m c). Keys at or
// past `valid` are masked (valid >= kBlockN: none).
template <int kBlockN>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             int valid, int t) {
  constexpr int kBlocks = kBlockN / 8;
  if (valid < kBlockN) {
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * nb + 2 * t + e >= valid) {
          s[4 * nb + e] = -INFINITY;
          s[4 * nb + 2 + e] = -INFINITY;
        }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * nb], s[4 * nb + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
  }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // a row lives in the 4 lanes of a quad; the tile's first key is valid,
    // so the maximum is finite
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = mx[i] > m[i] ? ex2((m[i] - mx[i]) * c) : 1.f;
    m[i] = mx[i];
    mc[i] = mx[i] * c;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * nb + e] = ex2(fmaf(s[4 * nb + e], c, -mc[e >> 1]));
      ls[e >> 1] += s[4 * nb + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
}

// P as bf16 A fragments: fragment kk (keys 16 kk .. 16 kk + 15) is
// {row g keys +0-7, row g + 8 keys +0-7, row g keys +8-15, row g + 8 keys
// +8-15} = p[4 kk .. 4 kk + 3]
template <int kBlockN>
__device__ __forceinline__ void pack_p(const float (&s)[kBlockN / 2],
                                       uint32_t (&p)[kBlockN / 4]) {
#pragma unroll
  for (int nb = 0; nb < kBlockN / 8; ++nb) {
    p[2 * nb] = pack_bf16(s[4 * nb], s[4 * nb + 1]);
    p[2 * nb + 1] = pack_bf16(s[4 * nb + 2], s[4 * nb + 3]);
  }
}

// O += P . V over one tile, V read MN-major
template <int DH, int kBlockN>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&p)[kBlockN / 4],
                                         const __nv_bfloat16* v_s) {
  const uint64_t dv = make_desc<DH>(v_s, 16 * DH);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    pv_mma<DH>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               dv + kk * 2 * DH);  // 16 keys of 2 DH bytes, in 16-byte units
}

template <int DH, int kBlockN>
__device__ __forceinline__ void issue_s(float (&s)[kBlockN / 2], uint64_t dq,
                                        const __nv_bfloat16* k_s) {
  const uint64_t dk = make_desc<DH>(k_s, 16 * DH);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {  // 16 columns = 32 bytes a step
    if constexpr (kBlockN == 128)
      wgmma_m64n128k16_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
    else
      wgmma_m64n112k16_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(128 * (Tile<DH>::kConsumers + 1), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int nq, int nk,
                       float c, long long ob, long long oh, long long ot) {
  extern __shared__ unsigned char smem_raw[];
  using Sm = Smem<DH>;
  constexpr int kConsumers = Tile<DH>::kConsumers, kBlockM = Sm::kBlockM;
  constexpr int kBlockN = Sm::kBlockN;
  Sm& sm = *reinterpret_cast<Sm*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBlockM;
  const int tiles = (nk + kBlockN - 1) / kBlockN;
  constexpr uint32_t kTileBytes = kBlockN * DH * 2;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      // one arrival from each consumer warp
      mbar_init(&sm.k_empty[s], 4 * kConsumers);
      mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    if (tid == 0) {
      mbar_expect_tx(&sm.q_full, kBlockM * DH * 2);
      tma_load(sm.q, &tq, &sm.q_full, q0, h, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages, parity = ((j / kStages) & 1) ^ 1;
        if (j >= kStages) mbar_wait(&sm.k_empty[s], parity);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load(sm.k[s], &tk, &sm.k_full[s], j * kBlockN, h, b);
        if (j >= kStages) mbar_wait(&sm.v_empty[s], parity);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load(sm.v[s], &tv, &sm.v_full[s], j * kBlockN, h, b);
      }
    }
    return;
  }

  // consumers
  const int cw = wg - 1, next = kSchedBarrier + (cw + 1) % kConsumers;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int last_valid = nk - (tiles - 1) * kBlockN;
  float s[kBlockN / 2];
  uint32_t p[kBlockN / 4];
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  // the consumer warpgroups take the tensor cores in turn, the first first
  if (cw == kConsumers - 1) named_arrive(kSchedBarrier);
  mbar_wait(&sm.q_full, 0);
  const uint64_t dq = make_desc<DH>(sm.q + cw * kRows * DH, 16 * DH);

  // tile 0: scores only
  mbar_wait(&sm.k_full[0], 0);
  named_sync(kSchedBarrier + cw);
  wgmma_fence();
  issue_s<DH, kBlockN>(s, dq, sm.k[0]);
  wgmma_commit();
  named_arrive(next);
  wgmma_wait<0>();
  fence_regs(s);
  __syncwarp();
  if (lane == 0) mbar_arrive(&sm.k_empty[0]);
  softmax_tile<kBlockN>(s, m, l, alpha, c, tiles == 1 ? last_valid : kBlockN,
                     t);
  pack_p<kBlockN>(s, p);

  for (int j = 1; j < tiles; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(&sm.k_full[st], (j / kStages) & 1);
    named_sync(kSchedBarrier + cw);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_s<DH, kBlockN>(s, dq, sm.k[st]);
    wgmma_commit();
    mbar_wait(&sm.v_full[prev], ((j - 1) / kStages) & 1);
    issue_pv<DH, kBlockN>(o, p, sm.v[prev]);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();  // the scores of tile j
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.k_empty[st]);
    softmax_tile<kBlockN>(s, m, l, alpha, c,
                       j == tiles - 1 ? last_valid : kBlockN, t);
    wgmma_wait<0>();  // P . V of tile j - 1
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.v_empty[prev]);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb) {
        o[4 * nb] *= alpha[0];
        o[4 * nb + 1] *= alpha[0];
        o[4 * nb + 2] *= alpha[1];
        o[4 * nb + 3] *= alpha[1];
      }
    }
    pack_p<kBlockN>(s, p);
  }

  // P . V of the last tile
  const int st = (tiles - 1) % kStages;
  mbar_wait(&sm.v_full[st], ((tiles - 1) / kStages) & 1);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<DH, kBlockN>(o, p, sm.v[st]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  // the last warpgroup's arrival before the first turn is matched here, so
  // every barrier ends complete
  if (cw == 0) named_sync(kSchedBarrier);

  // normalise and write rows < nq
  const int row0 = q0 + cw * kRows + warp * 16 + g;
  __nv_bfloat16* o_g = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / li;
    const int qi = row0 + 8 * i;
    if (qi < nq) {
      uint32_t* row = reinterpret_cast<uint32_t*>(o_g + qi * ot);
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb)
        row[nb * 4 + t] =
            pack_bf16(o[4 * nb + 2 * i] * inv, o[4 * nb + 2 * i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no link against the driver
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, nullptr);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault);
#endif
    if (err == cudaSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a (batch, heads, tokens, dh) bf16 operand with element
// strides s = {batch, head, token} (last axis contiguous) and a box of
// (dh, rows) at the swizzle the wgmma descriptors name.
template <int DH>
static bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                     int tokens, const long long* s, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)tokens,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DH, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int batch, int heads, int nq, int nk,
                          float c, const long long* s, cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(&tq, q, batch, heads, nq, s, T::kBlockM) ||
      !make_map<DH>(&tk, k, batch, heads, nk, s + 3, T::kBlockN) ||
      !make_map<DH>(&tv, v, batch, heads, nk, s + 6, T::kBlockN))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<DH>) + 1024;
  auto kernel = flash_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + T::kBlockM - 1) / T::kBlockM, heads, batch);
  kernel<<<grid, 128 * (T::kConsumers + 1), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), nq, nk, c, s[9], s[10],
      s[11]);
  return cudaGetLastError();
}

}  // namespace flash_sm90

// bf16 q (batch, heads, nq, dh), k and v (batch, heads, nk, dh) and out
// (batch, heads, nq, dh), each with its last axis contiguous and its batch,
// head and token strides (in elements) in strides[0..2] (q), [3..5] (k),
// [6..8] (v), [9..11] (out); q, k, v 16-byte aligned with strides that are
// multiples of 8, out rows 4-byte aligned. dh is 32 or 64; nq, nk >= 1.
// scale is the plain score scale; log2(e) is folded in here.
extern "C" int la_flash_wgmma(const void* q, const void* k, const void* v,
                              void* out, int batch, int heads, int nq, int nk,
                              int dh, float scale, const long long* strides,
                              void* stream) {
  if (nq < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  const float c = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)flash_sm90::launch<32>(q, k, v, out, batch, heads, nq, nk,
                                         c, strides, st);
    case 64:
      return (int)flash_sm90::launch<64>(q, k, v, out, batch, heads, nq, nk,
                                         c, strides, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

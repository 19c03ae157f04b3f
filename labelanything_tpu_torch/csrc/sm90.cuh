// Hopper (sm_90a) building blocks shared by the hand-written wgmma / TMA
// kernels (flash_wgmma.cu, relpos_global_bwd.cu, relpos_packed_sm90.cuh):
// mbarriers whose waits trap instead of hanging, 4-D TMA tile loads and 1-D
// bulk copies into shared memory (also multicast across a cluster: the
// fused TwoWayTransformer's weights), wgmma issue / commit / wait and
// register fences, the shared-memory matrix descriptor of 128-byte-swizzled
// (or, at 32-byte rows, 64-byte-swizzled) operand tiles and of tiles at any
// swizzle, the wgmma shapes the kernels use, and TMA tensor maps encoded
// over strided operands through cudaGetDriverEntryPoint (nothing links
// against libcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

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

// one TMA load of a (cols, rows, 1, 1) box at coordinates (col, row, h, b)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(h), "r"(b)
      : "memory");
}

// one bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) from device to shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same copy read once from device memory and written into every block
// of the cluster that `mask` names, at dst's offset in each; each
// destination's barrier at bar's offset receives the bytes.
__device__ __forceinline__ void bulk_load_multicast(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "h"(mask)
      : "memory");
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

// D (64 x 64, fp32) += A (64 x 16) . B (64 x 16)^T, both from shared
// memory, K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
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

// Shared-memory matrix descriptor of a wgmma operand tile written by the TMA
// with a swizzle of kSwizzle bytes (32, 64 or 128): `lbo` is the byte
// stride between swizzle atoms along M or N of an MN-major operand (unused
// where the operand is one atom wide or K-major), `sbo` the byte stride
// between groups of 8 rows (K-major) or of 8 K-rows (MN-major).
template <int kSwizzle>
__device__ __forceinline__ uint64_t make_desc_sw(const void* smem, uint32_t lbo,
                                                 uint32_t sbo) {
  static_assert(kSwizzle == 32 || kSwizzle == 64 || kSwizzle == 128,
                "a swizzle of 32, 64 or 128 bytes");
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= uint64_t((lbo >> 4) & 0x3FFF) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFF) << 32;
  d |= kLayout << 62;
  return d;
}

// D (64 x n, fp32, accumulators d[OFF] .. of a longer array) += A (64 x 16,
// bf16 A fragments in registers) . B (16 x n, MN-major in shared memory)

template <int OFF, int N>
__device__ __forceinline__ void wgmma_m64n64k16_rs_at(float (&d)[N], uint32_t a0,
                                                     uint32_t a1, uint32_t a2,
                                                     uint32_t a3, uint64_t db) {
  static_assert(OFF + 32 <= N, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int OFF, int N>
__device__ __forceinline__ void wgmma_m64n16k16_rs_at(float (&d)[N], uint32_t a0,
                                                     uint32_t a1, uint32_t a2,
                                                     uint32_t a3, uint64_t db) {
  static_assert(OFF + 8 <= N, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
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

// The tensor map of a (batch, heads, tokens, cols) bf16 operand with
// element strides s = {batch, head, token} (last axis contiguous) and a box
// of (box_cols, rows), written into shared memory with the given swizzle.
static bool encode_map(CUtensorMap* map, const void* ptr, int batch,
                       int heads, int tokens, int cols, const long long* s,
                       int box_cols, int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)tokens,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a (batch, heads, tokens, dh) operand in (dh, rows) boxes at
// the swizzle the wgmma descriptors name.
template <int DH>
static bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                     int tokens, const long long* s, int rows) {
  return encode_map(map, ptr, batch, heads, tokens, DH, s, DH, rows,
                    DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90

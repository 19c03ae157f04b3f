// Score-path variants of the packed global rel-pos attention kernel, for the
// score-dtype microbench (ops/microbench_softmax_dtype.py).
//
// Replaces scripts/microbench_softmax_dtype.py: run_variant ->
// _kernel_variant, the TPU script that timed the packed global body with
// (a) the bias expanded by a one-hot matmul, (e) the bias by broadcast adds
// and (f) e with bf16 score tiles. Here (e) is the shipped kernel of
// relpos_packed.cu; this file instantiates the other two from the same
// template (relpos_packed.cuh): la_relpos_packed_onehot (kBiasOneHot) and
// la_relpos_packed_bf16exp (kExpBf16). Neither is on a serving path. Both
// are bf16 only and take the key grids the microbench uses: rows 64 wide
// (the division-free bias instance) and, for the one-hot product,
// kh + kw <= 128.
//
// What bounds them: as the shipped kernel, operations (4 N^2 dh flops a
// head). The one-hot variant adds 2 N^2 (kh + kw) flops of mostly-zero
// products and the integer work of making the 0/1 fragments; the bf16
// variant halves the count of exponential operations and moves the row
// sums onto the tensor cores, at the price of P's exponent arguments
// rounded to bf16.
#include <cstdint>

#include "relpos_common.cuh"
#include "relpos_mma.cuh"
#include "relpos_packed.cuh"

namespace relpos {
namespace packed {

template <int kVariant>
int launch_variant(const void* qkv, const void* r, void* out, int b, int n,
                   int heads, int kh, int kw, int dh, float scale,
                   int is_bf16, const long long* strides, void* stream) {
  if (!is_bf16 || kw != tc::kChunk) return (int)cudaErrorInvalidValue;
  if (kVariant == kBiasOneHot && kh + kw > 16 * kOneHotSteps)
    return (int)cudaErrorInvalidValue;
  const float qscale = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides* s = reinterpret_cast<const Strides*>(strides);
  if (dh == 64)
    return (int)launch_global_tc<64, true, kVariant>(
        qkv, r, out, b, n, heads, kh, kw, qscale, s, st);
  if (dh == 80)
    return (int)launch_global_tc<80, true, kVariant>(
        qkv, r, out, b, n, heads, kh, kw, qscale, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace packed
}  // namespace relpos

// Arguments as la_relpos_packed_global (relpos_packed.cu).
extern "C" int la_relpos_packed_onehot(const void* qkv, const void* r,
                                       void* out, int b, int n, int heads,
                                       int kh, int kw, int dh, float scale,
                                       int is_bf16, const long long* strides,
                                       void* stream) {
  return relpos::packed::launch_variant<relpos::packed::kBiasOneHot>(
      qkv, r, out, b, n, heads, kh, kw, dh, scale, is_bf16, strides, stream);
}

extern "C" int la_relpos_packed_bf16exp(const void* qkv, const void* r,
                                        void* out, int b, int n, int heads,
                                        int kh, int kw, int dh, float scale,
                                        int is_bf16, const long long* strides,
                                        void* stream) {
  return relpos::packed::launch_variant<relpos::packed::kExpBf16>(
      qkv, r, out, b, n, heads, kh, kw, dh, scale, is_bf16, strides, stream);
}

// The packed global kernel on Hopper (relpos_packed_sm90.cuh) at head width
// 80: SAM ViT-H's four global blocks at 1024 px (16 heads, 64 x 64 tokens).
#include "relpos_packed_sm90.cuh"

// As la_relpos_packed_global in bf16 at dh 80 on a key grid that
// relpos::packed_sm90::grid_ok admits (rows 64 wide, kh even up to 64); qkv's
// base and strides must suit the TMA (16-byte multiples). Any other call
// returns cudaErrorInvalidValue.
extern "C" int la_relpos_packed_global_wgmma(const void* qkv, const void* r,
                                             void* out, int b, int n,
                                             int heads, int kh, int kw,
                                             int dh, float scale, int is_bf16,
                                             const long long* strides,
                                             void* stream) {
  if (dh != 80 || !is_bf16) return (int)cudaErrorInvalidValue;
  const float qscale = scale * 1.4426950408889634f;
  return (int)relpos::packed_sm90::launch_global_wgmma<80>(
      qkv, r, out, b, n, heads, kh, kw, qscale,
      reinterpret_cast<const relpos::packed::Strides*>(strides),
      static_cast<cudaStream_t>(stream));
}

// The global rel-pos kernel on Hopper (relpos_packed_sm90.cuh) at head
// width 80, SAM ViT-H's four global blocks at 1024 px (16 heads, 64 x 64
// tokens) on the packed layout, and at head width 64, the four global
// blocks of ViT-B (12 heads) and ViT-L (16 heads) on the token-major qkv.
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
      qkv, r, out, nullptr, b, n, heads, kh, kw, qscale,
      reinterpret_cast<const relpos::packed::Strides*>(strides),
      static_cast<cudaStream_t>(stream));
}

// As la_relpos_global (relpos_global.cu) in bf16 on a key grid that
// relpos::packed_sm90::grid_ok admits: qkv (b, n, 3 heads 64), r (b, n,
// heads (kh + kw)) and out (b, n, heads 64) contiguous and 16-byte aligned;
// lse null or (b, heads, n) fp32. They are read as the packed kernel's
// strided views, no copy: qkv as (b, 3 heads, n, 64), r as (b, heads, n,
// kh + kw), out as (b, heads, n, 64). Any other call returns
// cudaErrorInvalidValue.
extern "C" int la_relpos_global_wgmma(const void* qkv, const void* r,
                                      void* out, float* lse, int b, int n,
                                      int heads, int kh, int kw, float scale,
                                      int is_bf16, void* stream) {
  using relpos::packed::Strides;
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  const long long c = 64LL * heads, rr = kh + kw;
  const Strides s[3] = {{3 * c * n, 64, 3 * c},
                        {rr * heads * n, rr, rr * heads},
                        {c * n, 64, c}};
  return (int)relpos::packed_sm90::launch_global_wgmma<64>(
      qkv, r, out, lse, b, n, heads, kh, kw, scale * 1.4426950408889634f, s,
      static_cast<cudaStream_t>(stream));
}

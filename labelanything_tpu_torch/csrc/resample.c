/* PIL's 8-bit resample (Pillow's Resample.c, ImagingResampleHorizontal_8bpc
   and ImagingResampleVertical_8bpc) on an (H, W, C) uint8 image: per
   output position a first input index and ``ks`` integer weights of 22
   fractional bits (computed by labelanything_tpu_torch/data/transforms.py
   as Pillow computes them), a sum started at one half, shifted and
   clipped to uint8; the horizontal pass first.

   Replaces no TPU kernel: the JAX package resizes with PIL on the host.
   C and not numpy because the loader's threads resize every image of an
   episode and numpy's passes keep too much of the GIL to run them side by
   side (data/transforms.py keeps the numpy twin, which the tests hold it
   to). ctypes releases the GIL for the call.

   Build: part of the host library of data/native.py. */

#include <stdint.h>

#define PRECISION_BITS (32 - 8 - 2)

static uint8_t clip8(int32_t ss) {
  int32_t v = ss >> PRECISION_BITS;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* in (h, w, c) -> out (h, ow, c) along the rows */
static void horizontal(const uint8_t *in, int h, int w, int c, uint8_t *out,
                       int ow, const int32_t *xmin, const int32_t *k,
                       int ks) {
  for (int y = 0; y < h; y++) {
    const uint8_t *row = in + (long)y * w * c;
    uint8_t *o = out + (long)y * ow * c;
    for (int x = 0; x < ow; x++) {
      const int32_t *kk = k + (long)x * ks;
      for (int ch = 0; ch < c; ch++) {
        int32_t ss = 1 << (PRECISION_BITS - 1);
        for (int t = 0; t < ks; t++) {
          int src = xmin[x] + t;
          if (src > w - 1) src = w - 1; /* its weight is 0 */
          ss += row[src * c + ch] * kk[t];
        }
        o[x * c + ch] = clip8(ss);
      }
    }
  }
}

/* in (h, w, c) -> out (oh, w, c) along the columns */
static void vertical(const uint8_t *in, int h, int w, int c, uint8_t *out,
                     int oh, const int32_t *ymin, const int32_t *k, int ks) {
  long stride = (long)w * c;
  for (int y = 0; y < oh; y++) {
    const int32_t *kk = k + (long)y * ks;
    uint8_t *o = out + y * stride;
    for (long i = 0; i < stride; i++) {
      int32_t ss = 1 << (PRECISION_BITS - 1);
      for (int t = 0; t < ks; t++) {
        int src = ymin[y] + t;
        if (src > h - 1) src = h - 1;
        ss += in[src * stride + i] * kk[t];
      }
      o[i] = clip8(ss);
    }
  }
}

/* ``xks`` 0 skips the horizontal pass (w == ow), ``yks`` 0 the vertical
   one; ``tmp`` holds (h, ow, c) between the passes when both run. */
int la_resample_u8(const uint8_t *in, int h, int w, int c, uint8_t *out,
                   int oh, int ow, const int32_t *xmin, const int32_t *xk,
                   int xks, const int32_t *ymin, const int32_t *yk, int yks,
                   uint8_t *tmp) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return -1;
  if (xks && yks) {
    horizontal(in, h, w, c, tmp, ow, xmin, xk, xks);
    vertical(tmp, h, ow, c, out, oh, ymin, yk, yks);
  } else if (xks) {
    horizontal(in, h, w, c, out, ow, xmin, xk, xks);
  } else if (yks) {
    vertical(in, h, w, c, out, oh, ymin, yk, yks);
  } else {
    return -1;
  }
  return 0;
}

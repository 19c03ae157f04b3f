/* Undoes the five row filters of the PNG standard (section 9.2: None, Sub,
   Up, Average, Paeth) on the scanlines of one image or Adam7 pass, each
   row's filter byte first; ``bpp`` bytes a pixel, the filters predicting
   a byte from the byte one pixel to its left, the one above and the one
   above-left.

   Replaces no TPU kernel: the JAX package reads PNG files with PIL. C and
   not numpy because Average and Paeth rows are recurrences along the row:
   data/png.py keeps the numpy twin (a wavefront over anti-diagonals, a
   Python loop that holds the GIL), which the tests hold this to. ctypes
   releases the GIL for the call.

   Build: part of the host library of data/native.py. */

#include <stdint.h>
#include <stdlib.h>

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

/* raw (h, 1 + rowbytes) -> out (h, rowbytes); returns 0, or 1 + the row
   whose filter byte is not 0 to 4. */
int la_png_unfilter(const uint8_t *raw, int h, int rowbytes, int bpp,
                    uint8_t *out) {
  for (int y = 0; y < h; y++) {
    const uint8_t *f = raw + (long)y * (rowbytes + 1);
    int kind = f[0];
    f++;
    uint8_t *o = out + (long)y * rowbytes;
    const uint8_t *prev = y ? out + (long)(y - 1) * rowbytes : 0;
    if (kind > 4) return y + 1;
    for (int x = 0; x < rowbytes; x++) {
      int a = x >= bpp ? o[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: break;
      }
      o[x] = (uint8_t)(f[x] + pred);
    }
  }
  return 0;
}

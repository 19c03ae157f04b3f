/* JPEG decoding on the host, bit for bit as libjpeg-turbo decodes at its
   defaults (the library PIL decodes with): the islow integer IDCT
   (jidctint.c), fancy upsampling (jdsample.c: h2v1, h1v2, h2v2), the
   YCbCr and YCCK tables of jdcolor.c and the colour space that
   jdapimin.c guesses from the JFIF and Adobe markers.

   Replaces no TPU kernel: the JAX package decodes through PIL on the host.
   It is C and not Python because a Huffman decoder walks its codes one at a
   time (labelanything_tpu_torch/data/jpeg.py keeps the numpy twin, which
   the tests hold it to), and it runs on the host, not the card, because
   the work is a serial walk over the entropy-coded bytes of one image with
   no parallel structure worth a launch. ctypes releases the GIL for the
   call, so a loader's threads decode in parallel.

   Taken: baseline and extended Huffman (SOF0, SOF1) and progressive (SOF2)
   files of 8-bit samples, 1, 3 or 4 components, sampling ratios of 1 or 2
   each way, restart intervals. Refused, with the feature named: arithmetic
   coding, lossless and hierarchical files, other precisions, DNL.

   Build: cc -O2 -shared -fPIC -o libla_jpeg.so jpeg_decode.c */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  int defined;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << 9]; /* (length << 8) | value; 0: longer than 9 bits */
} Huff;

typedef struct {
  int id, h, v, tq;
  int dsw, dsh; /* the component's size in samples */
  int wib, hib; /* ceil(dsw / 8), ceil(dsh / 8) */
  int bw, bh;   /* blocks allocated: the interleaved MCUs' */
  int16_t *coef;
  int latched;
  uint16_t q[64]; /* natural order */
  int pred;
  int td, ta;
  uint8_t *plane; /* decoded samples, wib * 8 wide */
} Comp;

typedef struct {
  const uint8_t *p;
  size_t n, pos;
  uint32_t acc;
  int nbits;
  int marker_hit;
} Bits;

typedef struct {
  int W, H, nc, progressive, hmax, vmax, mcux, mcuy, restart;
  int jfif, adobe, adobe_transform, sof_seen;
  Comp comp[4];
  uint16_t qt[4][64];
  int qdef[4];
  Huff dc[4], ac[4];
  int eobrun;
  char *err;
  int errlen;
} Jpeg;

static const uint8_t ZZ[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* k may run past 63 in a corrupt block: libjpeg's extra entries */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define FAIL(...)                                   \
  do {                                              \
    snprintf(j->err, (size_t)j->errlen, __VA_ARGS__); \
    return -1;                                      \
  } while (0)

static int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* ---- entropy decoding --------------------------------------------------- */

static void fill(Bits *b) {
  while (b->nbits <= 24) {
    uint32_t c = 0;
    if (!b->marker_hit && b->pos < b->n) {
      c = b->p[b->pos];
      if (c == 0xFF) {
        size_t q = b->pos + 1;
        while (q < b->n && b->p[q] == 0xFF) q++;
        if (q < b->n && b->p[q] == 0) {
          b->pos = q + 1; /* a stuffed 0xFF */
        } else {
          b->marker_hit = 1; /* libjpeg feeds zeros past a marker */
          c = 0;
        }
      } else {
        b->pos++;
      }
    }
    b->acc |= c << (24 - b->nbits);
    b->nbits += 8;
  }
}

static int get_bits(Bits *b, int n) {
  if (n == 0) return 0;
  fill(b);
  int v = (int)(b->acc >> (32 - n));
  b->acc <<= n;
  b->nbits -= n;
  return v;
}

static int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + (int)((unsigned)-1 << s) + 1 : x;
}

static int huff_decode(Bits *b, const Huff *h) {
  fill(b);
  int e = h->look[b->acc >> (32 - 9)];
  if (e) {
    int len = e >> 8;
    b->acc <<= len;
    b->nbits -= len;
    return e & 255;
  }
  int l = 10;
  int32_t code = (int32_t)(b->acc >> (32 - l));
  while (l <= 16 && code > h->maxcode[l]) {
    l++;
    code = (int32_t)(b->acc >> (32 - l));
  }
  if (l > 16) return 0; /* libjpeg: "bad Huffman code", decodes as 0 */
  b->acc <<= l;
  b->nbits -= l;
  return h->vals[h->valoffset[l] + code];
}

static int build_huff(Jpeg *j, Huff *h) {
  int code = 0, k = 0;
  memset(h->look, 0, sizeof h->look);
  for (int l = 1; l <= 16; l++) {
    h->valoffset[l] = k - code;
    for (int i = 0; i < h->bits[l]; i++, k++, code++) {
      if (l <= 9) {
        int shift = 9 - l;
        for (int f = 0; f < (1 << shift); f++)
          h->look[(code << shift) | f] = (uint16_t)((l << 8) | h->vals[k]);
      }
    }
    h->maxcode[l] = h->bits[l] ? code - 1 : -1;
    if (code > (1 << l)) FAIL("JPEG: bad Huffman table");
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->defined = 1;
  return 0;
}

/* ---- markers --------------------------------------------------------------- */

static int read_dht(Jpeg *j, const uint8_t *s, int len) {
  int pos = 0;
  while (pos < len) {
    if (pos + 17 > len) FAIL("JPEG: truncated DHT segment");
    int tc = s[pos] >> 4, th = s[pos] & 15, total = 0;
    if (tc > 1 || th > 3) FAIL("JPEG: bad DHT table id");
    Huff *h = tc ? &j->ac[th] : &j->dc[th];
    h->bits[0] = 0;
    for (int i = 1; i <= 16; i++) total += h->bits[i] = s[pos + i];
    if (total > 256 || pos + 17 + total > len) FAIL("JPEG: bad DHT counts");
    memcpy(h->vals, s + pos + 17, (size_t)total);
    if (build_huff(j, h)) return -1;
    pos += 17 + total;
  }
  return 0;
}

static int read_dqt(Jpeg *j, const uint8_t *s, int len) {
  int pos = 0;
  while (pos < len) {
    int pq = s[pos] >> 4, tq = s[pos] & 15;
    if (tq > 3 || pq > 1) FAIL("JPEG: bad DQT table id");
    if (pos + 1 + 64 * (pq + 1) > len) FAIL("JPEG: truncated DQT segment");
    for (int k = 0; k < 64; k++)
      j->qt[tq][ZZ[k]] = pq ? (uint16_t)u16(s + pos + 1 + 2 * k)
                            : s[pos + 1 + k];
    j->qdef[tq] = 1;
    pos += 1 + 64 * (pq + 1);
  }
  return 0;
}

static int read_sof(Jpeg *j, const uint8_t *s, int len, int marker) {
  if (j->sof_seen) FAIL("JPEG: more than one frame header");
  if (len < 6) FAIL("JPEG: truncated frame header");
  if (s[0] != 8) FAIL("JPEG: %d-bit samples are not supported (8-bit only)", s[0]);
  j->H = u16(s + 1);
  j->W = u16(s + 3);
  j->nc = s[5];
  j->progressive = marker == 0xC2;
  if (j->H == 0) FAIL("JPEG: DNL (height given after the scan) is not supported");
  if (j->W == 0) FAIL("JPEG: zero image width");
  if (j->nc != 1 && j->nc != 3 && j->nc != 4)
    FAIL("JPEG: %d components are not supported (1, 3 or 4)", j->nc);
  if (len < 6 + 3 * j->nc) FAIL("JPEG: truncated frame header");
  j->hmax = j->vmax = 1;
  for (int c = 0; c < j->nc; c++) {
    Comp *k = &j->comp[c];
    k->id = s[6 + 3 * c];
    k->h = s[7 + 3 * c] >> 4;
    k->v = s[7 + 3 * c] & 15;
    k->tq = s[8 + 3 * c];
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3)
      FAIL("JPEG: bad component parameters");
    if (k->h > j->hmax) j->hmax = k->h;
    if (k->v > j->vmax) j->vmax = k->v;
  }
  j->mcux = (j->W + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->H + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->nc; c++) {
    Comp *k = &j->comp[c];
    if ((j->hmax / k->h != 1 && j->hmax / k->h != 2) || j->hmax % k->h ||
        (j->vmax / k->v != 1 && j->vmax / k->v != 2) || j->vmax % k->v)
      FAIL("JPEG: sampling factors %dx%d against %dx%d are not supported "
           "(ratios of 1 or 2 only)", k->h, k->v, j->hmax, j->vmax);
    k->dsw = (j->W * k->h + j->hmax - 1) / j->hmax;
    k->dsh = (j->H * k->v + j->vmax - 1) / j->vmax;
    k->wib = (k->dsw + 7) / 8;
    k->hib = (k->dsh + 7) / 8;
    k->bw = j->mcux * k->h;
    k->bh = j->mcuy * k->v;
    k->coef = (int16_t *)calloc((size_t)k->bw * k->bh * 64, sizeof(int16_t));
    if (!k->coef) FAIL("JPEG: out of memory");
  }
  j->sof_seen = 1;
  return 0;
}

/* ---- scans ------------------------------------------------------------------ */

static void decode_block_baseline(Bits *b, const Huff *dc, const Huff *ac,
                                  Comp *k, int16_t *blk) {
  int s = huff_decode(b, dc);
  int diff = s ? extend(get_bits(b, s), s) : 0;
  k->pred += diff;
  blk[0] = (int16_t)k->pred;
  for (int i = 1; i < 64; i++) {
    int rs = huff_decode(b, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      blk[ZZ[i]] = (int16_t)extend(get_bits(b, s), s);
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

static void decode_dc_first(Bits *b, const Huff *dc, Comp *k, int16_t *blk,
                            int al) {
  int s = huff_decode(b, dc);
  int diff = s ? extend(get_bits(b, s), s) : 0;
  k->pred += diff;
  blk[0] = (int16_t)((unsigned)k->pred << al);
}

static void decode_ac_first(Jpeg *j, Bits *b, const Huff *ac, int16_t *blk,
                            int ss, int se, int al) {
  if (j->eobrun > 0) {
    j->eobrun--;
    return;
  }
  for (int k = ss; k <= se; k++) {
    int rs = huff_decode(b, ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[ZZ[k]] = (int16_t)((unsigned)extend(get_bits(b, s), s) << al);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        j->eobrun = 1 << r;
        if (r) j->eobrun += get_bits(b, r);
        j->eobrun--;
        break;
      }
    }
  }
}

static void refine(Bits *b, int16_t *c, int p1, int m1) {
  if (get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
}

static void decode_ac_refine(Jpeg *j, Bits *b, const Huff *ac, int16_t *blk,
                             int ss, int se, int al) {
  int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
  int k = ss;
  if (j->eobrun == 0) {
    for (; k <= se; k++) {
      int rs = huff_decode(b, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(b, 1) ? p1 : m1;
      } else if (r != 15) {
        j->eobrun = 1 << r;
        if (r) j->eobrun += get_bits(b, r);
        break;
      }
      do {
        int16_t *c = blk + ZZ[k];
        if (*c != 0) {
          refine(b, c, p1, m1);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s) blk[ZZ[k]] = (int16_t)s;
    }
  }
  if (j->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t *c = blk + ZZ[k];
      if (*c != 0) refine(b, c, p1, m1);
    }
    j->eobrun--;
  }
}

/* Decodes one scan; returns the position after its entropy-coded data. */
static long decode_scan(Jpeg *j, const uint8_t *data, size_t n, size_t pos,
                        const uint8_t *s, int len) {
  if (!j->sof_seen) FAIL("JPEG: scan before the frame header");
  int ns = s[0];
  if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) FAIL("JPEG: bad scan header");
  Comp *sc[4];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], c;
    for (c = 0; c < j->nc; c++)
      if (j->comp[c].id == id) break;
    if (c == j->nc) FAIL("JPEG: scan names an unknown component");
    sc[i] = &j->comp[c];
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3) FAIL("JPEG: bad Huffman table id");
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
  int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
  int dc_scan = ss == 0;
  if (j->progressive) {
    if (dc_scan ? se != 0 : (se < ss || se > 63 || ns != 1))
      FAIL("JPEG: bad progressive scan parameters");
    if (al > 13 || ah > 13) FAIL("JPEG: bad successive approximation");
  } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
    FAIL("JPEG: bad sequential scan parameters");
  }
  for (int i = 0; i < ns; i++) {
    Comp *k = sc[i];
    if (!k->latched) { /* libjpeg latches a table at the component's first scan */
      if (!j->qdef[k->tq]) FAIL("JPEG: quantization table %d is not defined", k->tq);
      memcpy(k->q, j->qt[k->tq], sizeof k->q);
      k->latched = 1;
    }
    int need_dc = !j->progressive || (dc_scan && ah == 0);
    int need_ac = !j->progressive || !dc_scan;
    if ((need_dc && !j->dc[k->td].defined) || (need_ac && !j->ac[k->ta].defined))
      FAIL("JPEG: scan uses an undefined Huffman table");
    k->pred = 0;
  }
  j->eobrun = 0;
  Bits b = {data, n, pos, 0, 0, 0};
  long units, per_row;
  if (ns == 1) {
    per_row = sc[0]->wib;
    units = (long)sc[0]->wib * sc[0]->hib;
  } else {
    per_row = j->mcux;
    units = (long)j->mcux * j->mcuy;
  }
  for (long m = 0; m < units; m++) {
    if (j->restart && m > 0 && m % j->restart == 0) {
      /* discard the byte's padding bits, skip the RSTn marker */
      b.acc = 0;
      b.nbits = 0;
      b.marker_hit = 0;
      if (b.pos + 1 < n && data[b.pos] == 0xFF) {
        size_t q = b.pos + 1;
        while (q < n && data[q] == 0xFF) q++;
        if (q < n && data[q] >= 0xD0 && data[q] <= 0xD7) b.pos = q + 1;
      }
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      j->eobrun = 0;
    }
    long my = m / per_row, mx = m % per_row;
    for (int i = 0; i < ns; i++) {
      Comp *k = sc[i];
      int bh = ns == 1 ? 1 : k->v, bwn = ns == 1 ? 1 : k->h;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bwn; bx++) {
          long row = ns == 1 ? my : my * k->v + by;
          long col = ns == 1 ? mx : mx * k->h + bx;
          int16_t *blk = k->coef + (row * k->bw + col) * 64;
          if (!j->progressive)
            decode_block_baseline(&b, &j->dc[k->td], &j->ac[k->ta], k, blk);
          else if (dc_scan && ah == 0)
            decode_dc_first(&b, &j->dc[k->td], k, blk, al);
          else if (dc_scan) {
            if (get_bits(&b, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
          } else if (ah == 0)
            decode_ac_first(j, &b, &j->ac[k->ta], blk, ss, se, al);
          else
            decode_ac_refine(j, &b, &j->ac[k->ta], blk, ss, se, al);
        }
    }
  }
  return (long)b.pos;
}

/* ---- IDCT, upsampling, colour --------------------------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static uint8_t clamp255(int64_t x) { return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x); }

/* jpeg_idct_islow; out-of-range results saturate, as libjpeg-turbo's SIMD
   IDCT does (the C one wraps through its range-limit table). */
static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    int64_t d[8];
    for (int r = 0; r < 8; r++) d[r] = (int64_t)in[r * 8 + c] * q[r * 8 + c];
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = d[2]; z3 = d[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * -FIX_1_847759065;
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = (d[0] + d[4]) * (1 << CONST_BITS);
    t1 = (d[0] - d[4]) * (1 << CONST_BITS);
    t10 = t0 + t3; t13 = t0 - t3; t11 = t1 + t2; t12 = t1 - t2;
    t0 = d[7]; t1 = d[5]; t2 = d[3]; t3 = d[1];
    z1 = t0 + t3; z2 = t1 + t2; z3 = t0 + t2; z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336; t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026; t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223; z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560; z4 *= -FIX_0_390180644;
    z3 += z5; z4 += z5;
    t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;
    ws[0 * 8 + c] = DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    ws[7 * 8 + c] = DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    ws[1 * 8 + c] = DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    ws[6 * 8 + c] = DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    ws[2 * 8 + c] = DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    ws[5 * 8 + c] = DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    ws[3 * 8 + c] = DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    ws[4 * 8 + c] = DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t *w = ws + r * 8;
    uint8_t *o = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2]; z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * -FIX_1_847759065;
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = (w[0] + w[4]) * (1 << CONST_BITS);
    t1 = (w[0] - w[4]) * (1 << CONST_BITS);
    t10 = t0 + t3; t13 = t0 - t3; t11 = t1 + t2; t12 = t1 - t2;
    t0 = w[7]; t1 = w[5]; t2 = w[3]; t3 = w[1];
    z1 = t0 + t3; z2 = t1 + t2; z3 = t0 + t2; z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336; t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026; t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223; z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560; z4 *= -FIX_0_390180644;
    z3 += z5; z4 += z5;
    t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = clamp255(DESCALE(t10 + t3, n) + 128);
    o[7] = clamp255(DESCALE(t10 - t3, n) + 128);
    o[1] = clamp255(DESCALE(t11 + t2, n) + 128);
    o[6] = clamp255(DESCALE(t11 - t2, n) + 128);
    o[2] = clamp255(DESCALE(t12 + t1, n) + 128);
    o[5] = clamp255(DESCALE(t12 - t1, n) + 128);
    o[3] = clamp255(DESCALE(t13 + t0, n) + 128);
    o[4] = clamp255(DESCALE(t13 - t0, n) + 128);
  }
}

/* One row of ``w`` samples to ``2 w`` (jdsample.c h2v1_fancy_upsample on
   ``sum`` = 3 x nearer + farther rows when ``vert``; the h2v2 rounding). */
static void h2_row(const int *cs, int w, uint8_t *out, int vert) {
  if (!vert) {
    out[0] = (uint8_t)cs[0];
    out[1] = (uint8_t)((cs[0] * 3 + cs[1] + 2) >> 2);
    for (int x = 1; x < w - 1; x++) {
      out[2 * x] = (uint8_t)((cs[x] * 3 + cs[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((cs[x] * 3 + cs[x + 1] + 2) >> 2);
    }
    out[2 * w - 2] = (uint8_t)((cs[w - 1] * 3 + cs[w - 2] + 1) >> 2);
    out[2 * w - 1] = (uint8_t)cs[w - 1];
  } else {
    out[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
    out[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
    for (int x = 1; x < w - 1; x++) {
      out[2 * x] = (uint8_t)((cs[x] * 3 + cs[x - 1] + 8) >> 4);
      out[2 * x + 1] = (uint8_t)((cs[x] * 3 + cs[x + 1] + 7) >> 4);
    }
    out[2 * w - 2] = (uint8_t)((cs[w - 1] * 3 + cs[w - 2] + 8) >> 4);
    out[2 * w - 1] = (uint8_t)((cs[w - 1] * 4 + 7) >> 4);
  }
}

/* The component upsampled to the (H, W) frame, into ``full``. */
static int upsample(Jpeg *j, Comp *k, uint8_t *full, int *cs) {
  int W = j->W, H = j->H, rh = j->hmax / k->h, rv = j->vmax / k->v;
  int stride = k->wib * 8, w = k->dsw, h = k->dsh;
  uint8_t *row2 = (uint8_t *)malloc((size_t)2 * w + 2);
  if (!row2) FAIL("JPEG: out of memory");
  int fancy_h = w > 2; /* jdsample.c: fancy h2 needs more than 2 columns */
  for (int y = 0; y < H; y++) {
    uint8_t *o = full + (size_t)y * W;
    int sy = rv == 2 ? y >> 1 : y;
    const uint8_t *in0 = k->plane + (size_t)sy * stride;
    if (rh == 1 && rv == 1) {
      memcpy(o, in0, (size_t)W);
    } else if (rh == 2 && rv == 1) {
      if (fancy_h) {
        for (int x = 0; x < w; x++) cs[x] = in0[x];
        h2_row(cs, w, row2, 0);
      } else {
        for (int x = 0; x < w; x++) row2[2 * x] = row2[2 * x + 1] = in0[x];
      }
      memcpy(o, row2, (size_t)W);
    } else {
      /* v2: the nearer row is sy, the farther the one above for an even
         output row, below for an odd one, clamped at the edges */
      int far = (y & 1) ? (sy + 1 < h ? sy + 1 : h - 1) : (sy > 0 ? sy - 1 : 0);
      const uint8_t *in1 = k->plane + (size_t)far * stride;
      if (rh == 1) { /* h1v2_fancy_upsample */
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (fancy_h) {
        for (int x = 0; x < w; x++) cs[x] = in0[x] * 3 + in1[x];
        h2_row(cs, w, row2, 1);
        memcpy(o, row2, (size_t)W);
      } else { /* h2v2_upsample: each sample a 2 x 2 box */
        for (int x = 0; x < w; x++) row2[2 * x] = row2[2 * x + 1] = in0[x];
        memcpy(o, row2, (size_t)W);
      }
    }
  }
  free(row2);
  return 0;
}

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static int32_t Cr_r[256], Cb_b[256], Cr_g[256], Cb_g[256];

static void build_colour_tables(void) {
  for (int i = 0, x = -128; i < 256; i++, x++) {
    Cr_r[i] = (FIX(1.40200) * x + ONE_HALF) >> SCALEBITS;
    Cb_b[i] = (FIX(1.77200) * x + ONE_HALF) >> SCALEBITS;
    Cr_g[i] = -FIX(0.71414) * x;
    Cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
  }
}

static void jpeg_free(Jpeg *j) {
  for (int c = 0; c < 4; c++) {
    free(j->comp[c].coef);
    free(j->comp[c].plane);
  }
}

static int parse(Jpeg *j, const uint8_t *d, size_t n) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) FAIL("JPEG: not a JPEG file (no SOI marker)");
  size_t pos = 2;
  int scans = 0;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) pos++; /* libjpeg skips garbage */
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) break; /* no EOI: libjpeg decodes what it has */
    int m = d[pos++];
    if (m == 0xD9) break;
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) continue;
    if (pos + 2 > n) FAIL("JPEG: truncated marker segment");
    int len = u16(d + pos) - 2;
    const uint8_t *s = d + pos + 2;
    if (len < 0 || pos + 2 + (size_t)len > n) FAIL("JPEG: truncated marker segment");
    pos += 2 + (size_t)len;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        if (read_sof(j, s, len, m)) return -1;
        break;
      case 0xC3: FAIL("JPEG: lossless (SOF3) files are not supported");
      case 0xC5: case 0xC6: case 0xC7:
        FAIL("JPEG: hierarchical (differential, SOF%d) files are not supported", m - 0xC0);
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        FAIL("JPEG: arithmetic coding (SOF%d) is not supported", m - 0xC0);
      case 0xCC: FAIL("JPEG: arithmetic coding (DAC) is not supported");
      case 0xDE: case 0xDF: FAIL("JPEG: hierarchical files (DHP / EXP) are not supported");
      case 0xDC: FAIL("JPEG: DNL (height given after the scan) is not supported");
      case 0xC4:
        if (read_dht(j, s, len)) return -1;
        break;
      case 0xDB:
        if (read_dqt(j, s, len)) return -1;
        break;
      case 0xDD:
        if (len < 2) FAIL("JPEG: bad DRI segment");
        j->restart = u16(s);
        break;
      case 0xE0:
        if (len >= 14 && memcmp(s, "JFIF\0", 5) == 0) j->jfif = 1;
        break;
      case 0xEE:
        if (len >= 12 && memcmp(s, "Adobe", 5) == 0) {
          j->adobe = 1;
          j->adobe_transform = s[11];
        }
        break;
      case 0xDA: {
        long end = decode_scan(j, d, n, pos, s, len);
        if (end < 0) return -1;
        pos = (size_t)end;
        scans++;
        break;
      }
      default:
        break;
    }
  }
  if (!j->sof_seen) FAIL("JPEG: no frame header");
  if (!scans) FAIL("JPEG: no scan");
  return 0;
}

/* The image's (height, width, components); 0 or -1 with ``err`` set. */
int la_jpeg_info(const uint8_t *data, long n, int *hwc, char *err, int errlen) {
  Jpeg jj;
  memset(&jj, 0, sizeof jj);
  Jpeg *j = &jj;
  j->err = err;
  j->errlen = errlen;
  size_t pos = 2;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) FAIL("JPEG: not a JPEG file (no SOI marker)");
  while (pos + 4 <= (size_t)n) {
    while (pos < (size_t)n && data[pos] != 0xFF) pos++;
    while (pos < (size_t)n && data[pos] == 0xFF) pos++;
    if (pos + 3 > (size_t)n) break;
    int m = data[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    int len = u16(data + pos);
    if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (pos + 8 > (size_t)n) break;
      hwc[0] = u16(data + pos + 3);
      hwc[1] = u16(data + pos + 5);
      hwc[2] = data[pos + 7];
      return 0;
    }
    pos += (size_t)len;
  }
  FAIL("JPEG: no frame header");
}

/* Decodes into ``out`` (H, W, C) uint8, C = 1 (L), 3 (RGB) or 4 (CMYK as
   PIL holds it: 255 - libjpeg's output, PIL's rawmode "CMYK;I"). */
int la_jpeg_decode(const uint8_t *data, long n, uint8_t *out, long out_size,
                   char *err, int errlen) {
  static int tables = 0;
  if (!tables) { /* idempotent, so a race only repeats it */
    build_colour_tables();
    tables = 1;
  }
  Jpeg jj;
  memset(&jj, 0, sizeof jj);
  Jpeg *j = &jj;
  j->err = err;
  j->errlen = errlen;
  int rc = parse(j, data, (size_t)n);
  uint8_t *full[4] = {0, 0, 0, 0};
  int *cs = NULL;
  if (rc) goto done;
  if ((long)j->W * j->H * j->nc != out_size) {
    snprintf(err, (size_t)errlen, "JPEG: output buffer of %ld bytes, %ld needed",
             out_size, (long)j->W * j->H * j->nc);
    rc = -1;
    goto done;
  }
  cs = (int *)malloc(sizeof(int) * ((size_t)j->W + 8));
  for (int c = 0; c < j->nc && !rc; c++) {
    Comp *k = &j->comp[c];
    if (!k->latched) {
      snprintf(err, (size_t)errlen, "JPEG: component %d has no scan", k->id);
      rc = -1;
      break;
    }
    int stride = k->wib * 8;
    k->plane = (uint8_t *)malloc((size_t)stride * k->hib * 8);
    full[c] = (uint8_t *)malloc((size_t)j->W * j->H);
    if (!k->plane || !full[c] || !cs) {
      snprintf(err, (size_t)errlen, "JPEG: out of memory");
      rc = -1;
      break;
    }
    for (int by = 0; by < k->hib; by++)
      for (int bx = 0; bx < k->wib; bx++)
        idct_islow(k->coef + ((size_t)by * k->bw + bx) * 64, k->q,
                   k->plane + (size_t)by * 8 * stride + bx * 8, stride);
    rc = upsample(j, k, full[c], cs);
  }
  if (rc) goto done;
  size_t npix = (size_t)j->W * j->H;
  if (j->nc == 1) {
    memcpy(out, full[0], npix);
  } else {
    /* jdapimin.c's guess of the colour space */
    int ycc;
    if (j->nc == 3) {
      if (j->jfif) ycc = 1;
      else if (j->adobe) ycc = j->adobe_transform != 0;
      else ycc = !(j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66);
    } else {
      ycc = j->adobe ? j->adobe_transform != 0 : 0;
    }
    for (size_t i = 0; i < npix; i++) {
      uint8_t *o = out + i * j->nc;
      if (ycc) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        int r = y + Cr_r[cr];
        int g = y + (int)((Cb_g[cb] + Cr_g[cr]) >> SCALEBITS);
        int b = y + Cb_b[cb];
        if (j->nc == 3) {
          o[0] = clamp255(r); o[1] = clamp255(g); o[2] = clamp255(b);
        } else { /* ycck_cmyk_convert */
          o[0] = clamp255(255 - r); o[1] = clamp255(255 - g); o[2] = clamp255(255 - b);
          o[3] = full[3][i];
        }
      } else {
        for (int c = 0; c < j->nc; c++) o[c] = full[c][i];
      }
      if (j->nc == 4)
        for (int c = 0; c < 4; c++) o[c] = (uint8_t)(255 - o[c]);
    }
  }
done:
  for (int c = 0; c < 4; c++) free(full[c]);
  free(cs);
  jpeg_free(j);
  return rc;
}

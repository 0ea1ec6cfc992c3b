/* Baseline JPEG decoding stages for `bundlesdf_tpu_torch/utils/jpeg.py`.
 *
 * Four entry points, one per stage, each a plain C function bound with
 * ctypes (the marker segments are parsed in Python):
 *   jpeg_decode_scan  Huffman decode of one scan into quantized
 *                     coefficients (natural order, int16), with restart
 *                     markers and DC prediction;
 *   jpeg_idct_plane   dequantization and libjpeg's ISLOW integer IDCT
 *                     (jidctint.c: CONST_BITS 13, PASS1_BITS 2, DESCALE
 *                     rounding, the post-IDCT range-limit table);
 *   jpeg_upsample     libjpeg's fancy (triangle-filter) upsampling of one
 *                     chroma plane: h2v1, h1v2 and h2v2 with their
 *                     alternating rounding biases and replicated edges,
 *                     box replication where libjpeg-turbo takes it (h2v1
 *                     and h2v2 at a downsampled width of 2 or less);
 *   jpeg_ycc_rgb      the fixed-point YCbCr -> RGB tables of jdcolor.c.
 * Together they give the pixels libjpeg-turbo's default decompression
 * gives (JDCT_ISLOW, do_fancy_upsampling), which is what Pillow and
 * imageio return.
 *
 * Build: cc -O2 -shared -fPIC -o libjpeg_decode.so jpeg_decode.c
 */
#include <stdint.h>
#include <string.h>

/* zigzag position -> natural (row-major) position, with 16 spare entries
 * so a corrupt run length cannot index past the block (jutils.c) */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK_BITS 9

typedef struct {
  int32_t maxcode[18];    /* largest code of each length, -1 if none */
  int32_t valoffset[18];  /* huffval index = code + valoffset[length] */
  uint8_t huffval[256];
  uint8_t look_len[1 << LOOK_BITS]; /* 0: code longer than LOOK_BITS */
  uint8_t look_sym[1 << LOOK_BITS];
} htable;

/* jdhuff.c's jpeg_make_d_derived_tbl from the DHT counts and values;
 * returns -1 on a table whose codes overflow their lengths */
static int make_table(const uint8_t *bits, const uint8_t *vals, htable *t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) {
      if (p >= 256) return -1;
      size[p++] = (uint8_t)l;
    }
  size[p] = 0;
  int n = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c > (1u << si)) return -1;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - (int32_t)code[p];
      p += bits[l - 1];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  memcpy(t->huffval, vals, (size_t)n);
  memset(t->look_len, 0, sizeof t->look_len);
  for (p = 0; p < n; p++) {
    int l = size[p];
    if (l > LOOK_BITS) continue;
    int lo = (int)(code[p] << (LOOK_BITS - l));
    for (int k = 0; k < (1 << (LOOK_BITS - l)); k++) {
      t->look_len[lo + k] = (uint8_t)l;
      t->look_sym[lo + k] = vals[p];
    }
  }
  return 0;
}

typedef struct {
  const uint8_t *p, *end;
  uint64_t buf;   /* bits left-aligned */
  int nbits;
  int marker;     /* a marker was reached: zeros are fed from here on */
} bitreader;

static inline void fill(bitreader *br) {
  while (br->nbits <= 56) {
    uint32_t c = 0;
    if (!br->marker && br->p < br->end) {
      c = br->p[0];
      if (c == 0xFF) {
        if (br->p + 1 < br->end && br->p[1] == 0x00) {
          br->p += 2;              /* a stuffed 0xFF */
        } else {
          br->marker = 1;          /* RSTn or the scan's end */
          c = 0;
        }
      } else {
        br->p++;
      }
    }
    br->buf |= (uint64_t)c << (56 - br->nbits);
    br->nbits += 8;
  }
}

static inline int get_bits(bitreader *br, int n) {
  if (n == 0) return 0;
  if (br->nbits < n) fill(br);
  int v = (int)(br->buf >> (64 - n));
  br->buf <<= n;
  br->nbits -= n;
  return v;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((-1u) << s) + 1 : v;
}

/* one Huffman symbol, or -1 for a code no table entry has */
static inline int decode_sym(bitreader *br, const htable *t) {
  if (br->nbits < 16) fill(br);
  int look = (int)(br->buf >> (64 - LOOK_BITS));
  int l = t->look_len[look];
  if (l) {
    br->buf <<= l;
    br->nbits -= l;
    return t->look_sym[look];
  }
  for (l = LOOK_BITS + 1; l <= 16; l++) {
    int32_t code = (int32_t)(br->buf >> (64 - l));
    if (code <= t->maxcode[l]) {
      br->buf <<= l;
      br->nbits -= l;
      return t->huffval[(code + t->valoffset[l]) & 0xFF];
    }
  }
  return -1;
}

/* Decode one scan of @n_scomp components.
 * @data/@len: the entropy-coded segment (restart markers included).
 * @tables: 8 tables of 16 counts + 256 values (0-3 DC, 4-7 AC).
 * @scomp: per scan component, 6 int64: h, v (blocks of an MCU; 1, 1 in a
 *   non-interleaved scan), dc table, ac table, grid width in blocks,
 *   block offset of the component's grid in @coef.
 * @mcus_x/@mcus_y: the scan's MCU grid; @restart: MCUs between restart
 * markers (0: none). Returns 0, or a negative code on corrupt data or
 * more than 4 scan components. */
int jpeg_decode_scan(const uint8_t *data, int64_t len, const uint8_t *tables,
                     int n_scomp, const int64_t *scomp, int64_t mcus_x,
                     int64_t mcus_y, int64_t restart, int16_t *coef) {
  htable tabs[8];
  int built[8] = {0};
  if (n_scomp < 1 || n_scomp > 4) return -7;
  for (int c = 0; c < n_scomp; c++) {
    for (int k = 0; k < 2; k++) {
      int ti = (int)scomp[c * 6 + 2 + k] + 4 * k;
      if (ti < 0 || ti > 7) return -2;
      if (!built[ti]) {
        const uint8_t *tb = tables + ti * 272;
        if (make_table(tb, tb + 16, &tabs[ti]) < 0) return -3;
        built[ti] = 1;
      }
    }
  }
  bitreader br = {data, data + len, 0, 0, 0};
  int pred[4] = {0, 0, 0, 0};
  int64_t todo = restart;
  for (int64_t my = 0; my < mcus_y; my++) {
    for (int64_t mx = 0; mx < mcus_x; mx++) {
      if (restart && todo == 0) {
        /* drop the padding bits, step over RSTn, reset the predictions */
        br.buf = 0;
        br.nbits = 0;
        br.marker = 0;
        while (br.p + 1 < br.end &&
               !(br.p[0] == 0xFF && br.p[1] >= 0xD0 && br.p[1] <= 0xD7))
          br.p++;
        if (br.p + 1 < br.end) br.p += 2;
        memset(pred, 0, sizeof pred);
        todo = restart;
      }
      for (int c = 0; c < n_scomp; c++) {
        const int64_t *sc = scomp + c * 6;
        const htable *dc = &tabs[sc[2]], *ac = &tabs[sc[3] + 4];
        for (int64_t v = 0; v < sc[1]; v++) {
          for (int64_t h = 0; h < sc[0]; h++) {
            int64_t by = my * sc[1] + v, bx = mx * sc[0] + h;
            int16_t *blk = coef + (sc[5] + by * sc[4] + bx) * 64;
            int s = decode_sym(&br, dc);
            if (s < 0) return -4;
            if (s) {
              if (s > 16) return -5;
              s = extend(get_bits(&br, s), s);
            }
            pred[c] += s;
            blk[0] = (int16_t)pred[c];
            for (int k = 1; k < 64; k++) {
              int rs = decode_sym(&br, ac);
              if (rs < 0) return -4;
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                if (k > 63) return -6;
                int val = extend(get_bits(&br, s), s);
                blk[kNatural[k]] = (int16_t)val;
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
      }
      if (restart) todo--;
    }
  }
  return 0;
}

/* ---------------------------------------------------------------- IDCT */
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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* jdmaster.c's post-IDCT range limit: x & 1023 indexes a table that is
 * x + 128 on [-128, 127], 255 above and 0 below (wrapping past +-512) */
static inline uint8_t range_limit(int64_t x) {
  int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

/* the even and odd halves of one 8-point ISLOW pass over in[0..7*step] */
#define IDCT_1D(in0, in1, in2, in3, in4, in5, in6, in7)                    \
  int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;                      \
  int64_t tmp10, tmp11, tmp12, tmp13;                                      \
  z2 = (in2);                                                              \
  z3 = (in6);                                                              \
  z1 = (z2 + z3) * FIX_0_541196100;                                        \
  tmp2 = z1 + z3 * (-FIX_1_847759065);                                     \
  tmp3 = z1 + z2 * FIX_0_765366865;                                        \
  z2 = (in0);                                                              \
  z3 = (in4);                                                              \
  tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);                           \
  tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);                           \
  tmp10 = tmp0 + tmp3;                                                     \
  tmp13 = tmp0 - tmp3;                                                     \
  tmp11 = tmp1 + tmp2;                                                     \
  tmp12 = tmp1 - tmp2;                                                     \
  tmp0 = (in7);                                                            \
  tmp1 = (in5);                                                            \
  tmp2 = (in3);                                                            \
  tmp3 = (in1);                                                            \
  z1 = tmp0 + tmp3;                                                        \
  z2 = tmp1 + tmp2;                                                        \
  z3 = tmp0 + tmp2;                                                        \
  z4 = tmp1 + tmp3;                                                        \
  z5 = (z3 + z4) * FIX_1_175875602;                                        \
  tmp0 = tmp0 * FIX_0_298631336;                                           \
  tmp1 = tmp1 * FIX_2_053119869;                                           \
  tmp2 = tmp2 * FIX_3_072711026;                                           \
  tmp3 = tmp3 * FIX_1_501321110;                                           \
  z1 = z1 * (-FIX_0_899976223);                                            \
  z2 = z2 * (-FIX_2_562915447);                                            \
  z3 = z3 * (-FIX_1_961570560);                                            \
  z4 = z4 * (-FIX_0_390180644);                                            \
  z3 += z5;                                                                \
  z4 += z5;                                                                \
  tmp0 += z1 + z3;                                                         \
  tmp1 += z2 + z4;                                                         \
  tmp2 += z2 + z3;                                                         \
  tmp3 += z1 + z4;

/* Dequantize and inverse-transform an (@nby x @nbx)-block grid of @coef
 * with the natural-order table @qt into the (8 nby x 8 nbx) plane @out. */
void jpeg_idct_plane(const int16_t *coef, const uint16_t *qt, int64_t nby,
                     int64_t nbx, uint8_t *out) {
  int64_t stride = nbx * 8;
  for (int64_t by = 0; by < nby; by++) {
    for (int64_t bx = 0; bx < nbx; bx++) {
      const int16_t *in = coef + (by * nbx + bx) * 64;
      int64_t ws[64];
      for (int c = 0; c < 8; c++) {   /* pass 1: columns */
#define DQ(r) ((int64_t)in[(r) * 8 + c] * qt[(r) * 8 + c])
        IDCT_1D(DQ(0), DQ(1), DQ(2), DQ(3), DQ(4), DQ(5), DQ(6), DQ(7))
#undef DQ
        const int sh = CONST_BITS - PASS1_BITS;
        ws[0 * 8 + c] = (int)DESCALE(tmp10 + tmp3, sh);
        ws[7 * 8 + c] = (int)DESCALE(tmp10 - tmp3, sh);
        ws[1 * 8 + c] = (int)DESCALE(tmp11 + tmp2, sh);
        ws[6 * 8 + c] = (int)DESCALE(tmp11 - tmp2, sh);
        ws[2 * 8 + c] = (int)DESCALE(tmp12 + tmp1, sh);
        ws[5 * 8 + c] = (int)DESCALE(tmp12 - tmp1, sh);
        ws[3 * 8 + c] = (int)DESCALE(tmp13 + tmp0, sh);
        ws[4 * 8 + c] = (int)DESCALE(tmp13 - tmp0, sh);
      }
      for (int r = 0; r < 8; r++) {   /* pass 2: rows */
        const int64_t *w = ws + r * 8;
        IDCT_1D(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7])
        const int sh = CONST_BITS + PASS1_BITS + 3;
        uint8_t *o = out + (by * 8 + r) * stride + bx * 8;
        o[0] = range_limit(DESCALE(tmp10 + tmp3, sh));
        o[7] = range_limit(DESCALE(tmp10 - tmp3, sh));
        o[1] = range_limit(DESCALE(tmp11 + tmp2, sh));
        o[6] = range_limit(DESCALE(tmp11 - tmp2, sh));
        o[2] = range_limit(DESCALE(tmp12 + tmp1, sh));
        o[5] = range_limit(DESCALE(tmp12 - tmp1, sh));
        o[3] = range_limit(DESCALE(tmp13 + tmp0, sh));
        o[4] = range_limit(DESCALE(tmp13 - tmp0, sh));
      }
    }
  }
}

/* ---------------------------------------------------------- upsampling */
/* Upsample the real (@dh x @dw) samples of a plane (row stride
 * @in_stride) by @hf x @vf into @out ((dh vf) x (dw hf), row stride
 * @out_stride), as jdsample.c does. Rows above the first and below the
 * last are the edge rows replicated (jdmainct.c's context rows). */
void jpeg_upsample(const uint8_t *in, int64_t in_stride, int64_t dw,
                   int64_t dh, int hf, int vf, uint8_t *out,
                   int64_t out_stride) {
  int fancy_h = dw > 2;
  if (hf == 2 && vf == 1 && fancy_h) {            /* h2v1_fancy_upsample */
    for (int64_t y = 0; y < dh; y++) {
      const uint8_t *s = in + y * in_stride;
      uint8_t *o = out + y * out_stride;
      int v = s[0];
      o[0] = (uint8_t)v;
      o[1] = (uint8_t)((v * 3 + s[1] + 2) >> 2);
      for (int64_t x = 1; x < dw - 1; x++) {
        v = s[x] * 3;
        o[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
      }
      v = s[dw - 1];
      o[2 * dw - 2] = (uint8_t)((v * 3 + s[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)v;
    }
    return;
  }
  if (hf == 1 && vf == 2) {                       /* h1v2_fancy_upsample */
    for (int64_t y = 0; y < dh; y++) {
      const uint8_t *s0 = in + y * in_stride;
      for (int v = 0; v < 2; v++) {
        int64_t yn = v == 0 ? (y > 0 ? y - 1 : 0) : (y < dh - 1 ? y + 1 : y);
        const uint8_t *s1 = in + yn * in_stride;
        int bias = v == 0 ? 1 : 2;
        uint8_t *o = out + (2 * y + v) * out_stride;
        for (int64_t x = 0; x < dw; x++)
          o[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
      }
    }
    return;
  }
  if (hf == 2 && vf == 2 && fancy_h) {            /* h2v2_fancy_upsample */
    for (int64_t y = 0; y < dh; y++) {
      const uint8_t *s0 = in + y * in_stride;
      for (int v = 0; v < 2; v++) {
        int64_t yn = v == 0 ? (y > 0 ? y - 1 : 0) : (y < dh - 1 ? y + 1 : y);
        const uint8_t *s1 = in + yn * in_stride;
        uint8_t *o = out + (2 * y + v) * out_stride;
        int this_ = s0[0] * 3 + s1[0];
        int next = s0[1] * 3 + s1[1];
        o[0] = (uint8_t)((this_ * 4 + 8) >> 4);
        o[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
        int last = this_;
        this_ = next;
        for (int64_t x = 1; x < dw - 1; x++) {
          next = s0[x + 1] * 3 + s1[x + 1];
          o[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
          last = this_;
          this_ = next;
        }
        o[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        o[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
      }
    }
    return;
  }
  /* h2v1_upsample, h2v2_upsample (a downsampled width of 2 or less):
   * replicate */
  for (int64_t y = 0; y < dh * vf; y++) {
    const uint8_t *s = in + (y / vf) * in_stride;
    uint8_t *o = out + y * out_stride;
    for (int64_t x = 0; x < dw * hf; x++) o[x] = s[x / hf];
  }
}

/* ------------------------------------------------------ colour convert */
#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

/* jdcolor.c's ycc_rgb_convert on (@H x @W) planes with row strides
 * @sy, @sc (Cb and Cr share one), into the contiguous (H, W, 3) @out. */
void jpeg_ycc_rgb(const uint8_t *y, const uint8_t *cb, const uint8_t *cr,
                  int64_t H, int64_t W, int64_t sy, int64_t sc,
                  uint8_t *out) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = (-FIX(0.71414)) * x;
    cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
  }
  for (int64_t r = 0; r < H; r++) {
    const uint8_t *py = y + r * sy, *pb = cb + r * sc, *pr = cr + r * sc;
    uint8_t *o = out + r * W * 3;
    for (int64_t c = 0; c < W; c++) {
      int yy = py[c], b = pb[c], rr = pr[c];
      int vr = yy + cr_r[rr];
      int vg = yy + (int)((cb_g[b] + cr_g[rr]) >> SCALEBITS);
      int vb = yy + cb_b[b];
      o[3 * c] = (uint8_t)(vr < 0 ? 0 : vr > 255 ? 255 : vr);
      o[3 * c + 1] = (uint8_t)(vg < 0 ? 0 : vg > 255 ? 255 : vg);
      o[3 * c + 2] = (uint8_t)(vb < 0 ? 0 : vb > 255 ? 255 : vb);
    }
  }
}

// The classifier's offline augmentation in the port's host data library
// (data/img_aug.py): PIL's bilinear affine warp and a baseline JPEG
// encoder whose files are byte-equal to what PIL's ``Image.save`` writes
// at its defaults, so that the port writes the augmented CUB folder as
// the JAX package does, on a host without PIL.
//
// affine_bilinear_u8 is PIL's generic transform (Geometry.c:
// affine_transform with bilinear_filter32RGB): the output pixel centre
// (x + 0.5, y + 0.5) maps to the source point, a point outside the
// image gives 0, else the two clamped columns of the floored row blend
// in f64, the row below joins where it is inside the image (else it is
// the first row again), and the result is truncated to uint8.
//
// jpeg_encode is libjpeg-turbo at what Pillow asks of it by default:
// quality 75, 4:2:0, the standard Huffman tables, JFIF 1.01 with
// density 0/1/1, no restart markers, and a COM marker when given one.
//  * jccolor.c: RGB -> YCbCr through 16-bit fixed-point tables (Y
//    rounds with ONE_HALF, Cb and Cr with ONE_HALF - 1 above the
//    CBCR_OFFSET);
//  * jcsample.c, jcprepct.c: each plane is widened to whole blocks by
//    copying its last column (before the chroma's 2x2 average, which
//    adds a bias alternating 1, 2 along a row) and lengthened by copying
//    its last row (an odd image's last row pairs with itself; the
//    chroma's last row is then copied down to whole blocks);
//  * jfdctint.c: jpeg_fdct_islow on samples less 128;
//  * jcdctmgr.c: quantization by libjpeg-turbo's reciprocals of the
//    table entries times 8, with 16-bit DCT elements (the SIMD build,
//    which PIL runs; its quantize equals the C one with those
//    elements);
//  * jccoefct.c: the blocks of a partial MCU past the image are dummy
//    blocks, AC zero, DC that of the block before them in the MCU;
//  * jchuff.c: DC differences per component, AC runs with ZRL and EOB,
//    a 0x00 stuffed after every 0xFF, the last byte padded with ones.
// PIL's SIMD build and these C sources gave the same bytes on every
// image the tests try; no place needed PIL's bytes to overrule them.
//
// The only shared state is a colour table built once and then only
// read: threads may call both functions at once.
// Build: adlm_tpu_torch/native/__init__.py, with augment.cc and jpeg.cc.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag -> natural order
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c's tables, natural order
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts per length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------------------
// RGB -> YCbCr (jccolor.c)
// ---------------------------------------------------------------------------

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = 128 << kScaleBits;

constexpr int32_t fix(double x) { return (int32_t)(x * (1 << kScaleBits) + 0.5); }

struct ColorTables {
  int32_t t[8][256];  // R_Y G_Y B_Y R_CB G_CB B_CB(=R_CR) G_CR B_CR
  ColorTables() {
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + kOneHalf;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + kCbCrOffset + kOneHalf - 1;
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};

// ---------------------------------------------------------------------------
// Forward DCT (jfdctint.c, jpeg_fdct_islow) and quantization (jcdctmgr.c)
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                  F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                  F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One pass over 8 lines of the block, `stride` apart within a line and
// `step` apart between lines; the first pass keeps PASS1_BITS of
// headroom, the second removes it (the result is 8 times the DCT).
void fdct_pass(int32_t* d, int stride, int step, bool first) {
  const int sh_even = first ? 0 : kPass1Bits;
  const int sh_odd = first ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
  for (int ctr = 0; ctr < 8; ++ctr, d += step) {
    int32_t tmp0 = d[0] + d[7 * stride], tmp7 = d[0] - d[7 * stride];
    int32_t tmp1 = d[stride] + d[6 * stride], tmp6 = d[stride] - d[6 * stride];
    int32_t tmp2 = d[2 * stride] + d[5 * stride], tmp5 = d[2 * stride] - d[5 * stride];
    int32_t tmp3 = d[3 * stride] + d[4 * stride], tmp4 = d[3 * stride] - d[4 * stride];

    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    if (first) {
      d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
      d[4 * stride] = (tmp10 - tmp11) * (1 << kPass1Bits);
    } else {
      d[0] = descale(tmp10 + tmp11, sh_even);
      d[4 * stride] = descale(tmp10 - tmp11, sh_even);
    }
    int32_t z1 = (tmp12 + tmp13) * F_0_541;
    d[2 * stride] = descale(z1 + tmp13 * F_0_765, sh_odd);
    d[6 * stride] = descale(z1 + tmp12 * -F_1_847, sh_odd);

    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175;
    tmp4 *= F_0_298;
    tmp5 *= F_2_053;
    tmp6 *= F_3_072;
    tmp7 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    d[7 * stride] = descale(tmp4 + z1 + z3, sh_odd);
    d[5 * stride] = descale(tmp5 + z2 + z4, sh_odd);
    d[3 * stride] = descale(tmp6 + z2 + z3, sh_odd);
    d[stride] = descale(tmp7 + z1 + z4, sh_odd);
  }
}

// compute_reciprocal with 16-bit DCT elements: x / divisor, rounded, is
// ((|x| + corr) * recip) >> shift with the sign put back.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

struct Component {
  Divisor div[64];     // natural order
  uint8_t qzig[64];    // the table as DQT writes it
};

void make_component(const int* base, Component* c) {
  const int scale = 50;  // jpeg_quality_scaling(75)
  for (int i = 0; i < 64; ++i) {
    int q = (base[i] * scale + 50) / 100;
    q = q < 1 ? 1 : (q > 255 ? 255 : q);
    c->div[i] = reciprocal((uint32_t)q << 3);
  }
  for (int k = 0; k < 64; ++k) {
    int q = (base[kNatural[k]] * scale + 50) / 100;
    c->qzig[k] = (uint8_t)(q < 1 ? 1 : (q > 255 ? 255 : q));
  }
}

// plane: `stride` bytes a row, the block's top left at (y, x); out: the
// quantized coefficients in natural order.
void dct_block(const uint8_t* plane, int stride, int y, int x, const Component& c,
               int16_t* out) {
  int32_t ws[64];
  for (int r = 0; r < 8; ++r)
    for (int k = 0; k < 8; ++k) ws[8 * r + k] = (int32_t)plane[(size_t)(y + r) * stride + x + k] - 128;
  fdct_pass(ws, 1, 8, true);    // rows
  fdct_pass(ws, 8, 1, false);   // columns
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    int32_t q = (int32_t)(((a + c.div[i].corr) * c.div[i].recip) >> c.div[i].shift);
    out[i] = (int16_t)(t < 0 ? -q : q);
  }
}

// ---------------------------------------------------------------------------
// Huffman coding (jchuff.c)
// ---------------------------------------------------------------------------

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

void make_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes* h) {
  std::memset(h, 0, sizeof *h);
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h->code[vals[k]] = (uint16_t)code++;
      h->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t buf = 0;
  int nbits = 0;

  void put(uint32_t bits, int n) {
    buf = (buf << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t byte = (uint8_t)(buf >> nbits);
      out->push_back(byte);
      if (byte == 0xFF) out->push_back(0);
    }
  }
  void flush() {  // pad the last byte with ones
    if (nbits) put(0x7F, 8 - nbits);
  }
};

inline int nbits_of(int v) { return v ? 32 - __builtin_clz((unsigned)v) : 0; }

void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int diff = blk[0] - *last_dc;
  *last_dc = blk[0];
  int a = diff < 0 ? -diff : diff, v = diff < 0 ? diff - 1 : diff;
  int n = nbits_of(a);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put((uint32_t)v, n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int c = blk[kNatural[k]];
    if (c == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    a = c < 0 ? -c : c;
    v = c < 0 ? c - 1 : c;
    n = nbits_of(a);
    int sym = (run << 4) | n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)v, n);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

// ---------------------------------------------------------------------------
// Markers (jcmarker.c)
// ---------------------------------------------------------------------------

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void marker(std::vector<uint8_t>& o, int m, int len) {
  o.push_back(0xFF);
  o.push_back((uint8_t)m);
  put16(o, len);
}

void dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  marker(o, 0xC4, 2 + 1 + 16 + n);
  o.push_back((uint8_t)cls_id);
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

}  // namespace

extern "C" {

// PIL's Image.transform(size, AFFINE, a, BILINEAR) of an (h, w, 3) uint8
// image into an (h, w, 3) output, a[6] mapping output to source.
void affine_bilinear_u8(const uint8_t* src, int h, int w, const double* a, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint8_t* out = dst + ((size_t)y * w + x) * 3;
      double xo = x + 0.5, yo = y + 0.5;
      double xin = a[0] * xo + a[1] * yo + a[2];
      double yin = a[3] * xo + a[4] * yo + a[5];
      if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) {
        out[0] = out[1] = out[2] = 0;
        continue;
      }
      xin -= 0.5;
      yin -= 0.5;
      int xi = xin < 0.0 ? (int)std::floor(xin) : (int)xin;
      int yi = yin < 0.0 ? (int)std::floor(yin) : (int)yin;
      double dx = xin - xi, dy = yin - yi;
      int x0 = xi < 0 ? 0 : (xi >= w ? w - 1 : xi);
      int x1 = xi + 1 < 0 ? 0 : (xi + 1 >= w ? w - 1 : xi + 1);
      int y0 = yi < 0 ? 0 : (yi >= h ? h - 1 : yi);
      const uint8_t* r0 = src + (size_t)y0 * w * 3;
      const uint8_t* r1 = yi + 1 >= 0 && yi + 1 < h ? src + (size_t)(yi + 1) * w * 3 : nullptr;
      for (int b = 0; b < 3; ++b) {
        double v1 = r0[x0 * 3 + b] + (r0[x1 * 3 + b] - r0[x0 * 3 + b]) * dx;
        double v2 = r1 ? r1[x0 * 3 + b] + (r1[x1 * 3 + b] - r1[x0 * 3 + b]) * dx : v1;
        out[b] = (uint8_t)(v1 + (v2 - v1) * dy);
      }
    }
  }
}

// PIL's default JPEG of an (h, w, 3) uint8 RGB image, with a COM marker
// of `ncomment` bytes when that is not 0.  Writes at most `cap` bytes to
// `out` and returns the file's length, or 0 if `cap` is too small.
size_t jpeg_encode(const uint8_t* rgb, int h, int w, const uint8_t* comment, int ncomment,
                   uint8_t* out, size_t cap) {
  static const ColorTables ct;  // built once, read only (thread-safe init)
  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  const int lw = 16 * mcu_cols, lh = 16 * mcu_rows;  // luma plane, whole MCUs
  const int cw = 8 * mcu_cols, ch = 8 * mcu_rows;    // chroma planes
  const int lbw = (w + 7) / 8, lbh = (h + 7) / 8;    // luma blocks inside the image

  // Y at full size and Cb, Cr at full size for one pair of rows, every
  // row and column past the image a copy of the last one.
  std::vector<uint8_t> Y((size_t)lh * lw), Cb((size_t)ch * cw), Cr((size_t)ch * cw);
  std::vector<uint8_t> cbrow(2 * (size_t)lw), crrow(2 * (size_t)lw);
  const int crows = (h + 1) / 2;  // chroma rows from the image
  for (int y = 0; y < lh; ++y) {
    const uint8_t* s = rgb + (size_t)(y < h ? y : h - 1) * w * 3;
    uint8_t* yr = &Y[(size_t)y * lw];
    uint8_t* cbr = &cbrow[(size_t)(y & 1) * lw];
    uint8_t* crr = &crrow[(size_t)(y & 1) * lw];
    for (int x = 0; x < lw; ++x) {
      const uint8_t* p = s + 3 * (x < w ? x : w - 1);
      int r = p[0], g = p[1], b = p[2];
      yr[x] = (uint8_t)((ct.t[0][r] + ct.t[1][g] + ct.t[2][b]) >> kScaleBits);
      cbr[x] = (uint8_t)((ct.t[3][r] + ct.t[4][g] + ct.t[5][b]) >> kScaleBits);
      crr[x] = (uint8_t)((ct.t[5][r] + ct.t[6][g] + ct.t[7][b]) >> kScaleBits);
    }
    if (y & 1 && y / 2 < crows) {  // h2v2_downsample of the pair
      for (int x = 0, bias = 1; x < cw; ++x, bias ^= 3) {
        const int i = 2 * x, j = lw + 2 * x;
        Cb[(size_t)(y / 2) * cw + x] =
            (uint8_t)((cbrow[i] + cbrow[i + 1] + cbrow[j] + cbrow[j + 1] + bias) >> 2);
        Cr[(size_t)(y / 2) * cw + x] =
            (uint8_t)((crrow[i] + crrow[i + 1] + crrow[j] + crrow[j + 1] + bias) >> 2);
      }
    }
  }
  for (int y = crows; y < ch; ++y) {
    std::memcpy(&Cb[(size_t)y * cw], &Cb[(size_t)(crows - 1) * cw], cw);
    std::memcpy(&Cr[(size_t)y * cw], &Cr[(size_t)(crows - 1) * cw], cw);
  }

  Component luma, chroma;
  make_component(kStdLuma, &luma);
  make_component(kStdChroma, &chroma);
  HuffCodes dc_l, ac_l, dc_c, ac_c;
  make_codes(kDcLumaBits, kDcVals, &dc_l);
  make_codes(kAcLumaBits, kAcLumaVals, &ac_l);
  make_codes(kDcChromaBits, kDcVals, &dc_c);
  make_codes(kAcChromaBits, kAcChromaVals, &ac_c);

  std::vector<uint8_t> o;
  o.reserve((size_t)h * w / 4 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  marker(o, 0xE0, 16);  // JFIF 1.01, no units, density 1:1, no thumbnail
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + 14);
  if (ncomment > 0) {
    marker(o, 0xFE, 2 + ncomment);
    o.insert(o.end(), comment, comment + ncomment);
  }
  marker(o, 0xDB, 67);
  o.push_back(0);
  o.insert(o.end(), luma.qzig, luma.qzig + 64);
  marker(o, 0xDB, 67);
  o.push_back(1);
  o.insert(o.end(), chroma.qzig, chroma.qzig + 64);
  marker(o, 0xC0, 17);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  const uint8_t comps[10] = {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 10);
  dht(o, 0x00, kDcLumaBits, kDcVals);
  dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  dht(o, 0x01, kDcChromaBits, kDcVals);
  dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  marker(o, 0xDA, 12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + 10);

  BitWriter bw{&o};
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int16_t blk[6][64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (int n = 0; n < 4; ++n) {
        const int by = 2 * my + n / 2, bx = 2 * mx + n % 2;
        if (by < lbh && bx < lbw) {
          dct_block(Y.data(), lw, 8 * by, 8 * bx, luma, blk[n]);
        } else {  // a dummy block: AC zero, DC that of the block before it
          // (jccoefct.c takes a bottom row's from the block before the
          // row, which the row's first dummy block has copied)
          std::memset(blk[n], 0, sizeof blk[n]);
          blk[n][0] = blk[n - 1][0];
        }
      }
      dct_block(Cb.data(), cw, 8 * my, 8 * mx, chroma, blk[4]);
      dct_block(Cr.data(), cw, 8 * my, 8 * mx, chroma, blk[5]);
      for (int n = 0; n < 4; ++n) encode_block(bw, blk[n], &dc_y, dc_l, ac_l);
      encode_block(bw, blk[4], &dc_cb, dc_c, ac_c);
      encode_block(bw, blk[5], &dc_cr, dc_c, ac_c);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  if (o.size() > cap) return 0;
  std::memcpy(out, o.data(), o.size());
  return o.size();
}

}  // extern "C"

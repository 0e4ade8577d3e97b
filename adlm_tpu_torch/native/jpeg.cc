// JPEG decoder of the port's host data library, bit-equal to the pixels
// PIL gives (Pillow decodes through libjpeg-turbo with its defaults:
// the integer "islow" IDCT, fancy chroma upsampling and fixed-point
// YCbCr->RGB), so that the port reads the JPEG datasets (PASCAL VOC,
// CUB-200, Stanford Cars) as the JAX package does, on a host without PIL.
//
// Reads: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2), 8-bit, 1 component (grey) or 3 (YCbCr, or
// RGB where libjpeg-turbo takes it so: an Adobe APP14 marker with
// transform 0, or component ids 'R','G','B' without JFIF), sampling
// 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2), any size, restart markers,
// 8- and 16-bit quantization tables.  Refuses (code 2) arithmetic
// coding, lossless and hierarchical frames, 12-bit samples, 2 or 4
// components and other sampling factors; refuses (code 1) anything
// corrupt or truncated, where libjpeg-turbo would warn and pad.
//
// What libjpeg-turbo does, and this file with it:
//  * the entropy decoder stores every block's coefficients (int16, as
//    JCOEF), baseline and progressive alike (jdhuff.c, jdphuff.c: the
//    progressive AC refinement's correction bits and EOB runs);
//  * jidctint.c's jpeg_idct_islow: dequantize in integers, CONST_BITS
//    13, PASS1_BITS 2, DESCALE rounding, with the 16-bit intermediates
//    and the saturating output of its SIMD version, which PIL runs
//    (idct_islow below says where that differs from the C version);
//  * jdsample.c: h2v1 and h2v2 fancy upsampling where the downsampled
//    width exceeds 2 (else box replication), reading only the
//    downsampled width, the context rows above the first and below the
//    last real row being those rows themselves (jdmainct.c);
//  * jdcolor.c: build_ycc_rgb_table's fixed-point tables (SCALEBITS 16)
//    and the sample range limit.
//  * No block smoothing: a complete progressive file leaves no
//    coefficient bit unknown, so libjpeg-turbo applies none; a file
//    that would need it is refused.
//
// The decoder keeps no global state: every call owns its tables and
// buffers, so threads may decode at once (ctypes releases the GIL).
// Build: adlm_tpu_torch/native/__init__.py, with augment.cc.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order, with libjpeg's 16 extra entries that absorb
// a run past the block's end in corrupt data (jutils.c)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
  int code;  // 1: corrupt or truncated; 2: a variant the port does not read
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{1, msg}; }
[[noreturn]] void refuse(const std::string& msg) { throw Failure{2, msg}; }

std::string hex2(int v) {
  char b[8];
  std::snprintf(b, sizeof b, "0x%02X", v);
  return b;
}

constexpr int kLook = 9;  // bits of the Huffman fast lookup

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int nvals = 0;
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLook] = {};  // (length << 8) | symbol, 0: longer code

  // jdhuff.c::jpeg_make_d_derived_tbl, with its checks
  void derive(bool dc) {
    int size[257], code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) size[p++] = l;
    size[p] = 0;
    int c = 0, si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1 << si)) fail("bad Huffman table");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - code[p];
        p += bits[l];
        maxcode[l] = code[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLook; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int first = code[p] << (kLook - l);
        for (int j = 0; j < (1 << (kLook - l)); ++j)
          look[first + j] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) fail("bad Huffman table: a DC symbol over 15");
  }
};

// The entropy-coded segment's bits, MSB first, FF 00 unstuffed.  At a
// marker or the end of the data it appends zero bits and counts them:
// a decoder that consumes one of them has run past its data.
struct Bits {
  const uint8_t* d;
  size_t pos, end;
  uint64_t acc = 0;
  int n = 0;     // bits in acc
  int pad = 0;   // zero bits appended past the data
  bool stop = false;

  void fill() {
    while (n <= 56) {
      unsigned b = 0;
      if (!stop) {
        if (pos >= end) {
          stop = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < end && d[q] == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            stop = true;  // a marker: pos stays on its first FF
          }
        }
      }
      if (stop) pad += 8;
      acc |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  inline unsigned peek(int k) {
    if (n < k) fill();
    return static_cast<unsigned>(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    n -= k;
  }
  inline unsigned get(int k) {
    if (k == 0) return 0;
    unsigned v = peek(k);
    skip(k);
    return v;
  }
  void reset() {
    acc = 0;
    n = 0;
    pad = 0;
    stop = false;
  }
  bool overrun() const { return pad > n; }
};

inline int decode(Bits& b, const Huffman& h) {
  unsigned w = b.peek(16);
  unsigned e = h.look[w >> (16 - kLook)];
  if (e) {
    b.skip(e >> 8);
    return e & 255;
  }
  int l = kLook + 1;
  int32_t code = w >> (16 - l);
  while (code > h.maxcode[l]) {
    if (++l > 16) fail("bad Huffman code");
    code = w >> (16 - l);
  }
  b.skip(l);
  int idx = code + h.valoffset[l];
  if (idx < 0 || idx >= h.nvals) fail("bad Huffman code");
  return h.vals[idx];
}

inline int extend(unsigned v, int s) {
  return static_cast<int>(v) < (1 << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                               : static_cast<int>(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int cw = 0, ch = 0;    // downsampled width and height
  int bw = 0, bh = 0;    // blocks that hold samples
  int sbw = 0, sbh = 0;  // blocks allocated: whole MCUs
  std::vector<int16_t> coef;
  int16_t q[64] = {};    // the table latched at the component's first scan
  bool latched = false;
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
  int coef_bits[64];
  Component() { std::memset(coef_bits, 0xFF, sizeof coef_bits); }  // -1: unsent
  int16_t* block(int bx, int by) { return coef.data() + (static_cast<size_t>(by) * sbw + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t size, pos = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  int eobrun = 0;
  int scans = 0;

  Decoder(const uint8_t* data, size_t n) : d(data), size(n) {}

  int u8() {
    if (pos >= size) fail("truncated: the file ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c::next_marker: skip stray bytes, then FF fill bytes
  int next_marker() {
    for (;;) {
      while (pos < size && d[pos] != 0xFF) ++pos;
      while (pos < size && d[pos] == 0xFF) ++pos;
      if (pos >= size) fail("truncated: the file ends before its EOI marker");
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  // a marker segment's body: [pos, returned end)
  size_t segment() {
    int len = u16();
    if (len < 2) fail("marker segment of length " + std::to_string(len));
    size_t end = pos + len - 2;
    if (end > size) fail("truncated: a marker segment runs past the end of the file");
    return end;
  }

  void parse_sof(int marker) {
    if (frame) fail("a second frame header (SOF)");
    size_t end = segment();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision == 12) refuse("12-bit precision");
    if (precision != 8) fail("sample precision " + std::to_string(precision));
    if (height == 0) fail("image height 0 (a DNL marker): not read");
    if (width == 0) fail("image width 0");
    if (ncomp == 2 || ncomp == 4)
      refuse(std::to_string(ncomp) + " components" +
             (ncomp == 4 ? " (CMYK or YCCK)" : ""));
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + " components");
    if (end != pos + 3 * static_cast<size_t>(ncomp)) fail("frame header of a wrong length");
    progressive = marker == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
      if (c.tq > 3) fail("quantization table " + std::to_string(c.tq));
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp && ncomp > 1; ++i) {
      const Component& c = comp[i];
      int hr = hmax / c.h, vr = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((hr == 1 && vr == 1) || (hr == 2 && vr == 1) || (hr == 2 && vr == 2));
      if (!ok) {
        std::string f;
        for (int j = 0; j < ncomp; ++j)
          f += (j ? "," : "") + std::to_string(comp[j].h) + "x" + std::to_string(comp[j].v);
        refuse("sampling factors " + f + " (the port reads 4:4:4, 4:2:2 and 4:2:0)");
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.cw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ch = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.cw + 7) / 8;
      c.bh = (c.ch + 7) / 8;
      c.sbw = mcux * c.h;
      c.sbh = mcuy * c.v;
    }
    frame = true;
  }

  // allocate the coefficient arrays (after the header only: jpeg_header
  // reads no further)
  void allocate() {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.coef.assign(static_cast<size_t>(c.sbw) * c.sbh * 64, 0);
    }
  }

  void parse_dqt() {
    size_t end = segment();
    while (pos < end) {
      int pq = u8();
      int t = pq & 15;
      pq >>= 4;
      if (t > 3) fail("quantization table " + std::to_string(t));
      if (pq > 1) fail("quantization table precision " + std::to_string(pq));
      if (pos + (pq ? 128 : 64) > end) fail("truncated quantization table");
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[t] = true;
    }
    if (pos != end) fail("DQT segment of a wrong length");
  }

  void parse_dht() {
    size_t end = segment();
    while (pos < end) {
      int index = u8();
      Huffman h;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += h.bits[l] = static_cast<uint8_t>(u8());
      if (count > 256 || pos + count > end) fail("bad Huffman table");
      for (int i = 0; i < count; ++i) h.vals[i] = static_cast<uint8_t>(u8());
      h.nvals = count;
      h.defined = true;
      bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index > 3) fail("Huffman table index " + std::to_string(index));
      (is_ac ? ac : dc)[index] = h;
    }
    if (pos != end) fail("DHT segment of a wrong length");
  }

  // jdmarker.c::get_interesting_appn: JFIF (APP0) and Adobe (APP14)
  void parse_app(int marker) {
    size_t end = segment();
    size_t len = end - pos;
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void restart(Bits& b, int expect) {
    pos = b.pos;
    int m = next_marker();
    if (m != 0xD0 + expect)
      fail("corrupt: expected restart marker RST" + std::to_string(expect) + ", found " +
           hex2(m));
    b.pos = pos;
    b.reset();
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    eobrun = 0;
  }

  void block_sequential(Bits& b, Component& c, int16_t* blk) {
    int s = decode(b, dc[c.dc_tbl]);
    int diff = s ? extend(b.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    const Huffman& t = ac[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      int rs = decode(b, t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(Bits& b, Component& c, int16_t* blk, int al) {
    int s = decode(b, dc[c.dc_tbl]);
    int diff = s ? extend(b.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
  }

  void block_ac_first(Bits& b, const Huffman& t, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode(b, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(b.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c::decode_mcu_AC_refine
  void block_ac_refine(Bits& b, const Huffman& t, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -p1;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(b, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.get(1) ? p1 : m1;  // a newly nonzero coefficient is +-1 in this bit
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (b.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && b.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  void parse_sos() {
    if (!frame) fail("a scan (SOS) before the frame header");
    size_t end = segment();
    int ns = u8();
    if (ns < 1 || ns > 4 || end != pos + 2 * static_cast<size_t>(ns) + 3)
      fail("bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tables = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("a scan names component " + std::to_string(id) + ", not in the frame");
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) fail("a scan names a component twice");
      c->dc_tbl = tables >> 4;
      c->ac_tbl = tables & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("bad Huffman table selector");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    ++scans;
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      if (!c->latched) {  // jdinput.c::latch_quant_tables
        if (!qt_defined[c->tq]) fail("no quantization table " + std::to_string(c->tq));
        for (int k = 0; k < 64; ++k) c->q[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
    }
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) blocks_in_mcu += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
    if (blocks_in_mcu > 10) fail("too many blocks in an MCU");

    bool dc_band = true, refine = false;
    if (progressive) {
      dc_band = ss == 0;
      refine = ah != 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("bad progression parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    } else {
      for (int i = 0; i < ns; ++i)
        for (int k = 0; k < 64; ++k) sc[i]->coef_bits[k] = 0;
    }
    // the tables the scan decodes with
    for (int i = 0; i < ns; ++i) {
      bool need_dc = !progressive || (dc_band && !refine);
      bool need_ac = !progressive || !dc_band;
      if (need_dc) {
        Huffman& h = dc[sc[i]->dc_tbl];
        if (!h.defined) fail("no DC Huffman table " + std::to_string(sc[i]->dc_tbl));
        h.derive(true);
      }
      if (need_ac) {
        Huffman& h = ac[sc[i]->ac_tbl];
        if (!h.defined) fail("no AC Huffman table " + std::to_string(sc[i]->ac_tbl));
        h.derive(false);
      }
    }

    Bits b{d, pos, size};
    eobrun = 0;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    int mx = ns == 1 ? sc[0]->bw : mcux;
    int my = ns == 1 ? sc[0]->bh : mcuy;
    int64_t total = static_cast<int64_t>(mx) * my;
    int left = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (left == 0) {
          restart(b, next_rst);
          next_rst = (next_rst + 1) & 7;
          left = restart_interval;
        }
        --left;
      }
      int x = static_cast<int>(m % mx), y = static_cast<int>(m / mx);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            int16_t* blk = c.block(x * nh + bx, y * nv + by);
            if (!progressive) {
              block_sequential(b, c, blk);
            } else if (dc_band) {
              if (refine) {
                if (b.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              } else {
                block_dc_first(b, c, blk, al);
              }
            } else if (refine) {
              block_ac_refine(b, ac[c.ac_tbl], blk, ss, se, al);
            } else {
              block_ac_first(b, ac[c.ac_tbl], blk, ss, se, al);
            }
          }
      }
      if (b.overrun()) fail("truncated or corrupt: the entropy-coded data ends inside a scan");
    }
    pos = b.pos;
  }

  // jdcoefct.c::smoothing_ok: libjpeg-turbo smooths the blocks of a
  // progressive image whose first nine AC coefficients' bits are not
  // all known
  bool would_smooth() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      if (comp[i].coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (comp[i].coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // SOI, then markers up to the frame header (header_only) or to EOI
  void run(bool header_only) {
    if (size < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          parse_sof(m);
          if (header_only) return;
          allocate();
          break;
        case 0xC3:
          refuse("lossless coding (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          refuse("hierarchical coding (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          refuse("arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC4:
          parse_dht();
          break;
        case 0xCC:  // DAC: arithmetic-coding conditioning, whose SOF is refused
        case 0xFE:  // COM
        case 0xDC:  // DNL
          pos = segment();
          break;
        case 0xDB:
          parse_dqt();
          break;
        case 0xDD: {
          size_t end = segment();
          if (end != pos + 2) fail("DRI segment of a wrong length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          if (header_only) fail("a scan before the frame header");
          parse_sos();
          break;
        case 0xD9:
          if (header_only || !frame) fail("no frame header (SOF) before EOI");
          if (!scans) fail("no scan before EOI");
          if (would_smooth())
            refuse("progressive scans that leave coefficient bits unsent "
                   "(libjpeg-turbo smooths its blocks)");
          return;
        case 0xD8:
          fail("a second SOI marker");
        case 0x01:  // TEM, no segment
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:  // a stray RSTn
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            parse_app(m);
            break;
          }
          fail("unknown marker " + hex2(m));
      }
    }
  }

  // ---- output ----------------------------------------------------------

  // One 1-D pass of jidctint.c::jpeg_idct_islow (CONST_BITS 13), before
  // its DESCALE, as libjpeg-turbo's SIMD version computes it: in0 + in4,
  // in0 - in4 and the odd part's z3 = in7 + in3, z4 = in5 + in1 are
  // 16-bit sums; the products and the rest are exact.
  static inline void idct_1d(const int* x, int64_t* o) {
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int64_t z1 = (int64_t(x[2]) + x[6]) * F0541;
    int64_t tmp2 = z1 - x[6] * F1847, tmp3 = z1 + x[2] * F0765;
    int64_t tmp0 = int64_t(int16_t(x[0] + x[4])) * 8192;
    int64_t tmp1 = int64_t(int16_t(x[0] - x[4])) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
    int64_t z3 = int16_t(x[7] + x[3]), z4 = int16_t(x[5] + x[1]);
    int64_t z5 = (z3 + z4) * F1175;
    z1 = (t0 + t3) * -F0899;
    int64_t z2 = (t1 + t2) * -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    t0 = t0 * F0298 + z1 + z3;
    t1 = t1 * F2053 + z2 + z4;
    t2 = t2 * F3072 + z2 + z3;
    t3 = t3 * F1501 + z1 + z4;
    o[0] = tmp10 + t3;
    o[7] = tmp10 - t3;
    o[1] = tmp11 + t2;
    o[6] = tmp11 - t2;
    o[2] = tmp12 + t1;
    o[5] = tmp12 - t1;
    o[3] = tmp13 + t0;
    o[4] = tmp13 - t0;
  }

  static inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

  // jpeg_idct_islow on one block into 8 rows of a plane, as PIL's
  // libjpeg-turbo runs it (its SIMD version): 16-bit dequantized
  // coefficients; a column whose AC terms are all zero is its DC << 2 in
  // 16 bits, any other column's outputs saturate to 16 bits; each sample
  // saturates to [0, 255] after the +128 shift, where the C version's
  // range-limit table (IDCT_range_limit & RANGE_MASK) would wrap values
  // past +-512.  Files from a real encoder stay inside every one of these
  // ranges; the wraps and saturations show only on hand-made tables.
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    int ws[64], x[8];
    int64_t o[8];
    for (int c = 0; c < 8; ++c) {
      for (int r = 0; r < 8; ++r) x[r] = int16_t(in[8 * r + c] * q[8 * r + c]);
      if (!x[1] && !x[2] && !x[3] && !x[4] && !x[5] && !x[6] && !x[7]) {
        for (int r = 0; r < 8; ++r) ws[8 * r + c] = int16_t(x[0] * 4);
        continue;
      }
      idct_1d(x, o);
      for (int r = 0; r < 8; ++r) {
        int64_t v = descale(o[r], 11);
        ws[8 * r + c] = static_cast<int>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
      }
    }
    for (int r = 0; r < 8; ++r) {
      uint8_t* row = out + static_cast<size_t>(r) * stride;
      idct_1d(ws + 8 * r, o);
      for (int c = 0; c < 8; ++c) {
        int64_t v = descale(o[c], 18) + 128;
        row[c] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
  }

  // one output row of a component, upsampled to full width (>= width)
  static void upsample_row(const uint8_t* plane, int stride, const Component& c, int hr,
                           int vr, int y, uint8_t* out, int* colsum) {
    const int cw = c.cw;
    if (hr == 1) {  // 4:4:4 (vr is 1 too)
      std::memcpy(out, plane + static_cast<size_t>(y) * stride, cw);
      return;
    }
    const bool fancy = cw > 2;
    if (vr == 1) {  // h2v1
      const uint8_t* in = plane + static_cast<size_t>(y) * stride;
      if (!fancy) {
        for (int x = 0; x < cw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
        return;
      }
      out[0] = in[0];
      out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < cw - 1; ++x) {
        int v = in[x] * 3;
        out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      int v = in[cw - 1] * 3;
      out[2 * cw - 2] = static_cast<uint8_t>((v + in[cw - 2] + 1) >> 2);
      out[2 * cw - 1] = in[cw - 1];
      return;
    }
    // h2v2: the nearer row and the other one, clamped to the real rows
    const int i = y >> 1;
    const uint8_t* in0 = plane + static_cast<size_t>(i) * stride;
    if (!fancy) {
      for (int x = 0; x < cw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
      return;
    }
    int far = (y & 1) ? std::min(i + 1, c.ch - 1) : std::max(i - 1, 0);
    const uint8_t* in1 = plane + static_cast<size_t>(far) * stride;
    for (int x = 0; x < cw; ++x) colsum[x] = in0[x] * 3 + in1[x];
    out[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
    for (int x = 1; x < cw - 1; ++x) {
      int t = colsum[x] * 3;
      out[2 * x] = static_cast<uint8_t>((t + colsum[x - 1] + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((t + colsum[x + 1] + 7) >> 4);
    }
    out[2 * cw - 2] = static_cast<uint8_t>((colsum[cw - 1] * 3 + colsum[cw - 2] + 8) >> 4);
    out[2 * cw - 1] = static_cast<uint8_t>((colsum[cw - 1] * 4 + 7) >> 4);
  }

  void output(uint8_t* out) {
    std::vector<uint8_t> planes[3];
    int stride[3];
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      stride[ci] = c.bw * 8;
      planes[ci].resize(static_cast<size_t>(stride[ci]) * c.bh * 8);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(bx, by), c.q,
                     planes[ci].data() + static_cast<size_t>(by) * 8 * stride[ci] + bx * 8,
                     stride[ci]);
    }
    if (ncomp == 1) {
      for (int y = 0; y < height; ++y)
        std::memcpy(out + static_cast<size_t>(y) * width,
                    planes[0].data() + static_cast<size_t>(y) * stride[0], width);
      return;
    }
    // jdcolor.c::build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    const bool rgb = colour_is_rgb();
    const int wide = 2 * (mcux * 8 * hmax) + 16;
    std::vector<uint8_t> rows(3 * static_cast<size_t>(wide));
    std::vector<int> colsum(wide);
    for (int y = 0; y < height; ++y) {
      uint8_t* r3[3];
      for (int ci = 0; ci < 3; ++ci) {
        const Component& c = comp[ci];
        r3[ci] = rows.data() + ci * static_cast<size_t>(wide);
        upsample_row(planes[ci].data(), stride[ci], c, hmax / c.h, vmax / c.v, y, r3[ci],
                     colsum.data());
      }
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      if (rgb) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = r3[0][x];
          o[3 * x + 1] = r3[1][x];
          o[3 * x + 2] = r3[2][x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        int yy = r3[0][x], cb = r3[1][x], cr = r3[2][x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }

  // jdapimin.c::default_decompress_parms for 3 components
  bool colour_is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
};

int report(const Failure& f, char* err, int err_size) {
  if (err && err_size > 0) std::snprintf(err, err_size, "%s", f.msg.c_str());
  return f.code;
}

}  // namespace

extern "C" {

// The frame header: hwc = (height, width, components).  0, or the
// failure's code with its message in err.
int jpeg_header(const uint8_t* data, size_t size, int* hwc, char* err, int err_size) {
  try {
    Decoder dec(data, size);
    dec.run(true);
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.ncomp;
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_size);
  } catch (const std::bad_alloc&) {
    return report(Failure{1, "out of memory"}, err, err_size);
  }
}

// Decode into out (h, w, c) uint8, which must be the header's shape.
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int h, int w, int c,
                char* err, int err_size) {
  try {
    Decoder dec(data, size);
    dec.run(false);
    if (dec.height != h || dec.width != w || dec.ncomp != c)
      fail("the output buffer does not match the frame header");
    dec.output(out);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_size);
  } catch (const std::bad_alloc&) {
    return report(Failure{1, "out of memory"}, err, err_size);
  }
}

}  // extern "C"

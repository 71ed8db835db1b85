// A JPEG decoder that gives libjpeg-turbo's bits: the decoder that PIL
// bundles and the JAX package's native loader links, as both call it
// (out_color_space JCS_RGB, or JCS_CMYK for 4 components, every other
// setting at its default).
//
//   markers   SOI, APPn (JFIF, Adobe's transform flag), DQT (8- and 16-bit
//             tables), SOF0/SOF1/SOF2 at 8-bit precision, DHT, SOS, DRI and
//             RSTn, EOI.  Arithmetic coding, 12-bit, lossless and
//             hierarchical frames throw.
//   entropy   Huffman with 0xFF00 stuffing and a 9-bit lookahead table;
//             sequential MCUs; progressive DC first/refine and AC
//             first/refine scans with EOBRUN (jdhuff.c, jdphuff.c).
//   IDCT      jpeg_idct_islow (jidctint.c): CONST_BITS 13, PASS1_BITS 2,
//             the post-IDCT range-limit table.
//   upsample  jdsample.c: fancy h2v1, h1v2 and h2v2 with their edge and
//             context-row cases (the rows above the first and below the
//             last repeat them, jdmainct.c), the plain h2v1 / h2v2 where
//             the component is at most 2 samples wide, the generic
//             integral-factor method otherwise.
//   colour    jdcolor.c's fixed-point YCbCr->RGB tables; grayscale
//             replicated; RGB (Adobe transform 0, or 'R','G','B' ids)
//             passed through; YCCK->CMYK, then PIL's CMYK->RGB.
//
// A file whose entropy data ends before its last scan is complete throws
// as truncated, as PIL's reader does; a marker met inside a scan pads the
// scan with zero bits, as libjpeg-turbo does.
#include <algorithm>
#include <cstring>

#include "image.h"

namespace uvcimg {
namespace {

// zigzag -> natural order, with libjpeg's 16 extra entries that keep a
// corrupt run length inside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool present = false;
  uint8_t look_len[512];   // 0: code longer than 9 bits
  uint8_t look_sym[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, hs = 1, vs = 1, tq = 0;
  int dw = 0, dh = 0;          // downsampled size (samples)
  int wb = 0, hb = 0;          // blocks holding real samples
  int bw = 0, bh = 0;          // blocks allocated (MCU-padded)
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
  int16_t* block(int by, int bx) {
    return coef.data() + (size_t(by) * bw + bx) * 64;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;     // set once a marker stops the entropy data
  int eof_pad = 0;    // zero bytes inserted past the end of the file

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (marker == 0) {
        if (p >= end) {
          ++eof_pad;
        } else if (*p != 0xFF) {
          b = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q >= end) {
            ++eof_pad;
            p = end;
          } else if (*q == 0) {
            b = 0xFF;
            p = q + 1;
          } else {
            marker = *q;  // p stays on the marker's 0xFF
          }
        }
      }
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  int get(int n) {  // n <= 16
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = int(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  int peek(int n) {
    if (bits < n) fill();
    return int(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  bool truncated() const { return eof_pad > 0 && bits < 8 * eof_pad; }
  void reset() {
    buf = 0;
    bits = 0;
    eof_pad = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((~0u << s) + 1) : v;
}

int decode_huff(BitReader& br, const Huff& t) {
  const int look = br.peek(9);
  const int l = t.look_len[look];
  if (l) {
    br.skip(l);
    return t.look_sym[look];
  }
  const int bits16 = br.peek(16);
  int len = 10;
  while (len <= 16 && (bits16 >> (16 - len)) > t.maxcode[len]) ++len;
  if (len > 16) {  // libjpeg-turbo: a corrupt code decodes as 0
    br.skip(16);
    return 0;
  }
  br.skip(len);
  return t.vals[((bits16 >> (16 - len)) + t.valoffset[len]) & 0xFF];
}

void build_huff(Huff& t, const uint8_t* counts, const uint8_t* vals,
                int nvals) {
  uint16_t code[257];
  uint8_t size[257];
  int k = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) size[k++] = uint8_t(l);
  size[k] = 0;
  int c = 0, si = size[0];
  k = 0;
  while (size[k]) {
    while (size[k] == si) code[k++] = uint16_t(c++);
    if (c >= (1 << si)) throw ImageError("bad Huffman table");
    c <<= 1;
    ++si;
  }
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - code[p];
      p += counts[l - 1];
      t.maxcode[l] = code[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look_len, 0, sizeof t.look_len);
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int look = code[p] << (9 - l);
      for (int r = 1 << (9 - l); r > 0; --r, ++look) {
        t.look_len[look] = uint8_t(l);
        t.look_sym[look] = vals[p];
      }
    }
  }
  std::memset(t.vals, 0, sizeof t.vals);
  std::memcpy(t.vals, vals, size_t(nvals));
  t.present = true;
}

// ---------------------------------------------------------------------------
// jpeg_idct_islow
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

struct RangeLimit {
  uint8_t idct[1024];  // indexed by (x & 1023) for an IDCT output x
  RangeLimit() {
    for (int r = 0; r < 1024; ++r) {
      int v;
      if (r < 128) v = r + 128;
      else if (r < 512) v = 255;
      else if (r < 896) v = 0;
      else v = r - 896;
      idct[r] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = int(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, n));
    wp[56] = int(descale(tmp10 - tmp3, n));
    wp[8] = int(descale(tmp11 + tmp2, n));
    wp[48] = int(descale(tmp11 - tmp2, n));
    wp[16] = int(descale(tmp12 + tmp1, n));
    wp[40] = int(descale(tmp12 - tmp1, n));
    wp[24] = int(descale(tmp13 + tmp0, n));
    wp[32] = int(descale(tmp13 - tmp0, n));
  }
  const int n2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t v = kRange.idct[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.idct[int(descale(tmp10 + tmp3, n2)) & 1023];
    op[7] = kRange.idct[int(descale(tmp10 - tmp3, n2)) & 1023];
    op[1] = kRange.idct[int(descale(tmp11 + tmp2, n2)) & 1023];
    op[6] = kRange.idct[int(descale(tmp11 - tmp2, n2)) & 1023];
    op[2] = kRange.idct[int(descale(tmp12 + tmp1, n2)) & 1023];
    op[5] = kRange.idct[int(descale(tmp12 - tmp1, n2)) & 1023];
    op[3] = kRange.idct[int(descale(tmp13 + tmp0, n2)) & 1023];
    op[4] = kRange.idct[int(descale(tmp13 - tmp0, n2)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// colour tables (jdcolor.c)
// ---------------------------------------------------------------------------

struct YccTables {
  // cr_g + cb_g stays within 32 bits (|x| <= 128), as libjpeg-turbo's
  // JLONG sums do
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int sb = 16;
    const int64_t half = int64_t(1) << (sb - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + half) >> sb);
      cb_b[i] = int((fix(1.77200) * x + half) >> sb);
      cr_g[i] = int(-fix(0.71414) * x);
      cb_g[i] = int(-fix(0.34414) * x + half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline void ycc_to_rgb(int y, int cb, int cr, uint8_t* o) {
  o[0] = clamp255(y + kYcc.cr_r[cr]);
  o[1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
  o[2] = clamp255(y + kYcc.cb_b[cb]);
}

// PIL's cmyk2rgb after the "CMYK;I" unpack (each byte inverted)
inline uint8_t muldiv255(int a, int b) {
  const int t = a * b + 128;
  return uint8_t(((t >> 8) + t) >> 8);
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

enum class ColorSpace { Gray, YCbCr, RGB, CMYK, YCCK };

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0;
  bool progressive = false;
  bool frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Component> comps;
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) throw ImageError("truncated JPEG data");
    return data[pos++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }

  // The next marker code, skipping fill bytes and (as libjpeg-turbo's
  // next_marker) garbage between segments.
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_frame(int marker) {
    if (frame) throw ImageError("JPEG with more than one frame");
    const size_t len = size_t(u16());
    const size_t stop = pos + len - 2;
    const int precision = u8();
    if (precision != 8)
      throw ImageError("JPEG sample precision " + std::to_string(precision) +
                       " is not supported (8-bit only)");
    height = u16();
    width = u16();
    const int nc = u8();
    if (height == 0) throw ImageError("JPEG frame without a height (DNL)");
    if (width == 0) throw ImageError("JPEG frame of width 0");
    if (nc != 1 && nc != 3 && nc != 4)
      throw ImageError("JPEG with " + std::to_string(nc) + " components");
    comps.resize(size_t(nc));
    for (auto& c : comps) {
      c.id = u8();
      const int s = u8();
      c.hs = s >> 4;
      c.vs = s & 15;
      c.tq = u8() & 3;
      if (c.hs < 1 || c.hs > 4 || c.vs < 1 || c.vs > 4)
        throw ImageError("bad JPEG sampling factors");
      hmax = std::max(hmax, c.hs);
      vmax = std::max(vmax, c.vs);
    }
    if (pos != stop) throw ImageError("bad JPEG frame header length");
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.dw = int((int64_t(width) * c.hs + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.vs + vmax - 1) / vmax);
      c.wb = (c.dw + 7) / 8;
      c.hb = (c.dh + 7) / 8;
      c.bw = mcux * c.hs;
      c.bh = mcuy * c.vs;
    }
    frame = true;
  }

  void allocate() {
    for (auto& c : comps) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
  }

  void read_dqt() {
    const size_t stop = pos - 2 + size_t(u16());
    while (pos < stop) {
      const int pq = u8();
      const int t = pq & 15;
      if (t > 3) throw ImageError("bad JPEG quantization table id");
      for (int k = 0; k < 64; ++k)
        qt[t][kNatural[k]] = uint16_t((pq >> 4) ? u16() : u8());
      qt_present[t] = true;
    }
  }

  void read_dht() {
    const size_t stop = pos - 2 + size_t(u16());
    while (pos < stop) {
      const int tc = u8();
      const int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) throw ImageError("bad JPEG Huffman table id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(u8());
      if (total > 256) throw ImageError("bad JPEG Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) {
        vals[i] = uint8_t(u8());
        // jdhuff.c refuses a DC table with a symbol past 15
        if (cls == 0 && vals[i] > 15) throw ImageError("bad Huffman table");
      }
      build_huff(cls ? ac[id] : dc[id], counts, vals, total);
    }
  }

  void read_app(int marker) {
    const size_t len = size_t(u16());
    if (len < 2 || pos + len - 2 > n) throw ImageError("truncated JPEG data");
    const uint8_t* s = data + pos;
    const size_t m = len - 2;
    if (marker == 0xE0 && m >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && m >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = s[11];
    }
    pos += m;
  }

  void skip_segment() {
    const size_t len = size_t(u16());
    if (len < 2 || pos + len - 2 > n) throw ImageError("truncated JPEG data");
    pos += len - 2;
  }

  ColorSpace color_space() const {
    const int nc = int(comps.size());
    if (nc == 1) return ColorSpace::Gray;
    if (nc == 3) {
      if (saw_jfif) return ColorSpace::YCbCr;
      if (saw_adobe) return adobe_transform == 0 ? ColorSpace::RGB
                                                  : ColorSpace::YCbCr;
      if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
        return ColorSpace::RGB;
      return ColorSpace::YCbCr;
    }
    if (saw_adobe && adobe_transform != 0) return ColorSpace::YCCK;
    return ColorSpace::CMYK;
  }

  // ---- scans ---------------------------------------------------------------

  void decode_block_sequential(BitReader& br, Component& c, int16_t* blk) {
    const Huff& dt = dc[c.dc_tbl];
    const Huff& at = ac[c.ac_tbl];
    int s = decode_huff(br, dt);
    if (s) s = extend(br.get(s), s);
    c.last_dc += s;
    blk[0] = int16_t(c.last_dc);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huff(br, at);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int s = decode_huff(br, dc[c.dc_tbl]);
    if (s) s = extend(br.get(s), s);
    c.last_dc += s;
    blk[0] = int16_t(int(unsigned(c.last_dc) << al));
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss,
                       int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& at = ac[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      const int rs = decode_huff(br, at);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(int(unsigned(extend(br.get(s), s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss,
                        int se, int al) {
    const int p1 = 1 << al;
    const int m1 = int(~0u << al);
    const Huff& at = ac[c.ac_tbl];
    int k = ss;
    auto refine = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode_huff(br, at);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine(coef);
      }
      --eobrun;
    }
  }

  // Consume the RSTn after a restart interval: libjpeg-turbo drops the
  // buffered bits, reads the marker and resets the predictors and EOBRUN.
  void restart(BitReader& br) {
    br.reset();
    if (br.marker == 0) {
      // find the marker in the data that follows
      const uint8_t* q = br.p;
      while (q + 1 < br.end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF))
        ++q;
      if (q + 1 >= br.end) {
        br.p = br.end;
        return;
      }
      br.p = q;
      br.marker = q[1];
    }
    if (br.marker >= 0xD0 && br.marker <= 0xD7) {
      br.p += 2;
      br.marker = 0;
    }
    for (auto& c : comps) c.last_dc = 0;
    eobrun = 0;
  }

  void read_scan() {
    if (!frame) throw ImageError("JPEG scan before its frame");
    const size_t len = size_t(u16());
    const size_t stop = pos + len - 2;
    const int ns = u8();
    if (ns < 1 || ns > 4) throw ImageError("bad JPEG scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = u8();
      const int t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw ImageError("JPEG scan names an unknown component");
      found->dc_tbl = t >> 4 & 3;
      found->ac_tbl = t & 3;
      sc.push_back(found);
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    if (pos != stop) throw ImageError("bad JPEG scan header length");
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13)
        throw ImageError("bad progressive JPEG scan parameters");
    }
    for (Component* c : sc) {
      if (!qt_present[c->tq]) throw ImageError("JPEG without its DQT table");
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c->dc_tbl].present) ||
          (need_ac && !ac[c->ac_tbl].present))
        throw ImageError("JPEG scan without its Huffman table");
      c->last_dc = 0;
    }
    eobrun = 0;

    BitReader br{data + pos, data + n};
    auto decode_block = [&](Component& c, int by, int bx) {
      int16_t* blk = c.block(by, bx);
      if (!progressive) {
        decode_block_sequential(br, c, blk);
      } else if (ss == 0) {
        if (ah == 0) decode_dc_first(br, c, blk, al);
        else if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
      } else if (ah == 0) {
        decode_ac_first(br, c, blk, ss, se, al);
      } else {
        decode_ac_refine(br, c, blk, ss, se, al);
      }
    };
    int todo = restart_interval;
    auto next_mcu = [&]() {
      if (restart_interval) {
        if (todo == 0) {
          restart(br);
          todo = restart_interval;
        }
        --todo;
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx) {
          next_mcu();
          decode_block(c, by, bx);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          next_mcu();
          for (Component* c : sc)
            for (int v = 0; v < c->vs; ++v)
              for (int h = 0; h < c->hs; ++h)
                decode_block(*c, my * c->vs + v, mx * c->hs + h);
        }
    }
    if (br.truncated()) throw ImageError("truncated JPEG data");
    // resume at the marker that ends the entropy data
    const uint8_t* q = br.p;
    while (q + 1 < br.end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF &&
                               !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    pos = size_t(q - data);
  }

  // ---- header, scans, and the output ---------------------------------------

  // Reads markers up to the first scan (header_only) or to EOI.
  void run(bool header_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      throw ImageError("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      if (pos >= n) {
        if (scanned && !header_only) return;  // EOI missing after scans
        throw ImageError("truncated JPEG data");
      }
      const int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_frame(m);
        if (header_only) return;
        allocate();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        throw ImageError("arithmetic-coded JPEG is not supported");
      } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC8) {
        throw ImageError(m == 0xC3 ? "lossless JPEG is not supported"
                         : (m >= 0xC9 ? "arithmetic-coded JPEG is not supported"
                                      : "hierarchical JPEG is not supported"));
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (header_only) throw ImageError("JPEG scan before its frame");
        read_scan();
        scanned = true;
      } else if (m == 0xD9) {
        if (!scanned) throw ImageError("JPEG without image data");
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // no segment follows
      } else {
        skip_segment();
      }
    }
  }

  void idct_all() {
    for (auto& c : comps) {
      const size_t stride = size_t(c.bw) * 8;
      c.plane.assign(stride * size_t(c.bh) * 8, 0);
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(by, bx), q,
                     c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
                     stride);
    }
  }

  // Output row y of component c, upsampled to `width` samples (jdsample.c).
  void upsample_row(const Component& c, int y, uint8_t* out,
                    std::vector<uint8_t>& wide) const {
    const size_t stride = size_t(c.bw) * 8;
    const int hr = hmax / c.hs, vr = vmax / c.vs;
    auto row = [&](int r) {
      r = std::min(std::max(r, 0), c.dh - 1);
      return c.plane.data() + size_t(r) * stride;
    };
    const int dw = c.dw;
    if (hr * c.hs != hmax || vr * c.vs != vmax)
      throw ImageError("fractional JPEG sampling factors are not supported");
    if (hr == 1 && vr == 1) {
      std::memcpy(out, row(y), size_t(width));
      return;
    }
    wide.resize(size_t(dw) * hr + 8);
    uint8_t* o = wide.data();
    if (hr == 2 && vr == 1 && dw > 2) {
      const uint8_t* in = row(y);
      o[0] = in[0];
      o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        const int v = in[i] * 3;
        o[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
        o[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
    } else if (hr == 1 && vr == 2) {
      const int i = y / 2;
      const bool above = (y & 1) == 0;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row(above ? i - 1 : i + 1);
      const int bias = above ? 1 : 2;
      for (int x = 0; x < dw; ++x)
        o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {
      const int i = y / 2;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row((y & 1) ? i + 1 : i - 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      o[0] = uint8_t((this_sum * 4 + 8) >> 4);
      o[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dw; ++x) {
        next_sum = in0[x] * 3 + in1[x];
        o[2 * x - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x - 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
    } else {
      // plain replication: h2v1 / h2v2 on narrow components, and the
      // generic integral factors
      const uint8_t* in = row(y / vr);
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < hr; ++k) o[x * hr + k] = in[x];
    }
    std::memcpy(out, o, size_t(width));
  }

  Image output(bool cmyk_to_rgb) {
    const ColorSpace cs = color_space();
    if ((cs == ColorSpace::CMYK || cs == ColorSpace::YCCK) && !cmyk_to_rgb)
      throw ImageError("4-component (CMYK/YCCK) JPEG");
    idct_all();
    Image img;
    img.w = width;
    img.h = height;
    img.px.resize(size_t(width) * height * 3);
    const int nc = int(comps.size());
    std::vector<uint8_t> rows(size_t(width) * nc), wide;
    for (int y = 0; y < height; ++y) {
      for (int ci = 0; ci < nc; ++ci)
        upsample_row(comps[size_t(ci)], y, rows.data() + size_t(ci) * width,
                     wide);
      const uint8_t* r0 = rows.data();
      const uint8_t* r1 = r0 + width;
      const uint8_t* r2 = r1 + width;
      const uint8_t* r3 = r2 + width;
      uint8_t* o = img.px.data() + size_t(y) * width * 3;
      if (cs == ColorSpace::Gray) {
        for (int x = 0; x < width; ++x, o += 3) o[0] = o[1] = o[2] = r0[x];
      } else if (cs == ColorSpace::YCbCr) {
        for (int x = 0; x < width; ++x, o += 3)
          ycc_to_rgb(r0[x], r1[x], r2[x], o);
      } else if (cs == ColorSpace::RGB) {
        for (int x = 0; x < width; ++x, o += 3) {
          o[0] = r0[x];
          o[1] = r1[x];
          o[2] = r2[x];
        }
      } else {
        for (int x = 0; x < width; ++x, o += 3) {
          uint8_t cmy[3] = {r0[x], r1[x], r2[x]};
          if (cs == ColorSpace::YCCK) {
            ycc_to_rgb(r0[x], r1[x], r2[x], cmy);
            for (auto& v : cmy) v = uint8_t(255 - v);
          }
          // PIL: "CMYK;I" inverts every byte, then cmyk2rgb
          const int nk = 255 - (255 - r3[x]);
          for (int k = 0; k < 3; ++k)
            o[k] = clamp255(nk - muldiv255(255 - cmy[k], nk));
        }
      }
    }
    return img;
  }
};

}  // namespace

void jpeg_info(const uint8_t* data, size_t n, int* w, int* h) {
  Decoder d(data, n);
  d.run(true);
  if (!d.frame) throw ImageError("JPEG without a frame");
  *w = d.width;
  *h = d.height;
}

Image jpeg_decode(const uint8_t* data, size_t n, bool cmyk_to_rgb) {
  Decoder d(data, n);
  d.run(false);
  return d.output(cmyk_to_rgb);
}

}  // namespace uvcimg

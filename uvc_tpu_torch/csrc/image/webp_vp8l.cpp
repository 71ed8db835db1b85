// Lossless WebP (the VP8L bitstream of RFC 9649), the ALPH chunk of a
// lossy image, and the RIFF container around both (RFC 9649, 2.7): a
// simple "VP8 " or "VP8L" file, or an extended one (VP8X) with ALPH, or
// with an animation whose first frame is decoded as PIL shows it: on a
// canvas of zeros at its offset, not blended (libwebp's WebPAnimDecoder
// treats the first frame as a key frame).
#include <algorithm>
#include <cstring>

#include "image.h"
#include "webp.h"

namespace uvcimg {
namespace {

inline uint32_t le24(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
}
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | uint32_t(p[3]) << 24;
}

// --- the bit reader: least significant bit first ---------------------------
struct BitReader {
  const uint8_t* data;
  size_t n, pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  uint64_t consumed = 0;

  BitReader(const uint8_t* d, size_t len) : data(d), n(len) {}
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = pos < n ? data[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {
    fill();
    return uint32_t(val & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    consumed += uint64_t(k);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // true once the reader has gone past the end of its data
  bool eos() const { return consumed > uint64_t(n) * 8; }
};

// --- canonical prefix codes (RFC 9649, 3.7.2) --------------------------------
constexpr int kMaxLen = 15;
constexpr int kFastBits = 9;

struct PrefixCode {
  int single = -1;  // a code of one symbol, read with no bits
  uint16_t count[kMaxLen + 1] = {};
  std::vector<uint16_t> sorted;  // symbols by (length, symbol)
  std::vector<uint16_t> fast;    // next kFastBits bits -> len << 12 | sym

  // false where the lengths make no valid code (as libwebp's
  // VP8LBuildHuffmanTable refuses them)
  bool build(const std::vector<int>& lengths) {
    const int size = int(lengths.size());
    std::fill(count, count + kMaxLen + 1, 0);
    for (int len : lengths) {
      if (len > kMaxLen) return false;
      ++count[len];
    }
    if (count[0] == size) return false;
    int offset[kMaxLen + 2] = {};
    for (int len = 1; len < kMaxLen; ++len) {
      if (count[len] > (1 << len)) return false;
      offset[len + 1] = offset[len] + count[len];
    }
    offset[kMaxLen + 1] = offset[kMaxLen] + count[kMaxLen];
    sorted.assign(size_t(size - count[0]), 0);
    {
      int next[kMaxLen + 2];
      std::copy(offset, offset + kMaxLen + 2, next);
      for (int s = 0; s < size; ++s)
        if (lengths[s] > 0) sorted[size_t(next[lengths[s]]++)] = uint16_t(s);
    }
    if (offset[kMaxLen] == 1) {  // one symbol of length below 15
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len <= kMaxLen; ++len) {
      open = (open << 1) - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    fast.assign(size_t(1) << kFastBits, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= kMaxLen; ++len, code <<= 1) {
      for (int i = 0; i < count[len]; ++i, ++code, ++k) {
        if (len > kFastBits) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int r = rev; r < (1 << kFastBits); r += 1 << len)
          fast[size_t(r)] = uint16_t(len << 12 | sorted[size_t(k)]);
      }
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint16_t e = fast[br.peek(kFastBits)];
    if (e) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    // longer than kFastBits: one bit at a time
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxLen; ++len) {
      code |= int(br.read(1));
      const int c = count[len];
      if (code - c < first) return sorted[size_t(index + code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    throw ImageError("bad WebP lossless prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

// One prefix code of `alphabet` symbols (RFC 9649, 3.7.2.1).
PrefixCode read_code(BitReader& br, int alphabet) {
  std::vector<int> lengths(size_t(alphabet), 0);
  bool ok = true;
  if (br.read(1)) {  // a simple code: one or two symbols
    const int num = int(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    int s = int(br.read(first_bits));
    if (s < alphabet) lengths[size_t(s)] = 1;
    if (num == 2) {
      s = int(br.read(8));
      if (s < alphabet) lengths[size_t(s)] = 1;
    }
  } else {  // code lengths, themselves prefix coded
    std::vector<int> cl_lengths(19, 0);
    const int num_codes = int(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_lengths[size_t(kCodeLengthOrder[i])] = int(br.read(3));
    PrefixCode cl;
    ok = cl.build(cl_lengths);
    int max_symbol = alphabet;
    if (ok && br.read(1)) {
      const int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > alphabet) ok = false;
    }
    int symbol = 0, prev = 8;
    while (ok && symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = cl.read(br);
      if (len < 16) {
        lengths[size_t(symbol++)] = len;
        if (len != 0) prev = len;
      } else {
        const int slot = len - 16;
        const int extra[3] = {2, 3, 7}, offs[3] = {3, 3, 11};
        const int repeat = int(br.read(extra[slot])) + offs[slot];
        if (symbol + repeat > alphabet) {
          ok = false;
          break;
        }
        const int v = slot == 0 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[size_t(symbol++)] = v;
      }
    }
  }
  PrefixCode code;
  if (!ok || br.eos() || !code.build(lengths))
    throw ImageError("bad WebP lossless prefix code");
  return code;
}

// --- the image stream --------------------------------------------------------
// (dy, 8 - dx) of the 120 short distance codes
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};


inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) -
                            int((c >> s) & 0xff)))
           << s;
  return out;
}
inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = int((a >> s) & 0xff), y = int((b >> s) & 0xff);
    out |= uint32_t(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}
inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff),
              c = int((tl >> s) & 0xff);
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 / 15 as the reference does
  }
}

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Group {
  PrefixCode code[5];  // green + lengths + cache, red, blue, alpha, distance
};

inline int prefix_value(BitReader& br, int symbol) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

std::vector<uint32_t> decode_stream(BitReader& br, int xsize, int ysize,
                                    bool level0) {
  check_pixels(uint64_t(xsize), uint64_t(ysize), "WebP lossless image");
  std::vector<Transform> transforms;
  int width = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = int(br.read(2));
      if (seen & (1u << t.type))
        throw ImageError("WebP lossless transform repeated");
      seen |= 1u << t.type;
      t.xsize = width;
      if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
        t.bits = int(br.read(3)) + 2;
        t.data = decode_stream(br, subsample(width, t.bits),
                               subsample(ysize, t.bits), false);
      } else if (t.type == COLOR_INDEXING) {
        const int num_colors = int(br.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                 : num_colors > 2 ? 2 : 3;
        width = subsample(t.xsize, t.bits);
        const std::vector<uint32_t> pal =
            decode_stream(br, num_colors, 1, false);
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        t.data[0] = pal[0];
        for (int i = 1; i < num_colors; ++i)
          t.data[size_t(i)] = add_pixels(pal[size_t(i)], t.data[size_t(i - 1)]);
      }
      transforms.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11)
      throw ImageError("bad WebP lossless colour cache size");
  }
  int meta_bits = 0, meta_w = 1;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    meta_w = subsample(width, meta_bits);
    meta = decode_stream(br, meta_w, subsample(ysize, meta_bits), false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max(num_groups, int(m) + 1);
    }
  }
  // the codes of every group are read; those the image refers to are kept
  std::vector<int> index(size_t(num_groups), meta.empty() ? 0 : -1);
  if (!meta.empty()) {
    for (uint32_t m : meta) index[m] = 0;
    int k = 0;
    for (int& i : index)
      if (i == 0) i = k++;
  }
  std::vector<Group> groups;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (int g = 0; g < num_groups; ++g) {
    Group grp;
    for (int c = 0; c < 5; ++c) grp.code[c] = read_code(br, alphabets[c]);
    if (index[size_t(g)] >= 0) groups.push_back(std::move(grp));
  }
  if (!meta.empty())
    for (uint32_t& m : meta) m = uint32_t(index[m]);

  // the pixels (RFC 9649, 5.2)
  // grown as decoded: a header that claims more than its data holds
  // allocates only what the data makes
  const size_t total = size_t(width) * ysize;
  std::vector<uint32_t> px;
  px.reserve(std::min<size_t>(total, size_t(1) << 20));
  std::vector<uint32_t> cache(size_t(cache_size), 0);
  const int cache_shift = 32 - cache_bits;
  auto cache_insert = [&](uint32_t argb) {
    if (cache_bits) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  size_t pos = 0;
  int col = 0, row = 0;
  while (pos < total) {
    const Group& g =
        meta.empty() ? groups[0]
                     : groups[meta[size_t(row >> meta_bits) * meta_w +
                                   size_t(col >> meta_bits)]];
    const int code = g.code[0].read(br);
    if (code < 256) {
      const uint32_t r = uint32_t(g.code[1].read(br));
      const uint32_t b = uint32_t(g.code[2].read(br));
      const uint32_t a = uint32_t(g.code[3].read(br));
      px.push_back(a << 24 | r << 16 | uint32_t(code) << 8 | b);
    } else if (code < 256 + 24) {
      const int length = prefix_value(br, code - 256);
      const int dist_code = prefix_value(br, g.code[4].read(br));
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int v = kCodeToPlane[dist_code - 1];
        dist = (v >> 4) * width + (8 - (v & 0xf));
        if (dist < 1) dist = 1;
      }
      if (size_t(dist) > pos || size_t(length) > total - pos || br.eos())
        throw ImageError("bad WebP lossless back-reference");
      for (int i = 0; i < length; ++i, ++pos) {
        px.push_back(px[pos - size_t(dist)]);
        cache_insert(px[pos]);
      }
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      continue;
    } else {
      const int key = code - 256 - 24;
      if (key >= cache_size) throw ImageError("bad WebP lossless code");
      px.push_back(cache[size_t(key)]);
    }
    if (br.eos()) break;
    cache_insert(px[pos]);
    ++pos;
    if (++col >= width) {
      col = 0;
      ++row;
    }
  }
  if (br.eos()) throw ImageError("truncated WebP lossless data");

  // the transforms, last read first undone (RFC 9649, 4)
  for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) {
    const int w = t->xsize, bits = t->bits;
    if (t->type == PREDICTOR) {
      const int bw = subsample(w, bits);
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[size_t(x)] = add_pixels(px[size_t(x)],
                                                             px[size_t(x - 1)]);
      for (int y = 1; y < ysize; ++y) {
        uint32_t* cur = px.data() + size_t(y) * w;
        const uint32_t* up = cur - w;
        const uint32_t* modes = t->data.data() + size_t(y >> bits) * bw;
        cur[0] = add_pixels(cur[0], up[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = int((modes[x >> bits] >> 8) & 0xf);
          // up[x + 1] of the last column is this row's first pixel
          cur[x] = add_pixels(cur[x],
                              predict(mode, cur[x - 1], up[x], up[x + 1],
                                      up[x - 1]));
        }
      }
    } else if (t->type == CROSS_COLOR) {
      const int bw = subsample(w, bits);
      for (int y = 0; y < ysize; ++y) {
        uint32_t* cur = px.data() + size_t(y) * w;
        const uint32_t* el = t->data.data() + size_t(y >> bits) * bw;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = el[x >> bits];
          const int g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                    r2b = int8_t((m >> 16) & 0xff);
          const uint32_t argb = cur[x];
          const int green = int8_t((argb >> 8) & 0xff);
          int red = int((argb >> 16) & 0xff);
          int blue = int(argb & 0xff);
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * int(int8_t(red))) >> 5;
          blue &= 0xff;
          cur[x] = (argb & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
        }
      }
    } else if (t->type == SUBTRACT_GREEN) {
      for (uint32_t& p : px) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else {  // COLOR_INDEXING: from the packed width back to xsize
      const int packed = subsample(w, bits);
      std::vector<uint32_t> out(size_t(w) * ysize);
      const int bpp = 8 >> bits;  // bits an index, 1 << bits a byte
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* in = px.data() + size_t(y) * packed;
        uint32_t* o = out.data() + size_t(y) * w;
        for (int x = 0; x < w; ++x) {
          const int shift = (x & ((1 << bits) - 1)) * bpp;
          o[x] = t->data[((in[x >> bits] >> 8) >> shift) & mask];
        }
      }
      px.swap(out);
    }
  }
  return px;
}

// A VP8L bitstream with its 5-byte header: ARGB pixels.
std::vector<uint32_t> vp8l_decode(const uint8_t* data, size_t n, int* w,
                                  int* h) {
  if (n < 5 || data[0] != 0x2f) throw ImageError("bad WebP lossless header");
  BitReader br(data + 1, n - 1);
  *w = int(br.read(14)) + 1;
  *h = int(br.read(14)) + 1;
  br.read(1);  // alpha is used: a hint
  if (br.read(3) != 0) throw ImageError("bad WebP lossless version");
  return decode_stream(br, *w, *h, true);
}

void vp8l_size(const uint8_t* data, size_t n, int* w, int* h) {
  if (n < 5 || data[0] != 0x2f) throw ImageError("bad WebP lossless header");
  const uint32_t bits = le32(data + 1);
  *w = int(bits & 0x3fff) + 1;
  *h = int((bits >> 14) & 0x3fff) + 1;
}

// --- the ALPH chunk (the container specification's "Alpha") ---------------
// PIL's convert("RGB") drops the alpha, and the first frame is not blended,
// so no pixel of the RGB depends on its values; but libwebp refuses a file
// whose alpha does not decode, and so does this.  Its filter cannot fail
// and is not undone.
void check_alpha(const uint8_t* data, size_t n, int w, int h) {
  if (n < 1) throw ImageError("empty WebP ALPH chunk");
  const int method = data[0] & 3, pre = (data[0] >> 4) & 3,
            reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0)
    throw ImageError("bad WebP ALPH header");
  if (method == 0) {
    if (n - 1 < size_t(w) * h) throw ImageError("truncated WebP ALPH data");
  } else {
    BitReader br(data + 1, n - 1);
    decode_stream(br, w, h, true);
  }
}

// --- the container ----------------------------------------------------------
struct Chunk {
  const uint8_t* tag;
  const uint8_t* data;
  size_t size;
};

// The chunks in [p, end), each padded to an even size.
std::vector<Chunk> chunks_of(const uint8_t* p, const uint8_t* end) {
  std::vector<Chunk> out;
  while (end - p >= 8) {
    const size_t size = le32(p + 4);
    if (size > size_t(end - p) - 8) throw ImageError("truncated WebP chunk");
    out.push_back({p, p + 8, size});
    p += 8 + size + (size & 1);
    if (p > end) break;
  }
  return out;
}

bool is(const Chunk& c, const char* tag) {
  return std::memcmp(c.tag, tag, 4) == 0;
}

struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  const Chunk* alpha = nullptr;
  const Chunk* image = nullptr;
};

void frame_size(const Chunk& c, int* w, int* h) {
  if (is(c, "VP8 "))
    vp8_frame_size(c.data, c.size, w, h);
  else
    vp8l_size(c.data, c.size, w, h);
  check_pixels(uint64_t(*w), uint64_t(*h), "WebP frame");
}

// The RIFF header, and the canvas and the first frame the file shows.
struct Layout {
  std::vector<Chunk> top, sub;
  int canvas_w = 0, canvas_h = 0;
  Frame frame;
};

void find_image(const std::vector<Chunk>& chunks, Frame* f) {
  for (const Chunk& c : chunks) {
    if (is(c, "ALPH") && !f->alpha) f->alpha = &c;
    if (is(c, "VP8 ") || is(c, "VP8L")) {
      f->image = &c;
      return;
    }
  }
  throw ImageError("WebP file without an image chunk");
}

void layout(const uint8_t* d, size_t n, Layout* lay) {
  if (n < 20 || std::memcmp(d, "RIFF", 4) != 0 ||
      std::memcmp(d + 8, "WEBP", 4) != 0)
    throw ImageError("not a WebP file");
  const size_t riff = le32(d + 4);
  if (riff < 12) throw ImageError("bad WebP RIFF size");
  if (riff > n - 8) throw ImageError("truncated WebP file");
  const uint8_t* end = d + 8 + riff;
  lay->top = chunks_of(d + 12, end);
  if (lay->top.empty()) throw ImageError("truncated WebP file");
  const Chunk& first = lay->top[0];
  Frame& f = lay->frame;
  if (is(first, "VP8 ") || is(first, "VP8L")) {
    f.image = &first;
    frame_size(first, &f.w, &f.h);
    lay->canvas_w = f.w;
    lay->canvas_h = f.h;
    return;
  }
  if (!is(first, "VP8X") || first.size < 10)
    throw ImageError("WebP file of unknown layout");
  const int flags = first.data[0];
  lay->canvas_w = int(le24(first.data + 4)) + 1;
  lay->canvas_h = int(le24(first.data + 7)) + 1;
  check_pixels(uint64_t(lay->canvas_w), uint64_t(lay->canvas_h),
               "WebP canvas");
  if (flags & 0x02) {  // animation: every frame checked, the first kept
    for (const Chunk& c : lay->top) {
      if (!is(c, "ANMF")) continue;
      if (c.size < 16) throw ImageError("truncated WebP ANMF chunk");
      Frame g;
      g.x = int(le24(c.data)) * 2;
      g.y = int(le24(c.data + 3)) * 2;
      std::vector<Chunk> sub = chunks_of(c.data + 16, c.data + c.size);
      find_image(sub, &g);
      frame_size(*g.image, &g.w, &g.h);
      if (g.w != int(le24(c.data + 6)) + 1 || g.h != int(le24(c.data + 9)) + 1)
        throw ImageError("WebP frame size differs from its ANMF header");
      if (g.x + g.w > lay->canvas_w || g.y + g.h > lay->canvas_h)
        throw ImageError("WebP frame outside its canvas");
      if (!f.image) {
        lay->sub = std::move(sub);
        g.alpha = g.image = nullptr;
        find_image(lay->sub, &g);
        f = g;
      }
    }
    if (!f.image) throw ImageError("animated WebP without a frame");
    return;
  }
  find_image(lay->top, &f);
  frame_size(*f.image, &f.w, &f.h);
  if (f.w != lay->canvas_w || f.h != lay->canvas_h)
    throw ImageError("WebP image size differs from its canvas");
}

}  // namespace

void webp_info(const uint8_t* data, size_t n, int* w, int* h) {
  Layout lay;
  layout(data, n, &lay);
  *w = lay.canvas_w;
  *h = lay.canvas_h;
}

Image webp_decode(const uint8_t* data, size_t n) {
  Layout lay;
  layout(data, n, &lay);
  const Frame& f = lay.frame;
  const Chunk& img = *f.image;
  // the frame first, so that a file cut short allocates no canvas
  std::vector<uint8_t> frame;  // 4 bytes a pixel, its alpha byte unused
  if (is(img, "VP8L")) {
    int fw, fh;
    const std::vector<uint32_t> px = vp8l_decode(img.data, img.size, &fw, &fh);
    frame.resize(px.size() * 4);
    for (size_t i = 0; i < px.size(); ++i) {
      frame[4 * i] = uint8_t(px[i] >> 16);
      frame[4 * i + 1] = uint8_t(px[i] >> 8);
      frame[4 * i + 2] = uint8_t(px[i]);
    }
  } else {
    Yuv420 yuv;
    vp8_decode(img.data, img.size, &yuv);
    frame.resize(size_t(f.w) * f.h * 4);
    yuv420_to_rgba(yuv, frame.data(), size_t(f.w) * 4);
    if (f.alpha) check_alpha(f.alpha->data, f.alpha->size, f.w, f.h);
  }
  // at its offset on a canvas of zeros
  Image out;
  out.w = lay.canvas_w;
  out.h = lay.canvas_h;
  out.px.assign(size_t(out.w) * out.h * 3, 0);
  for (int y = 0; y < f.h; ++y)
    for (int x = 0; x < f.w; ++x)
      std::memcpy(&out.px[(size_t(f.y + y) * out.w + f.x + x) * 3],
                  &frame[(size_t(y) * f.w + x) * 4], 3);
  return out;
}

}  // namespace uvcimg

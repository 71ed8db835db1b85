// BMP, to RGB as PIL's BmpImagePlugin and convert("RGB") give it: the
// BITMAPCOREHEADER (OS/2, 12 bytes) and the info headers of 40 to 124
// bytes; 1-, 4- and 8-bit palettes (a palette of grays read as PIL's L and
// 1 modes read it), 16 bits as 5-5-5 and through bit fields (5-6-5 too),
// 24 and 32 bits with the bit-field layouts PIL takes; RLE8 and RLE4 as
// PIL's BmpRleDecoder reads them, its quirks kept (a delta escape reads
// four bytes; an odd run of RLE4 literals drops its last pixel); rows
// bottom-up, or top-down where the height is negative.
#include <algorithm>
#include <cstring>

#include "image.h"

namespace uvcimg {
namespace {

inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0] | p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return le16(p) | le16(p + 2) << 16;
}

enum Mode { PAL, GRAY, BILEVEL, RGB555, RGB565, RGB24, RGB32 };

struct Bmp {
  uint32_t w = 0, h = 0, bits = 0, comp = 0;
  bool top_down = false;
  size_t offset = 0;
  Mode mode = PAL;
  int byte_of[3] = {2, 1, 0};       // 32 bits: the bytes of R, G, B
  uint8_t pal[256 * 3] = {};        // unlisted entries are black
};

Bmp parse(const uint8_t* d, size_t n) {
  if (n < 18 || d[0] != 'B' || d[1] != 'M') throw ImageError("not a BMP file");
  Bmp b;
  b.offset = le32(d + 10);
  const uint32_t hsize = le32(d + 14);
  if (hsize < 4 || n < 14 + size_t(hsize)) throw ImageError("truncated BMP header");
  const uint8_t* hd = d + 18;  // the header after its size
  uint32_t colors = 0, masks[4] = {0, 0, 0, 0};
  size_t padding = 4;
  if (hsize == 12) {
    b.w = le16(hd);
    b.h = le16(hd + 2);
    b.bits = le16(hd + 6);
    padding = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 ||
             hsize == 108 || hsize == 124) {
    b.top_down = hd[7] == 0xFF;
    b.w = le32(hd);
    b.h = b.top_down ? uint32_t(0) - le32(hd + 4) : le32(hd + 4);
    b.bits = le16(hd + 10);
    b.comp = le32(hd + 12);
    colors = le32(hd + 28);
    if (b.comp == 3) {
      if (hsize >= 52) {
        for (int i = 0; i < (hsize >= 56 ? 4 : 3); ++i)
          masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (n < 14 + size_t(hsize) + 12) throw ImageError("truncated BMP header");
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + 14 + hsize + 4 * i);
      }
    }
  } else {
    throw ImageError("BMP with a " + std::to_string(hsize) +
                     "-byte header is not supported");
  }
  if (b.w < 1 || b.h < 1) throw ImageError("BMP of empty size");
  check_pixels(b.w, b.h, "BMP");
  if (colors == 0) colors = b.bits < 32 ? 1u << b.bits : 0;
  if (b.offset == 14 + size_t(hsize) && b.bits <= 8) b.offset += 4 * size_t(colors);
  switch (b.bits) {
    case 1: case 4: case 8: b.mode = PAL; break;
    case 16: b.mode = RGB555; break;
    case 24: b.mode = RGB24; break;
    case 32: b.mode = RGB32; break;
    default:
      throw ImageError("BMP of " + std::to_string(b.bits) +
                       " bits per pixel is not supported");
  }
  if (b.comp == 3) {  // bit fields: the layouts PIL's plugin lists
    auto is = [&](uint32_t r, uint32_t g, uint32_t bl) {
      return masks[0] == r && masks[1] == g && masks[2] == bl;
    };
    bool ok = false;
    if (b.bits == 32) {
      struct { uint32_t m[4]; int r, g, bl; } kLayouts[] = {
          {{0xFF0000, 0xFF00, 0xFF, 0}, 2, 1, 0},
          {{0xFF000000, 0xFF0000, 0xFF00, 0}, 3, 2, 1},
          {{0xFF000000, 0xFF00, 0xFF, 0}, 3, 1, 0},
          {{0xFF000000, 0xFF0000, 0xFF00, 0xFF}, 3, 2, 1},
          {{0xFF, 0xFF00, 0xFF0000, 0xFF000000}, 0, 1, 2},
          {{0xFF0000, 0xFF00, 0xFF, 0xFF000000}, 2, 1, 0},
          {{0xFF000000, 0xFF00, 0xFF, 0xFF0000}, 3, 1, 0},
          {{0, 0, 0, 0}, 2, 1, 0}};
      for (const auto& l : kLayouts)
        if (std::equal(l.m, l.m + 4, masks)) {
          b.byte_of[0] = l.r;
          b.byte_of[1] = l.g;
          b.byte_of[2] = l.bl;
          ok = true;
          break;
        }
    } else if (b.bits == 24) {
      ok = is(0xFF0000, 0xFF00, 0xFF);
    } else if (b.bits == 16) {
      if (is(0xF800, 0x7E0, 0x1F)) {
        b.mode = RGB565;
        ok = true;
      } else {
        ok = is(0x7C00, 0x3E0, 0x1F);
      }
    }
    if (!ok) throw ImageError("BMP bit-field layout is not supported");
  } else if (b.comp != 0 && b.comp != 1 && b.comp != 2) {
    throw ImageError("BMP compression " + std::to_string(b.comp) +
                     " is not supported");
  }
  if (b.mode == PAL) {
    if (colors < 1 || colors > 65536)
      throw ImageError("BMP palette size is not supported");
    // the palette after the header; a gray one (0..colors-1, or black
    // and white for two colours) makes PIL read the indices themselves
    const size_t at = 14 + size_t(hsize);
    const size_t have = at < n ? n - at : 0;
    auto entry = [&](size_t i, int c) -> int {  // stored B, G, R; -1 cut
      return i * padding + 3 <= have ? d[at + i * padding + size_t(2 - c)]
                                     : -1;
    };
    bool gray = true;
    for (uint32_t i = 0; i < colors && gray; ++i) {
      const int v = colors == 2 ? (i ? 255 : 0) : int(i & 255);
      for (int c = 0; c < 3; ++c)
        if (entry(i, c) != v) gray = false;
    }
    if (gray) b.mode = colors == 2 ? BILEVEL : GRAY;
    for (uint32_t i = 0; i < std::min<uint32_t>(colors, 256); ++i)
      for (int c = 0; c < 3; ++c)
        b.pal[3 * i + c] = uint8_t(std::max(0, entry(i, c)));
  }
  if (b.comp == 1 || b.comp == 2) {
    if (b.mode != PAL && b.mode != GRAY)
      throw ImageError("run-length coded BMP of this mode is not supported");
  }
  return b;
}

// PIL's BmpRleDecoder: one index a pixel, rows of w in file order.
std::vector<uint8_t> rle_indices(const Bmp& b, const uint8_t* d, size_t n) {
  const bool rle4 = b.comp == 2;
  const size_t w = b.w, dest = size_t(b.w) * b.h;
  std::vector<uint8_t> data;
  size_t pos = b.offset, x = 0;
  auto take = [&](size_t k) {  // read(k): what is there of k bytes
    const size_t got = pos < n ? std::min(k, n - pos) : 0;
    const size_t at = pos;
    pos += got;
    return std::make_pair(at, got);
  };
  while (data.size() < dest) {
    const auto a = take(1), c = take(1);
    if (!a.second || !c.second) break;
    size_t num = d[a.first];
    const int byte = d[c.first];
    if (num) {
      if (x + num > w) num = x < w ? w - x : 0;
      for (size_t i = 0; i < num; ++i)
        data.push_back(uint8_t(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
      x += num;
    } else if (byte == 0) {  // end of line
      while (data.size() % w) data.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: PIL reads two bytes, then right, up
      if (take(2).second < 2) break;
      const auto ru = take(2);
      if (ru.second < 2) throw ImageError("truncated BMP run-length data");
      const size_t right = d[ru.first], up = d[ru.first + 1];
      // no further than the image: PIL reads only its first w * h values
      data.insert(data.end(), std::min(right + up * w, dest - data.size()),
                  0);
      x = data.size() % w;
    } else {  // literal pixels
      const size_t count = rle4 ? size_t(byte) / 2 : size_t(byte);
      const auto lit = take(count);
      for (size_t i = 0; i < lit.second; ++i) {
        const int v = d[lit.first + i];
        if (rle4) {
          data.push_back(uint8_t(v >> 4));
          data.push_back(uint8_t(v & 15));
        } else {
          data.push_back(uint8_t(v));
        }
      }
      if (lit.second < count) break;
      x += size_t(byte);
      if (pos % 2) ++pos;
    }
  }
  if (data.size() < dest) throw ImageError("truncated BMP run-length data");
  return data;
}

}  // namespace

void bmp_info(const uint8_t* data, size_t n, int* w, int* h) {
  const Bmp b = parse(data, n);
  *w = int(b.w);
  *h = int(b.h);
}

Image bmp_decode(const uint8_t* d, size_t n) {
  const Bmp b = parse(d, n);
  Image img;
  img.w = int(b.w);
  img.h = int(b.h);
  auto out_row = [&](size_t file_row) {
    const size_t y = b.top_down ? file_row : b.h - 1 - file_row;
    return img.px.data() + y * b.w * 3;
  };
  if (b.comp == 1 || b.comp == 2) {
    const std::vector<uint8_t> idx = rle_indices(b, d, n);
    img.px.resize(size_t(b.w) * b.h * 3);
    for (size_t r = 0; r < b.h; ++r) {
      uint8_t* o = out_row(r);
      for (size_t x = 0; x < b.w; ++x, o += 3) {
        const int v = idx[r * b.w + x];
        if (b.mode == GRAY)
          o[0] = o[1] = o[2] = uint8_t(v);
        else
          std::memcpy(o, b.pal + 3 * v, 3);
      }
    }
    return img;
  }
  // uncompressed: rows `stride` apart, padded to 4 bytes, the last one
  // without its padding
  if (b.mode == GRAY && b.bits < 8)
    throw ImageError("BMP of " + std::to_string(b.bits) + " bits with a "
                     "palette of the grays 0, 1, 2, ... is not supported");
  const size_t stride = (size_t(b.w) * b.bits + 31) / 32 * 4;
  const int raw_bits = b.mode == GRAY ? 8 : b.mode == BILEVEL ? 1 : int(b.bits);
  const size_t row_bytes = (size_t(b.w) * raw_bits + 7) / 8;
  if (b.offset > n || (n - b.offset) < stride * (b.h - 1) + row_bytes)
    throw ImageError("truncated BMP pixel data");
  img.px.resize(size_t(b.w) * b.h * 3);
  for (size_t r = 0; r < b.h; ++r) {
    const uint8_t* in = d + b.offset + r * stride;
    uint8_t* o = out_row(r);
    for (size_t x = 0; x < b.w; ++x, o += 3) {
      switch (b.mode) {
        case PAL: {
          const int v = (in[x * b.bits / 8] >> (8 - b.bits - x * b.bits % 8)) &
                        ((1 << b.bits) - 1);
          std::memcpy(o, b.pal + 3 * v, 3);
          break;
        }
        case GRAY: o[0] = o[1] = o[2] = in[x]; break;
        case BILEVEL:
          o[0] = o[1] = o[2] = uint8_t((in[x / 8] >> (7 - x % 8)) & 1 ? 255 : 0);
          break;
        case RGB555:
        case RGB565: {
          const uint32_t v = le16(in + 2 * x);
          const bool g6 = b.mode == RGB565;
          const uint32_t r5 = g6 ? v >> 11 : (v >> 10) & 31;
          const uint32_t g = g6 ? (v >> 5) & 63 : (v >> 5) & 31;
          o[0] = uint8_t(r5 * 255 / 31);
          o[1] = uint8_t(g * 255 / (g6 ? 63 : 31));
          o[2] = uint8_t((v & 31) * 255 / 31);
          break;
        }
        case RGB24:
          o[0] = in[3 * x + 2];
          o[1] = in[3 * x + 1];
          o[2] = in[3 * x];
          break;
        case RGB32:
          for (int c = 0; c < 3; ++c) o[c] = in[4 * x + size_t(b.byte_of[c])];
          break;
      }
    }
  }
  return img;
}

}  // namespace uvcimg

// PNG scanlines and uncompressed BMP, to RGB as PIL's convert("RGB") gives
// them.  The PNG chunk walk and the zlib inflate of IDAT run in Python
// (data/imagelib.py) with the standard library's zlib; this file undoes
// the five scanline filters and converts the pixels.
#include <algorithm>
#include <cstdlib>
#include <cstring>

#include "image.h"

namespace uvcimg {
namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  throw ImageError("PNG colour type " + std::to_string(color_type) +
                   " is not supported");
}

}  // namespace

void png_unfilter_rgb(uint8_t* raw, size_t raw_len, int w, int h, int depth,
                      int color_type, const uint8_t* plte, int n_plte,
                      uint8_t* out) {
  const int ch = channels_of(color_type);
  const bool ok_depth = depth == 8 || ((color_type == 0 || color_type == 3) &&
                                       (depth == 1 || depth == 2 ||
                                        depth == 4));
  if (!ok_depth)
    throw ImageError("PNG bit depth " + std::to_string(depth) +
                     " for colour type " + std::to_string(color_type) +
                     " is not supported");
  const size_t rowbytes = (size_t(w) * ch * depth + 7) / 8;
  const size_t bpp = std::max<size_t>(1, size_t(ch) * depth / 8);
  if (raw_len < (rowbytes + 1) * size_t(h))
    throw ImageError("truncated PNG image data");
  uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + size_t(y) * (rowbytes + 1);
    const int f = row[0];
    uint8_t* cur = row + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      switch (f) {
        case 0: break;
        case 1: cur[i] = uint8_t(cur[i] + a); break;
        case 2: cur[i] = uint8_t(cur[i] + b); break;
        case 3: cur[i] = uint8_t(cur[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(cur[i] + paeth(a, b, c)); break;
        default: throw ImageError("bad PNG filter type");
      }
    }
    prev = cur;
    uint8_t* o = out + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x, o += 3) {
      if (depth == 8) {
        const uint8_t* p = cur + size_t(x) * ch;
        if (color_type == 3) {
          if (p[0] >= n_plte)
            throw ImageError("PNG palette index out of range");
          std::memcpy(o, plte + 3 * p[0], 3);
        } else if (ch >= 3) {
          std::memcpy(o, p, 3);
        } else {
          o[0] = o[1] = o[2] = p[0];
        }
        continue;
      }
      const size_t bit = size_t(x) * depth;
      const int v = (cur[bit >> 3] >> (8 - depth - int(bit & 7))) &
                    ((1 << depth) - 1);
      if (color_type == 3) {
        if (v >= n_plte) throw ImageError("PNG palette index out of range");
        std::memcpy(o, plte + 3 * v, 3);
      } else {
        o[0] = o[1] = o[2] = uint8_t(v * (255 / ((1 << depth) - 1)));
      }
    }
  }
}

// BITMAPFILEHEADER + an info header of 40 bytes or more, 24 bits (BGR) or
// 32 bits (BGRX, or BI_BITFIELDS with the BGRA masks), rows padded to 4
// bytes, bottom-up unless the height is negative.
namespace {
struct BmpHeader {
  int w, h, bits;
  bool top_down;
  size_t offset;
};

BmpHeader bmp_header(const uint8_t* d, size_t n) {
  if (n < 26 || d[0] != 'B' || d[1] != 'M') throw ImageError("not a BMP file");
  const uint32_t hsize = le32(d + 14);
  if (hsize < 40 || n < 14 + size_t(hsize))
    throw ImageError("BMP with a " + std::to_string(hsize) +
                     "-byte header is not supported");
  BmpHeader b;
  b.offset = le32(d + 10);
  b.w = int32_t(le32(d + 18));
  const int32_t hh = int32_t(le32(d + 22));
  b.top_down = hh < 0;
  b.h = hh < 0 ? -hh : hh;
  b.bits = d[28] | d[29] << 8;
  const uint32_t comp = le32(d + 30);
  if (b.w < 1 || b.h < 1) throw ImageError("BMP of empty size");
  if (uint64_t(b.w) * uint64_t(b.h) > (uint64_t(1) << 31))
    throw ImageError("BMP larger than 2**31 pixels");
  if (b.bits != 24 && b.bits != 32)
    throw ImageError("BMP of " + std::to_string(b.bits) +
                     " bits per pixel is not supported");
  if (comp == 3 && b.bits == 32) {
    const uint8_t* m = d + 54;  // after a 40-byte header, or inside a V4/V5
    if (n < 66 || le32(m) != 0xFF0000 || le32(m + 4) != 0xFF00 ||
        le32(m + 8) != 0xFF)
      throw ImageError("BMP bit fields other than BGRA are not supported");
  } else if (comp != 0) {
    throw ImageError("compressed BMP is not supported");
  }
  return b;
}
}  // namespace

void bmp_info(const uint8_t* data, size_t n, int* w, int* h) {
  const BmpHeader b = bmp_header(data, n);
  *w = b.w;
  *h = b.h;
}

Image bmp_decode(const uint8_t* data, size_t n) {
  const BmpHeader b = bmp_header(data, n);
  const size_t bpp = size_t(b.bits) / 8;
  const size_t stride = (size_t(b.w) * b.bits + 31) / 32 * 4;
  if (b.offset + stride * size_t(b.h) > n)
    throw ImageError("truncated BMP pixel data");
  Image img;
  img.w = b.w;
  img.h = b.h;
  img.px.resize(size_t(b.w) * b.h * 3);
  for (int y = 0; y < b.h; ++y) {
    const int sy = b.top_down ? y : b.h - 1 - y;
    const uint8_t* in = data + b.offset + size_t(sy) * stride;
    uint8_t* o = img.px.data() + size_t(y) * b.w * 3;
    for (int x = 0; x < b.w; ++x) {
      o[3 * x] = in[bpp * x + 2];
      o[3 * x + 1] = in[bpp * x + 1];
      o[3 * x + 2] = in[bpp * x];
    }
  }
  return img;
}

}  // namespace uvcimg

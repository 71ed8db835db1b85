// PNG scanlines to RGB as PIL's convert("RGB") gives them.  The PNG chunk
// walk and the zlib inflate of IDAT run in Python (data/imagelib.py) with
// the standard library's zlib; this file undoes the five scanline filters,
// plain or over the seven passes of Adam7, and converts the pixels.
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

// The seven passes of Adam7 (x0, y0, dx, dy); a plain image is one pass.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};
const int kPlain[1][4] = {{0, 0, 1, 1}};

// The inflated size of an image's data.
size_t png_data_size(int w, int h, int depth, int color_type, int interlace) {
  const int ch = channels_of(color_type);
  const int(*passes)[4] = interlace ? kAdam7 : kPlain;
  size_t need = 0;
  for (int p = 0; p < (interlace ? 7 : 1); ++p) {
    const int pw = (w - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    const int ph = (h - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (pw > 0 && ph > 0)
      need += size_t(ph) * (1 + (size_t(pw) * ch * depth + 7) / 8);
  }
  return need;
}

}  // namespace

void png_unfilter_rgb(uint8_t* raw, size_t raw_len, int w, int h, int depth,
                      int color_type, int interlace, const uint8_t* plte,
                      int n_plte, uint8_t* out) {
  const int ch = channels_of(color_type);
  const bool ok_depth =
      depth == 8 || (depth == 16 && color_type != 3) ||
      ((color_type == 0 || color_type == 3) &&
       (depth == 1 || depth == 2 || depth == 4));
  if (!ok_depth)
    throw ImageError("PNG bit depth " + std::to_string(depth) +
                     " for colour type " + std::to_string(color_type) +
                     " is not supported");
  if (raw_len < png_data_size(w, h, depth, color_type, interlace))
    throw ImageError("truncated PNG image data");
  const size_t bpp = std::max<size_t>(1, size_t(ch) * depth / 8);
  const int(*passes)[4] = interlace ? kAdam7 : kPlain;
  for (int pass = 0; pass < (interlace ? 7 : 1); ++pass) {
    const int x0 = passes[pass][0], y0 = passes[pass][1];
    const int dx = passes[pass][2], dy = passes[pass][3];
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t rowbytes = (size_t(pw) * ch * depth + 7) / 8;
    uint8_t* prev = nullptr;
    for (int y = 0; y < ph; ++y, raw += rowbytes + 1) {
      const int f = raw[0];
      uint8_t* cur = raw + 1;
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
      uint8_t* o = out + (size_t(y0 + y * dy) * w + x0) * 3;
      for (int x = 0; x < pw; ++x, o += 3 * dx) {
        if (depth == 16) {  // PIL's modes: the high byte, gray clipped
          const uint8_t* p = cur + size_t(x) * ch * 2;
          if (ch >= 3) {
            o[0] = p[0];
            o[1] = p[2];
            o[2] = p[4];
          } else if (ch == 2) {
            o[0] = o[1] = o[2] = p[0];
          } else {
            const int v = p[0] << 8 | p[1];
            o[0] = o[1] = o[2] = uint8_t(std::min(v, 255));
          }
          continue;
        }
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
}

}  // namespace uvcimg

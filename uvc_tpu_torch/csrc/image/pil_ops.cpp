// The pixel work of RandAugment's ops and colour jitter, as Pillow does it
// for an 8-bit RGB image (libImaging's Histo.c, Point.c, Convert.c,
// Blend.c, Filter.c and Geometry.c).  The look-up tables of the integer
// ops and the affine matrices are built in Python as Pillow builds them
// (data/augment.py); these functions apply them.
#include <cmath>
#include <cstring>

#include "image.h"

namespace uvcimg {
namespace {

// Convert.c: rgb2l
inline uint8_t luma(const uint8_t* p) {
  return uint8_t((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
}

// Filter.c's clip8 for float sums
inline uint8_t clip8f(float in) {
  if (in <= 0.0f) return 0;
  if (in >= 255.0f) return 255;
  return uint8_t(in);
}

}  // namespace

void rgb_histogram(const uint8_t* src, size_t npx, int64_t* hist) {
  std::memset(hist, 0, 768 * sizeof(int64_t));
  for (size_t i = 0; i < npx; ++i) {
    ++hist[src[3 * i]];
    ++hist[256 + src[3 * i + 1]];
    ++hist[512 + src[3 * i + 2]];
  }
}

void rgb_lut(const uint8_t* src, size_t npx, const uint8_t* lut,
             uint8_t* dst) {
  for (size_t i = 0; i < npx; ++i) {
    dst[3 * i] = lut[src[3 * i]];
    dst[3 * i + 1] = lut[256 + src[3 * i + 1]];
    dst[3 * i + 2] = lut[512 + src[3 * i + 2]];
  }
}

// ImageEnhance: Image.blend(degenerate, image, factor) with the degenerate
// image of `kind` (0 colour, 1 contrast, 2 brightness, 3 sharpness).
void enhance(const uint8_t* src, int w, int h, int kind, float alpha,
             uint8_t* dst) {
  const size_t n = size_t(w) * h * 3;
  std::vector<uint8_t> deg(n);
  if (kind == 0) {  // convert("L").convert("RGB")
    for (size_t i = 0; i < n; i += 3) deg[i] = deg[i + 1] = deg[i + 2] =
        luma(src + i);
  } else if (kind == 1) {  // a flat image of the rounded mean luma
    int64_t hist[256] = {0};
    for (size_t i = 0; i < n; i += 3) ++hist[luma(src + i)];
    double sum = 0.0;  // ImageStat: sum += j * h[j], in order
    for (int j = 0; j < 256; ++j) sum += double(j * hist[j]);
    const double count = double(size_t(w) * h);
    const double mean = count ? sum / count : 0.0;
    std::memset(deg.data(), int(mean + 0.5), n);
  } else if (kind == 2) {  // black
    std::memset(deg.data(), 0, n);
  } else if (kind == 3) {  // filter(SMOOTH), border pixels kept
    std::memcpy(deg.data(), src, n);
    if (w >= 3 && h >= 3) {
      const float k0 = 1.0f / 13.0f, k1 = 5.0f / 13.0f;
      const float kern[9] = {k0, k0, k0, k0, k1, k0, k0, k0, k0};
      const size_t stride = size_t(w) * 3;
      for (int y = 1; y < h - 1; ++y) {
        const uint8_t* rm = src + size_t(y - 1) * stride;
        const uint8_t* r0 = src + size_t(y) * stride;
        const uint8_t* rp = src + size_t(y + 1) * stride;
        for (int x = 1; x < w - 1; ++x) {
          for (int c = 0; c < 3; ++c) {
            const size_t i = size_t(x) * 3 + c;
            float ss = 0.5f;
            ss += float(rp[i - 3]) * kern[0] + float(rp[i]) * kern[1] +
                  float(rp[i + 3]) * kern[2];
            ss += float(r0[i - 3]) * kern[3] + float(r0[i]) * kern[4] +
                  float(r0[i + 3]) * kern[5];
            ss += float(rm[i - 3]) * kern[6] + float(rm[i]) * kern[7] +
                  float(rm[i + 3]) * kern[8];
            deg[size_t(y) * stride + i] = clip8f(ss);
          }
        }
      }
    }
  } else {
    throw ImageError("unknown enhancement");
  }
  // Blend.c
  if (alpha == 0.0f) {
    std::memcpy(dst, deg.data(), n);
  } else if (alpha == 1.0f) {
    std::memcpy(dst, src, n);
  } else if (alpha >= 0 && alpha <= 1.0f) {
    for (size_t i = 0; i < n; ++i)
      dst[i] = uint8_t(int(deg[i]) + alpha * (int(src[i]) - int(deg[i])));
  } else {
    for (size_t i = 0; i < n; ++i) {
      const float t = float(int(deg[i]) + alpha * (int(src[i]) - int(deg[i])));
      dst[i] = clip8f(t);
    }
  }
}

// Image.transform(size, AFFINE, a, resample, fillcolor=fill): the generic
// transform of Geometry.c, each output pixel centre mapped through `a` in
// double precision and sampled with the BILINEAR or BICUBIC (a = -1)
// filter; a centre that maps outside the image keeps the fill colour.
void affine(const uint8_t* src, int w, int h, const double* a, int interp,
            const uint8_t* fill, uint8_t* dst) {
  const size_t stride = size_t(w) * 3;
  auto floor_i = [](double x) { return x < 0.0 ? int(std::floor(x)) : int(x); };
  auto xclip = [w](int x) { return x < 0 ? 0 : (x < w ? x : w - 1); };
  auto yclip = [h](int y) { return y < 0 ? 0 : (y < h ? y : h - 1); };
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint8_t* out = dst + size_t(y) * stride + size_t(x) * 3;
      const double xin0 = x + 0.5, yin0 = y + 0.5;
      double xin = a[0] * xin0 + a[1] * yin0 + a[2];
      double yin = a[3] * xin0 + a[4] * yin0 + a[5];
      if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) {
        std::memcpy(out, fill, 3);
        continue;
      }
      xin -= 0.5;
      yin -= 0.5;
      int xi = floor_i(xin), yi = floor_i(yin);
      const double dx = xin - xi, dy = yin - yi;
      if (interp == BILINEAR) {
        const int x0 = xclip(xi) * 3, x1 = xclip(xi + 1) * 3;
        for (int b = 0; b < 3; ++b) {
          const uint8_t* in = src + size_t(yclip(yi)) * stride + b;
          double v1 = in[x0] + (in[x1] - in[x0]) * dx;
          double v2;
          if (yi + 1 >= 0 && yi + 1 < h) {
            in = src + size_t(yi + 1) * stride + b;
            v2 = in[x0] + (in[x1] - in[x0]) * dx;
          } else {
            v2 = v1;
          }
          v1 = v1 + (v2 - v1) * dy;
          out[b] = uint8_t(v1);
        }
      } else {
        --xi;
        --yi;
        const int x0 = xclip(xi) * 3, x1 = xclip(xi + 1) * 3,
                  x2 = xclip(xi + 2) * 3, x3 = xclip(xi + 3) * 3;
        auto cubic = [](double v1, double v2, double v3, double v4, double d) {
          const double p1 = v2;
          const double p2 = -v1 + v3;
          const double p3 = 2 * (v1 - v2) + v3 - v4;
          const double p4 = -v1 + v2 - v3 + v4;
          return p1 + d * (p2 + d * (p3 + d * p4));
        };
        for (int b = 0; b < 3; ++b) {
          auto row = [&](const uint8_t* in) {
            return cubic(in[x0], in[x1], in[x2], in[x3], dx);
          };
          const double v1 = row(src + size_t(yclip(yi)) * stride + b);
          const double v2 = (yi + 1 >= 0 && yi + 1 < h)
                                ? row(src + size_t(yi + 1) * stride + b) : v1;
          const double v3 = (yi + 2 >= 0 && yi + 2 < h)
                                ? row(src + size_t(yi + 2) * stride + b) : v2;
          const double v4 = (yi + 3 >= 0 && yi + 3 < h)
                                ? row(src + size_t(yi + 3) * stride + b) : v3;
          const double v = cubic(v1, v2, v3, v4, dy);
          out[b] = v <= 0.0 ? 0 : (v >= 255.0 ? 255 : uint8_t(v));
        }
      }
    }
  }
}

}  // namespace uvcimg

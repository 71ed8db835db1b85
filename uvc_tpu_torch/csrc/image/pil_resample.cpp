// Pillow's Image.resize for 8-bit RGB, exactly (libImaging/Resample.c and,
// for NEAREST, Geometry.c's ImagingScaleAffine), and the PIL path's crop
// plan built on it.
//
// BILINEAR and BICUBIC (a = -0.5): the coefficients in double precision
// (support x scale, centre (xx + 0.5) * scale, normalised to sum 1), then
// fixed point at PRECISION_BITS = 22 with +-0.5 rounding; the horizontal
// pass first, over the rows the vertical pass reads, into a uint8
// intermediate; then the vertical pass; clip8.  A pass whose axis keeps
// its size and box is skipped, as ImagingResampleInner skips it.
#include <algorithm>
#include <cmath>
#include <cstring>

#include "image.h"

namespace uvcimg {
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // [out][2]: first tap, tap count
  std::vector<int32_t> kk;   // [out][ksize], fixed point
};

// precompute_coeffs + normalize_coeffs_8bpc; in0 / in1 are the box's
// single-precision edges, as Pillow keeps them.
Coeffs precompute(int in_size, float in0, float in1, int out_size,
                  int interp) {
  double (*filter)(double) =
      interp == BICUBIC ? bicubic_filter : bilinear_filter;
  const double fsupport = interp == BICUBIC ? 2.0 : 1.0;
  double scale = double(in1 - in0) / out_size;
  double filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = fsupport * filterscale;
  Coeffs c;
  c.ksize = int(std::ceil(support)) * 2 + 1;
  std::vector<double> kk(size_t(out_size) * c.ksize, 0.0);
  c.bounds.resize(size_t(out_size) * 2);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[size_t(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double w = filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    c.bounds[size_t(xx) * 2] = xmin;
    c.bounds[size_t(xx) * 2 + 1] = xmax;
  }
  c.kk.resize(kk.size());
  for (size_t i = 0; i < kk.size(); ++i)
    c.kk[i] = kk[i] < 0 ? int32_t(-0.5 + kk[i] * (1 << kPrecisionBits))
                        : int32_t(0.5 + kk[i] * (1 << kPrecisionBits));
  return c;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

// ImagingScaleAffine: nearest neighbour with the source positions
// accumulated step by step from the pixel centres.
void nearest_resize(const uint8_t* src, int sw, int sh, size_t stride,
                    int out_w, int out_h, uint8_t* dst) {
  const double a0 = double(float(sw)) / out_w;
  const double a4 = double(float(sh)) / out_h;
  auto coord = [](double v) { return v < 0.0 ? -1 : int(v); };
  std::vector<int> xin(size_t(out_w), 0);
  double xo = 0.0 + a0 * 0.5;
  for (int x = 0; x < out_w; ++x) {
    xin[size_t(x)] = std::min(std::max(coord(xo), 0), sw - 1);
    xo += a0;
  }
  double yo = 0.0 + a4 * 0.5;
  for (int y = 0; y < out_h; ++y) {
    const int yi = std::min(std::max(coord(yo), 0), sh - 1);
    const uint8_t* in = src + size_t(yi) * stride;
    uint8_t* out = dst + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x)
      std::memcpy(out + size_t(x) * 3, in + size_t(xin[size_t(x)]) * 3, 3);
    yo += a4;
  }
}

}  // namespace

void pil_resize(const uint8_t* src, int sw, int sh, size_t stride, int out_w,
                int out_h, int interp, uint8_t* dst) {
  if (out_w < 1 || out_h < 1) throw ImageError("resize to an empty image");
  if (interp == NEAREST) {
    nearest_resize(src, sw, sh, stride, out_w, out_h, dst);
    return;
  }
  if (interp != BILINEAR && interp != BICUBIC)
    throw ImageError("unsupported resample filter");
  const bool need_h = out_w != sw;
  const bool need_v = out_h != sh;
  const Coeffs cv = precompute(sh, 0.0f, float(sh), out_h, interp);
  const int yfirst = cv.bounds[0];
  const int ylast = cv.bounds[size_t(out_h) * 2 - 2] +
                    cv.bounds[size_t(out_h) * 2 - 1];
  // the horizontal pass, into a packed intermediate (or the source itself)
  std::vector<uint8_t> tmp;
  const uint8_t* vin = src;
  size_t vstride = stride;
  int yoff = 0;
  int width = sw;
  if (need_h) {
    const Coeffs ch = precompute(sw, 0.0f, float(sw), out_w, interp);
    const int rows = ylast - yfirst;
    tmp.resize(size_t(rows) * out_w * 3);
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* in = src + size_t(yy + yfirst) * stride;
      uint8_t* out = tmp.data() + size_t(yy) * out_w * 3;
      for (int xx = 0; xx < out_w; ++xx) {
        const int xmin = ch.bounds[size_t(xx) * 2];
        const int xmax = ch.bounds[size_t(xx) * 2 + 1];
        const int32_t* k = &ch.kk[size_t(xx) * ch.ksize];
        int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* p = in + size_t(x + xmin) * 3;
          ss0 += p[0] * k[x];
          ss1 += p[1] * k[x];
          ss2 += p[2] * k[x];
        }
        out[xx * 3] = clip8(ss0);
        out[xx * 3 + 1] = clip8(ss1);
        out[xx * 3 + 2] = clip8(ss2);
      }
    }
    vin = tmp.data();
    vstride = size_t(out_w) * 3;
    yoff = yfirst;
    width = out_w;
  }
  if (!need_v) {  // the vertical bounds then start at row 0
    for (int y = 0; y < out_h; ++y)
      std::memcpy(dst + size_t(y) * width * 3, vin + size_t(y) * vstride,
                  size_t(width) * 3);
    return;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* k = &cv.kk[size_t(yy) * cv.ksize];
    const int ymin = cv.bounds[size_t(yy) * 2] - yoff;
    const int ymax = cv.bounds[size_t(yy) * 2 + 1];
    uint8_t* out = dst + size_t(yy) * width * 3;
    for (int xx = 0; xx < width; ++xx) {
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* p = vin + size_t(y + ymin) * vstride + size_t(xx) * 3;
        ss0 += p[0] * k[y];
        ss1 += p[1] * k[y];
        ss2 += p[2] * k[y];
      }
      out[xx * 3] = clip8(ss0);
      out[xx * 3 + 1] = clip8(ss1);
      out[xx * 3 + 2] = clip8(ss2);
    }
  }
}

void pil_crop(const Image& src, int bx, int by, int bw, int bh, int rw,
              int rh, int cx, int cy, int size, bool flip, int interp,
              uint8_t* out) {
  if (bx < 0 || by < 0 || bw < 1 || bh < 1 || bx + bw > src.w ||
      by + bh > src.h)
    throw ImageError("crop box outside the image");
  if (cx < 0 || cy < 0 || cx + size > rw || cy + size > rh)
    throw ImageError("centre crop outside the resized image");
  const size_t stride = size_t(src.w) * 3;
  const uint8_t* box = src.px.data() + size_t(by) * stride + size_t(bx) * 3;
  std::vector<uint8_t> resized;
  const uint8_t* r = box;
  size_t rstride = stride;
  if (rw != bw || rh != bh) {
    resized.resize(size_t(rw) * rh * 3);
    pil_resize(box, bw, bh, stride, rw, rh, interp, resized.data());
    r = resized.data();
    rstride = size_t(rw) * 3;
  }
  for (int y = 0; y < size; ++y) {
    const uint8_t* in = r + size_t(y + cy) * rstride + size_t(cx) * 3;
    uint8_t* o = out + size_t(y) * size * 3;
    if (!flip) {
      std::memcpy(o, in, size_t(size) * 3);
    } else {
      for (int x = 0; x < size; ++x)
        std::memcpy(o + size_t(size - 1 - x) * 3, in + size_t(x) * 3, 3);
    }
  }
}

}  // namespace uvcimg

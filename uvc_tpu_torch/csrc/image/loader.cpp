// The C interface of the port's image library (loaded with ctypes by
// data/imagelib.py), its thread pool, and the native path's transforms.
//
// The native path is the JAX package's native loader (native/uvc_loader.cpp)
// copied, over this library's JPEG decoder: the splitmix64 Rng, the
// RandomResizedCrop draw, and its own separable resample with float
// weights.  That library is built with -march=native, where the compiler
// fuses some multiply-adds; the fused ones are written here as std::fma
// (the filter polynomials, the filter centre, the two draws of the crop,
// every accumulation of the resample), so this file, built with
// -ffp-contract=off, gives its bits on any x86-64 host (where the host has
// FMA, the resample uses its instruction; std::fma's result is the same).
//
// Every entry point returns 0 on success, else a non-zero status with a
// message in `err`.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>

#include "image.h"

namespace uvcimg {
namespace {

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) throw ImageError("cannot open the file");
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f)) > 0)
    data.insert(data.end(), buf, buf + got);
  const bool bad = std::ferror(f) != 0;
  std::fclose(f);
  if (bad) throw ImageError("cannot read the file");
  return data;
}

enum Format { kJpeg = 1, kPng = 2, kBmp = 3 };

int sniff(const std::vector<uint8_t>& d) {
  const size_t n = d.size();
  if (n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF) return kJpeg;
  if (n >= 8 && std::memcmp(d.data(), "\x89PNG\r\n\x1a\n", 8) == 0)
    return kPng;
  if (n >= 2 && d[0] == 'B' && d[1] == 'M') return kBmp;
  if (n >= 12 && std::memcmp(d.data(), "RIFF", 4) == 0 &&
      std::memcmp(d.data() + 8, "WEBP", 4) == 0)
    throw ImageError("WebP is not supported");
  throw ImageError("not a JPEG, PNG or BMP file");
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// ---------------------------------------------------------------------------
// the native path (native/uvc_loader.cpp)
// ---------------------------------------------------------------------------

struct Rng {  // splitmix64
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

double triangle_filter(double x) {
  x = std::abs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

double native_bicubic_filter(double x) {
  const double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return std::fma(std::fma(a + 2.0, x, -(a + 3.0)) * x, x, 1.0);
  if (x < 2.0) return std::fma(std::fma(x - 5.0, x, 8.0), x, -4.0) * a;
  return 0.0;
}

struct FilterTable {
  std::vector<float> weights;  // [out, kmax]
  std::vector<int> starts;     // [out]
  int kmax;
};

FilterTable build_filter(double origin, double span, int in_size,
                         int out_size, int interp) {
  const double base_support = interp == 1 ? 2.0 : 1.0;
  double (*filt)(double) = interp == 1 ? native_bicubic_filter
                                       : triangle_filter;
  const double scale = span / out_size;
  const double ss = std::max(1.0, scale);
  const double support = base_support * ss;
  const int kmax = int(std::ceil(support * 2.0)) + 2;
  FilterTable t;
  t.kmax = kmax;
  t.weights.assign(size_t(out_size) * kmax, 0.0f);
  t.starts.resize(size_t(out_size));
  for (int o = 0; o < out_size; ++o) {
    const double center = std::fma(o + 0.5, scale, origin);
    int lo = int(std::floor(center - support + 0.5));
    int hi = int(std::ceil(center + support - 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size - 1);
    if (hi < lo) {
      lo = std::min(std::max(int(center), 0), in_size - 1);
      hi = lo;
    }
    t.starts[size_t(o)] = lo;
    double total = 0.0;
    const int n = std::min(hi - lo + 1, kmax);
    for (int k = 0; k < n; ++k) {
      const double x = (lo + k + 0.5 - center) / ss;
      const double w = filt(x);
      t.weights[size_t(o) * kmax + k] = float(w);
      total += w;
    }
    if (total != 0)
      for (int k = 0; k < n; ++k)
        t.weights[size_t(o) * kmax + k] /= float(total);
  }
  return t;
}

// Cloned for hosts with FMA, where std::fma is one instruction instead of
// a libm call; std::fma rounds once either way, so both give these bits.
__attribute__((target_clones("fma", "default")))
void native_resample(const uint8_t* src, int sw, int sh, double x0,
                     double y0, double cw, double ch, uint8_t* dst, int size,
                     bool flip, int interp) {
  const FilterTable fx = build_filter(x0, cw, sw, size, interp);
  const FilterTable fy = build_filter(y0, ch, sh, size, interp);
  const int row_lo = fy.starts[0];
  const int row_hi = std::min(fy.starts[size_t(size) - 1] + fy.kmax, sh);
  const int rows = row_hi - row_lo;
  std::vector<float> tmp(size_t(rows) * size * 3);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* srow = src + size_t(row_lo + r) * sw * 3;
    float* trow = tmp.data() + size_t(r) * size * 3;
    for (int o = 0; o < size; ++o) {
      const int lo = fx.starts[size_t(o)];
      const float* w = &fx.weights[size_t(o) * fx.kmax];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < fx.kmax; ++k) {
        const int ix = lo + k;
        if (ix >= sw) break;
        const float ww = w[k];
        if (ww == 0.0f) continue;
        const uint8_t* p = srow + size_t(ix) * 3;
        acc0 = std::fma(ww, float(p[0]), acc0);
        acc1 = std::fma(ww, float(p[1]), acc1);
        acc2 = std::fma(ww, float(p[2]), acc2);
      }
      trow[o * 3 + 0] = acc0;
      trow[o * 3 + 1] = acc1;
      trow[o * 3 + 2] = acc2;
    }
  }
  for (int oy = 0; oy < size; ++oy) {
    const int lo = fy.starts[size_t(oy)];
    const float* w = &fy.weights[size_t(oy) * fy.kmax];
    for (int ox = 0; ox < size; ++ox) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < fy.kmax; ++k) {
        const int iy = lo + k;
        if (iy >= row_hi) break;
        const float ww = w[k];
        if (ww == 0.0f) continue;
        const float* p = tmp.data() + (size_t(iy - row_lo) * size + ox) * 3;
        acc0 = std::fma(ww, p[0], acc0);
        acc1 = std::fma(ww, p[1], acc1);
        acc2 = std::fma(ww, p[2], acc2);
      }
      const int tx = flip ? (size - 1 - ox) : ox;
      uint8_t* out = dst + (size_t(oy) * size + tx) * 3;
      out[0] = uint8_t(std::lround(std::min(255.f, std::max(0.f, acc0))));
      out[1] = uint8_t(std::lround(std::min(255.f, std::max(0.f, acc1))));
      out[2] = uint8_t(std::lround(std::min(255.f, std::max(0.f, acc2))));
    }
  }
}

// torchvision RandomResizedCrop's draw (10 tries, then the centre crop)
void sample_rrc(Rng& rng, int w, int h, double* x0, double* y0, double* cw,
                double* ch) {
  const double area = double(w) * h;
  for (int i = 0; i < 10; ++i) {
    const double target = area * std::fma(rng.uniform(), 1.0 - 0.08, 0.08);
    const double lr = std::log(3.0 / 4.0), ur = std::log(4.0 / 3.0);
    const double ar = std::exp(std::fma(rng.uniform(), ur - lr, lr));
    const double cw_ = std::round(std::sqrt(target * ar));
    const double ch_ = std::round(std::sqrt(target / ar));
    if (cw_ > 0 && cw_ <= w && ch_ > 0 && ch_ <= h) {
      *x0 = std::floor(rng.uniform() * (w - cw_ + 1));
      *y0 = std::floor(rng.uniform() * (h - ch_ + 1));
      *cw = cw_;
      *ch = ch_;
      return;
    }
  }
  const double in_ratio = double(w) / h;
  if (in_ratio < 3.0 / 4.0) {
    *cw = w;
    *ch = std::round(w / (3.0 / 4.0));
  } else if (in_ratio > 4.0 / 3.0) {
    *ch = h;
    *cw = std::round(h * (4.0 / 3.0));
  } else {
    *cw = w;
    *ch = h;
  }
  *x0 = (w - *cw) / 2;
  *y0 = (h - *ch) / 2;
}

// One image of the native path; false where the JAX package's native
// loader would hand the file to the PIL path (no JPEG, 4 components, or
// data libjpeg-turbo rejects).
bool native_one(const char* path, uint64_t seed, int size, bool train,
                int resize_to, int interp, uint8_t* out) {
  Image img;
  try {
    const std::vector<uint8_t> d = read_file(path);
    if (d.size() < 3 || d[0] != 0xFF || d[1] != 0xD8) return false;
    img = jpeg_decode(d.data(), d.size(), false);
  } catch (const std::exception&) {
    return false;
  }
  const int w = img.w, h = img.h;
  if (train) {
    Rng rng(seed);
    double x0, y0, cw, ch;
    sample_rrc(rng, w, h, &x0, &y0, &cw, &ch);
    const bool flip = rng.uniform() < 0.5;
    native_resample(img.px.data(), w, h, x0, y0, cw, ch, out, size, flip,
                    interp);
  } else {
    const double scale = double(resize_to) / std::min(w, h);
    const double cw = size / scale, ch = size / scale;
    const double x0 = (w - cw) / 2.0, y0 = (h - ch) / 2.0;
    native_resample(img.px.data(), w, h, x0, y0, cw, ch, out, size, false,
                    interp);
  }
  return true;
}

// ---------------------------------------------------------------------------
// thread pool
// ---------------------------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) threads_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // fn(i) for i in [0, n) across the pool; blocks until done.  Whole jobs
  // are serialised: a train and an eval loader may call at once.
  void parallel_for(int n, std::function<void(int)> fn) {
    std::lock_guard<std::mutex> job(job_mu_);
    std::unique_lock<std::mutex> lk(mu_);
    fn_ = std::move(fn);
    next_ = 0;
    total_ = n;
    done_ = 0;
    cv_.notify_all();
    done_cv_.wait(lk, [this] { return done_ == total_; });
    fn_ = nullptr;
  }

 private:
  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || (fn_ && next_ < total_); });
        if (stop_) return;
        idx = next_++;
      }
      fn_(idx);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (++done_ == total_) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> threads_;
  std::mutex job_mu_, mu_;
  std::condition_variable cv_, done_cv_;
  std::function<void(int)> fn_;
  int next_ = 0, total_ = 0, done_ = 0;
  bool stop_ = false;
};

}  // namespace
}  // namespace uvcimg

using namespace uvcimg;

extern "C" {

// Size and format (1 JPEG, 2 PNG, 3 BMP) from the header alone.
int uvc_image_info(const char* path, int* w, int* h, int* fmt, char* err,
                   int errlen) {
  return guarded(err, errlen, [&] {
    const std::vector<uint8_t> d = read_file(path);
    *fmt = sniff(d);
    if (*fmt == kJpeg) {
      jpeg_info(d.data(), d.size(), w, h);
    } else if (*fmt == kBmp) {
      bmp_info(d.data(), d.size(), w, h);
    } else {
      if (d.size() < 24 || std::memcmp(d.data() + 12, "IHDR", 4) != 0)
        throw ImageError("PNG without its IHDR chunk");
      auto be32 = [&](size_t i) {
        return int(uint32_t(d[i]) << 24 | uint32_t(d[i + 1]) << 16 |
                   uint32_t(d[i + 2]) << 8 | d[i + 3]);
      };
      *w = be32(16);
      *h = be32(20);
    }
  });
}

// Decode a JPEG or BMP file to RGB into a buffer the caller frees with
// uvc_image_free; a PNG returns status 2 (decoded through Python's zlib).
int uvc_decode_rgb(const char* path, uint8_t** out, int* w, int* h,
                   char* err, int errlen) {
  *out = nullptr;
  int png = 0;
  const int st = guarded(err, errlen, [&] {
    const std::vector<uint8_t> d = read_file(path);
    const int fmt = sniff(d);
    if (fmt == kPng) {
      png = 1;
      return;
    }
    Image img = fmt == kJpeg ? jpeg_decode(d.data(), d.size(), true)
                             : bmp_decode(d.data(), d.size());
    *w = img.w;
    *h = img.h;
    *out = static_cast<uint8_t*>(std::malloc(img.px.size()));
    if (!*out) throw ImageError("out of memory");
    std::memcpy(*out, img.px.data(), img.px.size());
  });
  return st ? st : (png ? 2 : 0);
}

void uvc_image_free(uint8_t* p) { std::free(p); }

// The PIL path's crop plan (pil_resample.cpp) on a file (JPEG, BMP; a PNG
// returns status 2) or on an RGB array.
int uvc_load_pil_crop(const char* path, const int* plan, uint8_t* out,
                      char* err, int errlen) {
  int png = 0;
  const int st = guarded(err, errlen, [&] {
    const std::vector<uint8_t> d = read_file(path);
    const int fmt = sniff(d);
    if (fmt == kPng) {
      png = 1;
      return;
    }
    const Image img = fmt == kJpeg ? jpeg_decode(d.data(), d.size(), true)
                                   : bmp_decode(d.data(), d.size());
    pil_crop(img, plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
             plan[6], plan[7], plan[8], plan[9] != 0, plan[10], out);
  });
  return st ? st : (png ? 2 : 0);
}

int uvc_pil_crop(const uint8_t* src, int w, int h, const int* plan,
                 uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Image img;
    img.w = w;
    img.h = h;
    img.px.assign(src, src + size_t(w) * h * 3);
    pil_crop(img, plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
             plan[6], plan[7], plan[8], plan[9] != 0, plan[10], out);
  });
}

int uvc_pil_resize(const uint8_t* src, int w, int h, int out_w, int out_h,
                   int interp, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    pil_resize(src, w, h, size_t(w) * 3, out_w, out_h, interp, out);
  });
}

int uvc_png_unfilter(uint8_t* raw, size_t raw_len, int w, int h, int depth,
                     int color_type, const uint8_t* plte, int n_plte,
                     uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    png_unfilter_rgb(raw, raw_len, w, h, depth, color_type, plte, n_plte,
                     out);
  });
}

// RandAugment / jitter pixel work (pil_ops.cpp)
void uvc_rgb_histogram(const uint8_t* src, size_t npx, int64_t* hist) {
  rgb_histogram(src, npx, hist);
}

void uvc_rgb_lut(const uint8_t* src, size_t npx, const uint8_t* lut,
                 uint8_t* out) {
  rgb_lut(src, npx, lut, out);
}

int uvc_enhance(const uint8_t* src, int w, int h, int kind, float alpha,
                uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { enhance(src, w, h, kind, alpha, out); });
}

void uvc_affine(const uint8_t* src, int w, int h, const double* a,
                int interp, const uint8_t* fill, uint8_t* out) {
  affine(src, w, h, a, interp, fill, out);
}

// The native path: a pool of `num_threads` workers.
void* uvc_loader_create(int num_threads) {
  return new Pool(std::max(1, num_threads));
}

void uvc_loader_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// The native path's train crop of a w x h image at `seed`: x0, y0, width,
// height and the flip (0 / 1), as load_batch draws them.
void uvc_native_crop_box(int w, int h, uint64_t seed, double* box) {
  Rng rng(seed);
  sample_rrc(rng, w, h, &box[0], &box[1], &box[2], &box[3]);
  box[4] = rng.uniform() < 0.5 ? 1.0 : 0.0;
}

// paths: n C strings; seeds: n uint64; out: n * size*size*3 uint8;
// status: n int32 (0 ok, 1 the caller loads that image through the PIL
// path); interp: 0 bilinear, 1 bicubic.
void uvc_load_batch(void* pool, const char** paths, int n, int size,
                    int train, int resize_to, int interp,
                    const uint64_t* seeds, uint8_t* out, int32_t* status) {
  const size_t stride = size_t(size) * size * 3;
  static_cast<Pool*>(pool)->parallel_for(n, [&](int i) {
    status[i] = native_one(paths[i], seeds ? seeds[i] : 0, size, train != 0,
                           resize_to, interp, out + size_t(i) * stride)
                    ? 0 : 1;
  });
}

}  // extern "C"

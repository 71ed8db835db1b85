// Host image code of uvc_tpu_torch's input pipeline: decoders and the
// transforms of the two folder paths, with no image library beneath.
//
// Every function here is plain C++17 on 8-bit RGB buffers.  The decoders
// and transforms are written to give the bits that PIL (with its bundled
// libjpeg-turbo) and the JAX package's native loader give, so they are
// built without contracted multiply-adds (-ffp-contract=off); where the
// native loader's arithmetic was fused, the fusion is written out as
// std::fma.  Errors are thrown as ImageError and turned into a status and a
// message at the C interface (loader.cpp).
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace uvcimg {

struct ImageError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// PIL refuses an image of more pixels than this (twice
// Image.MAX_IMAGE_PIXELS: a decompression bomb), and so do the BMP and WebP
// decoders here, before they allocate.
constexpr uint64_t kMaxPixels = 2 * uint64_t(89478485);
inline void check_pixels(uint64_t w, uint64_t h, const char* what) {
  if (w * h > kMaxPixels)
    throw ImageError(std::string(what) + " of more pixels than PIL opens");
}

// An 8-bit RGB image, rows packed.
struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
};

// --- jpeg.cpp ---------------------------------------------------------------
// The frame's size from the markers before the first scan; throws if the
// data is no JPEG or its frame cannot be decoded.
void jpeg_info(const uint8_t* data, size_t n, int* w, int* h);
// Decode to RGB as libjpeg-turbo with out_color_space = JCS_RGB (1 and 3
// components).  With `cmyk_to_rgb`, a 4-component file decodes to CMYK as
// libjpeg-turbo does and then to RGB as PIL's convert("RGB") of its
// inverted "CMYK;I" raw mode; without it such a file throws.
Image jpeg_decode(const uint8_t* data, size_t n, bool cmyk_to_rgb);

// --- png.cpp ----------------------------------------------------------------
// Undo the scanline filters of a PNG whose zlib stream has been inflated
// into `raw` (the seven Adam7 passes when `interlace`), and convert to RGB
// as PIL's convert("RGB"): colour types 0/2/3/4/6 at bit depths 1-16
// (palette `plte`, n_plte entries; 16-bit samples by their high byte, but
// 16-bit gray, PIL's mode I;16, clipped to 255).
void png_unfilter_rgb(uint8_t* raw, size_t raw_len, int w, int h, int depth,
                      int color_type, int interlace, const uint8_t* plte,
                      int n_plte, uint8_t* out);
void bmp_info(const uint8_t* data, size_t n, int* w, int* h);
Image bmp_decode(const uint8_t* data, size_t n);

// --- webp_vp8l.cpp (the container), webp_vp8.cpp ---------------------------
// The canvas size, as PIL's WebP plugin reports it.
void webp_info(const uint8_t* data, size_t n, int* w, int* h);
// The first frame on its canvas as libwebp's WebPAnimDecoder gives it to
// PIL, without its alpha, as PIL's convert("RGB").
Image webp_decode(const uint8_t* data, size_t n);

// --- pil_resample.cpp -------------------------------------------------------
enum Interp { NEAREST = 0, BILINEAR = 2, BICUBIC = 3 };  // PIL's codes
// PIL's Image.resize((out_w, out_h), interp) of the RGB image `src`
// (stride in bytes), into `dst` (packed).
void pil_resize(const uint8_t* src, int sw, int sh, size_t stride, int out_w,
                int out_h, int interp, uint8_t* dst);
// The PIL path's crop plan: crop box (bx, by, bw, bh) of `src`, resize it to
// (rw, rh) (skipped when equal to the box), crop (cx, cy, size, size) of
// the result and mirror it when `flip`.
void pil_crop(const Image& src, int bx, int by, int bw, int bh, int rw,
              int rh, int cx, int cy, int size, bool flip, int interp,
              uint8_t* out);

// --- pil_ops.cpp ------------------------------------------------------------
// Per-channel histogram (768 counts) and look-up table (768 entries) of an
// RGB image of npx pixels.
void rgb_histogram(const uint8_t* src, size_t npx, int64_t* hist);
void rgb_lut(const uint8_t* src, size_t npx, const uint8_t* lut,
             uint8_t* dst);
// ImageEnhance's Color (0), Contrast (1), Brightness (2) or Sharpness (3)
// at `alpha` (Image.blend's single-precision factor).
void enhance(const uint8_t* src, int w, int h, int kind, float alpha,
             uint8_t* dst);
// Image.transform(AFFINE) with the matrix a[6], BILINEAR or BICUBIC, and
// the RGB fill colour where a sample falls outside.
void affine(const uint8_t* src, int w, int h, const double* a, int interp,
            const uint8_t* fill, uint8_t* dst);

}  // namespace uvcimg

// What the WebP files share: the VP8 frame's planes and the decoders of
// the two bitstreams (webp_vp8.cpp, webp_vp8l.cpp).  The container walk
// is in webp_vp8l.cpp.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace uvcimg {

// A decoded VP8 frame: Y'CbCr 4:2:0 planes padded to whole macroblocks.
struct Yuv420 {
  int width = 0, height = 0, y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};

// The frame size from a VP8 key frame's header.
void vp8_frame_size(const uint8_t* data, size_t n, int* w, int* h);
// Decode the VP8 key frame in `data` (a "VP8 " chunk's payload).
void vp8_decode(const uint8_t* data, size_t n, Yuv420* out);
// To RGB as libwebp's RGBA output (fancy upsampling), rows of `stride`
// bytes, 4 bytes a pixel; the alpha bytes are left as they are.
void yuv420_to_rgba(const Yuv420& in, uint8_t* rgba, size_t stride);

}  // namespace uvcimg

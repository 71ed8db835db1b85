"""Write the image fixtures (``tests/fixtures/images/``) and their digests.

The files cover what the port's image library decodes: JPEG at several
sizes (1x1 to 500x375), samplings (4:4:4, 4:2:2, 4:2:0), qualities (50,
75, 95), baseline, progressive and optimised, grayscale, CMYK and
restart markers; PNG in modes RGB, RGBA, L, LA, P (8- and 4-bit) and 1;
BMP at 24 and 32 bits. Six of the JPEGs are photo-sized
(``IMAGENET_LIKE``: 500x375, 500x333, 375x500 and 333x500, 4:2:0
baseline at quality 85-95, 2.9-5.4 bits a pixel, 87 KB a file on
average; ILSVRC-2012's train files average about 108 KB, 138 GB in 1.28
M files): the loader benchmarks time those alone, since a decode's cost
grows with the file's pixels and bits. Five more (``LIBJPEG_FILES``)
carry samplings that PIL cannot write (h1v2, 4:1:1, 4:1:0, 3:1, chroma
above luma); they were written once by libjpeg-turbo 2.1.5's encoder
with the components' sampling factors set, from ``photo`` at seeds 40-44
and quality 85, and are committed as they are: this script does not
rewrite them, and their records are the PIL decode alone.
``digests.json`` holds, per record, the sha256
(``tests/image_check.py::digest``) of what PIL and the JAX package make
of them: each file's ``convert("RGB")``, the PIL path's train and eval
crops (``uvc_tpu.data.pipeline``), the native path's
(``uvc_tpu.data.native_loader``, its library built from ``native/``),
and RandAugment's ops, colour jitter and the whole policy
(``uvc_tpu.data.augment``) on one PIL-path crop. A train record also
keeps the box the port draws here, which the card's check prints beside
its own when a digest differs.

The WebP files (``webp_*``) are PIL's (libwebp's) lossy, lossless,
palette and alpha encodings, four of them photo-sized (``WEBP_PHOTOS``:
the first ``IMAGENET_LIKE`` photo of each shape re-encoded at quality 80;
55 KB a file on average), on which the card's check trains.  The files PIL cannot write (``HAND_FILES``) are written here by
this script's own encoders: PNG at 16 bits and with Adam7 interlacing
(``png_bytes``), BMP with 4-bit, 16-bit, OS/2 and run-length coded
pixels (``bmp_bytes``, ``rle_bytes``), WebP whose alpha is raw with
each of its four filters, an animated WebP whose first frame sits
at an offset inside its canvas (``anim_webp``), and two VP8 frames with
the header fields libwebp's encoder never writes (``vp8_webp``: the
simple loop filter, sharpness, loop-filter deltas, 4 and 8 token
partitions, relative segment values, probability updates).

``python tests/make_image_fixtures.py`` rewrites the files and the
digests with this machine's PIL; the tier-1 test recomputes the digests
from the committed files and compares (``reference_records``).
"""

from __future__ import annotations

import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "images"

# name -> (format, mode, width, height, save options)
FILES = {
    "jpeg_1x1_420.jpg": ("JPEG", "RGB", 1, 1, dict(subsampling=2)),
    "jpeg_17x9_420.jpg": ("JPEG", "RGB", 17, 9, dict(subsampling=2)),
    "jpeg_97x131_444_q95.jpg": ("JPEG", "RGB", 97, 131,
                                dict(subsampling=0, quality=95)),
    "jpeg_333x500_422.jpg": ("JPEG", "RGB", 333, 500, dict(subsampling=1)),
    "jpeg_500x375_420_q50.jpg": ("JPEG", "RGB", 500, 375,
                                 dict(subsampling=2, quality=50)),
    "jpeg_500x375_420_progressive.jpg": ("JPEG", "RGB", 500, 375,
                                         dict(subsampling=2,
                                              progressive=True)),
    "jpeg_333x500_444_progressive_optimized_q95.jpg": (
        "JPEG", "RGB", 333, 500,
        dict(subsampling=0, progressive=True, optimize=True, quality=95)),
    "jpeg_97x131_422_optimized_q50.jpg": ("JPEG", "RGB", 97, 131,
                                          dict(subsampling=1, optimize=True,
                                               quality=50)),
    "jpeg_201x143_420_q95.jpg": ("JPEG", "RGB", 201, 143,
                                 dict(subsampling=2, quality=95)),
    "jpeg_gray_131x97.jpg": ("JPEG", "L", 131, 97, {}),
    "jpeg_gray_64x48_progressive.jpg": ("JPEG", "L", 64, 48,
                                        dict(progressive=True)),
    "jpeg_cmyk_97x131.jpg": ("JPEG", "CMYK", 97, 131, dict(quality=90)),
    "jpeg_200x150_420_restart_rows.jpg": ("JPEG", "RGB", 200, 150,
                                          dict(subsampling=2,
                                               restart_marker_rows=1)),
    "jpeg_160x120_progressive_restart.jpg": ("JPEG", "RGB", 160, 120,
                                             dict(progressive=True,
                                                  restart_marker_blocks=4)),
    "png_rgb_64x48.png": ("PNG", "RGB", 64, 48, {}),
    "png_rgba_48x64.png": ("PNG", "RGBA", 48, 64, {}),
    "png_l_33x21.png": ("PNG", "L", 33, 21, {}),
    "png_la_21x33.png": ("PNG", "LA", 21, 33, {}),
    "png_p_64x48.png": ("PNG", "P", 64, 48, dict(optimize=True)),
    "png_p4_40x30.png": ("PNG", "P16", 40, 30, {}),
    "png_1bit_45x31.png": ("PNG", "1", 45, 31, {}),
    "bmp_24_50x37.bmp": ("BMP", "RGB", 50, 37, {}),
    "bmp_32_37x50.bmp": ("BMP", "RGBA", 37, 50, {}),
}
# name -> (width, height, quality): photo-sized 4:2:0 baseline JPEGs with
# more noise than the others (``photo(..., noise=PHOTO_NOISE)``)
IMAGENET_LIKE = {
    "imagenet_500x375_420_q90.jpg": (500, 375, 90),
    "imagenet_500x375_420_q95.jpg": (500, 375, 95),
    "imagenet_500x333_420_q88.jpg": (500, 333, 88),
    "imagenet_500x333_420_q92.jpg": (500, 333, 92),
    "imagenet_375x500_420_q90.jpg": (375, 500, 90),
    "imagenet_333x500_420_q85.jpg": (333, 500, 85),
}
PHOTO_NOISE = 16
FILES.update({name: ("JPEG", "RGB", w, h, dict(subsampling=2, quality=q))
              for name, (w, h, q) in IMAGENET_LIKE.items()})
FILES.update({
    "webp_lossy_97x131_q80.webp": ("WEBP", "RGB", 97, 131, dict(quality=80)),
    "webp_lossy_17x9_q30_m0.webp": ("WEBP", "RGB", 17, 9,
                                    dict(quality=30, method=0)),
    "webp_lossy_1x1.webp": ("WEBP", "RGB", 1, 1, {}),
    "webp_lossy_alpha_64x48_m6.webp": ("WEBP", "RGBa", 64, 48,
                                       dict(quality=70, method=6)),
    "webp_lossless_64x48.webp": ("WEBP", "RGB", 64, 48, dict(lossless=True)),
    "webp_lossless_rgba_33x21.webp": ("WEBP", "RGBa", 33, 21,
                                      dict(lossless=True, exact=True)),
    "webp_lossless_p16_40x30.webp": ("WEBP", "P16", 40, 30,
                                     dict(lossless=True)),
    "png_gray16_33x21.png": ("PNG", "I;16", 33, 21, {}),
    "bmp_1bit_45x31.bmp": ("BMP", "1", 45, 31, {}),
    "bmp_8bit_p_40x30.bmp": ("BMP", "P", 40, 30, {}),
})
# photo-sized lossy WebPs: the first IMAGENET_LIKE photo of each shape,
# re-encoded at quality 80
WEBP_PHOTOS = {
    "webp_photo_500x375_q80.webp": "imagenet_500x375_420_q90.jpg",
    "webp_photo_500x333_q80.webp": "imagenet_500x333_420_q88.jpg",
    "webp_photo_375x500_q80.webp": "imagenet_375x500_420_q90.jpg",
    "webp_photo_333x500_q80.webp": "imagenet_333x500_420_q85.jpg",
}
# committed JPEGs that PIL cannot write: name -> the sampling factors
# (h, v) of Y, Cb, Cr
LIBJPEG_FILES = {
    "jpeg_97x131_h1v2.jpg": ((1, 2), (1, 1), (1, 1)),
    "jpeg_131x97_411.jpg": ((4, 1), (1, 1), (1, 1)),
    "jpeg_131x97_410_progressive.jpg": ((4, 2), (1, 1), (1, 1)),
    "jpeg_97x61_311.jpg": ((3, 1), (1, 1), (1, 1)),
    "jpeg_61x97_chroma_2x2_luma_1x1.jpg": ((1, 1), (2, 2), (2, 2)),
}

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _png_rows(samples: np.ndarray, depth: int, bpp: int, first: int
              ) -> bytes:
    """Scanlines of ``samples`` [h, w, channels], each filtered with the
    next of the five filters in turn (from ``first``)."""
    out, prev = bytearray(), None
    for i, r in enumerate(samples):
        flat = r.reshape(-1)
        if depth == 16:
            row = flat.astype(">u2").tobytes()
        elif depth == 8:
            row = flat.astype(np.uint8).tobytes()
        else:
            bits = np.unpackbits(flat.astype(np.uint8)[:, None], axis=1)
            row = np.packbits(bits[:, 8 - depth:].reshape(-1)).tobytes()
        up = prev or bytes(len(row))
        kind = (first + i) % 5
        filt = bytearray(len(row))
        for j, x in enumerate(row):
            a = row[j - bpp] if j >= bpp else 0
            c = up[j - bpp] if j >= bpp else 0
            pred = (0, a, up[j], (a + up[j]) >> 1, _paeth(a, up[j], c))[kind]
            filt[j] = (x - pred) & 255
        out += bytes([kind]) + filt
        prev = row
    return bytes(out)


def png_bytes(samples: np.ndarray, depth: int, color_type: int,
              interlace: bool = False, plte: bytes = b"") -> bytes:
    """A PNG of ``samples`` [h, w, channels] (palette indices for colour
    type 3), plain or Adam7-interlaced."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b"".join(_png_rows(samples[y0::dy, x0::dx], depth, bpp, k)
                        for k, (x0, y0, dx, dy) in enumerate(ADAM7)
                        if x0 < w and y0 < h)
    else:
        data = _png_rows(samples, depth, bpp, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                       0, 0, int(interlace))) +
            (chunk(b"PLTE", plte) if plte else b"") +
            chunk(b"IDAT", zlib.compress(data, 9)) + chunk(b"IEND", b""))


def bmp_bytes(w: int, h: int, bits: int, pixels: bytes, *, comp: int = 0,
              palette=(), core: bool = False, masks=(),
              top_down: bool = False) -> bytes:
    """A BMP file: the OS/2 core header (``core``) or the 40-byte info
    header (with ``masks`` after it for bit fields), the palette (RGB
    triples, stored BGR), then ``pixels`` as stored."""
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        pal = b"".join(bytes((b, g, r)) for r, g, b in palette)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                           bits, comp, len(pixels), 2835, 2835, len(palette),
                           0)
        info += b"".join(struct.pack("<I", m) for m in masks)
        pal = b"".join(bytes((b, g, r, 0)) for r, g, b in palette)
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + pal + pixels)


def rle_bytes(idx: np.ndarray, rle4: bool) -> bytes:
    """Run-length code the palette indices ``idx`` [h, w] (top row first;
    written bottom row first) as RLE8 or RLE4: runs of equal pixels,
    literal stretches (of an even length in RLE4, the one length PIL's
    reader takes whole), an end of line after each row and the end of the
    bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                v = int(row[x])
                out += bytes((run, v << 4 | v if rle4 else v))
                x += run
                continue
            n = 3
            while x + n < w and n < 254 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1] ==
                    row[x + n + 2]):
                n += 1
            if rle4 and n % 2:
                if n > 3:
                    n -= 1
                elif x + 4 <= w:
                    n = 4
                else:
                    out += bytes((1, int(row[x]) << 4))
                    x += 1
                    continue
            lit = [int(v) for v in row[x:x + n]]
            if rle4:
                lit += [0] * (n % 2)
                body = bytes(a << 4 | b for a, b in zip(lit[::2], lit[1::2]))
            else:
                body = bytes(lit)
            out += bytes((0, n)) + body + b"\0" * (len(body) % 2)
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) % 2)


def _webp_chunks(img, **opts) -> bytes:
    """The image chunks (ALPH and VP8 or VP8L) of PIL's encoding of
    ``img`` (``opts`` of its WebP writer), without the RIFF and VP8X
    headers."""
    b = io.BytesIO()
    img.save(b, "WEBP", **{"quality": 75, **opts})
    data = b.getvalue()[12:]
    out = b""
    while data:
        size = struct.unpack("<I", data[4:8])[0]
        if data[:4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[:8 + size + size % 2]
        data = data[8 + size + size % 2:]
    return out


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes((flags, 0, 0, 0)) +
                  (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def anim_webp(canvas: tuple, frames: list, **opts) -> bytes:
    """An animated WebP of ``canvas`` (w, h) and ``frames``, each (x, y,
    PIL image; x and y even) encoded with ``opts``, none blended."""
    body = _vp8x(0x02 | 0x10, *canvas)
    body += _chunk(b"ANIM", struct.pack("<IH", 0xFF204080, 0))
    for x, y, img in frames:
        w, h = img.size
        head = b"".join(v.to_bytes(3, "little") for v in
                        (x // 2, y // 2, w - 1, h - 1, 100)) + bytes((2,))
        body += _chunk(b"ANMF", head + _webp_chunks(img, **opts))
    return _riff(body)


def raw_alpha_webp(rgb: np.ndarray, alpha: np.ndarray, filt: int) -> bytes:
    """A lossy WebP of ``rgb`` with ``alpha`` in an uncompressed ALPH chunk,
    filtered with ``filt`` (0 none, 1 horizontal, 2 vertical, 3 gradient)
    as the container specification defines the filters."""
    from PIL import Image
    a = alpha.astype(int)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]               # the first row: left
        pred[1:, 0] = a[:-1, 0]               # the first column: above
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0,
                                   255)
    alph = bytes((filt << 2,)) + ((a - pred) & 255).astype(np.uint8).tobytes()
    vp8 = _webp_chunks(Image.fromarray(rgb))
    return _riff(_vp8x(0x10, w, h) + _chunk(b"ALPH", alph) + vp8)


# the files written by _hand_files
HAND_FILES = (
    "png_rgb16_adam7_37x29.png", "png_rgba16_29x37.png",
    "png_la16_adam7_21x17.png", "png_gray16_adam7_17x21.png",
    "png_rgb_adam7_45x31.png", "png_p4_adam7_33x21.png",
    "png_gray2_adam7_23x19.png", "png_1bit_adam7_9x9.png",
    "bmp_4bit_37x23.bmp", "bmp_16_555_37x23.bmp",
    "bmp_16_565_bitfields_37x23.bmp", "bmp_16_555_bitfields_37x23.bmp",
    "bmp_os2_8bit_37x23.bmp", "bmp_24_topdown_37x23.bmp",
    "bmp_rle8_37x23.bmp", "bmp_rle4_37x23.bmp",
    "webp_alpha_raw_none_29x19.webp", "webp_alpha_raw_horizontal_29x19.webp",
    "webp_alpha_raw_vertical_29x19.webp", "webp_alpha_raw_gradient_29x19.webp",
    "webp_anim_offset_48x32.webp", "webp_anim_lossless_alpha_40x24.webp",
    "webp_vp8_simple_filter_4parts_45x37.webp",
    "webp_vp8_lf_deltas_segments_45x37.webp",
)


class BoolWriter:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bits = bytearray(), 255, 0, 24

    def put(self, bit: int, prob: int = 128) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):          # carry into the output
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bits -= 1
            if not self.bits:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bits = 8

    def literal(self, v: int, n: int) -> None:
        for i in reversed(range(n)):
            self.put((v >> i) & 1)

    def flagged(self, v: int, n: int) -> None:
        """A flag, then (when v) |v| in n bits and its sign."""
        self.put(int(v != 0))
        if v:
            self.literal(abs(v), n)
            self.put(int(v < 0))

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0)
        return bytes(self.out)


def vp8_webp(rng, w: int, h: int, *, simple: bool, level: int,
             sharpness: int, lf_delta: bool, parts_log2: int,
             segments: bool, absolute: bool, q: int,
             update_probs: bool) -> bytes:
    """A lossy WebP whose VP8 key frame carries these header fields
    (the simple or normal loop filter at ``level`` and ``sharpness``,
    loop-filter deltas, 1-8 token partitions, segments with absolute or
    relative values, base quantiser ``q``, coefficient probability
    updates) and random bits for its modes and tokens (mostly zero bytes
    in the token partitions), which both decoders read alike: the fields
    libwebp's encoder never writes."""
    bw = BoolWriter()
    bw.put(0)                                   # colour space
    bw.put(0)                                   # clamping
    bw.put(int(segments))
    if segments:
        bw.put(1)                               # update the map
        bw.put(1)                               # update the data
        bw.put(int(absolute))
        for _ in range(4):
            bw.flagged(int(rng.integers(0, 40) if absolute else
                           rng.integers(-15, 16)), 7)
        for _ in range(4):
            bw.flagged(int(rng.integers(0, 63) if absolute else
                           rng.integers(-20, 21)), 6)
        for _ in range(3):
            bw.put(1)
            bw.literal(int(rng.integers(1, 256)), 8)
    bw.put(int(simple))
    bw.literal(level, 6)
    bw.literal(sharpness, 3)
    bw.put(int(lf_delta))
    if lf_delta:
        bw.put(1)
        for _ in range(8):
            bw.flagged(int(rng.integers(-20, 21)), 6)
    bw.literal(parts_log2, 2)
    bw.literal(q, 7)
    for _ in range(5):
        bw.flagged(int(rng.integers(-15, 16)) if rng.integers(2) else 0, 4)
    bw.put(0)                                   # refresh entropy probs
    for _ in range(4 * 8 * 3 * 11):             # the update flags
        bw.put(int(update_probs and rng.integers(20) == 0),
               128 if update_probs else 255)
    skip = int(rng.integers(2))
    bw.put(skip)
    if skip:
        bw.literal(int(rng.integers(0, 256)), 8)
    mbs = ((w + 15) // 16) * ((h + 15) // 16)
    for _ in range(40 * mbs):                   # the modes
        bw.put(int(rng.integers(2)))
    part0 = bw.finish()
    parts = []
    for _ in range(1 << parts_log2):
        n = 60 * mbs // (1 << parts_log2) + 64
        parts.append(np.where(rng.random(n) < 0.15, rng.integers(0, 256, n),
                              0).astype(np.uint8).tobytes())
    frame = (struct.pack("<I", 1 << 4 | len(part0) << 5)[:3] +
             b"\x9d\x01\x2a" + struct.pack("<HH", w, h) + part0 +
             b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1]) +
             b"".join(parts))
    return _riff(_chunk(b"VP8 ", frame))


def _hand_files() -> dict:
    """name -> the bytes of each file written here."""
    from PIL import Image
    out = {}
    gen = iter(range(100, 200))              # the photos' seeds
    for name, (ctype, depth, interlace, w, h) in {
            "png_rgb16_adam7_37x29.png": (2, 16, True, 37, 29),
            "png_rgba16_29x37.png": (6, 16, False, 29, 37),
            "png_la16_adam7_21x17.png": (4, 16, True, 21, 17),
            "png_gray16_adam7_17x21.png": (0, 16, True, 17, 21),
            "png_rgb_adam7_45x31.png": (2, 8, True, 45, 31),
            "png_p4_adam7_33x21.png": (3, 4, True, 33, 21),
            "png_gray2_adam7_23x19.png": (0, 2, True, 23, 19),
            "png_1bit_adam7_9x9.png": (0, 1, True, 9, 9)}.items():
        img = photo(w, h, next(gen)).astype(np.int64)
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        plte = b""
        if ctype == 3:
            samples = img[..., :1] % (1 << depth)
            plte = photo(1 << depth, 1, next(gen)).tobytes()
        elif depth == 16:
            samples = np.dstack([img, img[..., :1]])[..., :ch] * 257
            samples = np.minimum(samples + np.arange(w)[None, :, None] * 3,
                                 65535)
            if ctype == 0:
                samples = samples // 64        # gray: around 255
        else:
            samples = np.dstack([img, img[..., :1]])[..., :ch] >> (8 - depth)
        out[name] = png_bytes(samples, depth, ctype, interlace, plte)
    # BMP: 4-bit palette, 16 bits (5-5-5 plain, 5-6-5 and 5-5-5 bit
    # fields), OS/2 8-bit, top-down 24-bit, RLE8, RLE4
    w, h = 37, 23
    img = photo(w, h, next(gen))
    pal16 = [tuple(int(v) for v in c) for c in photo(16, 1, next(gen))[0]]
    idx4 = (img[..., 0] // 16).astype(np.uint8)
    stride4 = (w * 4 + 31) // 32 * 4
    rows4 = b"".join(np.packbits(np.unpackbits(r[:, None], axis=1)[:, 4:]
                                 .reshape(-1)).tobytes().ljust(stride4, b"\0")
                     for r in idx4[::-1])
    out["bmp_4bit_37x23.bmp"] = bmp_bytes(w, h, 4, rows4, palette=pal16)
    v = img.astype(np.uint32)
    for name, masks, word in (
            ("bmp_16_555_37x23.bmp", (),
             (v[..., 0] >> 3) << 10 | (v[..., 1] >> 3) << 5 | v[..., 2] >> 3),
            ("bmp_16_565_bitfields_37x23.bmp", (0xF800, 0x7E0, 0x1F),
             (v[..., 0] >> 3) << 11 | (v[..., 1] >> 2) << 5 | v[..., 2] >> 3),
            ("bmp_16_555_bitfields_37x23.bmp", (0x7C00, 0x3E0, 0x1F),
             (v[..., 0] >> 3) << 10 | (v[..., 1] >> 3) << 5 | v[..., 2] >> 3)):
        rows = b"".join(r.astype("<u2").tobytes().ljust((w * 2 + 3) // 4 * 4,
                                                        b"\0")
                        for r in word[::-1])
        out[name] = bmp_bytes(w, h, 16, rows, comp=3 if masks else 0,
                              masks=masks)
    pal256 = [tuple(int(x) for x in c) for c in photo(256, 1, next(gen))[0]]
    idx8 = img[..., 1]
    rows8 = b"".join(r.tobytes().ljust((w + 3) // 4 * 4, b"\0")
                     for r in idx8[::-1])
    out["bmp_os2_8bit_37x23.bmp"] = bmp_bytes(w, h, 8, rows8, palette=pal256,
                                              core=True)
    rows24 = b"".join(r[:, ::-1].tobytes().ljust((w * 3 + 3) // 4 * 4, b"\0")
                      for r in img)
    out["bmp_24_topdown_37x23.bmp"] = bmp_bytes(w, h, 24, rows24,
                                                top_down=True)
    # flat runs among noise, so that both runs and literals occur
    flat = (idx8 // 32 * 32).astype(np.uint8)
    flat[::3] = idx8[::3]
    out["bmp_rle8_37x23.bmp"] = bmp_bytes(w, h, 8, rle_bytes(flat, False),
                                          comp=1, palette=pal256)
    out["bmp_rle4_37x23.bmp"] = bmp_bytes(w, h, 4, rle_bytes(idx4 // 4 * 4,
                                                             True),
                                          comp=2, palette=pal16)
    # WebP: raw alpha under each filter, an animation's offset first frame
    rgb = photo(29, 19, next(gen))
    alpha = photo(29, 19, next(gen))[..., 0]
    alpha[:6, :9] = 0
    for filt, fname in enumerate(("none", "horizontal", "vertical",
                                  "gradient")):
        out[f"webp_alpha_raw_{fname}_29x19.webp"] = raw_alpha_webp(rgb, alpha,
                                                                   filt)
    frames = [Image.fromarray(photo(30, 20, next(gen))),
              Image.fromarray(photo(48, 32, next(gen)))]
    out["webp_anim_offset_48x32.webp"] = anim_webp(
        (48, 32), [(6, 8, frames[0]), (0, 0, frames[1])])
    frames = [Image.fromarray(np.dstack([photo(40, 24, next(gen)),
                                         photo(40, 24, next(gen))[..., :1]])),
              Image.fromarray(photo(36, 20, next(gen)))]
    out["webp_anim_lossless_alpha_40x24.webp"] = anim_webp(
        (40, 24), [(0, 0, frames[0]), (2, 2, frames[1])], lossless=True)
    rng = np.random.default_rng(next(gen))
    out["webp_vp8_simple_filter_4parts_45x37.webp"] = vp8_webp(
        rng, 45, 37, simple=True, level=40, sharpness=5, lf_delta=False,
        parts_log2=2, segments=False, absolute=False, q=20,
        update_probs=False)
    out["webp_vp8_lf_deltas_segments_45x37.webp"] = vp8_webp(
        rng, 45, 37, simple=False, level=30, sharpness=2, lf_delta=True,
        parts_log2=3, segments=True, absolute=False, q=40,
        update_probs=True)
    assert sorted(out) == sorted(HAND_FILES)
    return out


SEEDS = (0, 1, 2)
SIZE = 224
INTERPS = ("bilinear", "bicubic")
OP_SOURCE = {"file": "jpeg_500x375_420_progressive.jpg", "seed": 0,
             "size": SIZE, "interp": "bicubic"}
# colour jitter and the whole policy on one crop of a WebP photo too
WEBP_SOURCE = {"file": "webp_photo_500x375_q80.webp", "seed": 0,
               "size": SIZE, "interp": "bicubic"}
OP_LEVELS = (0.0, 2.5, 5.0, 7.5, 10.0)
OP_RNG = 7
DRAWS = (0, 1, 2, 3)


def photo(w: int, h: int, seed: int, noise: float = 4) -> np.ndarray:
    """A photo-like test card: smooth waves, a few flat shapes with edges,
    noise of standard deviation ``noise``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 1)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            f = rng.uniform(0.5, 6, 2)
            img[..., c] += np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) +
                                  rng.uniform(0, 2 * np.pi))
    img = 128 + 35 * img
    for _ in range(4):
        x0, y0 = rng.integers(0, max(w, 1)), rng.integers(0, max(h, 1))
        img[y0:y0 + h // 3, x0:x0 + w // 4] = rng.integers(0, 256, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(out: Path = FIXTURES) -> None:
    from PIL import Image
    out.mkdir(parents=True, exist_ok=True)
    names = list(FILES)
    for i, (name, (fmt, mode, w, h, opts)) in enumerate(FILES.items()):
        img = Image.fromarray(photo(
            w, h, i, PHOTO_NOISE if name in IMAGENET_LIKE else 4))
        if mode == "P16":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=16)
        elif mode == "P":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=200)
        elif mode == "RGBa":        # RGBA with an alpha of its own
            a = photo(w, h, i + 1000)[..., :1]
            a[: h // 3, : w // 3] = 0
            img = Image.fromarray(np.dstack([np.asarray(img), a]))
        elif mode == "I;16":        # 16-bit gray about 255: PIL clips it
            g = np.asarray(img)[..., 0].astype(np.uint16)
            img = Image.fromarray(g * g // 64)
        elif mode != "RGB":
            img = img.convert(mode)
        img.save(out / name, fmt, **opts)
    for name, jpeg in WEBP_PHOTOS.items():
        w, h, _ = IMAGENET_LIKE[jpeg]
        Image.fromarray(photo(w, h, names.index(jpeg), PHOTO_NOISE)).save(
            out / name, "WEBP", quality=80)
    for name, data in _hand_files().items():
        (out / name).write_bytes(data)


def file_names() -> list:
    """Every fixture file's name."""
    return [*FILES, *WEBP_PHOTOS, *HAND_FILES, *LIBJPEG_FILES]


def _records() -> list:
    """The records without their digests (and boxes)."""
    recs = [{"kind": "decode", "file": f} for f in file_names()]
    for f in [*FILES, *WEBP_PHOTOS, *HAND_FILES]:
        for interp in INTERPS:
            for path in ("pil", "native"):
                for seed in SEEDS:
                    recs.append({"kind": f"{path}_train", "file": f,
                                 "seed": seed, "size": SIZE,
                                 "interp": interp})
                recs.append({"kind": f"{path}_eval", "file": f, "size": SIZE,
                             "interp": interp})
    for op in ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
               "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
               "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY"):
        for level in OP_LEVELS:
            for resample in (2, 3):
                recs.append({"kind": "op", "source": OP_SOURCE, "op": op,
                             "level": level, "resample": resample,
                             "rng": OP_RNG})
    for source in (OP_SOURCE, WEBP_SOURCE):
        for r in DRAWS:
            recs.append({"kind": "jitter", "source": source, "rng": r,
                         "strength": 0.4})
            for interp in INTERPS:
                recs.append({"kind": "augment", "source": source, "rng": r,
                             "aa": "rand-m9-mstd0.5-inc1", "interp": interp})
    return recs


def reference(rec: dict, fixtures: Path) -> np.ndarray:
    """What PIL and the JAX package make of one record."""
    from PIL import Image

    from uvc_tpu.data import augment, native_loader, pipeline
    kind = rec["kind"]
    if kind in ("op", "jitter", "augment"):
        src = rec["source"]
        img = pipeline.load_train_image(
            str(fixtures / src["file"]), np.random.default_rng(src["seed"]),
            src["size"], interpolation=src["interp"])
        rng = np.random.default_rng(rec["rng"])
        if kind == "op":
            out = augment._apply_op(Image.fromarray(img), rec["op"],
                                    rec["level"], rng, rec["resample"])
        elif kind == "jitter":
            out = augment.color_jitter_image(Image.fromarray(img), rng,
                                             rec["strength"])
        else:
            return augment.make_train_augment(rec["aa"], 0.0,
                                              rec["interp"])(img, rng)
        return np.asarray(out, np.uint8)
    path = str(fixtures / rec["file"])
    if kind == "decode":
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    if kind == "pil_train":
        return pipeline.load_train_image(
            path, np.random.default_rng(rec["seed"]), rec["size"],
            interpolation=rec["interp"])
    if kind == "pil_eval":
        return pipeline.load_eval_image(path, rec["size"],
                                        interpolation=rec["interp"])
    if not native_loader.available():
        raise RuntimeError("the JAX package's native loader does not build")
    seeds = np.asarray([rec.get("seed", 0)], np.uint64)
    return native_loader.load_batch(
        [path], rec["size"], train=kind == "native_train", seeds=seeds,
        interpolation=rec["interp"], num_threads=2)[0]


def reference_records(fixtures: Path = FIXTURES) -> list:
    """Every record with PIL's / the JAX package's digest; a train record
    with the box the port draws here."""
    sys.path.insert(0, str(REPO))
    from image_check import _port_box, digest
    out = []
    for rec in _records():
        rec = dict(rec, sha256=digest(reference(rec, fixtures)))
        if rec["kind"] in ("pil_train", "native_train"):
            rec["box"] = _port_box(rec, str(fixtures / rec["file"]))
        out.append(rec)
    return out


def main() -> None:
    write_fixtures()
    (FIXTURES / "digests.json").write_text(json.dumps(
        {"records": reference_records()}, indent=0) + "\n")
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    print(f"{len(file_names())} files, {total} bytes with the digests")


if __name__ == "__main__":
    main()

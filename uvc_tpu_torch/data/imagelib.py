"""The port's host image library: decoders and transforms with no PIL and
no system image library beneath.

``csrc/image/*.cpp`` is compiled with the host C++ compiler (``c++``, or
``$CXX``) at first use into ``build/uvc_tpu_torch/<digest>/`` of the
checkout (``ops/_cuda.py::build_root``; an installed package builds into
its cache directory) and loaded with ``ctypes``, whose calls release the
GIL, so the loaders' thread pools decode in parallel.  The flags keep
every multiply and add apart (``-ffp-contract=off``, no ``-march``), so a
host gives the bits this one gives.  A build that fails raises with the
compiler's output.  Importing this module builds nothing.

What it decodes and how (the C++ files say more):

* JPEG: a decoder written to give libjpeg-turbo's bits (``jpeg.cpp``),
  baseline and progressive, 8-bit, 1 / 3 / 4 components;
* PNG: the chunk walk and the IDAT inflate here, with the standard
  library's ``zlib``, then the scanline filters in ``png.cpp``; colour
  types 0 / 2 / 3 / 4 / 6 at bit depths 1-16, plain or Adam7-interlaced
  (16-bit samples as PIL's modes give them: the high byte, 16-bit gray
  clipped to 255);
* BMP (``bmp.cpp``): the OS/2 and Windows headers; 1-, 4- and 8-bit
  palettes, 16 bits (5-5-5, 5-6-5 bit fields), 24 and 32 bits (the
  bit-field layouts PIL takes), RLE8 and RLE4 as PIL's reader reads them;
* WebP (``webp_vp8.cpp``, ``webp_vp8l.cpp``): lossy (VP8, RFC 6386) with
  libwebp's fancy upsampling and YUV->RGB, lossless (VP8L, RFC 9649), and
  an animation's first frame on its canvas, as PIL's WebP plugin
  (libwebp's ``WebPAnimDecoder``) gives them; the ALPH chunk is checked
  as libwebp checks it, and dropped, as ``convert("RGB")`` drops it.

Anything else (arithmetic-coded, 12-bit, lossless or hierarchical JPEG,
a 2-bit BMP, a gray-palette BMP below 8 bits) and any file whose data is
cut short raises ``ValueError`` naming the file.  Every image comes out
as PIL's ``convert("RGB")`` gives it: a uint8 ``[H, W, 3]`` array.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from uvc_tpu_torch.ops._cuda import build_root

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "image"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
          "-ffp-contract=off")

# PIL's filter codes, which the library takes
NEAREST, BILINEAR, BICUBIC = 0, 2, 3

_P, _I, _F, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
_ERR = [ctypes.c_char_p, _I]
_SIGNATURES = {
    "uvc_image_info": ([ctypes.c_char_p, _P, _P, _P] + _ERR, _I),
    "uvc_decode_rgb": ([ctypes.c_char_p, _P, _P, _P] + _ERR, _I),
    "uvc_image_free": ([_P], None),
    "uvc_load_pil_crop": ([ctypes.c_char_p, _P, _P] + _ERR, _I),
    "uvc_pil_crop": ([_P, _I, _I, _P, _P] + _ERR, _I),
    "uvc_pil_resize": ([_P, _I, _I, _I, _I, _I, _P] + _ERR, _I),
    "uvc_png_unfilter": ([_P, _S, _I, _I, _I, _I, _I, _P, _I, _P] + _ERR,
                         _I),
    "uvc_rgb_histogram": ([_P, _S, _P], None),
    "uvc_rgb_lut": ([_P, _S, _P, _P], None),
    "uvc_enhance": ([_P, _I, _I, _I, _F, _P] + _ERR, _I),
    "uvc_affine": ([_P, _I, _I, _P, _I, _P, _P], None),
    "uvc_loader_create": ([_I], _P),
    "uvc_loader_destroy": ([_P], None),
    "uvc_load_batch": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P], None),
    "uvc_native_crop_box": ([_I, _I, ctypes.c_uint64, _P], None),
}

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler: uvc_tpu_torch's image library is built from "
            "csrc/image at first use and needs c++ (or $CXX)")
    return cxx


def build_dir() -> Path:
    """Directory of the library built from the current sources."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_SRC.glob("*.[ch]*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_root(_SRC.parent.parent) / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless it is built; returns its path.  A second
    process building at once writes its own temporary file and renames it
    over the first's, so a reader never sees half a library.  Raises
    RuntimeError with the compiler's output if the sources do not
    compile."""
    lib = build_dir() / "libuvc_image.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [_compiler(), *_FLAGS, "-o", str(tmp),
           *map(str, sorted(_SRC.glob("*.cpp")))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the image library failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _call(fn, *args, what: str = "image"):
    err = ctypes.create_string_buffer(256)
    st = fn(*args, err, len(err))
    if st == 1:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    return st


def _rgb(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected a uint8 [H, W, 3] image, got {a.shape}")
    return a


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the file's header, as ``Image.open(path).size``."""
    w, h, fmt = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _call(library().uvc_image_info, os.fsencode(path), ctypes.byref(w),
          ctypes.byref(h), ctypes.byref(fmt), what=path)
    return w.value, h.value


def _decode_png(path: str) -> np.ndarray:
    """The PNG chunk walk: IHDR, PLTE and the IDAT stream (inflated here),
    every chunk's CRC checked; the rest of the work in ``png.cpp``."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, plte, ihdr = 8, [], b"", None
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG file (no IEND)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"{path}: truncated PNG file")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: broken PNG file (CRC of {kind!r})")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without its IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype, 0)
    # the rows of each Adam7 pass, or of the one plain pass
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    need = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            need += ph * (1 + (pw * channels * depth + 7) // 8)
    inflate = zlib.decompressobj()
    raw = bytearray(inflate.decompress(b"".join(idat), need))
    if w < 1 or h < 1 or len(raw) < need:
        raise ValueError(f"{path}: truncated PNG image data")
    raw_np = np.frombuffer(raw, np.uint8)
    pal = np.frombuffer(plte, np.uint8).copy()
    out = np.empty((h, w, 3), np.uint8)
    _call(library().uvc_png_unfilter, _ptr(raw_np), raw_np.size, w, h, depth,
          ctype, interlace, _ptr(pal) if pal.size else None, pal.size // 3,
          _ptr(out), what=path)
    return out


def decode_rgb(path: str) -> np.ndarray:
    """The file's pixels as PIL's ``Image.open(path).convert("RGB")``."""
    lib = library()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    st = _call(lib.uvc_decode_rgb, os.fsencode(path), ctypes.byref(buf),
               ctypes.byref(w), ctypes.byref(h), what=path)
    if st == 2:
        return _decode_png(path)
    try:
        return np.ctypeslib.as_array(
            buf, (h.value, w.value, 3)).copy()
    finally:
        lib.uvc_image_free(buf)


# ---------------------------------------------------------------------------
# the PIL path's transforms (Pillow's resample, crop and flip)
# ---------------------------------------------------------------------------


def load_crop(path: str, plan: Sequence[int]) -> np.ndarray:
    """Decode ``path`` and apply the crop plan ``(bx, by, bw, bh, rw, rh,
    cx, cy, size, flip, filter)``: crop the box, resize it to ``(rw, rh)``
    (``Image.resize``; skipped at its own size), crop ``size`` x ``size`` at
    ``(cx, cy)`` and mirror it when ``flip``."""
    plan_np = np.asarray(plan, np.int32)
    size = int(plan_np[8])
    out = np.empty((size, size, 3), np.uint8)
    st = _call(library().uvc_load_pil_crop, os.fsencode(path), _ptr(plan_np),
               _ptr(out), what=path)
    if st == 2:
        return crop(_decode_png(path), plan)
    return out


def crop(img: np.ndarray, plan: Sequence[int]) -> np.ndarray:
    """The crop plan of ``load_crop`` on an RGB array."""
    img = _rgb(img)
    plan_np = np.asarray(plan, np.int32)
    size = int(plan_np[8])
    out = np.empty((size, size, 3), np.uint8)
    _call(library().uvc_pil_crop, _ptr(img), img.shape[1], img.shape[0],
          _ptr(plan_np), _ptr(out))
    return out


def resize(img: np.ndarray, width: int, height: int,
           filt: int = BILINEAR) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), filt)``."""
    img = _rgb(img)
    if img.shape[:2] == (height, width):
        return img.copy()
    out = np.empty((height, width, 3), np.uint8)
    _call(library().uvc_pil_resize, _ptr(img), img.shape[1], img.shape[0],
          width, height, filt, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# RandAugment's pixel work (Pillow's histogram, point, enhance, transform)
# ---------------------------------------------------------------------------


def histogram(img: np.ndarray) -> list:
    """``Image.histogram()``: 768 counts, R then G then B."""
    img = _rgb(img)
    hist = np.empty(768, np.int64)
    library().uvc_rgb_histogram(_ptr(img), img.shape[0] * img.shape[1],
                                _ptr(hist))
    return hist.tolist()


def point(img: np.ndarray, lut: Sequence[int]) -> np.ndarray:
    """``Image.point(lut)`` with a 768-entry table (256 are used thrice),
    its entries clipped to 0..255 as Pillow's table is."""
    img = _rgb(img)
    lut = list(lut)
    if len(lut) == 256:
        lut = lut * 3
    table = np.clip(np.asarray(lut, np.int64), 0, 255).astype(np.uint8)
    out = np.empty_like(img)
    library().uvc_rgb_lut(_ptr(img), img.shape[0] * img.shape[1],
                          _ptr(table), _ptr(out))
    return out


ENHANCE_KINDS = ("color", "contrast", "brightness", "sharpness")


def enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    """``ImageEnhance.<Kind>(img).enhance(factor)``."""
    img = _rgb(img)
    out = np.empty_like(img)
    _call(library().uvc_enhance, _ptr(img), img.shape[1], img.shape[0],
          ENHANCE_KINDS.index(kind), float(factor), _ptr(out))
    return out


def affine(img: np.ndarray, matrix: Sequence[float], filt: int,
           fill: Sequence[int]) -> np.ndarray:
    """``img.transform(img.size, Image.AFFINE, matrix, filt,
    fillcolor=fill)`` for BILINEAR or BICUBIC."""
    img = _rgb(img)
    if filt not in (BILINEAR, BICUBIC):
        raise ValueError(f"affine transform with filter {filt}")
    a = np.asarray(matrix[:6], np.float64)
    f = np.asarray(fill, np.uint8)
    out = np.empty_like(img)
    library().uvc_affine(_ptr(img), img.shape[1], img.shape[0], _ptr(a), filt,
                         _ptr(f), _ptr(out))
    return out

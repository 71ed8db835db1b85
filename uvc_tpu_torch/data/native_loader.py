"""ctypes bindings for the native C++ image pipeline (native/uvc_loader.cpp),
the counterpart of ``uvc_tpu/data/native_loader.py``.

The same library as the JAX package's, built unchanged by ``make -C
native`` into ``native/libuvc_loader.so`` on first use: threaded JPEG
decode + RandomResizedCrop / flip (train) or resize + center crop (eval),
writing uint8 RGB batches straight into numpy buffers.  Host decoding,
not a device kernel.  Every entry point falls back to the PIL path
(``data/pipeline.py``) when the library or libjpeg is missing, and images
the native decoder rejects (non-JPEG files) fall back one by one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
# repo checkout: auto-built via make.  Installed-from-wheel deployments
# (no ../../native) can point UVC_NATIVE_LIB at a prebuilt .so; anything
# else degrades to the PIL path.
_LIB_PATH = os.environ.get("UVC_NATIVE_LIB") or os.path.abspath(
    os.path.join(_NATIVE_DIR, "libuvc_loader.so"))

_lock = threading.Lock()
_lib = None
_pool = None
_failed = False


def _load_library():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.uvc_loader_create.restype = ctypes.c_void_p
            lib.uvc_loader_create.argtypes = [ctypes.c_int]
            lib.uvc_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.uvc_load_batch.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        except Exception:
            _failed = True
            _lib = None
    return _lib


def available() -> bool:
    return _load_library() is not None


def _get_pool(num_threads: int):
    global _pool
    lib = _load_library()
    if lib is None:
        return None
    with _lock:
        if _pool is None:
            _pool = lib.uvc_loader_create(num_threads)
    return _pool


_INTERP_CODES = {"bilinear": 0, "bicubic": 1}


def load_batch(paths: Sequence[str], img_size: int, *, train: bool,
               seeds: Optional[np.ndarray] = None,
               resize_to: Optional[int] = None,
               interpolation: str = "bilinear",
               num_threads: int = 16) -> Optional[np.ndarray]:
    """Decode + transform a batch; returns [N, S, S, 3] uint8 or None when
    the native library is unavailable.  Images the native decoder rejects
    are loaded through the PIL fallback.  interpolation: bilinear or
    bicubic (both PIL-matched antialiased filters in C++); anything else
    returns None -> caller uses the PIL path."""
    lib = _load_library()
    if lib is None or interpolation not in _INTERP_CODES:
        return None
    if resize_to is None:
        from uvc_tpu_torch.data.pipeline import eval_resize_for
        resize_to = eval_resize_for(img_size)
    pool = _get_pool(num_threads)
    n = len(paths)
    out = np.empty((n, img_size, img_size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    if seeds is None:
        seeds = np.zeros((n,), np.uint64)
    seeds = np.ascontiguousarray(seeds, np.uint64)
    c_paths = (ctypes.c_char_p * n)(
        *[p.encode() for p in paths])
    lib.uvc_load_batch(
        pool, c_paths, n, img_size, 1 if train else 0, resize_to,
        _INTERP_CODES[interpolation],
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    bad = np.nonzero(status != 0)[0]
    if bad.size:
        import warnings

        from uvc_tpu_torch.data.pipeline import (load_eval_image,
                                           load_train_image)
        for i in bad:
            try:
                if train:
                    out[i] = load_train_image(
                        paths[i], np.random.default_rng(int(seeds[i])),
                        img_size, interpolation=interpolation)
                else:
                    out[i] = load_eval_image(paths[i], img_size,
                                             resize_to=resize_to,
                                             interpolation=interpolation)
            except Exception:
                # truly unreadable file: zero-fill rather than kill the
                # whole epoch (the reference would crash here)
                warnings.warn(f"unreadable image {paths[i]}; zero-filled")
                out[i] = 0
    return out

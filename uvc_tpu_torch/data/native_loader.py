"""The native path of the folder loader, the counterpart of
``uvc_tpu/data/native_loader.py``.

The JAX package's native loader (``native/uvc_loader.cpp``, libjpeg) is
re-implemented in the port's own image library (``data/imagelib.py``,
``csrc/image/loader.cpp``) over its own JPEG decoder, and gives its
bits: threaded decode + RandomResizedCrop / flip (train) or resize +
centre crop (eval) with that loader's splitmix64 draws and float
resample, written straight into a numpy batch.  Host code, not a device
kernel.  Nothing under ``native/`` is built or loaded.

``available()`` selects this path in ``FolderLoader``. It probes
nothing: it is true, or the library's build raises with the compiler's
output. It stays a switch because the two paths give different bits
(each the bits of one of the JAX package's paths), and tests and
benchmarks turn it off to take the PIL path. An image the native path
does not take (PNG, BMP, a CMYK JPEG, data the decoder rejects) goes, as
in the JAX package, through the PIL path's loader
(``pipeline.load_train_image`` / ``load_eval_image``), on
``num_threads`` threads, which raises ``ValueError`` for a file it
cannot decode.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from uvc_tpu_torch.data import imagelib

_lock = threading.Lock()
_pool = None


def available() -> bool:
    """True once the library is loaded (a failed build raises).  The
    selector of the native path, not a probe: turn it off (monkeypatch)
    to take the PIL path."""
    imagelib.library()
    return True


def _get_pool(num_threads: int):
    global _pool
    lib = imagelib.library()
    with _lock:
        if _pool is None:
            _pool = lib.uvc_loader_create(num_threads)
    return _pool


_INTERP_CODES = {"bilinear": 0, "bicubic": 1}


def load_batch(paths: Sequence[str], img_size: int, *, train: bool,
               seeds: Optional[np.ndarray] = None,
               resize_to: Optional[int] = None,
               interpolation: str = "bilinear",
               num_threads: int = 16) -> np.ndarray:
    """Decode + transform a batch into ``[N, S, S, 3]`` uint8.  Images the
    native path does not take are loaded through the PIL path.
    interpolation: bilinear or bicubic (the native loader's own
    antialiased filters); anything else raises ValueError, and
    ``FolderLoader`` sends it to the PIL path before calling this."""
    if interpolation not in _INTERP_CODES:
        raise ValueError(f"the native path resamples with "
                         f"{sorted(_INTERP_CODES)}, not {interpolation!r}")
    lib = imagelib.library()
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
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.uvc_load_batch(pool, c_paths, n, img_size, 1 if train else 0,
                       resize_to, _INTERP_CODES[interpolation],
                       seeds.ctypes.data, out.ctypes.data,
                       status.ctypes.data)
    bad = np.nonzero(status != 0)[0]
    if bad.size:
        from uvc_tpu_torch.data.pipeline import (load_eval_image,
                                                 load_train_image)

        def one(i):
            if train:
                return load_train_image(
                    paths[i], np.random.default_rng(int(seeds[i])),
                    img_size, interpolation=interpolation)
            return load_eval_image(paths[i], img_size, resize_to=resize_to,
                                   interpolation=interpolation)

        # each image on its own draw, so the threads give the bits of a
        # loop; the library releases the GIL
        with ThreadPoolExecutor(min(num_threads, bad.size)) as ex:
            for i, img in zip(bad, ex.map(one, bad)):
                out[i] = img
    return out


def crop_box(w: int, h: int, seed: int) -> list:
    """The train crop ``[x0, y0, width, height, flip]`` that ``load_batch``
    draws for a ``w`` x ``h`` image at ``seed``."""
    box = np.empty(5, np.float64)
    imagelib.library().uvc_native_crop_box(w, h, seed, box.ctypes.data)
    return box.tolist()

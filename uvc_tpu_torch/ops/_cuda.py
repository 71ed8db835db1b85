"""Build and load the hand-written CUDA kernels (``uvc_tpu_torch/csrc``).

Each ``.cu`` source becomes a shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes``.  The libraries go to ``build/uvc_tpu_torch/<digest>/`` beside
the package, keyed on a hash of every source and the compiler flags, so an
edited source rebuilds and an unchanged one loads at once.  All sources
compile in parallel, one ``nvcc`` each.

Importing this module builds nothing and needs no CUDA: the wrappers in
``ops/attention.py``, ``ops/mlp.py`` and ``ops/performer.py`` ask for a
library only when a CUDA tensor reaches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "uvc_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)

# library name -> (source, {C function: argtypes})
_LIBS = {
    "attention": ("attention.cu", {
        "uvc_layer_attention_ln":
            [_P] * 12 + [_I] * 5 + [_F, _F, _P],
        "uvc_layer_attention_ln_bwd":
            [_P] * 25 + [_I] * 7 + [_F, _F, _P],
        "uvc_layer_attention": [_P] * 9 + [_I] * 5 + [_F, _P],
        "uvc_layer_attention_bwd": [_P] * 19 + [_I] * 7 + [_F, _P],
    }),
    "attention_core": ("attention_core.cu", {
        "uvc_attention": [_P] * 4 + [_LP] + [_I] * 4 + [_F, _P],
        "uvc_attention_bwd": [_P] * 9 + [_LP] + [_I] * 4 + [_F, _P],
        "uvc_attention_bwd_ctx": [_P] * 10 + [_LP] + [_I] * 4 + [_F, _P],
    }),
    "mlp": ("mlp.cu", {
        "uvc_mlp_ln": [_P] * 11 + [_I] * 3 + [_F, _P],
        "uvc_mlp_ln_blend": [_P] * 13 + [_I] * 3 + [_F, _P],
        "uvc_mlp_ln_bwd": [_P] * 22 + [_I] * 5 + [_F, _P],
        "uvc_mlp_ln_blend_bwd": [_P] * 27 + [_I] * 5 + [_F, _P],
    }),
    "performer": ("performer.cu", {
        "uvc_performer": [_P] * 21 + [_I] * 5 + [_F, _P],
        "uvc_performer_bwd": [_P] * 41 + [_I] * 7 + [_F, _P],
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of uvc_tpu_torch are built from "
        "source at first use and need the CUDA toolkit")


def build_dir() -> Path:
    """Directory of the libraries built from the current sources."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build() -> float:
    """Compile every library that is not built yet, all at once.

    Returns the wall seconds spent.  The compiler's resource report
    (registers, shared memory, spills) is kept beside each library as
    ``lib<name>.log``.  Raises RuntimeError with the compiler's output if a
    source does not compile."""
    out_dir = build_dir()
    todo = [n for n in _LIBS if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / _LIBS[name][0])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{_LIBS[name][0]} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        for fn, argtypes in _LIBS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def longs(values) -> ctypes.Array:
    """``values`` as a C array of 64-bit integers (strides)."""
    values = list(values)
    return (ctypes.c_longlong * len(values))(*values)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def build_logs() -> Dict[str, str]:
    """The compiler's resource report of each built library."""
    d = build_dir()
    return {n: (d / f"lib{n}.log").read_text()
            for n in _LIBS if (d / f"lib{n}.log").exists()}

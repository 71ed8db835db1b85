"""Checkpoint save / restore (counterpart of
``uvc_tpu/utils/checkpoint.py``).

A checkpoint is one ``.ckpt`` file in the JAX package's format: the
msgpack bytes that ``flax.serialization.to_bytes`` writes for the tree.
This module reads and writes that format with a codec of its own (no
``msgpack``, ``flax`` or ``ml_dtypes``), so that either package resumes
the other's checkpoints:

* the subset of msgpack that flax emits: nil, booleans, ints, floats, str,
  bin, arrays, maps and ext types;
* flax's ext types: 1, an array, its payload the msgpack triple
  ``(shape, dtype name, C-order bytes)``; 2, a native complex
  ``(real, imag)``; 3, a numpy scalar, packed as a 0-d array;
* arrays above ``MAX_CHUNK_SIZE`` bytes, split into flat chunks under a
  ``__msgpack_chunked_array__`` map;
* ``bfloat16`` leaves, read and written through their bytes.

``save_checkpoint`` writes what the JAX package's ``save_checkpoint``
writes for the same tree: every leaf made an array (``jax.tree.map(
np.asarray, tree)``: Python scalars become 0-d int64 / float64 / bool
arrays, a string a 0-d unicode array), the keys of every dict sorted, as
JAX's tree map rebuilds dicts, and lists and tuples stored as maps of
their indices, as ``to_state_dict`` stores them.  ``load_checkpoint``
returns nested dicts whose array leaves are CPU tensors (numpy arrays
for the dtypes torch lacks, such as strings; a 0-d string as ``str``),
ext-3 scalars as numpy scalars and native ints and floats as Python
scalars.

``CheckpointManager`` takes the place of the JAX package's
``OrbaxManager``: the latest ``max_to_keep`` checkpoints of a run, as
``<step>.ckpt`` files in one directory.

Across data-parallel ranks (``parallel/mesh.py``) every rank holds the
same state, so only rank 0 writes a checkpoint and the others wait at a
barrier until the file is there (the JAX package writes from every
process).
"""

from __future__ import annotations

import os
import re
import struct
import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from uvc_tpu_torch.parallel.mesh import barrier, is_writer

# flax's limit on one array leaf; larger arrays are stored in chunks
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _len_header(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """The header of a str / bin / array / map of length ``n``: the fix
    form where there is one and ``n`` fits, else the 8-, 16- or 32-bit
    form (``codes``, None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _len_header(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code)


def _array_parts(shape, dtype_name: str, blob) -> List[bytes]:
    """The parts of flax's array payload ``packb((shape, dtype_name,
    bytes))``, the bytes left as one part (not copied)."""
    head = bytearray(b"\x93")
    head += _len_header(len(shape), 0x90, 0x0f, (None, 0xdc, 0xdd))
    for n in shape:
        head += _pack_int(int(n))
    name = dtype_name.encode()
    head += _len_header(len(name), 0xa0, 0x1f, (0xd9, 0xda, 0xdb)) + name
    head += _len_header(len(blob), None, 0, (0xc4, 0xc5, 0xc6))
    return [bytes(head), blob]


def _leaf_blob(x):
    """(shape, dtype name, C-order bytes) of an array or tensor leaf."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"cannot store a tensor of dtype {t.dtype}")
        raw = t.view(torch.uint8) if t.dim() else t.reshape(1).view(
            torch.uint8)
        return tuple(t.shape), _DTYPE_NAMES[t.dtype], raw.numpy().tobytes()
    arr = np.asarray(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be stored")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _pack(obj, parts: List[bytes]) -> None:
    """Append the msgpack encoding of ``obj`` to ``parts``, with flax's
    rules (``strict_types``: exactly dict / list / tuple containers)."""
    if obj is None:
        parts.append(b"\xc0")
    elif obj is True or obj is False:
        parts.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        parts.append(_pack_int(obj))
    elif type(obj) is float:
        parts.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        b = obj.encode()
        parts.append(_len_header(len(b), 0xa0, 0x1f, (0xd9, 0xda, 0xdb)))
        parts.append(b)
    elif type(obj) in (bytes, bytearray):
        parts.append(_len_header(len(obj), None, 0, (0xc4, 0xc5, 0xc6)))
        parts.append(bytes(obj))
    elif type(obj) in (list, tuple):
        parts.append(_len_header(len(obj), 0x90, 0x0f, (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, parts)
    elif type(obj) is dict:
        parts.append(_len_header(len(obj), 0x80, 0x0f, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            _pack(k, parts)
            _pack(v, parts)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        code = (_EXT_NPSCALAR if isinstance(obj, np.generic)
                else _EXT_NDARRAY)
        payload = _array_parts(*_leaf_blob(obj))
        parts.append(_ext_header(code, sum(len(p) for p in payload)))
        parts.extend(payload)
    elif type(obj) is complex:
        payload = packb((obj.real, obj.imag))
        parts.append(_ext_header(_EXT_COMPLEX, len(payload)))
        parts.append(payload)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, default=flax's ext packer, strict_types=True)``
    for the types flax stores (tensors as ndarrays)."""
    parts: List[bytes] = []
    _pack(obj, parts)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


_STR_DTYPE = re.compile(r"(str|bytes)(\d+)$")


def _np_dtype(name: str) -> np.dtype:
    """numpy's dtype of a stored dtype name; numpy names a string dtype by
    its bits (``str704``) but does not parse that name back."""
    m = _STR_DTYPE.match(name)
    if m:
        bits = int(m.group(2))
        return np.dtype(f"<U{bits // 32}" if m.group(1) == "str"
                        else f"S{bits // 8}")
    return np.dtype(name)


def _array_from_payload(payload: memoryview):
    """An ext-1 / ext-3 payload as a CPU tensor (a numpy array for the
    dtypes torch lacks)."""
    shape, name, buf = _Unpacker(payload, raw=True).unpack()
    name = name.decode()
    if name in _TORCH_DTYPES:
        dtype = _TORCH_DTYPES[name]
        if len(buf) == 0:
            return torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # the file's bytes are read-only; the clone owns its memory
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(buf, dtype=dtype)
        return flat.clone().reshape(shape)
    return np.frombuffer(buf, dtype=_np_dtype(name)).reshape(shape).copy()


def _ext_value(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        arr = _array_from_payload(payload)
        if isinstance(arr, np.ndarray) and arr.shape == () \
                and arr.dtype.kind in "US":
            return arr.item()
        return arr
    if code == _EXT_NPSCALAR:
        arr = _array_from_payload(payload)
        if torch.is_tensor(arr):
            return _np_scalar(arr)
        return arr[()]
    if code == _EXT_COMPLEX:
        re_, im = _Unpacker(payload, raw=False).unpack()
        return complex(re_, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _np_scalar(t: torch.Tensor):
    """The numpy scalar of a 0-d tensor (bfloat16 as its float32 value in
    a numpy float32: numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        return np.float32(t.float().item())
    return t.numpy()[()]


class _Unpacker:
    """A msgpack decoder over a memoryview; ``raw`` keeps str values as
    bytes (flax reads the array triple so)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def _uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode()

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        return _ext_value(code, self._take(n))

    def unpack(self):
        c = self._take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0xa0 <= c <= 0xbf:
            return self._str(c & 0x1f)
        if 0x90 <= c <= 0x9f:
            return [self.unpack() for _ in range(c & 0x0f)]
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self._uint(ints[c])
        if c == 0xca:
            return self._uint(">f")
        if c == 0xcb:
            return self._uint(">d")
        sizes = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if c in sizes:
            return self._str(self._uint(sizes[c]))
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if c in sizes:
            # raw mode reads an array's payload: its bytes stay a view
            b = self._take(self._uint(sizes[c]))
            return b if self.raw else bytes(b)
        if c in (0xdc, 0xdd):
            n = self._uint(">H" if c == 0xdc else ">I")
            return [self.unpack() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self._map(self._uint(">H" if c == 0xde else ">I"))
        fixed = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixed:
            return self._ext(fixed[c])
        sizes = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if c in sizes:
            return self._ext(self._uint(sizes[c]))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpackb(data, raw: bool = False):
    """``msgpack.unpackb(data, ext_hook=flax's ext decoder, raw=raw)``,
    array leaves as CPU tensors; chunked arrays are left chunked (see
    ``msgpack_restore``)."""
    up = _Unpacker(data, raw=raw)
    out = up.unpack()
    if up.pos != len(up.buf):
        raise ValueError("extra bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# chunking (flax's MAX_CHUNK_SIZE rule)
# ---------------------------------------------------------------------------


def _nbytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def _chunk(leaf) -> dict:
    """flax's ``_chunk``: the flat array in chunks of ``MAX_CHUNK_SIZE``
    bytes."""
    itemsize = (leaf.element_size() if torch.is_tensor(leaf)
                else leaf.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    n = flat.numel() if torch.is_tensor(flat) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(leaf.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if torch.is_tensor(chunks[0]):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax's ``msgpack_serialize`` of a state dict (dicts of leaves)."""
    return packb(_chunk_leaves(tree))


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: the state dict of ``data``."""
    return _unchunk(unpackb(data))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _as_saved(tree):
    """The tree as the JAX package's ``save_checkpoint`` stores it: dict
    keys sorted (``jax.tree.map``), named tuples as maps of their fields
    and lists / tuples as maps of their indices (``to_state_dict``),
    every leaf an array (``np.asarray``; tensors stay tensors)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {str(k): _as_saved(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _as_saved(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_saved(v) for i, v in enumerate(tree)}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return np.asarray(tree)


def to_bytes(tree) -> bytes:
    """The bytes ``save_checkpoint`` writes for ``tree``."""
    return msgpack_serialize(_as_saved(tree))


def restore_like(target, state: Any):
    """flax's ``from_state_dict``: ``state`` in ``target``'s structure
    (lists from maps of indices, dict keys checked), each array leaf
    checked against the target's shape and moved to the target tensor's
    device."""
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"the state has no keys {sorted(missing)}")
        return {k: restore_like(v, state[str(k)])
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(f"the state holds {len(state)} entries, the "
                             f"target {len(target)}")
        return type(target)(restore_like(v, state[str(i)])
                            for i, v in enumerate(target))
    if torch.is_tensor(target) and torch.is_tensor(state):
        if tuple(state.shape) != tuple(target.shape):
            raise ValueError(f"shape {tuple(state.shape)} in the state, "
                             f"{tuple(target.shape)} in the target")
        return state.to(target.device)
    return state


def lists_from_index_maps(tree: Any) -> Any:
    """``tree`` with every map whose keys are exactly ``"0"`` ...
    ``"n-1"`` made the list it was saved from (``to_state_dict`` stores a
    list as the map of its indices, so a checkpoint read without a target
    holds maps where the model holds lists: the R50 hybrid's stem units,
    the T2T ablations' blocks)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: lists_from_index_maps(v) for k, v in tree.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out


def params_of(ck: Any) -> Any:
    """The parameter tree of a checkpoint read without a target: its
    ``params`` entry (else the whole tree), its lists rebuilt."""
    return lists_from_index_maps(ck["params"] if "params" in ck else ck)


def _write_checkpoint(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    parts: List[bytes] = []
    _pack(_chunk_leaves(_as_saved(tree)), parts)
    with open(path, "wb") as f:
        f.writelines(parts)


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree (msgpack; one portable file, the JAX package's bytes
    for the same tree): written by rank 0 alone, every rank returning
    once it is written."""
    if is_writer():
        _write_checkpoint(path, tree)
    barrier()


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    with open(path, "rb") as f:
        data = f.read()
    state = msgpack_restore(data)
    return restore_like(target, state) if target is not None else state


class CheckpointManager:
    """Step-indexed checkpoints of one run in one directory, as
    ``<step>.ckpt`` files; keeps the latest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.ckpt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(f[:-5]) for f in os.listdir(self.directory)
                      if re.fullmatch(r"\d+\.ckpt", f))

    def save(self, step: int, tree: Any) -> None:
        """Write ``<step>.ckpt`` and drop the oldest past ``max_to_keep``:
        rank 0 alone, every rank returning once it is done."""
        if is_writer():
            tmp = self._path(step) + ".tmp"
            _write_checkpoint(tmp, tree)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        barrier()

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_checkpoint(self._path(step), target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

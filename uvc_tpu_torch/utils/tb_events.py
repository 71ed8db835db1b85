"""TensorBoard event files without ``tensorboard`` or protobuf (the H100's
machine has neither): what ``--enable_writer 1`` writes.

``EventFileWriter(logdir)`` writes the bytes that
``torch.utils.tensorboard.SummaryWriter(logdir)`` writes for the same
``add_scalar`` calls, with only the wall times differing:

* the file ``events.out.tfevents.<%010d int(time)>.<hostname>.<pid>.<uid>``
  in ``logdir``, ``uid`` a counter of the writers this process opened (as
  ``tensorboard.summary.writer.event_file_writer._global_uid``);
* TFRecord frames: the data's length as a little-endian u64, the masked
  CRC32C of those 8 bytes, the data, the masked CRC32C of the data; a
  masked CRC is ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``;
* first an ``Event`` (``tensorboard/compat/proto/event.proto``) with
  ``wall_time`` (field 1, double), ``file_version: "brain.Event:2"``
  (field 3) and ``source_metadata { writer:
  "tensorboard.summary.writer.event_file_writer" }`` (field 10);
* then, a scalar each, an ``Event`` with ``wall_time``, ``step`` (field 2,
  varint; omitted at 0, as proto3 omits a default) and ``summary`` (field
  5): ``Summary { value { tag (1), simple_value (2, float32) } }``, the
  value rounded to float32 (NaN and the infinities written as such).

Protobuf goes onto the wire by hand: varints, fixed64 doubles, fixed32
floats and length-delimited fields, each message's fields in the order of
their numbers.  Each ``add_scalar`` writes its frame to the file's buffer;
``flush`` hands the buffer to the operating system.  Torch's writer
flushes on a 120 s thread, so a short run can end with its last records
unwritten; this one holds every record once ``flush`` or ``close`` has
returned.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

FILE_VERSION = "brain.Event:2"
SOURCE_WRITER = "tensorboard.summary.writer.event_file_writer"

# the writers opened in this process, as tensorboard's _global_uid counts
_uid = itertools.count()


def _crc32c_table():
    """CRC-32C (Castagnoli, reflected polynomial 0x82f63b78), a byte at a
    time."""
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    n = struct.pack("<Q", len(data))
    return (n + struct.pack("<I", masked_crc(n)) + data
            + struct.pack("<I", masked_crc(data)))


# -- protobuf's wire format (wire types 0 varint, 1 fixed64, 2 length-
# delimited, 5 fixed32)

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1      # an int64 below 0 as its two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _float32(value: float) -> bytes:
    """``value`` rounded to float32, as protobuf's C cast rounds it (past
    float32's range, an infinity)."""
    with np.errstate(over="ignore"):
        return np.asarray(value, dtype=np.float64).astype("<f4").tobytes()


def _wall_time(wall_time: float) -> bytes:
    """Field 1, omitted where its bits are all 0 (proto3's default)."""
    bits = struct.pack("<d", wall_time)
    return _key(1, 1) + bits if any(bits) else b""


def header_event(wall_time: float) -> bytes:
    """The first record of every event file."""
    return (_wall_time(wall_time) + _bytes_field(3, FILE_VERSION.encode())
            + _bytes_field(10, _bytes_field(1, SOURCE_WRITER.encode())))


def scalar_event(tag: str, value: float, step: int,
                 wall_time: float) -> bytes:
    """An ``Event`` holding one ``simple_value`` summary."""
    summary_value = (_bytes_field(1, tag.encode()) if tag else b"") \
        + _key(2, 5) + _float32(value)
    out = _wall_time(wall_time)
    if step:
        out += _key(2, 0) + _varint(int(step))
    return out + _bytes_field(5, _bytes_field(1, summary_value))


class EventFileWriter:
    """An event file in ``logdir`` (made if missing), opened at
    construction with its first record written and flushed."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, "events.out.tfevents.%010d.%s.%s.%s" % (
                time.time(), socket.gethostname(), os.getpid(), next(_uid)))
        self._file = open(self.path, "wb")
        self._file.write(frame(header_event(time.time())))
        self.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._file.write(frame(scalar_event(
            tag, value, step,
            time.time() if wall_time is None else wall_time)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

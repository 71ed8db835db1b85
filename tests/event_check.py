"""Read a TensorBoard event file without ``tensorboard`` or protobuf.

Walks the TFRecord frames (a little-endian u64 length, the masked CRC32C
of its 8 bytes, the data, the masked CRC32C of the data), checks both
CRCs of every frame, and decodes the two messages an event file of
``--enable_writer 1`` holds (``tensorboard/compat/proto/event.proto`` and
``summary.proto``): the header ``Event`` (``wall_time``,
``file_version``, ``source_metadata.writer``) and the scalar ``Event``s
(``wall_time``, ``step``, ``summary.value[].tag`` /
``simple_value``).  A field of another number or wire type is an error,
so a file with anything else in it fails here.

Its CRC is computed bit by bit, independently of the table-driven one
that ``uvc_tpu_torch/utils/tb_events.py`` writes with.  Test-side, beside
the tests that use it: it imports nothing of the port and no JAX, so the
card's machine runs it (``chip_smoke.py`` phase 20).

Usage: python tests/event_check.py FILE
Prints one JSON line per record.
"""

from __future__ import annotations

import json
import struct
import sys


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), a bit at a time."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frames(blob: bytes):
    """Each record's data; raises ``ValueError`` on a bad CRC or a
    truncated frame."""
    p = 0
    n_rec = 0
    while p < len(blob):
        if p + 12 > len(blob):
            raise ValueError(f"record {n_rec}: truncated header at byte {p}")
        head = blob[p:p + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", blob[p + 8:p + 12])
        if crc != masked_crc(head):
            raise ValueError(f"record {n_rec}: the length's CRC fails")
        if p + 12 + n + 4 > len(blob):
            raise ValueError(f"record {n_rec}: truncated data at byte {p}")
        data = blob[p + 12:p + 12 + n]
        (crc,) = struct.unpack("<I", blob[p + 12 + n:p + 16 + n])
        if crc != masked_crc(data):
            raise ValueError(f"record {n_rec}: the data's CRC fails")
        yield data
        p += 16 + n
        n_rec += 1


def _varint(buf: bytes, p: int):
    out = shift = 0
    while True:
        b = buf[p]
        out |= (b & 0x7F) << shift
        p += 1
        shift += 7
        if not b & 0x80:
            return out, p


def fields(buf: bytes):
    """(field number, wire type, value) of each field of a message:
    varints as ints, fixed64 / fixed32 as their raw bytes,
    length-delimited as bytes."""
    p = 0
    while p < len(buf):
        key, p = _varint(buf, p)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, p = _varint(buf, p)
        elif wire == 1:
            value, p = buf[p:p + 8], p + 8
        elif wire == 5:
            value, p = buf[p:p + 4], p + 4
        elif wire == 2:
            n, p = _varint(buf, p)
            value, p = buf[p:p + n], p + n
        else:
            raise ValueError(f"field {field}: wire type {wire}")
        if p > len(buf):
            raise ValueError(f"field {field} runs past its message")
        yield field, wire, value


def _only(msg: bytes, allowed: dict, what: str):
    for field, wire, value in fields(msg):
        if allowed.get(field) != wire:
            raise ValueError(f"{what}: field {field} of wire type {wire}")
        yield field, value


def decode_event(data: bytes) -> dict:
    """An ``Event`` as a dict: ``wall_time``, ``step`` (0 where absent)
    and ``file_version`` / ``source_writer`` or ``summary`` (a list of
    ``(tag, simple_value)``, the value a Python float of the float32)."""
    ev = {"wall_time": 0.0, "step": 0}
    for field, value in _only(data, {1: 1, 2: 0, 3: 2, 5: 2, 10: 2},
                              "Event"):
        if field == 1:
            ev["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2:
            ev["step"] = value - (1 << 64) if value >> 63 else value
        elif field == 3:
            ev["file_version"] = value.decode()
        elif field == 10:
            for _, w in _only(value, {1: 2}, "SourceMetadata"):
                ev["source_writer"] = w.decode()
        else:
            summary = ev.setdefault("summary", [])
            for _, val in _only(value, {1: 2}, "Summary"):
                tag, simple = "", None
                for f, v in _only(val, {1: 2, 2: 5}, "Summary.Value"):
                    if f == 1:
                        tag = v.decode()
                    else:
                        simple = struct.unpack("<f", v)[0]
                summary.append((tag, simple))
    return ev


def read_events(path) -> list:
    """Every record of the event file at ``path``, decoded, both CRCs of
    each checked."""
    with open(path, "rb") as f:
        blob = f.read()
    return [decode_event(d) for d in frames(blob)]


def match_jsonl(event_path, jsonl_path) -> int:
    """Holds the event file of a ``MetricLogger`` run to the run's
    ``metrics.jsonl``: a header record, then every float scalar of the
    JSONL, line by line and key by key, at its step under its key, equal
    to the value rounded to float32 (NaN to NaN).  Returns the count of
    scalars; raises ``ValueError`` at the first that differs."""
    import numpy as np

    events = read_events(event_path)
    if not events or events[0].get("file_version") != "brain.Event:2":
        raise ValueError(f"{event_path}: no header record")
    got = [(tag, ev["step"], value) for ev in events[1:]
           for tag, value in ev.get("summary", [])]
    want = []
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            want += [(k, rec["step"], v) for k, v in rec.items()
                     if k != "step" and isinstance(v, float)]
    if len(got) != len(want):
        raise ValueError(f"{len(got)} scalars in the event file, "
                         f"{len(want)} float scalars in {jsonl_path}")
    for n, ((tag, step, value), (key, wstep, wvalue)) in enumerate(
            zip(got, want)):
        with np.errstate(over="ignore"):
            w32 = float(np.float32(wvalue))
        same = (value != value and w32 != w32) or value == w32
        if (tag, step) != (key, wstep) or not same:
            raise ValueError(f"scalar {n}: {(tag, step, value)} in the "
                             f"event file, {(key, wstep, w32)} expected")
    return len(want)


if __name__ == "__main__":
    for rec in read_events(sys.argv[1]):
        print(json.dumps(rec))

"""TensorBoard event files without tensorboard: the training CLI's log.

``SummaryWriter(log_dir)`` writes what ``tensorboardX.SummaryWriter`` writes
for ``add_scalar`` and ``add_image``.  The port depends on neither
tensorboardX nor tensorboard, and ``torch.utils.tensorboard`` is no way
round them: it needs tensorboard, its import loads TensorFlow wherever
TensorFlow is installed (seconds, and TensorFlow may bring JAX into the
process), and its record writer computes the same per-byte pure-Python
CRC32C as this module.  What it writes:

- one file ``events.out.tfevents.{seconds}.{host}.{pid}.{n}`` per writer
  (``n`` counts the writers this process opened, so two in one second do
  not share a file);
- TFRecord framing: the record's length as a little-endian u64, the masked
  CRC32C of those 8 bytes, the record, the masked CRC32C of the record;
- a first ``Event{wall_time, file_version: "brain.Event:2"}``, then one
  ``Event{wall_time (1), step (2), summary (5)}`` per call, whose
  ``Summary.Value`` holds the tag (1) and either ``simple_value`` (2, a
  float32) or ``image`` (4): ``{height 1, width 2, colorspace 3,
  encoded_image_string 4}``, a PNG from io/png.py.

Tags are cleaned and images converted as tensorboardX does: characters
outside ``[-/\\w.]`` become ``_``, leading slashes go; a float CHW image in
[0, 1] becomes uint8 HWC by ``(x * 255).astype(uint8)``, one channel
repeated to three.  Protobuf's proto3 rule is kept: a step of 0 is not
written.  So a record equals tensorboardX's byte for byte but for the
wall time and the PNG's compression.

The reader (``_read_events``) is for the tests and the smoke run.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import time
from typing import Iterator, List

import numpy as np

from sfm_nerf_tpu_torch.io.png import encode_png

_INVALID_TAG = re.compile(r"[^-/\w.]")
_opened = 0     # writers this process has opened


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    c = 0xFFFFFFFF
    for byte in data:
        c = _CRC_TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _frame(record: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the record, its masked CRC."""
    head = struct.pack("<Q", len(record))
    return (head + struct.pack("<I", masked_crc32c(head)) + record
            + struct.pack("<I", masked_crc32c(record)))


# -- protobuf wire format, as far as Event needs it ---------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # a negative int64 takes ten bytes
    out = bytearray()
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, body: bytes) -> bytes:
    return _key(field, 2) + _varint(len(body)) + body


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(int(step))
    if file_version:
        out += _len_field(3, file_version.encode())
    if summary:
        out += _len_field(5, summary)
    return out


def clean_tag(tag: str) -> str:
    return _INVALID_TAG.sub("_", tag).lstrip("/")


def image_hwc_u8(img) -> np.ndarray:
    """A CHW image (float in [0, 1], or uint8) as tensorboardX stores it:
    uint8 HWC, three channels for a grey one."""
    hwc = np.asarray(img).transpose(1, 2, 0)
    if hwc.shape[2] == 1:
        hwc = np.concatenate([hwc] * 3, axis=2)
    if hwc.dtype != np.uint8:
        hwc = (hwc * 255.0).astype(np.uint8)
    return hwc


class SummaryWriter:
    """``add_scalar`` / ``add_image`` / ``flush`` / ``close`` of
    ``tensorboardX.SummaryWriter``, writing one event file in ``log_dir``
    (made if missing), through a buffered file: ``flush`` puts what was
    added on the disk."""

    def __init__(self, log_dir: str):
        global _opened
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
                f".{os.getpid()}.{_opened}")
        _opened += 1
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self.seconds = 0.0          # host time spent in this writer's calls
        self._file.write(_frame(_event(time.time(), file_version="brain.Event:2")))

    def _summary(self, tag: str, value: bytes, step: int) -> None:
        t0 = time.perf_counter()
        summary = _len_field(1, _len_field(1, clean_tag(tag).encode()) + value)
        self._file.write(_frame(_event(time.time(), step, summary=summary)))
        self.seconds += time.perf_counter() - t0

    def add_scalar(self, tag: str, value, step: int = 0) -> None:
        value = np.float32(float(np.asarray(value).squeeze())).tobytes()
        self._summary(tag, _key(2, 5) + value, step)

    def add_image(self, tag: str, img, step: int = 0) -> None:
        """``img``: CHW, float in [0, 1] or uint8."""
        t0 = time.perf_counter()
        hwc = image_hwc_u8(img)
        h, w, c = hwc.shape
        image = (_key(1, 0) + _varint(h) + _key(2, 0) + _varint(w) + _key(3, 0) + _varint(c)
                 + _len_field(4, encode_png(hwc)))
        self.seconds += time.perf_counter() - t0
        self._summary(tag, _len_field(4, image), step)

    def flush(self) -> None:
        t0 = time.perf_counter()
        self._file.flush()
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        if not self._file.closed:
            self.flush()
            self._file.close()


# -- reading back -------------------------------------------------------------


def _read_records(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file, each CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        record = data[pos + 12:pos + 12 + n]
        (crc_r,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(head) or crc_r != masked_crc32c(record):
            raise ValueError(f"{path}: bad CRC in the record at byte {pos}")
        yield record
        pos += 16 + n


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of a message: ints for varints,
    bytes for the rest."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"wire type {wire} not read here")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _parse_event(record: bytes) -> dict:
    """``{'wall_time', 'step', 'file_version'?, 'values'?}``; each value
    ``{'tag', 'simple_value'}`` or ``{'tag', 'image': {'height', 'width',
    'colorspace', 'png'}}``."""
    event = {"step": 0}
    for field, _, v in _fields(record):
        if field == 1:
            event["wall_time"] = struct.unpack("<d", v)[0]
        elif field == 2:
            event["step"] = v - (1 << 64) if v >> 63 else v
        elif field == 3:
            event["file_version"] = v.decode()
        elif field == 5:
            event["values"] = [_parse_value(val) for f, _, val in _fields(v) if f == 1]
    return event


def _parse_value(buf: bytes) -> dict:
    out = {}
    for field, _, v in _fields(buf):
        if field == 1:
            out["tag"] = v.decode()
        elif field == 2:
            out["simple_value"] = float(np.frombuffer(v, "<f4")[0])
        elif field == 4:
            names = {1: "height", 2: "width", 3: "colorspace", 4: "png"}
            out["image"] = {names[f]: x for f, _, x in _fields(v) if f in names}
    return out


def _read_events(path: str) -> List[dict]:
    return [_parse_event(r) for r in _read_records(path)]

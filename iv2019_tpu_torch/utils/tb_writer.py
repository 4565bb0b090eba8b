"""TensorBoard event-file writer with no TensorFlow dependency.

A copy of iv2019_tpu/utils/tb_writer.py (numpy and PIL only). The reference
has TensorBoard summaries because it is TensorFlow
(define_estimator_hierarchical.py:290-398); this module writes the two
formats TensorBoard reads:

1. the ``Event`` protobuf (``tensorboard/compat/proto/event.proto``) —
   hand-encoded here with plain varint/length-delimited wire encoding
   (scalars via ``Summary.Value.simple_value``, images via
   ``Summary.Value.image`` PNG payloads);
2. the TFRecord on-disk framing — ``uint64 length; uint32 masked_crc32c
   (length); bytes data; uint32 masked_crc32c(data)`` with the Castagnoli
   CRC-32 and TF's rotate+offset masking.

Files are named ``events.out.tfevents.<ts>.<host>`` and begin with the
``brain.Event:2`` version record, exactly like TF's EventsWriter, so any
TensorBoard build can load them.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import threading
import time

import numpy as np

__all__ = ["EventFileWriter", "masked_crc32c"]


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven, reflected polynomial 0x82F63B78 —
# the checksum TFRecord framing requires. Pure Python; called on ~100-byte
# scalar records and per-summary image records, so speed is a non-issue.
# ---------------------------------------------------------------------------

def _make_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking: rotate right 15 and add a constant."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (write-only).
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
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


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


# event.proto: Event{1: double wall_time, 2: int64 step,
#                    3: string file_version, 5: Summary summary}
# summary.proto: Summary{1: repeated Value}
#   Value{1: string tag, 2: float simple_value, 4: Image image}
#   Image{1: int32 height, 2: int32 width, 3: int32 colorspace,
#         4: bytes encoded_image_string}


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _f_str(1, tag) + _f_float(2, float(value))
    summary = _f_bytes(1, val)
    return _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(5, summary)


def _image_event(
    tag: str, png: bytes, h: int, w: int, colorspace: int, step: int,
    wall_time: float,
) -> bytes:
    img = (
        _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, colorspace)
        + _f_bytes(4, png)
    )
    val = _f_str(1, tag) + _f_bytes(4, img)
    summary = _f_bytes(1, val)
    return _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_str(3, "brain.Event:2")


class EventFileWriter:
    """Append TensorBoard events to ``log_dir/events.out.tfevents.*``.

    The subset of torch's SummaryWriter the training loop uses:
    ``add_scalar``, ``add_image`` (HWC uint8 or HW/HW1 grayscale), ``flush``,
    ``close``. Thread-safe for interleaved writers.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname()
        )
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write_record(_version_event(time.time()))
        self._f.flush()

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", masked_crc32c(header)))
            self._f.write(data)
            self._f.write(struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def add_image(self, tag: str, image, step: int, dataformats: str = "HWC"):
        from PIL import Image

        arr = np.asarray(image)
        if dataformats == "CHW":
            arr = np.transpose(arr, (1, 2, 0))
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        h, w, c = arr.shape
        pil = Image.fromarray(arr[..., 0] if c == 1 else arr)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        self._write_record(
            _image_event(tag, buf.getvalue(), h, w, c, step, time.time())
        )

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

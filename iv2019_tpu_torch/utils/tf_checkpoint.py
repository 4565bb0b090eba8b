"""Reads TensorFlow checkpoints without TensorFlow.

The JAX package converts TF checkpoints with ``tf.train.load_checkpoint``
(iv2019_tpu/utils/checkpoint.py:421-447). The port reads the two formats
that loader reads for it by hand, so that the machine with the card needs
no TensorFlow:

- **V2** (``tf.train.Saver`` since TF 1.x, a prefix ``P``): ``P.index`` is a
  table (below) whose key ``""`` holds a ``BundleHeaderProto`` (shard
  count, endianness) and whose every other key is a variable name holding a
  ``BundleEntryProto`` (dtype, shape, shard, offset, size, masked CRC-32C
  of the bytes). The bytes are read from ``P.data-0000k-of-0000N``.
  Partitioned variables (entries with ``slices``) are refused.
- **V1** (one file, as the slim ``resnet_v1_50.ckpt`` of 2016 is): the same
  table; key ``""`` holds a ``SavedTensorSlices`` whose ``meta`` lists each
  tensor's name, shape and dtype; every other entry holds a ``SavedSlice``
  whose ``data`` is a ``TensorProto`` (values in its typed repeated fields
  or in ``tensor_content``). Each tensor is assembled from its slices and
  must be covered by them.

The table is LevelDB's: a 48-byte footer ending in the magic
``0xdb4775248b80fb57`` points at an index block, whose entries point at the
data blocks; a block holds prefix-compressed keys and a restart array, and
is followed by a type byte (0: not compressed, the only type TF writes
here) and the masked CRC-32C of contents and type. Every block's checksum
and every V2 tensor's checksum is verified; a mismatch, a bad magic, a
truncated file or a compressed block raises ``ValueError``.

Protocol buffers are decoded by hand (varints, fixed32/64, length-delimited
fields): only the few messages above are needed, and no ``protobuf``
package is assumed. dtypes: float32, float64, int32, int64, bool, float16
and bfloat16 (returned as 2-byte patterns, numpy dtype ``V2``, which is how
``np.savez`` stores TF's bfloat16 arrays); any other raises.

The CRC-32C runs as a C loop in the port's native helpers
(``iv2019_tpu_torch/native``); ``crc32c_py`` is the plain version, used
where the helpers cannot be built.

API: ``list_variables(path) -> {name: shape}`` and ``load_checkpoint(path)``
returning a reader with ``get_variable_to_shape_map()`` and
``get_tensor(name)`` (numpy). ``path`` is a V2 prefix, a V1 file, or a
directory, which means its ``checkpoint`` file's ``model_checkpoint_path``
as in TF.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Iterator

import numpy as np

__all__ = ["CheckpointReader", "crc32c", "crc32c_py", "list_variables", "load_checkpoint"]

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
CRC_MASK_DELTA = 0xA282EAD8

# TF DataType -> numpy dtype (types.proto); a *_REF type is its value + 100
DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("V2"),    # DT_BFLOAT16, as bit patterns
    19: np.dtype("<f2"),   # DT_HALF
}


# -- CRC-32C ---------------------------------------------------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c_py(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` continuing from ``crc`` (TF's ``crc32c::Extend``),
    one byte at a time: the plain version of the native helper."""
    c = crc ^ 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C through the native helper, or ``crc32c_py`` where it cannot be
    built."""
    from iv2019_tpu_torch import native

    value = native.crc32c(data, crc)
    return crc32c_py(data, crc) if value is None else value


def unmask_crc(masked: int) -> int:
    """TF's ``crc32c::Unmask``: the inverse of ``((c >> 15) | (c << 17)) +
    0xa282ead8`` on 32 bits."""
    rot = (masked - CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- protocol buffers ---------------------------------------------------------

def _varint(buf, pos: int) -> tuple[int, int]:
    result, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) of a message: an int for varint and
    fixed fields, a memoryview for length-delimited ones."""
    buf = memoryview(buf)
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64 field")
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated length-delimited field")
            value = buf[pos:pos + size]
            pos += size
        elif wire == 5:
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32 field")
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def _message(buf) -> dict[int, list]:
    out: dict[int, list] = {}
    for number, wire, value in _fields(buf):
        out.setdefault(number, []).append((wire, value))
    return out


def _scalar(msg: dict, number: int, default=0):
    """The last value of a scalar field (protobuf's rule for repeats)."""
    values = msg.get(number)
    return values[-1][1] if values else default


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _shape(buf) -> tuple[int, ...]:
    """TensorShapeProto: dim = 2 (Dim: size = 1), unknown_rank = 3."""
    if buf is None:
        return ()
    msg = _message(buf)
    if _scalar(msg, 3):
        raise ValueError("tensor of unknown rank")
    return tuple(_signed64(_scalar(_message(d), 1)) for _, d in msg.get(2, []))


def _dtype(code: int) -> int:
    code = code - 100 if code > 100 else code  # a *_REF type
    if code not in DTYPES:
        raise ValueError(f"unsupported TF dtype {code}")
    return code


# -- the table ------------------------------------------------------------------

def _block_handle(buf, pos: int) -> tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


class _Table:
    """An immutable sorted table (TF's lib/io/table, LevelDB's format)."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = memoryview(data), name
        if len(data) < FOOTER_BYTES:
            raise ValueError(f"{name}: {len(data)} bytes, shorter than a table footer")
        footer = self.data[len(data) - FOOTER_BYTES:]
        magic = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0]
        if magic != TABLE_MAGIC:
            raise ValueError(f"{name}: bad table magic {magic:#x} (truncated or not a "
                             "checkpoint table)")
        _, _, pos = _block_handle(footer, 0)  # the metaindex block: unused
        self.index = _block_handle(footer, pos)[:2]

    def block(self, offset: int, size: int) -> memoryview:
        end = offset + size + BLOCK_TRAILER_BYTES
        if offset < 0 or end > len(self.data):
            raise ValueError(f"{self.name}: block at {offset}+{size} runs past the end of "
                             f"the file ({len(self.data)} bytes)")
        contents = self.data[offset:offset + size + 1]  # with the type byte
        kind = contents[size]
        masked = struct.unpack_from("<I", self.data, offset + size + 1)[0]
        if crc32c(contents) != unmask_crc(masked):
            raise ValueError(f"{self.name}: block checksum mismatch at offset {offset}")
        if kind != 0:
            raise ValueError(f"{self.name}: block at offset {offset} has compression type "
                             f"{kind}; only uncompressed (0) blocks are read")
        return contents[:size]

    @staticmethod
    def entries(block: memoryview, name: str) -> Iterator[tuple[bytes, memoryview]]:
        if len(block) < 4:
            raise ValueError(f"{name}: block of {len(block)} bytes")
        restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
        limit = len(block) - 4 * (restarts + 1)
        if limit < 0:
            raise ValueError(f"{name}: {restarts} restarts do not fit a block of "
                             f"{len(block)} bytes")
        pos, key = 0, b""
        while pos < limit:
            shared, pos = _varint(block, pos)
            unshared, pos = _varint(block, pos)
            size, pos = _varint(block, pos)
            if shared > len(key) or pos + unshared + size > limit:
                raise ValueError(f"{name}: corrupt block entry")
            key = key[:shared] + bytes(block[pos:pos + unshared])
            pos += unshared
            yield key, block[pos:pos + size]
            pos += size

    def items(self) -> Iterator[tuple[bytes, memoryview]]:
        index = self.block(*self.index)
        for _, handle in self.entries(index, self.name):
            offset, size, _ = _block_handle(handle, 0)
            yield from self.entries(self.block(offset, size), self.name)


# -- V2 bundles -------------------------------------------------------------------

class _Entry:
    __slots__ = ("dtype", "shape", "shard", "offset", "size", "crc")

    def __init__(self, buf, name: str):
        msg = _message(buf)
        if 7 in msg:
            raise ValueError(f"{name}: partitioned variable (slices); not supported")
        self.dtype = _dtype(_scalar(msg, 1))
        self.shape = _shape(_scalar(msg, 2, None))
        self.shard = _scalar(msg, 3)
        self.offset = _scalar(msg, 4)
        self.size = _scalar(msg, 5)
        self.crc = _scalar(msg, 6)  # masked; checked even where absent, as TF does


class _BundleV2:
    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            table = _Table(f.read(), prefix + ".index")
        self.entries: dict[str, _Entry] = {}
        header = None
        for key, value in table.items():
            if key == b"":
                header = _message(value)
                continue
            if key[:1] == b"\x00":
                raise ValueError(f"{prefix}: a partitioned variable's slice key; not supported")
            name = key.decode()
            self.entries[name] = _Entry(value, name)
        if header is None:
            raise ValueError(f"{prefix}.index has no bundle header")
        if _scalar(header, 2):
            raise ValueError(f"{prefix}: big-endian bundle; only little-endian is read")
        self.num_shards = _scalar(header, 1, 1)

    def shard_path(self, shard: int) -> str:
        return f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"

    def tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        dtype = DTYPES[e.dtype]
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * dtype.itemsize:
            raise ValueError(f"{name}: {e.size} bytes for {count} x {dtype.itemsize}")
        if not 0 <= e.shard < self.num_shards:
            raise ValueError(f"{name}: shard {e.shard} of {self.num_shards}")
        raw = bytearray(e.size)
        with open(self.shard_path(e.shard), "rb") as f:
            f.seek(e.offset)
            got = f.readinto(raw)
        if got != e.size:
            raise ValueError(f"{name}: {self.shard_path(e.shard)} ends {e.size - got} "
                             "bytes early")
        if crc32c(raw) != unmask_crc(e.crc):
            raise ValueError(f"{name}: data checksum mismatch in {self.shard_path(e.shard)}")
        return np.frombuffer(raw, dtype).reshape(e.shape)


# -- V1 tensor slices -----------------------------------------------------------

def _extents(buf, shape: tuple[int, ...]) -> tuple[slice, ...]:
    """TensorSliceProto (extent = 1: start = 1, length = 2; no length: the
    whole dimension) -> an index into the full tensor."""
    extents = _message(buf).get(1, []) if buf is not None else []
    if extents and len(extents) != len(shape):
        raise ValueError(f"slice of rank {len(extents)} for a tensor of rank {len(shape)}")
    index = []
    for (_, e), dim in zip(extents, shape):
        m = _message(e)
        if 2 in m:
            start, length = _signed64(_scalar(m, 1)), _signed64(_scalar(m, 2))
        else:
            start, length = 0, dim
        if start < 0 or length < 0 or start + length > dim:
            raise ValueError(f"slice [{start}, {start + length}) of a dimension of {dim}")
        index.append(slice(start, start + length))
    return tuple(index) or tuple(slice(0, d) for d in shape)


def _packed(values: list, wire_fixed: int, fmt: str) -> np.ndarray:
    """A repeated numeric field: packed (length-delimited) chunks or single
    values, in order. ``fmt``: a numpy dtype for fixed-width fields, None
    for varints."""
    parts = []
    for wire, value in values:
        if wire == 2:
            if fmt is None:
                pos, out = 0, []
                while pos < len(value):
                    v, pos = _varint(value, pos)
                    out.append(_signed64(v))
                parts.append(np.asarray(out, np.int64))
            else:
                parts.append(np.frombuffer(value, fmt))
        elif wire == wire_fixed and fmt is not None:
            width = np.dtype(fmt).itemsize
            parts.append(np.frombuffer(value.to_bytes(width, "little"), fmt))
        elif wire == 0 and fmt is None:
            parts.append(np.asarray([_signed64(value)], np.int64))
        else:
            raise ValueError(f"repeated field of wire type {wire}")
    return np.concatenate(parts) if parts else np.zeros(0, fmt or np.int64)


def _tensor_values(buf, code: int, count: int, name: str) -> np.ndarray:
    """The ``count`` values of a TensorProto of dtype ``code``, flat."""
    msg = _message(buf)
    dtype = DTYPES[code]
    content = _scalar(msg, 4, None)
    if content is not None and len(content):
        flat = np.frombuffer(content, dtype)
    elif code == 1:
        flat = _packed(msg.get(5, []), 5, "<f4")
    elif code == 2:
        flat = _packed(msg.get(6, []), 1, "<f8")
    elif code == 3:
        flat = _packed(msg.get(7, []), 0, None).astype(np.int32)
    elif code == 9:
        flat = _packed(msg.get(10, []), 0, None)
    elif code == 10:
        flat = _packed(msg.get(11, []), 0, None) != 0
    else:  # half and bfloat16: the 16-bit patterns in half_val
        flat = (_packed(msg.get(13, []), 0, None) & 0xFFFF).astype("<u2").view(dtype)
    if flat.size != count:
        raise ValueError(f"{name}: a slice of {count} elements holds {flat.size} values")
    return flat


class _SlicesV1:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            table = _Table(f.read(), path)
        self.meta: dict[str, tuple[int, tuple[int, ...]]] = {}
        self.slices: dict[str, list[tuple[memoryview, memoryview]]] = {}
        for key, value in table.items():
            msg = _message(value)
            if key == b"":
                for _, tensor in _message(_scalar(msg, 1)).get(1, []):
                    t = _message(tensor)
                    name = bytes(_scalar(t, 1, b"")).decode()
                    self.meta[name] = (_dtype(_scalar(t, 3)), _shape(_scalar(t, 2, None)))
                continue
            saved = _message(_scalar(msg, 2, b""))
            name = bytes(_scalar(saved, 1, b"")).decode()
            self.slices.setdefault(name, []).append((_scalar(saved, 2, None),
                                                     _scalar(saved, 3, b"")))
        if not self.meta and self.slices:
            raise ValueError(f"{path}: no tensor-slice metadata")
        for name in self.slices:
            if name not in self.meta:
                raise ValueError(f"{path}: data for {name!r}, which the metadata does not list")

    def tensor(self, name: str) -> np.ndarray:
        code, shape = self.meta[name]
        out = np.zeros(shape, DTYPES[code])
        covered = np.zeros(shape, bool)
        for extent, data in self.slices.get(name, []):
            index = _extents(extent, shape)
            part = tuple(s.stop - s.start for s in index)
            count = int(np.prod(part, dtype=np.int64))
            out[index] = _tensor_values(data, code, count, name).reshape(part)
            covered[index] = True
        if not covered.all():
            raise ValueError(f"{self.path}: the slices of {name!r} cover "
                             f"{int(covered.sum())} of {covered.size} elements")
        return out


# -- the reader -------------------------------------------------------------------

def _resolve(path: str) -> str:
    """A directory -> the checkpoint its ``checkpoint`` file names."""
    path = os.fspath(path)
    if not os.path.isdir(path):
        return path
    state = os.path.join(path, "checkpoint")
    try:
        with open(state) as f:
            text = f.read()
    except OSError as e:
        raise ValueError(f"{path} is a directory without a 'checkpoint' file") from e
    m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', text, re.M)
    if not m:
        raise ValueError(f"{state} names no model_checkpoint_path")
    name = m.group(1).encode().decode("unicode_escape")
    return name if os.path.isabs(name) else os.path.join(path, name)


class CheckpointReader:
    """The variables of one checkpoint (V2 bundle or V1 file)."""

    def __init__(self, path: str):
        self.path = _resolve(path)
        if os.path.exists(self.path + ".index"):
            self._impl = _BundleV2(self.path)
            self._meta = {n: (e.dtype, e.shape) for n, e in self._impl.entries.items()}
        elif os.path.isfile(self.path):
            self._impl = _SlicesV1(self.path)
            self._meta = dict(self._impl.meta)
        else:
            raise ValueError(f"no checkpoint at {self.path} (neither {self.path}.index nor a "
                             "V1 file)")

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {name: list(shape) for name, (_, shape) in self._meta.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self._meta:
            raise KeyError(f"{name!r} is not in the checkpoint {self.path}")
        return self._impl.tensor(name)


def load_checkpoint(path: str) -> CheckpointReader:
    """A reader of the checkpoint at ``path`` (``tf.train.load_checkpoint``)."""
    return CheckpointReader(path)


def list_variables(path: str) -> dict[str, list[int]]:
    """{name: shape} of every variable, sorted by name."""
    return dict(sorted(load_checkpoint(path).get_variable_to_shape_map().items()))

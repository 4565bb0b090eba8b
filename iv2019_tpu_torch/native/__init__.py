"""Native (C++) helpers of the host input pipelines: build, load and bind.

The port's copy of iv2019_tpu/native: ``fastops.cpp`` (TF1 bilinear and
nearest resize, bbox rasterizing, uint8 -> f32, the label lookup; and, the
port's own, the CRC-32C that checks TF checkpoints) and
``decode.cpp`` (PNG/JPEG through the system libpng/libjpeg), each compiled
with ``g++`` at first use into its own library under ``build/`` at the
repository root, named by a hash of the source and the flags. ctypes
releases the interpreter lock for each call, so the input threads run them
in parallel.

Builds are safe to race: each process compiles into a temporary file of its
own in ``build/`` and renames it over the final name (``os.replace`` is
atomic), so no process ever opens a half-written library. A library that
cannot be had because the machine has no ``g++`` (or, for decode, no
libjpeg/libpng to link or to load at run time; the build adds a run-time
search path to where the compiler found them) is remembered for the
process and every call here returns None, so the caller takes its numpy or
PIL path; ``status()`` says which path each library took. ``fastops.cpp``
failing to compile or load where ``g++`` exists is a fault and raises.

Each function mirrors a numpy rule of the port and returns the same values
(tests/test_torch_native.py); one deliberate difference from the JAX
package's copy: the rasterizer divides each pixel's counts by their sum, as
the port's numpy and on-device rasterizers do, where the JAX package's
multiplies by the reciprocal (the two differ in the last bit at counts
such as 5/6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "CXX_FLAGS",
    "NativeHelpers",
    "available",
    "crc32c",
    "decode_available",
    "decode_image",
    "map_lut_i32",
    "rasterize_bboxes",
    "resize_bilinear_f32",
    "resize_nearest",
    "status",
    "u8_to_f32",
]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_ip = ctypes.POINTER(ctypes.c_int)


class Unavailable(Exception):
    """The library cannot be built or loaded on this machine (no compiler,
    or no system libraries to link or load); the caller falls back to
    numpy/PIL."""


def _declare_fastops(lib: ctypes.CDLL) -> None:
    lib.resize_bilinear_f32.argtypes = [_c_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        _c_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resize_nearest_bytes.argtypes = [_c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         _c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rasterize_bboxes.argtypes = [_c_i32p, _c_f32p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _c_f32p]
    lib.u8_to_f32.argtypes = [_c_u8p, ctypes.c_int64, _c_f32p, ctypes.c_int]
    lib.map_lut_i32.argtypes = [_c_u8p, ctypes.c_int64, _c_i32p, ctypes.c_int, _c_i32p]
    for name in ("resize_bilinear_f32", "resize_nearest_bytes", "rasterize_bboxes",
                 "u8_to_f32", "map_lut_i32"):
        getattr(lib, name).restype = None
    lib.crc32c_extend.argtypes = [ctypes.c_uint32, _c_u8p, ctypes.c_int64]
    lib.crc32c_extend.restype = ctypes.c_uint32


def _declare_decode(lib: ctypes.CDLL) -> None:
    lib.decode_info.argtypes = [_c_u8p, ctypes.c_int64, ctypes.c_int, _c_ip, _c_ip, _c_ip]
    lib.decode_info.restype = ctypes.c_int
    lib.decode_u8.argtypes = [_c_u8p, ctypes.c_int64, ctypes.c_int, _c_u8p]
    lib.decode_u8.restype = ctypes.c_int


# stem -> (source, link flags, binder, whether a failed compile or load
# means a missing system library rather than a fault)
_LIBRARIES = {
    "fastops": ("fastops.cpp", (), _declare_fastops, False),
    "decode": ("decode.cpp", ("-ljpeg", "-lpng"), _declare_decode, True),
}


def _link_flags(compiler: str, link: tuple) -> tuple:
    """``link`` plus a run-time search path to the directory where the
    compiler finds each ``-l`` library, so the loader finds it there too."""
    dirs = []
    for flag in link:
        found = subprocess.run([compiler, f"-print-file-name=lib{flag[2:]}.so"],
                               capture_output=True, text=True).stdout.strip()
        if os.path.isabs(found) and os.path.dirname(found) not in dirs:
            dirs.append(os.path.dirname(found))
    return tuple(link) + tuple(f"-Wl,-rpath,{d}" for d in dirs)


def library_path(stem: str, build_dir: Path = BUILD_DIR) -> Path:
    source, link, _, _ = _LIBRARIES[stem]
    flags = " ".join(CXX_FLAGS + link).encode()
    digest = hashlib.sha256((SRC_DIR / source).read_bytes() + flags).hexdigest()[:16]
    return Path(build_dir) / f"lib{stem}_host_{digest}.so"


def build(stem: str, build_dir: Path = BUILD_DIR) -> tuple[Path, bool]:
    """(library path, whether this call compiled it). Compiles into a
    temporary file of this process's own and renames it into place."""
    source, link, _, missing_lib_on_failure = _LIBRARIES[stem]
    path = library_path(stem, build_dir)
    if path.exists():
        return path, False
    compiler = shutil.which("g++")
    if compiler is None:
        raise Unavailable("no C++ compiler (g++) on this machine")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, str(SRC_DIR / source),
                               *_link_flags(compiler, link)], capture_output=True, text=True)
        if proc.returncode != 0:
            message = f"g++ could not build {source}: {proc.stderr.strip()[-600:]}"
            if missing_lib_on_failure:
                raise Unavailable(message)
            raise RuntimeError(message)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, True


def _open(stem: str, path: Path) -> ctypes.CDLL:
    """The loaded library; for decode, a system library the loader cannot
    find (linked, but not on this machine's search path) makes it
    unavailable."""
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        if _LIBRARIES[stem][3]:
            raise Unavailable(f"cannot load {path.name}: {e}") from e
        raise


class _Library:
    """One lazily built library: loaded once per process, or the reason it
    is unavailable."""

    def __init__(self, stem: str, build_dir: Path):
        self.stem, self.build_dir = stem, build_dir
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.status = "not loaded"

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and not self.status.startswith("unavailable"):
                try:
                    path, compiled = build(self.stem, self.build_dir)
                    lib = _open(self.stem, path)
                except Unavailable as e:
                    self.status = f"unavailable: {e}"
                    return None
                _LIBRARIES[self.stem][2](lib)
                self._lib = lib
                self.status = f"{'built' if compiled else 'loaded'} {path.name}"
            return self._lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeHelpers:
    """The native helpers built into ``build_dir``; each method returns None
    where its library is unavailable."""

    def __init__(self, build_dir: Path = BUILD_DIR):
        self._fastops = _Library("fastops", Path(build_dir))
        self._decode = _Library("decode", Path(build_dir))

    def status(self) -> dict[str, str]:
        """{'fastops': ..., 'decode': ...}: 'built <file>' (compiled by this
        process), 'loaded <file>', 'unavailable: <reason>' or 'not loaded'."""
        return {"fastops": self._fastops.status, "decode": self._decode.status}

    def available(self) -> bool:
        return self._fastops.get() is not None

    def decode_available(self) -> bool:
        return self._decode.get() is not None

    def resize_bilinear_f32(self, src: np.ndarray, size, align_corners: bool = False):
        """(H, W, C) f32 -> (oh, ow, C) f32, TF1 bilinear."""
        lib = self._fastops.get()
        if lib is None:
            return None
        src = np.ascontiguousarray(src, dtype=np.float32)
        h, w, c = src.shape
        oh, ow = int(size[0]), int(size[1])
        out = np.empty((oh, ow, c), np.float32)
        lib.resize_bilinear_f32(_ptr(src, ctypes.c_float), h, w, c, _ptr(out, ctypes.c_float),
                                oh, ow, int(align_corners))
        return out

    def resize_nearest(self, src: np.ndarray, size, align_corners: bool = False):
        """TF1 nearest resize over the two leading axes of (H, W[, ...]); dtype kept."""
        lib = self._fastops.get()
        if lib is None:
            return None
        src = np.ascontiguousarray(src)
        h, w = src.shape[:2]
        elem = int(np.prod(src.shape[2:], dtype=np.int64)) * src.dtype.itemsize
        oh, ow = int(size[0]), int(size[1])
        out = np.empty((oh, ow, *src.shape[2:]), src.dtype)
        lib.resize_nearest_bytes(_ptr(src, ctypes.c_uint8), h, w, elem,
                                 _ptr(out, ctypes.c_uint8), oh, ow, int(align_corners))
        return out

    def rasterize_bboxes(self, cids: np.ndarray, boxes: np.ndarray, h: int, w: int,
                         ncls: int):
        """(h, w, ncls) f32 multinomial of (N,) int32 ids and (N, 4) f32 boxes."""
        lib = self._fastops.get()
        if lib is None:
            return None
        cids = np.ascontiguousarray(cids, np.int32).reshape(-1)
        boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
        if len(cids) != len(boxes):
            raise ValueError(f"{len(cids)} class ids for {len(boxes)} boxes")
        out = np.empty((h, w, ncls), np.float32)
        lib.rasterize_bboxes(_ptr(cids, ctypes.c_int32), _ptr(boxes, ctypes.c_float),
                             len(cids), h, w, ncls, _ptr(out, ctypes.c_float))
        return out

    def u8_to_f32(self, src: np.ndarray, center: bool = False):
        """uint8 -> f32 as ``x * (1/255)`` (``center``: then ``* 2 - 1``)."""
        lib = self._fastops.get()
        if lib is None:
            return None
        src = np.ascontiguousarray(src, np.uint8)
        out = np.empty(src.shape, np.float32)
        lib.u8_to_f32(_ptr(src, ctypes.c_uint8), src.size, _ptr(out, ctypes.c_float),
                      int(center))
        return out

    def map_lut_i32(self, src: np.ndarray, table: np.ndarray):
        """int32 ``table[src]`` of uint8 ids, ids past the table clamped to its end."""
        lib = self._fastops.get()
        if lib is None:
            return None
        src = np.ascontiguousarray(src, np.uint8)
        table = np.ascontiguousarray(table, np.int32)
        out = np.empty(src.shape, np.int32)
        lib.map_lut_i32(_ptr(src, ctypes.c_uint8), src.size, _ptr(table, ctypes.c_int32),
                        len(table), _ptr(out, ctypes.c_int32))
        return out

    def crc32c(self, data, crc: int = 0):
        """CRC-32C of a bytes-like object, continuing from ``crc`` (TF's
        ``crc32c::Extend``); the value of utils/tf_checkpoint.py::crc32c_py."""
        lib = self._fastops.get()
        if lib is None:
            return None
        buf = np.frombuffer(data, np.uint8)
        return int(lib.crc32c_extend(crc, _ptr(buf, ctypes.c_uint8), buf.size))

    def decode_image(self, buf: bytes, force_rgb: bool = False):
        """PNG/JPEG bytes -> uint8 array, exactly ``np.asarray(Image.open(buf))``
        for 8-bit images (palette PNGs stay index maps), or with
        ``force_rgb`` that of ``.convert("RGB")``; None where the library is
        unavailable or the image is not one it takes (16-bit PNG, other
        formats), and the caller decodes with PIL."""
        lib = self._decode.get()
        if lib is None:
            return None
        data = np.frombuffer(buf, np.uint8)
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.decode_info(_ptr(data, ctypes.c_uint8), data.size, int(force_rgb),
                             ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        if rc != 0 or h.value <= 0 or w.value <= 0 or c.value <= 0:
            return None
        out = np.empty((h.value, w.value, c.value), np.uint8)
        rc = lib.decode_u8(_ptr(data, ctypes.c_uint8), data.size, int(force_rgb),
                           _ptr(out, ctypes.c_uint8))
        if rc != 0:
            return None
        return out[..., 0] if c.value == 1 else out


_HELPERS = NativeHelpers()

status = _HELPERS.status
available = _HELPERS.available
decode_available = _HELPERS.decode_available
resize_bilinear_f32 = _HELPERS.resize_bilinear_f32
resize_nearest = _HELPERS.resize_nearest
rasterize_bboxes = _HELPERS.rasterize_bboxes
u8_to_f32 = _HELPERS.u8_to_f32
map_lut_i32 = _HELPERS.map_lut_i32
crc32c = _HELPERS.crc32c
decode_image = _HELPERS.decode_image

"""The port's native host helpers (iv2019_tpu_torch/native): the cases of
tests/test_native.py against the port's own loader and numpy rules, builds
that race, and the sources against the JAX package's copies.

- Resize, rasterize, uint8 -> f32 and the label lookup against the numpy
  rules of the port that they stand in for; the rasterizer, u8 -> f32 and
  the lookup bit-equal, the resizes as in tests/test_native.py (bilinear
  within 1e-6, nearest equal). Decode against PIL, bit-equal for 8-bit
  images, palette PNGs as index maps; ``core.decode_image`` (native, else
  PIL) gives PIL's values on either route.
- Six processes build into one empty directory at once and each gets a
  working library (each compiles into a temporary file of its own and
  renames it into place); threads of one process share one build.
- ``decode.cpp`` is byte-equal to the JAX package's; ``fastops.cpp``
  differs in the one place the port chose (the rasterizer divides by the
  pixel's count, where the JAX package multiplies by its reciprocal).

None of this needs ``iv2019_tpu.native``. The tests skip only where the
machine has no ``g++`` (or, for decode, no libjpeg/libpng to link).
"""

import difflib
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from iv2019_tpu_torch import native
from iv2019_tpu_torch.input import core
from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes_pyloop
from iv2019_tpu_torch.ops.resize import _resize_nearest_axes, resize_bilinear, resize_nearest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fastops():
    if not native.available():
        pytest.skip(f"native helpers unavailable: {native.status()['fastops']}")
    return native


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((16, 24), (8, 12)), ((7, 13), (29, 5)),
                                          ((128, 256), (512, 1024))])
def test_bilinear_matches_the_numpy_rule(fastops, align, in_hw, out_hw):
    img = np.random.RandomState(0).rand(*in_hw, 3).astype(np.float32)
    got = fastops.resize_bilinear_f32(img, out_hw, align)
    np.testing.assert_allclose(got, resize_bilinear(img, out_hw, align), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align", [False, True])
def test_nearest_2d_int32_equals_the_numpy_rule(fastops, align):
    lab = np.random.RandomState(1).randint(0, 20, (33, 65)).astype(np.int32)
    got = fastops.resize_nearest(lab, (17, 129), align)
    np.testing.assert_array_equal(got, resize_nearest(lab, (17, 129), align))
    assert got.dtype == np.int32


def test_nearest_3d_f32_resizes_the_leading_axes(fastops):
    lab = np.random.RandomState(2).rand(16, 24, 15).astype(np.float32)
    got = fastops.resize_nearest(lab, (9, 40))
    np.testing.assert_array_equal(got, _resize_nearest_axes(lab, (9, 40), False, 0))


def test_rasterize_is_bit_equal_to_the_numpy_rule(fastops):
    rng = np.random.RandomState(3)
    for _ in range(3):
        k = rng.randint(1, 30)
        cids = rng.randint(-1, 15, k).astype(np.int32)
        x = np.sort(rng.rand(k, 2), 1)
        y = np.sort(rng.rand(k, 2), 1)
        boxes = np.stack([x[:, 0], x[:, 1], y[:, 0], y[:, 1]], 1).astype(np.float32)
        np.testing.assert_array_equal(fastops.rasterize_bboxes(cids, boxes, 40, 56, 15),
                                      rasterize_bboxes_pyloop(cids, boxes, 40, 56))
    # counts whose reciprocal product differs from the quotient: 5 of 6
    # boxes of one class over a pixel, 3 of 7
    for n_a, n_b in ((5, 1), (3, 4)):
        cids = np.array([2] * n_a + [7] * n_b, np.int32)
        boxes = np.tile(np.array([[0.0, 1.0, 0.0, 1.0]], np.float32), (n_a + n_b, 1))
        got = fastops.rasterize_bboxes(cids, boxes, 3, 4, 15)
        assert got[0, 0, 2] == np.float32(n_a) / np.float32(n_a + n_b)
        np.testing.assert_array_equal(got, rasterize_bboxes_pyloop(cids, boxes, 3, 4))


def test_u8_to_f32_and_lut_are_bit_equal_to_the_numpy_rules(fastops):
    rng = np.random.RandomState(4)
    u8 = rng.randint(0, 255, (50, 60, 3), np.uint8)
    np.testing.assert_array_equal(fastops.u8_to_f32(u8),
                                  u8.astype(np.float32) * (np.float32(1) / np.float32(255)))
    np.testing.assert_allclose(fastops.u8_to_f32(u8, center=True),
                               ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5, rtol=1e-5,
                               atol=1e-6)
    table = rng.randint(0, 20, 34).astype(np.int32)
    lab = rng.randint(0, 40, (50, 60)).astype(np.uint8)
    np.testing.assert_array_equal(fastops.map_lut_i32(lab, table),
                                  table[np.minimum(lab.astype(np.int64), 33)])


DECODE_CASES = ["png_rgb", "png_gray", "png_palette", "png_rgba", "jpeg_rgb", "jpeg_gray"]


def _encode(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, format=fmt, **kw)
    return b.getvalue()


def _encoded_case(case):
    """Bytes of a small random image of the kind ``case`` names."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "png_rgb":
        return _encode(Image.fromarray(rng.randint(0, 256, (37, 53, 3), np.uint8)), "PNG")
    if case == "png_gray":
        return _encode(Image.fromarray(rng.randint(0, 256, (20, 31), np.uint8), "L"), "PNG")
    if case == "png_palette":
        img = Image.fromarray(rng.randint(0, 34, (24, 40), np.uint8), "P")
        img.putpalette([i % 256 for i in range(768)])
        return _encode(img, "PNG")
    if case == "png_rgba":
        return _encode(Image.fromarray(rng.randint(0, 256, (16, 16, 4), np.uint8), "RGBA"), "PNG")
    if case == "jpeg_rgb":
        return _encode(Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)), "JPEG",
                       quality=90)
    if case == "jpeg_gray":
        return _encode(Image.fromarray(rng.randint(0, 256, (32, 32), np.uint8), "L"), "JPEG",
                       quality=90)
    return _encode(Image.fromarray(rng.randint(0, 256, (9, 13, 3), np.uint8)), "PPM")


@pytest.mark.parametrize("route", ["as_built", "pil_fallback"])
@pytest.mark.parametrize("case", DECODE_CASES + ["ppm_rgb"])
def test_core_decode_image_equals_pil(case, route, monkeypatch):
    """``core.decode_image``, the one reader of the input pipelines: PIL's
    values, raw and with ``force_rgb``, through the native helper where it
    builds and takes the image (not ppm), and through PIL where the helper
    is unavailable."""
    if route == "pil_fallback":
        monkeypatch.setattr(native, "decode_image", lambda buf, force_rgb=False: None)
    buf = _encoded_case(case)
    with Image.open(io.BytesIO(buf)) as img:
        ref, ref_rgb = np.asarray(img), np.asarray(img.convert("RGB"))
    for got, want in ((core.decode_image(buf), ref),
                      (core.decode_image(buf, force_rgb=True), ref_rgb)):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


class TestDecode:
    """libjpeg/libpng decode against PIL."""

    @pytest.fixture(autouse=True)
    def _need_decode(self):
        if not native.decode_available():
            pytest.skip(f"native decode unavailable: {native.status()['decode']}")

    @pytest.mark.parametrize("case", DECODE_CASES)
    def test_raw_and_rgb_equal_pil(self, case):
        buf = _encoded_case(case)
        ref = np.asarray(Image.open(io.BytesIO(buf)))
        got = native.decode_image(buf)
        assert got is not None and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        ref_rgb = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
        got_rgb = native.decode_image(buf, force_rgb=True)
        assert got_rgb is not None and got_rgb.shape == ref_rgb.shape
        np.testing.assert_array_equal(got_rgb, ref_rgb)

    def test_palette_stays_indices(self):
        ids = np.arange(34, dtype=np.uint8).reshape(2, 17)
        img = Image.fromarray(ids, "P")
        img.putpalette([255 - i % 256 for i in range(768)])
        np.testing.assert_array_equal(native.decode_image(_encode(img, "PNG")), ids)

    def test_unsupported_returns_none(self):
        assert native.decode_image(b"not an image") is None
        img16 = Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000, "I;16")
        assert native.decode_image(_encode(img16, "PNG")) is None

    def test_truncated_does_not_crash(self):
        buf = _encode(Image.fromarray(np.zeros((64, 64, 3), np.uint8)), "PNG")
        assert native.decode_image(buf[: len(buf) // 2]) is None
        jbuf = _encode(Image.fromarray(np.zeros((64, 64, 3), np.uint8)), "JPEG")
        native.decode_image(jbuf[: len(jbuf) // 2])


def test_pipeline_transforms_take_the_native_path(fastops):
    """core's transforms run the helpers and give the numpy rules' values."""
    rng = np.random.RandomState(6)
    u8 = rng.randint(0, 256, (21, 34, 3), np.uint8)
    image = core.convert_image_dtype(u8)
    np.testing.assert_array_equal(image, u8.astype(np.float32) * core._INV_255)
    table = rng.randint(0, 19, 34).astype(np.int32)
    lab = rng.randint(0, 40, (21, 34)).astype(np.uint8)
    np.testing.assert_array_equal(core.map_lids_to_cids(lab, table),
                                  table[np.minimum(lab.astype(np.int64), 33)])
    img, label = core.resize_images_and_labels(image, table[np.minimum(lab, 33)], (16, 24))
    np.testing.assert_allclose(img, resize_bilinear(image, (16, 24)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(label, _resize_nearest_axes(table[np.minimum(lab, 33)],
                                                              (16, 24), False, 0))
    assert native.status()["fastops"].startswith(("built", "loaded"))


_BUILDER = r"""
import json, sys
import numpy as np
from iv2019_tpu_torch.native import NativeHelpers
helpers = NativeHelpers(sys.argv[1])
ok = helpers.available()
out = helpers.rasterize_bboxes(np.array([3, -1], np.int32),
                               np.array([[0.1, 0.6, 0.2, 0.9], [0, 1, 0, 1]], np.float32),
                               8, 8, 15) if ok else None
print(json.dumps({"ok": ok, "status": helpers.status()["fastops"],
                  "sum": None if out is None else float(out.sum())}))
"""


def test_six_processes_building_at_once_all_get_the_library(tmp_path):
    if not native.available():
        pytest.skip(f"native helpers unavailable: {native.status()['fastops']}")
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build_dir)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["ok"] for r in results), results
    assert {r["sum"] for r in results} == {64.0}
    assert any(r["status"].startswith("built") for r in results), results
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert libs == [native.library_path("fastops", build_dir).name]
    assert not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]


def test_threads_of_one_process_share_one_build(tmp_path):
    if not native.available():
        pytest.skip(f"native helpers unavailable: {native.status()['fastops']}")
    helpers = native.NativeHelpers(tmp_path)
    results = []
    threads = [threading.Thread(target=lambda: results.append(helpers.available()))
               for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 8
    assert helpers.status()["fastops"].startswith("built")


def test_no_compiler_means_numpy_fallback(tmp_path, monkeypatch):
    """Without g++ the helpers report why and return None; the pipeline
    takes its numpy rules."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    helpers = native.NativeHelpers(tmp_path / "empty")
    assert not helpers.available()
    assert helpers.u8_to_f32(np.zeros(3, np.uint8)) is None
    assert helpers.status()["fastops"] == "unavailable: no C++ compiler (g++) on this machine"
    assert not helpers.decode_available()


def _read(*parts):
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def test_decode_source_is_the_jax_packages():
    assert _read("iv2019_tpu_torch", "native", "decode.cpp") == _read("iv2019_tpu", "native",
                                                                      "decode.cpp")


def test_fastops_source_differs_only_in_the_rasterizers_division():
    """The JAX package's helpers unchanged but for the rasterizer's division;
    the port's own CRC-32C (utils/tf_checkpoint.py) is appended after them."""
    port = _read("iv2019_tpu_torch", "native", "fastops.cpp").decode().splitlines()
    jax_copy = _read("iv2019_tpu", "native", "fastops.cpp").decode().splitlines()
    crc_start = port.index("// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes,")
    crc_end = port.index('}  // extern "C"')
    crc_block = port[crc_start:crc_end]
    diff = [line for line in difflib.unified_diff(jax_copy, port, lineterm="", n=0)
            if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert diff == [
        "-        float inv = 1.f / total;",
        "-        for (int k = 0; k < ncls; ++k) o[k] *= inv;",
        "+        // divide, as the numpy and on-device rasterizers do: k * (1/t)",
        "+        // differs from k / t in the last bit for some counts (5/6, 3/7)",
        "+        for (int k = 0; k < ncls; ++k) o[k] /= total;",
    ] + ["+" + line for line in crc_block]
    assert "crc32c_extend" in "\n".join(crc_block)


def test_decode_library_the_loader_cannot_open_means_pil(tmp_path, monkeypatch):
    """A decode library that links but whose libjpeg the loader cannot find
    is unavailable (PIL decodes); fastops failing to load is a fault."""
    if not native.available():
        pytest.skip(f"native helpers unavailable: {native.status()['fastops']}")

    def refuse(path, *args, **kw):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    helpers = native.NativeHelpers(tmp_path)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    assert not helpers.decode_available()
    assert helpers.decode_image(b"\x89PNG") is None
    assert helpers.status()["decode"].startswith("unavailable: cannot load")
    with pytest.raises(OSError):
        helpers.available()

"""The port's training input pipelines against the JAX package's.

- Synthetic per-pixel, bbox and image-label batches: bit-equal for the same
  seed (the same numpy draws, the same rasterizing).
- The TFRecord per-pixel reader and the OpenImages bbox and image-label
  readers on tiny files written here, with a fixed ``input_seed``: images
  within 1e-6 (the JAX package decodes and resizes through its C++
  helpers, the port through PIL and numpy; both round as TF1 does), labels,
  ids and paths equal.
- ``heterogeneous.train_input``: the same keys, shapes and values.
- The host rasterizer against the JAX package's three for boxes inside the
  image: bit-equal. Outside the image, and for label ids past the lookup
  table, the JAX package's paths disagree with each other (ROADMAP.md
  queue C); the port follows its native C++ helpers.
- ``device_prefetch`` on the CPU: order kept, errors re-raised, and its
  producer thread stopped when the consumer closes it.
"""

import io
import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from iv2019_tpu.input import cityscapes as jax_cityscapes
from iv2019_tpu.input import openimages as jax_openimages
from iv2019_tpu.input.heterogeneous import train_input as jax_hetero
from iv2019_tpu.input.tfrecord_writer import TFRecordWriter, encode_example
from iv2019_tpu.ops.rasterize import rasterize_bboxes as jax_rasterize_on_device
from iv2019_tpu.ops.rasterize import rasterize_bboxes_np as jax_rasterize_np
from iv2019_tpu.ops.rasterize import rasterize_bboxes_pyloop as jax_rasterize_pyloop
from iv2019_tpu.problem.problem_def import load_problem_def as jax_load_problem_def
from iv2019_tpu_torch.input import cityscapes, openimages
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.input.prefetch import device_prefetch
from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes_np
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.problem.taxonomy import OPEN_IMAGES_MID2CID, OPEN_IMAGES_MID2CID_V1
from torch_parity import torch_tiny_settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_JSON = os.path.join(ROOT, "iv2019_tpu", "problem_definitions", "cityscapes", "problem01.json")
PORT_JSON = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                         "problem01.json")
IMAGE_ATOL = 1e-6
BATCHES = 3


def _settings(**kw):
    kw.setdefault("training_problem_def_path", JAX_JSON)
    jax_settings, settings = torch_tiny_settings(**kw)
    return jax_settings, settings.replace(training_problem_def_path=PORT_JSON)


def _take(it, n=BATCHES):
    return [next(it) for _ in range(n)]


def _assert_batches_equal(got, want, image_atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                if k.startswith("proimages") and image_atol:
                    np.testing.assert_allclose(g[k], v, rtol=0, atol=image_atol, err_msg=k)
                else:
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


def test_synthetic_per_pixel_batches_are_bit_equal():
    jax_settings, settings = _settings(synthetic_data=True, Nb=3)
    want = _take(jax_cityscapes.synthetic_train_batches(
        jax_settings, jax_load_problem_def(JAX_JSON), seed=11))
    got = _take(cityscapes.synthetic_train_batches(settings, load_problem_def(PORT_JSON), seed=11))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("kind", ["bbox", "image"])
def test_synthetic_weak_batches_are_bit_equal(kind):
    jax_settings, settings = _settings(synthetic_data=True, Nb=3)
    want = _take(jax_openimages.synthetic_weak_batches(jax_settings, kind=kind, seed=4))
    got = _take(openimages.synthetic_weak_batches(settings, kind=kind, seed=4))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_rasterize_matches_jax(seed):
    """Boxes inside the image: the same as each of the JAX package's three
    rasterizers (host, Python loop, on-device)."""
    rng = np.random.RandomState(seed)
    # one image size and box count per seed (the on-device version compiles
    # per shape); id -1 pads, and the ids past 15 are skipped by all
    h, w = [(13, 17), (1, 9), (23, 6)][seed]
    for _ in range(20):
        cids = rng.randint(-1, 17, 8).astype(np.int32)
        boxes = np.sort(rng.rand(8, 2, 2), axis=2).reshape(8, 4).astype(np.float32)
        got = rasterize_bboxes_np(cids, boxes, h, w)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_rasterize_np(cids, boxes, h, w))
        np.testing.assert_array_equal(got, jax_rasterize_pyloop(cids, boxes, h, w))
        np.testing.assert_array_equal(got, np.asarray(jax_rasterize_on_device(cids, boxes, h, w)))


def test_out_of_range_inputs_follow_jax_native():
    """Boxes past the image edges and label ids past the lookup table: the
    JAX package's paths disagree there (ROADMAP.md queue C); the port does
    what its native C++ helpers do, which its pipelines run wherever a C++
    compiler is: truncate and clamp box edges, clamp ids to the table."""
    from iv2019_tpu import native

    if not native.available():
        pytest.skip("no C++ toolchain for the JAX package's native helpers")
    from iv2019_tpu_torch.input import core

    rng = np.random.RandomState(5)
    for _ in range(30):
        k = rng.randint(1, 9)
        cids = rng.randint(-1, 17, k).astype(np.int32)
        boxes = rng.uniform(-0.3, 1.3, (k, 4)).astype(np.float32)
        h, w = rng.randint(1, 24), rng.randint(1, 24)
        np.testing.assert_array_equal(rasterize_bboxes_np(cids, boxes, h, w),
                                      native.rasterize_bboxes(cids, boxes, h, w, 15))
    table = load_problem_def(PORT_JSON).lids2cids_voids_replaced()
    labels = rng.randint(0, 256, (7, 9)).astype(np.uint8)
    np.testing.assert_array_equal(core.map_lids_to_cids(labels, table),
                                  native.map_lut_i32(labels, table))


def _png(array) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def tfrecords(tmp_path_factory):
    """Five Cityscapes-like records of different sizes: RGB PNG images and
    label-id PNGs over the problem definition's 34 ids."""
    path = str(tmp_path_factory.mktemp("tfr") / "train.tfrecords")
    rng = np.random.RandomState(0)
    with TFRecordWriter(path) as w:
        for i, (h, w_) in enumerate([(40, 80), (36, 64), (50, 70), (32, 64), (45, 90)]):
            image = rng.randint(0, 256, (h, w_, 3), dtype=np.uint8)
            label = rng.randint(0, 34, (h, w_), dtype=np.uint8)
            w.write(encode_example({
                "image/encoded": _png(image), "image/format": "png",
                "image/path": f"img_{i}.png", "label/encoded": _png(label),
                "label/format": "png", "label/path": f"lab_{i}.png",
            }))
    return path


@pytest.mark.parametrize("preserve", [False, True])
def test_tfrecord_train_input_matches_jax(tfrecords, preserve):
    jax_settings, settings = _settings(tfrecords_path=tfrecords, Nb=2, input_seed=5,
                                       preserve_aspect_ratio=preserve)
    want = _take(jax_cityscapes.train_input(jax_settings, jax_load_problem_def(JAX_JSON)))
    got = _take(cityscapes.train_input(settings, load_problem_def(PORT_JSON)))
    _assert_batches_equal(got, want, IMAGE_ATOL)


@pytest.fixture(scope="module")
def openimages_files(tmp_path_factory):
    """Six JPEGs of different sizes, a bbox pickle and an image-label json
    over known and unknown MIDs of both label spaces."""
    root = tmp_path_factory.mktemp("oi")
    rng = np.random.RandomState(1)
    mids = sorted(set(OPEN_IMAGES_MID2CID) | set(OPEN_IMAGES_MID2CID_V1)) + ["/m/unknown"]
    bboxes, labels = {}, {}
    for i, (h, w) in enumerate([(48, 64), (60, 40), (30, 90), (64, 64), (50, 100), (40, 70)]):
        imageid = f"im{i}"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"{imageid}.jpg", quality=90)
        boxes = []
        for _ in range(rng.randint(1, 5)):
            x = np.sort(rng.rand(2)).tolist()
            y = np.sort(rng.rand(2)).tolist()
            boxes.append((mids[rng.randint(len(mids))], (x[0], x[1], y[0], y[1])))
        bboxes[imageid] = boxes
        labels[imageid] = [mids[j] for j in rng.randint(0, len(mids), rng.randint(0, 4))]
    with open(root / "bboxes.pkl", "wb") as f:
        pickle.dump(bboxes, f)
    with open(root / "labels.json", "w") as f:
        json.dump(labels, f)
    return dict(openimages_image_dir=str(root), openimages_bboxes_path=str(root / "bboxes.pkl"),
                openimages_image_labels_path=str(root / "labels.json"))


@pytest.mark.parametrize("space", ["v2", "v1"])
def test_bbox_reader_matches_jax(openimages_files, space):
    jax_settings, settings = _settings(Nb=2, input_seed=8, preserve_aspect_ratio=True,
                                       openimages_label_space=space, **openimages_files)
    want = _take(jax_openimages.bbox_train_input(jax_settings))
    got = _take(openimages.bbox_train_input(settings))
    _assert_batches_equal(got, want, IMAGE_ATOL)


@pytest.mark.parametrize("compact", [False, True])
def test_image_label_reader_matches_jax(openimages_files, compact):
    jax_settings, settings = _settings(Nb=2, input_seed=9, preserve_aspect_ratio=True,
                                       compact_image_labels=compact, **openimages_files)
    want = _take(jax_openimages.image_labels_train_input(jax_settings))
    got = _take(openimages.image_labels_train_input(settings))
    _assert_batches_equal(got, want, IMAGE_ATOL)
    assert ("image_label_vecs" in got[0]) is compact


def test_on_device_rasterizing_is_refused(openimages_files):
    _, settings = _settings(Nb=2, rasterize_on_device=True, **openimages_files)
    with pytest.raises(NotImplementedError):
        next(openimages.bbox_train_input(settings))


@pytest.mark.parametrize("nb", [(2, 2, 2), (2, 3, 0)])
def test_heterogeneous_train_input_matches_jax(nb):
    npp, npb, npi = nb
    jax_settings, settings = _settings(synthetic_data=True, input_seed=21, Nb_per_pixel=npp,
                                       Nb_per_bbox=npb, Nb_per_image=npi)
    want = _take(jax_hetero(jax_settings, jax_load_problem_def(JAX_JSON)), 2)
    got = _take(train_input(settings, load_problem_def(PORT_JSON)), 2)
    _assert_batches_equal(got, want)
    assert got[0]["proimages_per_bbox"].shape[0] == npb
    assert got[0]["prolabels_per_image"].shape == (npi, 32, 64, 15)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "input-prefetch" and t.is_alive()]


def test_device_prefetch_on_cpu_keeps_order_and_stops_on_close():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2, 3), i, np.float32), "ids": [f"id{i}"]}
            i += 1

    before = len(_prefetch_threads())
    it = device_prefetch(endless(), "cpu", depth=2)
    got = [next(it) for _ in range(5)]
    for i, batch in enumerate(got):
        assert isinstance(batch["x"], torch.Tensor) and float(batch["x"][0, 0]) == i
        assert batch["ids"] == [f"id{i}"]
    it.close()
    deadline = time.time() + 10
    while len(_prefetch_threads()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(_prefetch_threads()) == before


def test_device_prefetch_reraises_producer_errors():
    def failing():
        yield {"x": np.zeros(2, np.float32)}
        raise OSError("disk gone")

    it = device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)

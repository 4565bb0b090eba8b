"""On-device bbox rasterizing of the port against the JAX package's.

- ``ops/rasterize.py::rasterize_bboxes`` (batched, tensors) against
  ``iv2019_tpu.ops.rasterize.rasterize_bboxes`` (one image, jnp): bit-equal
  over random padded box lists with padding, ids past the weak classes,
  boxes past the image edges, and a coordinate where the f32 box edge and
  the f64 one floor to different pixels (JAX computes it in f32: x64 off).
- Inside the image the device rasterizer gives the host one's bits.
- ``transform_boxes_for_crop``, the on-device branch of ``bbox_train_input``
  on JPEGs written here (equal padded box tensors and crops, images within
  1e-6) and ``heterogeneous.train_input`` carrying the box tensors, against
  the JAX package.
- ``device_prefetch`` hands int32 ids and padded f32 boxes on unchanged.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iv2019_tpu.input import openimages as jax_openimages
from iv2019_tpu.input.heterogeneous import train_input as jax_hetero
from iv2019_tpu.input.tfrecord_writer import TFRecordWriter, encode_example
from iv2019_tpu.ops.rasterize import rasterize_bboxes as jax_rasterize
from iv2019_tpu.problem.problem_def import load_problem_def as jax_load_problem_def
from iv2019_tpu_torch.input import openimages
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.input.prefetch import device_prefetch
from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes, rasterize_bboxes_np
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.problem.taxonomy import OPEN_IMAGES_MID2CID
from test_torch_input import JAX_JSON, PORT_JSON, _png, _settings
from torch_parity import threads

IMAGE_ATOL = 1e-6


def _jax_batch(cids, boxes, h, w):
    return np.stack([np.asarray(jax_rasterize(jnp.asarray(c), jnp.asarray(b), h, w))
                     for c, b in zip(cids, boxes)])


def _random_boxes(rng, n, k, lo=-0.3, hi=1.3):
    cids = rng.randint(-1, 18, (n, k)).astype(np.int32)
    cids[:, k - 2:] = -1  # padding at the end, as the reader pads
    boxes = rng.uniform(lo, hi, (n, k, 2, 2))
    boxes = np.sort(boxes, axis=3).reshape(n, k, 4).astype(np.float32)
    return cids, boxes


@pytest.mark.parametrize("seed,hw", [(0, (13, 17)), (1, (1, 9)), (2, (23, 6)), (3, (16, 32)),
                                     (4, (7, 7))])
def test_device_rasterizer_is_bit_equal_to_jax(seed, hw):
    threads()
    rng = np.random.RandomState(seed)
    h, w = hw
    cids, boxes = _random_boxes(rng, 3, 12)
    got = rasterize_bboxes(torch.as_tensor(cids), torch.as_tensor(boxes), h, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, h, w, 15)
    np.testing.assert_array_equal(got.numpy(), _jax_batch(cids, boxes, h, w))


def test_f32_box_edges_as_jax_computes_them():
    """f32(3/23) * 23 rounds to 3.0 in f32 but is just under 3 in f64: the
    device rasterizer puts the edge at pixel 3, as JAX's does with x64 off."""
    c = np.float32(3 / 23)
    assert np.floor(c * np.float32(23)) == 3 and np.floor(np.float64(c) * 23) == 2
    cids = np.array([[2, 5, -1]], np.int32)
    boxes = np.array([[[c, 0.9, c, 0.9], [0.0, c, 0.0, c], [0, 0, 0, 0]]], np.float32)
    got = rasterize_bboxes(torch.as_tensor(cids), torch.as_tensor(boxes), 23, 23).numpy()
    np.testing.assert_array_equal(got, _jax_batch(cids, boxes, 23, 23))
    assert got[0, 3, 3, 2] == 0.5 and got[0, 2, 2, 2] == 0.0  # the box starts at pixel 3
    assert got[0, 3, 3, 5] == 0.5 and got[0, 4, 4, 5] == 0.0  # and the other ends there


@pytest.mark.parametrize("seed", range(3))
def test_device_rasterizer_equals_host_inside_the_image(seed):
    rng = np.random.RandomState(10 + seed)
    cids, boxes = _random_boxes(rng, 2, 9, 0.0, 1.0)
    cids = np.clip(cids, -1, 14)
    h, w = 20 + seed, 31
    got = rasterize_bboxes(torch.as_tensor(cids), torch.as_tensor(boxes), h, w).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], rasterize_bboxes_np(cids[i], boxes[i], h, w))


def test_device_rasterizer_is_repeatable_and_void_without_boxes():
    rng = np.random.RandomState(7)
    cids, boxes = _random_boxes(rng, 2, 6)
    cids[1] = -1
    a = rasterize_bboxes(torch.as_tensor(cids), torch.as_tensor(boxes), 9, 11)
    b = rasterize_bboxes(torch.as_tensor(cids), torch.as_tensor(boxes), 9, 11)
    assert torch.equal(a, b)
    void = torch.zeros(15)
    void[-1] = 1.0
    assert torch.equal(a[1], void.expand(9, 11, 15))
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", [
    dict(in_hw=(100, 200), target_hw=(100, 200)),
    dict(in_hw=(100, 200), target_hw=(100, 200), crop_offset=(50, 100), resized_hw=(200, 400)),
    dict(in_hw=(37, 90), target_hw=(32, 64), crop_offset=(3, 17), resized_hw=(37, 90)),
])
def test_transform_boxes_for_crop_matches_jax(case):
    rng = np.random.RandomState(3)
    coords = np.sort(rng.uniform(-0.1, 1.1, (9, 2, 2)), axis=2).reshape(9, 4).astype(np.float32)
    want = jax_openimages.transform_boxes_for_crop(coords, **case)
    got = openimages.transform_boxes_for_crop(coords, **case)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def weak_files(tmp_path_factory):
    """Five JPEGs of different sizes and a bbox pickle with up to 7 boxes an
    image, some of unknown MIDs, and one image with more than MAX_N_BBOXES."""
    root = tmp_path_factory.mktemp("weak")
    rng = np.random.RandomState(4)
    mids = sorted(OPEN_IMAGES_MID2CID) + ["/m/unknown"]
    bboxes = {}
    for i, (h, w) in enumerate([(48, 64), (60, 40), (30, 90), (64, 64), (50, 100)]):
        imageid = f"w{i}"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"{imageid}.jpg", quality=90)
        count = 600 if i == 3 else rng.randint(1, 8)
        boxes = []
        for _ in range(count):
            x = np.sort(rng.rand(2)).tolist()
            y = np.sort(rng.rand(2)).tolist()
            boxes.append((mids[rng.randint(len(mids))], (x[0], x[1], y[0], y[1])))
        bboxes[imageid] = boxes
    with open(root / "bboxes.pkl", "wb") as f:
        pickle.dump(bboxes, f)
    return dict(openimages_image_dir=str(root), openimages_bboxes_path=str(root / "bboxes.pkl"))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if not isinstance(v, np.ndarray):
                assert g[k] == v, k
                continue
            assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
            if k.startswith("proimages"):
                np.testing.assert_allclose(g[k], v, rtol=0, atol=IMAGE_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.mark.parametrize("preserve", [True, False])
def test_bbox_reader_on_device_branch_matches_jax(weak_files, preserve):
    jax_settings, settings = _settings(Nb=2, input_seed=6, preserve_aspect_ratio=preserve,
                                       rasterize_on_device=True, **weak_files)
    want = [next(it) for it in [jax_openimages.bbox_train_input(jax_settings)] for _ in range(4)]
    got = [next(it) for it in [openimages.bbox_train_input(settings)] for _ in range(4)]
    _assert_batches_equal(got, want)
    first = got[0]
    assert "prolabels" not in first
    assert first["bbox_cids"].shape == (2, openimages.MAX_N_BBOXES)
    assert first["bbox_coords"].shape == (2, openimages.MAX_N_BBOXES, 4)
    assert (np.concatenate([b["bbox_cids"] for b in got]) == -1).any()


def test_heterogeneous_input_carries_box_tensors(weak_files, tmp_path):
    path = str(tmp_path / "pp.tfrecords")
    rng = np.random.RandomState(8)
    with TFRecordWriter(path) as w:
        for i in range(3):
            w.write(encode_example({
                "image/encoded": _png(rng.randint(0, 256, (40, 72, 3), dtype=np.uint8)),
                "image/format": "png", "image/path": f"img_{i}.png",
                "label/encoded": _png(rng.randint(0, 34, (40, 72), dtype=np.uint8)),
                "label/format": "png", "label/path": f"lab_{i}.png"}))
    jax_settings, settings = _settings(
        tfrecords_path_per_pixel=path, input_seed=3, rasterize_on_device=True,
        compact_image_labels=True, Nb_per_pixel=1, Nb_per_bbox=2, Nb_per_image=0, **weak_files)
    want = [b for b, _ in zip(jax_hetero(jax_settings, jax_load_problem_def(JAX_JSON)), range(3))]
    got = [b for b, _ in zip(train_input(settings, load_problem_def(PORT_JSON)), range(3))]
    _assert_batches_equal(got, want)
    assert "prolabels_per_bbox" not in got[0]
    assert got[0]["bbox_cids"].dtype == np.int32
    assert got[0]["proimages_per_image"].shape[0] == 0


def test_prefetch_hands_box_tensors_on_unchanged():
    rng = np.random.RandomState(2)
    cids = rng.randint(-1, 15, (3, 516)).astype(np.int32)
    coords = rng.rand(3, 516, 4).astype(np.float32)
    batches = [{"bbox_cids": cids + i, "bbox_coords": coords * i, "imageids": ["a", "b", "c"]}
               for i in range(3)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert len(got) == 3
    for i, b in enumerate(got):
        assert b["bbox_cids"].dtype == torch.int32 and b["bbox_coords"].dtype == torch.float32
        np.testing.assert_array_equal(b["bbox_cids"].numpy(), cids + i)
        np.testing.assert_array_equal(b["bbox_coords"].numpy(), coords * i)
        assert b["imageids"] == ["a", "b", "c"]

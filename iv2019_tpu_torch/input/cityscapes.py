"""Cityscapes / Vistas per-pixel input (TFRecord KEYS2FEATURES_v5).

Port of iv2019_tpu/input/cityscapes.py (reference input_cityscapes.py /
input_vistas.py):

- train: TFRecord -> decode the PNG/JPEG image and PNG label (the native
  libpng/libjpeg helper, PIL where it does not build or take the image) ->
  lids2cids with voids replaced -> resize (optionally aspect-preserving + a
  shared random crop) to (hf, wf) -> shuffle(2000) + repeat -> batch ->
  [-1, 1) scaling;
- evaluate: one pass over the records, plain decode -> lids2cids -> plain
  resize to ``eval_size`` (default (hf, wf)) -> batch.

With ``settings.synthetic_data``, random batches of the same shapes and
dtypes (``synthetic_train_batches``, ``synthetic_eval_batches``), the same
numbers as the JAX package's for the same seed. Across ranks each batch
shard's train pipeline reads every ``data_count``-th record, from its own
(parallel/multihost.py::shard_records; the ranks of a spatial group read
the same ones); evaluation reads every record on every rank.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input import core
from iv2019_tpu_torch.input.tfrecord import parse_example, read_tfrecords
from iv2019_tpu_torch.parallel.multihost import shard_records
from iv2019_tpu_torch.problem.problem_def import ProblemDef

__all__ = ["evaluate_input", "synthetic_eval_batches", "synthetic_train_batches", "train_input"]


def _parse_record(record: bytes):
    ex = parse_example(record)
    image = core.decode_image(ex["image/encoded"][0])
    label = core.decode_image(ex["label/encoded"][0])
    if label.ndim == 3:
        label = label[..., 0]
    im_path = ex.get("image/path", [b""])[0].decode("utf-8", "replace")
    la_path = ex.get("label/path", [b""])[0].decode("utf-8", "replace")
    return image, label, im_path, la_path


def train_input(settings: Settings, problem_def: ProblemDef, tfrecords_path: Optional[str] = None,
                seed: Optional[int] = None) -> Iterator[dict]:
    """Yields batched {'proimages', 'prolabels', 'rawimagespaths',
    'rawlabelspaths'}: proimages f32 (Nb, hf, wf, 3) in [-1, 1), prolabels
    int32 (Nb, hf, wf)."""
    if seed is None:
        seed = settings.input_seed
    if settings.synthetic_data:
        yield from synthetic_train_batches(settings, problem_def, seed or 0)
        return
    path = tfrecords_path or settings.tfrecords_path or settings.tfrecords_path_per_pixel
    lut = problem_def.lids2cids_voids_replaced()
    hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    make_rng = core.per_item_rng_factory(seed)

    def _prebatch(indexed: tuple) -> dict:
        index, record = indexed
        image, label, im_path, la_path = _parse_record(record)
        proimage, prolabel = core.resize_images_and_labels(
            core.convert_image_dtype(image), core.map_lids_to_cids(label, lut), hw,
            settings.preserve_aspect_ratio, make_rng(index))
        return {"proimages": proimage, "prolabels": prolabel, "rawimagespaths": im_path,
                "rawlabelspaths": la_path}

    # each process keeps a disjoint stride of the record stream
    records = core.shuffle_repeat(lambda: shard_records(read_tfrecords(path)), seed=seed)
    for batch in core.batched(core.parallel_map(_prebatch, enumerate(records)), settings.Nb):
        batch["proimages"] = core.from_0_1_to_m1_1(batch["proimages"])
        yield batch


def evaluate_input(settings: Settings, problem_def: ProblemDef,
                   tfrecords_path: Optional[str] = None) -> Iterator[dict]:
    """One pass of eval batches: plain resize to ``eval_size`` or (hf, wf),
    labels nearest-resized with the images (reference
    input_cityscapes.py:190-246)."""
    if settings.synthetic_data:
        yield from synthetic_eval_batches(settings, problem_def)
        return
    path = tfrecords_path or settings.tfrecords_path
    lut = problem_def.lids2cids_voids_replaced()
    hw = settings.eval_size or (settings.height_feature_extractor, settings.width_feature_extractor)

    def _pre(record: bytes) -> dict:
        image, label, im_path, la_path = _parse_record(record)
        proimage, prolabel = core.resize_images_and_labels(
            core.convert_image_dtype(image), core.map_lids_to_cids(label, lut), hw)
        return {"proimages": core.from_0_1_to_m1_1(proimage), "prolabels": prolabel,
                "rawimagespaths": im_path, "rawlabelspaths": la_path}

    yield from core.batched(core.parallel_map(_pre, read_tfrecords(path)), settings.Nb)


def synthetic_train_batches(settings: Settings, problem_def: ProblemDef,
                            seed: int = 0) -> Iterator[dict]:
    """Random batches with the real pipeline's shapes and dtypes."""
    rng = np.random.RandomState(seed)
    h, w = settings.height_feature_extractor, settings.width_feature_extractor
    n = settings.Nb
    nc = problem_def.output_num_classes(settings.train_void_class)
    while True:
        yield {
            "proimages": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
            "prolabels": rng.randint(0, nc, (n, h, w)).astype(np.int32),
            "rawimagespaths": ["synthetic"] * n,
            "rawlabelspaths": ["synthetic"] * n,
        }


def synthetic_eval_batches(settings: Settings, problem_def: ProblemDef, seed: int = 0,
                           num_batches: int = 8) -> Iterator[dict]:
    """``num_batches`` random eval batches at ``eval_size`` or (hf, wf)."""
    rng = np.random.RandomState(seed)
    h, w = settings.eval_size or (settings.height_feature_extractor,
                                  settings.width_feature_extractor)
    n = settings.Nb
    nc = problem_def.output_num_classes(settings.train_void_class)
    for _ in range(num_batches):
        yield {
            "proimages": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
            "prolabels": rng.randint(0, nc, (n, h, w)).astype(np.int32),
            "rawimagespaths": ["synthetic"] * n,
            "rawlabelspaths": ["synthetic"] * n,
        }

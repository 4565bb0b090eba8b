"""Cityscapes / Vistas per-pixel training input (TFRecord KEYS2FEATURES_v5).

Port of the training half of iv2019_tpu/input/cityscapes.py (reference
input_cityscapes.py / input_vistas.py): TFRecord -> decode the PNG/JPEG
image and PNG label (PIL) -> lids2cids with voids replaced -> resize
(optionally aspect-preserving + a shared random crop) to (hf, wf) ->
shuffle(2000) + repeat -> batch -> [-1, 1) scaling. With
``settings.synthetic_data``, random batches of the same shapes and dtypes
(``synthetic_train_batches``), the same numbers as the JAX package's for
the same seed. Single process only: the JAX package's multi-host record
striding is not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import io
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input import core
from iv2019_tpu_torch.input.tfrecord import parse_example, read_tfrecords
from iv2019_tpu_torch.problem.problem_def import ProblemDef

__all__ = ["synthetic_train_batches", "train_input"]


def _decode(buf: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(buf)) as img:
        return np.asarray(img)


def _parse_record(record: bytes):
    ex = parse_example(record)
    image = _decode(ex["image/encoded"][0])
    label = _decode(ex["label/encoded"][0])
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

    records = core.shuffle_repeat(lambda: read_tfrecords(path), seed=seed)
    for batch in core.batched(core.parallel_map(_prebatch, enumerate(records)), settings.Nb):
        batch["proimages"] = core.from_0_1_to_m1_1(batch["proimages"])
        yield batch


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

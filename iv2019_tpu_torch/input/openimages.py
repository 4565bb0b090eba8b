"""OpenImages weak-supervision training input: bounding boxes and image labels.

Port of iv2019_tpu/input/openimages.py (reference input_subset_bboxes_v2.py,
input_subset_image_labels.py):

- bounding boxes: a {imageid: [(mid, (xmin, xmax, ymin, ymax)), ...]}
  mapping (pickle or json) and a JPEG directory; the label is the dense
  15-class multinomial rasterized from the boxes on the host
  (ops/rasterize.py), then aspect-preserving resized and randomly cropped
  to (hf, wf) with the image;
- image-level labels: {imageid: [mids]}; the label is one multinomial
  vector, uniform over the present classes, tiled to the image size, or
  with ``compact_image_labels`` shipped as (Nb, 15) vectors and broadcast
  on the device by the train step.

Both honor ``openimages_label_space`` ("v2", 15 classes, or the legacy "v1"
aggregation projected into the v2 space). ``rasterize_on_device`` is not
ported (ROADMAP.md queue A) and raises. The mappings are unpickled: read only
files this project's tools wrote.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input import core
from iv2019_tpu_torch.ops.rasterize import image_label_multinomial_np, rasterize_bboxes_np
from iv2019_tpu_torch.problem.taxonomy import (
    NUM_WEAK_CLASSES,
    OPEN_IMAGES_MID2CID,
    OPEN_IMAGES_MID2CID_V1,
    V1_CID2V2_CID,
)

__all__ = ["bbox_train_input", "image_labels_train_input", "mid2cid_for",
           "synthetic_weak_batches"]


def mid2cid_for(settings: Settings) -> dict:
    """MID -> v2 weak cid under ``openimages_label_space`` ("v1": the legacy
    10-class cids composed with their injection into the v2 space)."""
    if settings.openimages_label_space == "v1":
        return {mid: int(V1_CID2V2_CID[cid]) for mid, cid in OPEN_IMAGES_MID2CID_V1.items()}
    return OPEN_IMAGES_MID2CID


def _load_mapping(path: str) -> dict:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_image(image_dir: str, imageid: str) -> np.ndarray:
    with Image.open(os.path.join(image_dir, imageid + ".jpg")) as img:
        return np.asarray(img if img.mode == "RGB" else img.convert("RGB"))


def _refuse_on_device(settings: Settings) -> None:
    if settings.rasterize_on_device:
        raise NotImplementedError("on-device bbox rasterizing (rasterize_on_device) is not "
                                  "ported yet (ROADMAP.md queue A)")


def bbox_train_input(settings: Settings, seed: Optional[int] = None) -> Iterator[dict]:
    """Yields batched {'proimages' (Nb, hf, wf, 3) in [-1, 1), 'prolabels'
    (Nb, hf, wf, 15) f32, 'imageids'}."""
    _refuse_on_device(settings)
    if seed is None:
        seed = settings.input_seed
    if settings.synthetic_data:
        yield from synthetic_weak_batches(settings, kind="bbox", seed=seed or 0)
        return
    imageid2bboxes = _load_mapping(settings.openimages_bboxes_path)
    image_dir = settings.openimages_image_dir
    mid2cid = mid2cid_for(settings)
    hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    make_rng = core.per_item_rng_factory(seed)

    def _pre(indexed) -> dict:
        index, (imageid, bboxes) = indexed
        image = core.convert_image_dtype(_read_image(image_dir, imageid))
        h, w = image.shape[:2]
        cids = np.asarray([mid2cid.get(mid, -1) for mid, _ in bboxes], np.int32)
        coords = np.asarray([c for _, c in bboxes], np.float32).reshape(-1, 4)
        proimage, prolabel = core.resize_images_and_labels(
            image, rasterize_bboxes_np(cids, coords, h, w), hw, settings.preserve_aspect_ratio,
            make_rng(index))
        return {"proimages": proimage, "prolabels": prolabel, "imageids": imageid}

    items = core.shuffle_repeat(lambda: imageid2bboxes.items(), seed=seed)
    for batch in core.batched(core.parallel_map(_pre, enumerate(items)), settings.Nb):
        batch["proimages"] = core.from_0_1_to_m1_1(batch["proimages"])
        yield batch


def image_labels_train_input(settings: Settings, seed: Optional[int] = None) -> Iterator[dict]:
    """Image-level labels; the contract of ``bbox_train_input``, or
    'image_label_vecs' (Nb, 15) in place of 'prolabels' with
    ``compact_image_labels``."""
    _refuse_on_device(settings)
    if seed is None:
        seed = settings.input_seed
    if settings.synthetic_data:
        yield from synthetic_weak_batches(settings, kind="image", seed=seed or 0)
        return
    imageid2mids = _load_mapping(settings.openimages_image_labels_path)
    image_dir = settings.openimages_image_dir
    mid2cid = mid2cid_for(settings)
    hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    make_rng = core.per_item_rng_factory(seed)
    compact = settings.compact_image_labels

    def _pre(indexed) -> dict:
        index, (imageid, mids) = indexed
        rng = make_rng(index)
        image = core.convert_image_dtype(_read_image(image_dir, imageid))
        cids = [mid2cid.get(mid, -1) for mid in mids]
        vec = image_label_multinomial_np([c for c in cids if c >= 0])
        if compact:
            # constant over the image, so resize and crop leave it as it is
            proimage, _ = core.resize_images_and_labels(
                image, None, hw, settings.preserve_aspect_ratio, rng)
            return {"proimages": proimage, "image_label_vecs": vec, "imageids": imageid}
        rla = np.broadcast_to(vec, (*image.shape[:2], NUM_WEAK_CLASSES))
        proimage, prolabel = core.resize_images_and_labels(
            image, np.ascontiguousarray(rla), hw, settings.preserve_aspect_ratio, rng)
        return {"proimages": proimage, "prolabels": prolabel, "imageids": imageid}

    items = core.shuffle_repeat(lambda: imageid2mids.items(), seed=seed)
    for batch in core.batched(core.parallel_map(_pre, enumerate(items)), settings.Nb):
        batch["proimages"] = core.from_0_1_to_m1_1(batch["proimages"])
        yield batch


def synthetic_weak_batches(settings: Settings, kind: str = "bbox",
                           seed: int = 0) -> Iterator[dict]:
    """Random weak-label batches of the real shapes; the bbox kind
    rasterizes a few random boxes per image on the host."""
    rng = np.random.RandomState(seed)
    h, w = settings.height_feature_extractor, settings.width_feature_extractor
    n = settings.Nb
    while True:
        images = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
        labels = np.empty((n, h, w, NUM_WEAK_CLASSES), np.float32)
        for i in range(n):
            if kind == "bbox":
                k = rng.randint(1, 8)
                cids = rng.randint(0, NUM_WEAK_CLASSES - 1, size=k).astype(np.int32)
                x = np.sort(rng.rand(k, 2), axis=1)
                y = np.sort(rng.rand(k, 2), axis=1)
                boxes = np.stack([x[:, 0], x[:, 1], y[:, 0], y[:, 1]], 1).astype(np.float32)
                labels[i] = rasterize_bboxes_np(cids, boxes, h, w)
            else:
                labels[i] = image_label_multinomial_np(
                    rng.randint(0, NUM_WEAK_CLASSES - 1, size=rng.randint(0, 4)))
        yield {"proimages": images, "prolabels": labels, "imageids": [f"synthetic_{kind}"] * n}

"""OpenImages weak-supervision training input: bounding boxes and image labels.

Port of iv2019_tpu/input/openimages.py (reference input_subset_bboxes_v2.py,
input_subset_image_labels.py):

- bounding boxes: a {imageid: [(mid, (xmin, xmax, ymin, ymax)), ...]}
  mapping (pickle or json) and a JPEG directory; the label is the dense
  15-class multinomial rasterized from the boxes on the host
  (ops/rasterize.py), then aspect-preserving resized and randomly cropped
  to (hf, wf) with the image; or, with ``rasterize_on_device``, the boxes
  themselves in the crop's coordinates, padded to ``MAX_N_BBOXES``, which
  the train step rasterizes on the device;
- image-level labels: {imageid: [mids]}; the label is one multinomial
  vector, uniform over the present classes, tiled to the image size, or
  with ``compact_image_labels`` shipped as (Nb, 15) vectors and broadcast
  on the device by the train step.

Both honor ``openimages_label_space`` ("v2", 15 classes, or the legacy "v1"
aggregation projected into the v2 space). Images decode through the native
libjpeg helper where it builds, else PIL. The mappings are unpickled: read
only files this project's tools wrote.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, Optional

import numpy as np

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input import core
from iv2019_tpu_torch.ops.rasterize import image_label_multinomial_np, rasterize_bboxes_np
from iv2019_tpu_torch.parallel.multihost import shard_records
from iv2019_tpu_torch.problem.taxonomy import (
    NUM_WEAK_CLASSES,
    OPEN_IMAGES_MID2CID,
    OPEN_IMAGES_MID2CID_V1,
    V1_CID2V2_CID,
)

__all__ = ["MAX_N_BBOXES", "bbox_train_input", "image_labels_train_input", "mid2cid_for",
           "synthetic_weak_batches", "transform_boxes_for_crop"]

MAX_N_BBOXES = 516  # reference input_subset_bboxes_v2.py:33


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
    with open(os.path.join(image_dir, imageid + ".jpg"), "rb") as f:
        buf = f.read()
    return core.decode_image(buf, force_rgb=True)


def transform_boxes_for_crop(coords: np.ndarray, in_hw, target_hw, crop_offset=(0, 0),
                             resized_hw=None) -> np.ndarray:
    """Normalized (xmin, xmax, ymin, ymax) boxes of an image resized to
    ``resized_hw`` (default ``target_hw``) and cropped to ``target_hw`` at
    ``crop_offset``, in the crop's normalized coordinates, clipped to [0, 1]."""
    th, tw = target_hw
    rh, rw = resized_hw if resized_hw is not None else (th, tw)
    oy, ox = crop_offset
    out = np.empty_like(coords)
    out[:, 0] = (coords[:, 0] * rw - ox) / tw
    out[:, 1] = (coords[:, 1] * rw - ox) / tw
    out[:, 2] = (coords[:, 2] * rh - oy) / th
    out[:, 3] = (coords[:, 3] * rh - oy) / th
    return np.clip(out, 0.0, 1.0)


def _boxes_for_device(image, cids, coords, hw, preserve_aspect_ratio, rng) -> dict:
    """The image resized (aspect-preserving 'max' if asked) and cropped at
    one random offset, and its boxes padded to ``MAX_N_BBOXES`` in the
    crop's coordinates (iv2019_tpu/input/openimages.py:153-178: the offsets
    are drawn from ``rng`` in the same order)."""
    h, w = image.shape[:2]
    if preserve_aspect_ratio:
        rh, rw = core.aspect_preserving_size((h, w), hw, "max")
    else:
        rh, rw = hw
    oy = rng.randint(0, rh - hw[0] + 1) if rh > hw[0] else 0
    ox = rng.randint(0, rw - hw[1] + 1) if rw > hw[1] else 0
    proimage = core.resize_bilinear_fast(image, (rh, rw))[oy:oy + hw[0], ox:ox + hw[1]]
    n = min(len(cids), MAX_N_BBOXES)
    pad_cids = np.full((MAX_N_BBOXES,), -1, np.int32)
    pad_coords = np.zeros((MAX_N_BBOXES, 4), np.float32)
    pad_cids[:n] = cids[:n]
    pad_coords[:n] = transform_boxes_for_crop(coords[:n], (h, w), hw, (oy, ox), (rh, rw))
    return {"proimages": proimage, "bbox_cids": pad_cids, "bbox_coords": pad_coords}


def bbox_train_input(settings: Settings, seed: Optional[int] = None) -> Iterator[dict]:
    """Yields batched {'proimages' (Nb, hf, wf, 3) in [-1, 1), 'prolabels'
    (Nb, hf, wf, 15) f32, 'imageids'}; with ``rasterize_on_device``
    'bbox_cids' (Nb, MAX_N_BBOXES) int32 (padding -1) and 'bbox_coords'
    (Nb, MAX_N_BBOXES, 4) f32 in crop coordinates in place of 'prolabels'.
    Synthetic batches stay dense, as in the JAX package."""
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
    on_device = settings.rasterize_on_device

    def _pre(indexed) -> dict:
        index, (imageid, bboxes) = indexed
        image = core.convert_image_dtype(_read_image(image_dir, imageid))
        h, w = image.shape[:2]
        cids = np.asarray([mid2cid.get(mid, -1) for mid, _ in bboxes], np.int32)
        coords = np.asarray([c for _, c in bboxes], np.float32).reshape(-1, 4)
        if on_device:
            out = _boxes_for_device(image, cids, coords, hw, settings.preserve_aspect_ratio,
                                    make_rng(index))
            return dict(out, imageids=imageid)
        proimage, prolabel = core.resize_images_and_labels(
            image, rasterize_bboxes_np(cids, coords, h, w), hw, settings.preserve_aspect_ratio,
            make_rng(index))
        return {"proimages": proimage, "prolabels": prolabel, "imageids": imageid}

    # each batch shard keeps a disjoint stride of the images
    items = core.shuffle_repeat(lambda: shard_records(imageid2bboxes.items()), seed=seed)
    for batch in core.batched(core.parallel_map(_pre, enumerate(items)), settings.Nb):
        batch["proimages"] = core.from_0_1_to_m1_1(batch["proimages"])
        yield batch


def image_labels_train_input(settings: Settings, seed: Optional[int] = None) -> Iterator[dict]:
    """Image-level labels; the contract of ``bbox_train_input``, or
    'image_label_vecs' (Nb, 15) in place of 'prolabels' with
    ``compact_image_labels``."""
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

    items = core.shuffle_repeat(lambda: shard_records(imageid2mids.items()), seed=seed)
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

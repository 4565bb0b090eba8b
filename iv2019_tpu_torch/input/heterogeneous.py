"""Heterogeneous-supervision batches: per-pixel, bbox and image-level.

Port of iv2019_tpu/input/heterogeneous.py (reference
per_pixel_per_bbox_per_image.py:20-87): one training element per step from
the three pipelines, the image sub-batches kept as separate arrays (the
train step concatenates them on the device). Sub-batch sizes follow
``Nb_per_pixel`` / ``Nb_per_bbox`` / ``Nb_per_image`` with the per-type
aspect policies; the pipelines take seeds ``seed``, ``seed + 1`` and
``seed + 2``. ``Nb_per_image = 0`` gives the two-way variant. Across ranks
``Nb_per_*`` are the global batch: each batch shard's pipelines make
``Nb_per_* / data_count`` examples from their own stride of the records,
seeded ``seed + 7919 * data_index`` (parallel/multihost.py): the ranks of a
spatial group read the same stream and hold the same images.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input.cityscapes import train_input as per_pixel_train_input
from iv2019_tpu_torch.input.openimages import bbox_train_input, image_labels_train_input
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.problem.problem_def import ProblemDef
from iv2019_tpu_torch.problem.taxonomy import NUM_WEAK_CLASSES

__all__ = ["train_input"]


def _empty_weak(settings: Settings) -> dict:
    h, w = settings.height_feature_extractor, settings.width_feature_extractor
    return {"proimages": np.zeros((0, h, w, 3), np.float32),
            "prolabels": np.zeros((0, h, w, NUM_WEAK_CLASSES), np.float32), "imageids": []}


def train_input(settings: Settings, problem_def: ProblemDef,
                seed: Optional[int] = None) -> Iterator[dict]:
    """Yields {'proimages_per_pixel', 'proimages_per_bbox',
    'proimages_per_image', 'prolabels_per_pixel', 'prolabels_per_bbox' (or
    'bbox_cids' and 'bbox_coords' with ``rasterize_on_device``),
    'prolabels_per_image' (or 'image_label_vecs'), 'imageids_per_bbox',
    'imageids_per_image', 'rawimagespaths', 'rawlabelspaths'}."""
    if seed is None:
        seed = settings.input_seed
    if multihost.data_count() > 1:
        settings = settings.replace(
            Nb_per_pixel=multihost.local_share(settings.Nb_per_pixel),
            Nb_per_bbox=multihost.local_share(settings.Nb_per_bbox),
            Nb_per_image=multihost.local_share(settings.Nb_per_image))
        # decorrelate shuffle order and random crops across batch shards
        if seed is not None:
            seed = seed + 7919 * multihost.data_index()
    pp_iter = per_pixel_train_input(
        settings.replace(Nb=settings.Nb_per_pixel,
                         preserve_aspect_ratio=settings.preserve_aspect_ratio_per_pixel),
        problem_def, seed=seed)
    pb_iter = pi_iter = None
    if settings.Nb_per_bbox > 0:
        pb_iter = bbox_train_input(
            settings.replace(Nb=settings.Nb_per_bbox,
                             preserve_aspect_ratio=settings.preserve_aspect_ratio_per_bbox),
            seed=None if seed is None else seed + 1)
    if settings.Nb_per_image > 0:
        pi_iter = image_labels_train_input(
            settings.replace(Nb=settings.Nb_per_image,
                             preserve_aspect_ratio=settings.preserve_aspect_ratio_per_image),
            seed=None if seed is None else seed + 2)
    empty = _empty_weak(settings)
    while True:
        pp = next(pp_iter)
        pb = next(pb_iter) if pb_iter is not None else empty
        pi = next(pi_iter) if pi_iter is not None else empty
        batch = {
            "proimages_per_pixel": pp["proimages"],
            "proimages_per_bbox": pb["proimages"],
            "proimages_per_image": pi["proimages"],
            "prolabels_per_pixel": pp["prolabels"],
            "imageids_per_bbox": pb["imageids"],
            "imageids_per_image": pi["imageids"],
            "rawimagespaths": pp.get("rawimagespaths", []),
            "rawlabelspaths": pp.get("rawlabelspaths", []),
        }
        if "bbox_cids" in pb:
            # padded box tensors, rasterized by the train step on the device
            batch["bbox_cids"] = pb["bbox_cids"]
            batch["bbox_coords"] = pb["bbox_coords"]
        else:
            batch["prolabels_per_bbox"] = pb["prolabels"]
        if "image_label_vecs" in pi:
            batch["image_label_vecs"] = pi["image_label_vecs"]
        else:
            batch["prolabels_per_image"] = pi["prolabels"]
        yield batch

"""Predict input: recursive image glob -> network-ready batches of one.

Port of iv2019_tpu/input/dataset_agnostic.py:37-73 and the helpers it uses
from iv2019_tpu/input/core.py: recursive glob over png/jpg/jpeg/ppm, decode
to RGB (``core.decode_image``), uint8 -> [0, 1), TF1 bilinear resize with
``align_corners=False`` (optionally aspect-preserving 'max' then a random
crop), [-1, 1) scaling. ``eval_size``, where set, replaces (hf, wf) as the
size images are resized to. Decoding runs on the host, one image at a time.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input import core

__all__ = ["SUPPORTED_EXTENSIONS", "predict_input", "preprocess"]

SUPPORTED_EXTENSIONS = ("png", "PNG", "jpg", "JPG", "jpeg", "JPEG", "ppm", "PPM")


def find_images(predict_dir: str) -> list[str]:
    fnames: list[str] = []
    for ext in SUPPORTED_EXTENSIONS:
        fnames.extend(glob.glob(os.path.join(predict_dir, "**", f"*.{ext}"), recursive=True))
    return sorted(set(fnames))


def preprocess(raw: np.ndarray, hw: Sequence[int], preserve_aspect_ratio: bool = False,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (h, w, 3) in [-1, 1)."""
    image, _ = core.resize_images_and_labels(core.convert_image_dtype(raw), None, hw,
                                             preserve_aspect_ratio, rng)
    return core.from_0_1_to_m1_1(image)


def predict_input(settings: Settings) -> Iterator[dict]:
    """Yields {'proimages' (1, h, w, 3), 'rawimages', 'rawimagespaths'}
    per image, in sorted path order (batch size 1: raw sizes differ);
    (h, w) is ``eval_size`` or (hf, wf)."""
    hw = settings.eval_size or (settings.height_feature_extractor,
                                settings.width_feature_extractor)
    for path in find_images(settings.predict_dir):
        with open(path, "rb") as f:
            raw = core.decode_image(f.read(), force_rgb=True)
        yield {
            "proimages": preprocess(raw, hw, settings.preserve_aspect_ratio)[None],
            "rawimages": raw,
            "rawimagespaths": path,
        }

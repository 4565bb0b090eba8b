"""Predict input: recursive image glob -> network-ready batches of one.

Port of iv2019_tpu/input/dataset_agnostic.py:37-73 and the helpers it uses
from iv2019_tpu/input/core.py: recursive glob over png/jpg/jpeg/ppm, PIL
decode to RGB, uint8 -> [0, 1), TF1 bilinear resize with
``align_corners=False`` (optionally aspect-preserving 'max' then a random
crop), [-1, 1) scaling. Decoding runs on the host, one image at a time.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Iterator, Optional, Sequence

import numpy as np
from PIL import Image

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.ops.resize import resize_bilinear

__all__ = ["SUPPORTED_EXTENSIONS", "predict_input", "preprocess"]

SUPPORTED_EXTENSIONS = ("png", "PNG", "jpg", "JPG", "jpeg", "JPEG", "ppm", "PPM")


def find_images(predict_dir: str) -> list[str]:
    fnames: list[str] = []
    for ext in SUPPORTED_EXTENSIONS:
        fnames.extend(glob.glob(os.path.join(predict_dir, "**", f"*.{ext}"), recursive=True))
    return sorted(set(fnames))


def aspect_preserving_size(in_hw: Sequence[int], target_hw: Sequence[int]) -> tuple[int, int]:
    """Tight cover of ``target_hw`` with ceil, TF1 parity ('max' mode)."""
    scale = max(target_hw[0] / in_hw[0], target_hw[1] / in_hw[1])
    return (int(math.ceil(scale * in_hw[0])), int(math.ceil(scale * in_hw[1])))


def preprocess(raw: np.ndarray, hw: Sequence[int], preserve_aspect_ratio: bool = False,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (h, w, 3) in [-1, 1)."""
    # uint8 -> [0, 1) as x * (1/255), the reference's native decode path
    image = raw.astype(np.float32) * np.float32(1.0 / 255.0)
    th, tw = int(hw[0]), int(hw[1])
    rh, rw = aspect_preserving_size(image.shape[:2], (th, tw)) if preserve_aspect_ratio else (th, tw)
    image = resize_bilinear(image, (rh, rw))
    if (rh, rw) != (th, tw):
        rng = rng or np.random
        oy = rng.randint(0, rh - th + 1)
        ox = rng.randint(0, rw - tw + 1)
        image = image[oy:oy + th, ox:ox + tw]
    return (image - 0.5) / 0.5


def predict_input(settings: Settings) -> Iterator[dict]:
    """Yields {'proimages' (1, hf, wf, 3), 'rawimages', 'rawimagespaths'}
    per image, in sorted path order (batch size 1: raw sizes differ)."""
    hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    for path in find_images(settings.predict_dir):
        with Image.open(path) as img:
            raw = np.asarray(img if img.mode == "RGB" else img.convert("RGB"))
        yield {
            "proimages": preprocess(raw, hw, settings.preserve_aspect_ratio)[None],
            "rawimages": raw,
            "rawimagespaths": path,
        }

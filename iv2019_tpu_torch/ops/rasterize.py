"""Bounding-box and image-level weak labels, on the host (numpy).

Counterparts of ``rasterize_bboxes_np`` and ``image_label_multinomial_np``
of iv2019_tpu/ops/rasterize.py (reference input_subset_bboxes_v2.py:74-98,
input_subset_image_labels.py:73-96). A box covers the pixels
``[int(ymin * H), int(ymax * H)] x [int(xmin * W), int(xmax * W)]``, max edges
inclusive and every edge clamped to the image; each pixel's label is its
box counts normalized by their sum, one-hot void where no box covers it.
The counts are small integers, so the result is the same, to the bit, as
the JAX package's corner-delta rasterizers (and as its Python loop for
boxes inside the image).
The device-side rasterizer (``rasterize_on_device``) is not ported
(ROADMAP.md queue A).
"""

from __future__ import annotations

import numpy as np

from iv2019_tpu_torch.problem.taxonomy import NUM_WEAK_CLASSES

__all__ = ["image_label_multinomial_np", "rasterize_bboxes_np"]


def rasterize_bboxes_np(cids, boxes, height: int, width: int) -> np.ndarray:
    """(height, width, 15) f32 multinomial of one image's boxes.

    cids: (N,) weak class ids (entries outside [0, 15) are skipped);
    boxes: (N, 4) f32 normalized (xmin, xmax, ymin, ymax).
    """
    rla = np.zeros((height, width, NUM_WEAK_CLASSES), dtype=np.float32)
    for cid, (bxmin, bxmax, bymin, bymax) in zip(np.asarray(cids),
                                                 np.asarray(boxes, np.float32)):
        if not 0 <= cid < NUM_WEAK_CLASSES:
            continue
        xmin, xmax = int(bxmin * width), int(bxmax * width)
        ymin, ymax = int(bymin * height), int(bymax * height)
        rla[max(ymin, 0):max(ymax + 1, 0), max(xmin, 0):max(xmax + 1, 0), cid] += 1
    total = rla.sum(axis=2)
    covered = total > 0.5
    # in place: divide the covered pixels by their counts (an uncovered
    # pixel's counts are all 0, so dividing by 1 leaves them 0), then mark
    # the uncovered ones void
    np.divide(rla, np.where(covered, total, np.float32(1.0))[..., None], out=rla)
    rla[~covered, -1] = 1.0
    return rla


def image_label_multinomial_np(cids_present) -> np.ndarray:
    """(15,) f32 uniform over the present non-void classes; one-hot void if none."""
    vec = np.zeros(NUM_WEAK_CLASSES, dtype=np.float32)
    present = [c for c in set(int(c) for c in cids_present) if 0 <= c < NUM_WEAK_CLASSES - 1]
    if present:
        vec[np.asarray(present)] = 1.0 / len(present)
    else:
        vec[-1] = 1.0
    return vec

"""Bounding-box and image-level weak labels: on the host and on the device.

Counterparts of iv2019_tpu/ops/rasterize.py (reference
input_subset_bboxes_v2.py:74-98, input_subset_image_labels.py:73-96).

- ``rasterize_bboxes_np`` (host, one image): a box covers the pixels
  ``[int(ymin * H), int(ymax * H)] x [int(xmin * W), int(xmax * W)]``, max
  edges inclusive and every edge clamped to the image; each pixel's label is
  its box counts divided by their sum, one-hot void where no box covers it.
  It runs the native helper (``native/fastops.cpp``) where that builds, else
  the numpy loop below; the two give the same bits. For boxes inside the
  image both equal the JAX package's rasterizers.
- ``rasterize_bboxes`` (tensors, batched; ``rasterize_on_device``): the JAX
  package's device rasterizer, to the bit: box edges ``floor(f32(coord) *
  size)`` in f32 (JAX's ``astype(float64)`` is float32 with x64 off), the 4
  signed corners of each box scattered into an (N, H+1, W+1, 15) grid with
  invalid boxes (padding id -1, ids past 14, empty after clamping) routed to
  the (H, W) gutter cell, two cumulative sums, then the normalization. Every
  addend is +-1 and every count stays below 2^24, so the scatter and the
  sums are exact in f32 whatever order the device adds in, and two launches
  give the same bits. Outside the image it differs from the host rule
  (floor against truncation; ROADMAP.md queue C), as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch

from iv2019_tpu_torch import native
from iv2019_tpu_torch.problem.taxonomy import NUM_WEAK_CLASSES

__all__ = ["image_label_multinomial_np", "rasterize_bboxes", "rasterize_bboxes_np",
           "rasterize_bboxes_pyloop"]


def rasterize_bboxes_np(cids, boxes, height: int, width: int) -> np.ndarray:
    """(height, width, 15) f32 multinomial of one image's boxes.

    cids: (N,) weak class ids (entries outside [0, 15) are skipped);
    boxes: (N, 4) f32 normalized (xmin, xmax, ymin, ymax).
    """
    fast = native.rasterize_bboxes(np.asarray(cids, np.int32), np.asarray(boxes, np.float32),
                                   height, width, NUM_WEAK_CLASSES)
    if fast is not None:
        return fast
    return rasterize_bboxes_pyloop(cids, boxes, height, width)


def rasterize_bboxes_pyloop(cids, boxes, height: int, width: int) -> np.ndarray:
    """The numpy rule of ``rasterize_bboxes_np``, one box at a time."""
    rla = np.zeros((height, width, NUM_WEAK_CLASSES), dtype=np.float32)
    for cid, (bxmin, bxmax, bymin, bymax) in zip(np.asarray(cids),
                                                 np.asarray(boxes, np.float32).reshape(-1, 4)):
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


def rasterize_bboxes(cids: torch.Tensor, boxes: torch.Tensor, height: int,
                     width: int, rows=None) -> torch.Tensor:
    """(N, height, width, 15) f32 multinomials of padded box lists, on the
    tensors' device.

    cids: (N, K) int weak class ids, padding -1; boxes: (N, K, 4) f32
    normalized (xmin, xmax, ymin, ymax). ``rows`` (a, b): only image rows
    [a, b), (N, b - a, width, 15), the same bits as those rows of the whole
    (a band under spatial partitioning): each valid box's rows are clamped
    to the band, so a box above or below it scatters +1 and -1 into one
    cell, which cancel exactly.
    """
    n, k = cids.shape
    cids = cids.to(torch.int64)
    boxes = boxes.to(torch.float32)

    def edge(i, size):
        return torch.floor(boxes[..., i] * size).to(torch.int64)

    y0 = edge(2, height).clamp(0, height)
    y1 = (edge(3, height) + 1).clamp(0, height)
    x0 = edge(0, width).clamp(0, width)
    x1 = (edge(1, width) + 1).clamp(0, width)
    valid = (cids >= 0) & (cids < NUM_WEAK_CLASSES) & (y1 > y0) & (x1 > x0)
    cid = torch.where(valid, cids, 0)
    a, b = rows or (0, height)
    y0 = torch.where(valid, y0.clamp(a, b) - a, b - a)
    y1 = torch.where(valid, y1.clamp(a, b) - a, b - a)
    height = b - a
    x0, x1 = torch.where(valid, x0, width), torch.where(valid, x1, width)

    c = NUM_WEAK_CLASSES
    image = torch.arange(n, device=cids.device)[:, None] * (height + 1)

    def flat(y, x):
        return ((image + y) * (width + 1) + x) * c + cid

    index = torch.cat([flat(y0, x0), flat(y1, x0), flat(y0, x1), flat(y1, x1)], 1).reshape(-1)
    one = torch.ones((n, k), dtype=torch.float32, device=cids.device)
    signs = torch.cat([one, -one, -one, one], 1).reshape(-1)
    delta = torch.zeros(n * (height + 1) * (width + 1) * c, dtype=torch.float32,
                        device=cids.device)
    delta.index_add_(0, index, signs)
    delta = delta.view(n, height + 1, width + 1, c)[:, :height, :width]
    counts = torch.cumsum(torch.cumsum(delta, dim=1), dim=2)
    total = counts.sum(dim=-1, keepdim=True)
    void = torch.zeros(c, dtype=torch.float32, device=cids.device)
    void[-1] = 1.0
    return torch.where(total > 0.5, counts / torch.clamp_min(total, 1e-12), void)


def image_label_multinomial_np(cids_present) -> np.ndarray:
    """(15,) f32 uniform over the present non-void classes; one-hot void if none."""
    vec = np.zeros(NUM_WEAK_CLASSES, dtype=np.float32)
    present = [c for c in set(int(c) for c in cids_present) if 0 <= c < NUM_WEAK_CLASSES - 1]
    if present:
        vec[np.asarray(present)] = 1.0 / len(present)
    else:
        vec[-1] = 1.0
    return vec

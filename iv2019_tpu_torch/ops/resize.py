"""TF1-exact image resizing (NHWC), on torch tensors or numpy arrays.

Port of iv2019_tpu/ops/resize.py. The reference uses TF r1.12
``tf.image.resize_images`` semantics: bilinear with ``align_corners=True``
for the model's x8 logit upsampler and the predict output resize, bilinear
and nearest with the legacy ``align_corners=False`` (not half-pixel
centres) in the input pipelines. ``torch.nn.functional.interpolate``
matches neither: its ``align_corners=False`` is half-pixel, and it computes
coordinates in a precision that differs from TF's float32 at exact integer
boundaries. So the index and weight tables are computed here, in float32,
exactly as TF does:

- scale = (in-1)/(out-1) if align_corners and out > 1 else in/out
- bilinear: src = dst * scale; floor + lerp, clamped
- nearest: floor(src) (legacy) or roundf(src), half away from zero (aligned)

``rows`` (a, b) computes only output rows [a, b) of the resize, and
``in_rows`` (first, full) says the input holds rows [first, first + h) of an
input of ``full`` rows: a rank's band of a map split by height (spatial
partitioning). ``resize_band`` fetches the rows a band's outputs read from
the other ranks of its group.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.utils.spans import span

__all__ = [
    "resize_band",
    "resize_bilinear",
    "resize_bilinear_mxu",
    "resize_nearest",
]


def _tf1_scale(in_size: int, out_size: int, align_corners: bool) -> np.float32:
    """Scale in float32, as TF computes it (float64 gives off-by-one indices
    at exact integer boundaries, e.g. 11 * (30/22))."""
    if align_corners and out_size > 1:
        return np.float32(in_size - 1) / np.float32(out_size - 1)
    return np.float32(in_size) / np.float32(out_size)


def _bilinear_tables(in_size: int, out_size: int, align_corners: bool):
    """(lo_idx, hi_idx, frac) numpy tables for one axis, TF1 semantics."""
    scale = _tf1_scale(in_size, out_size, align_corners)
    src = np.arange(out_size, dtype=np.float32) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def _nearest_table(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    scale = _tf1_scale(in_size, out_size, align_corners)
    src = np.arange(out_size, dtype=np.float32) * scale
    if align_corners:
        # TF's roundf: half away from zero, not numpy's half to even
        idx = np.floor(src + np.float32(0.5)).astype(np.int64)
    else:
        idx = np.floor(src).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) dense interpolation matrix with <= 2 nonzeros per row."""
    lo, hi, frac = _bilinear_tables(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m


def _take(x, idx: np.ndarray, axis: int):
    if isinstance(x, np.ndarray):
        return np.take(x, idx, axis=axis)
    with span("iv.sync.resize_index"):
        idx = torch.as_tensor(idx, device=x.device)
    return torch.index_select(x, axis, idx)


def _weights(frac: np.ndarray, like):
    if isinstance(like, np.ndarray):
        return frac
    with span("iv.sync.resize_weights"):
        return torch.as_tensor(frac, device=like.device)


def _float32(x):
    return x.astype(np.float32) if isinstance(x, np.ndarray) else x.float()


def resize_bilinear(images, size: Sequence[int], align_corners: bool = False, rows=None):
    """TF1 bilinear resize of NHWC (or HWC) images to ``size``; float32 out.
    ``rows`` (a, b): output rows [a, b) only."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    _, in_h, in_w, _ = images.shape
    out_h, out_w = int(size[0]), int(size[1])
    a, b = rows or (0, out_h)
    imgs = _float32(images)
    if (in_h, in_w) == (out_h, out_w):
        imgs = imgs[:, a:b]
    else:
        y_lo, y_hi, y_frac = (t[a:b] for t in _bilinear_tables(in_h, out_h, align_corners))
        out_h = b - a
        x_lo, x_hi, x_frac = _bilinear_tables(in_w, out_w, align_corners)
        # along W, then along H, as the reference lerps
        left = _take(imgs, x_lo, 2)
        right = _take(imgs, x_hi, 2)
        row = left + (right - left) * _weights(x_frac.reshape(1, 1, out_w, 1), imgs)
        top = _take(row, y_lo, 1)
        bot = _take(row, y_hi, 1)
        imgs = top + (bot - top) * _weights(y_frac.reshape(1, out_h, 1, 1), imgs)
    return imgs[0] if squeeze else imgs


def resize_bilinear_mxu(images: torch.Tensor, size: Sequence[int], align_corners: bool = False,
                        rows=None, in_rows=None):
    """TF1-exact bilinear resize of NHWC as two f32 matrix products.

    The same function as :func:`resize_bilinear`, as contractions with
    constant interpolation matrices (the model's x8 logit upsampler).
    ``rows`` and ``in_rows`` as in the module docstring.
    """
    n, in_h, in_w, c = images.shape
    first, full_h = in_rows or (0, in_h)
    out_h, out_w = int(size[0]), int(size[1])
    a, b = rows or (0, out_h)
    x = images.float()
    if (full_h, in_w) == (out_h, out_w):
        return x[:, a - first:b - first]
    wh = _bilinear_matrix(full_h, out_h, align_corners)
    if wh[a:b, :first].any() or wh[a:b, first + in_h:].any():
        raise ValueError(f"output rows [{a}, {b}) read input rows outside [{first}, "
                         f"{first + in_h})")
    with span("iv.sync.resize_matrix"):
        wh = torch.as_tensor(np.ascontiguousarray(wh[a:b, first:first + in_h]), device=x.device)
    with span("iv.sync.resize_matrix"):
        ww = torch.as_tensor(_bilinear_matrix(in_w, out_w, align_corners), device=x.device)
    # (n, h, w, c) -> (n, c, h, w) @ ww.T -> wh @ . -> (n, out_h, out_w, c)
    x = x.permute(0, 3, 1, 2) @ ww.t()
    return (wh @ x).permute(0, 2, 3, 1)


def _resize_nearest_axes(features, size, align_corners: bool, axis0: int, rows=None,
                         in_rows=None):
    in_h, in_w = features.shape[axis0], features.shape[axis0 + 1]
    first, full_h = in_rows or (0, in_h)
    out_h, out_w = int(size[0]), int(size[1])
    a, b = rows or (0, out_h)
    if (full_h, in_w) == (out_h, out_w):
        return _take(features, np.arange(a - first, b - first), axis0)
    table = _nearest_table(full_h, out_h, align_corners)[a:b] - first
    if table.size and (table.min() < 0 or table.max() >= in_h):
        raise ValueError(f"output rows [{a}, {b}) read input rows outside [{first}, "
                         f"{first + in_h})")
    out = _take(features, table, axis0)
    return _take(out, _nearest_table(in_w, out_w, align_corners), axis0 + 1)


def resize_nearest(features, size: Sequence[int], align_corners: bool = False, rows=None,
                   in_rows=None):
    """TF1 nearest resize; rank >= 3 is N,H,W[,C], rank 2 is H,W. ``rows``
    and ``in_rows`` as in the module docstring."""
    axis0 = 1 if features.ndim >= 3 else 0
    return _resize_nearest_axes(features, size, align_corners, axis0, rows, in_rows)


def _source_rows(in_h: int, out_h: int, a: int, b: int, nearest: bool):
    """The input rows [start, stop) that output rows [a, b) of an
    align_corners resize read."""
    if nearest:
        t = _nearest_table(in_h, out_h, True)[a:b]
        return int(t.min()), int(t.max()) + 1
    lo, hi, _ = _bilinear_tables(in_h, out_h, True)
    return int(lo[a:b].min()), int(hi[a:b].max()) + 1


def resize_band(x: torch.Tensor, size: Sequence[int], mesh, nearest: bool = False):
    """The align_corners resize (bilinear as ``resize_bilinear_mxu``, or
    nearest) of a map split by height over ``mesh``'s spatial group, for
    this rank's band of the output: ``x`` (N, h, W[, C]) is the rank's band
    of a global input of h P rows, and the output rows [i H / P, (i + 1) H
    / P) read input rows that may lie in other bands, which the halo
    exchange brings (the mapping is global: row y reads y (hP - 1) / (H -
    1))."""
    p, index = mesh.spatial, mesh.spatial_index
    full_h, out_band = x.shape[1] * p, int(size[0]) // p
    if int(size[0]) % p:
        raise ValueError(f"output height {size[0]} does not split over {p} ranks")

    def need(q):
        return _source_rows(full_h, int(size[0]), q * out_band, (q + 1) * out_band, nearest)

    rows = (index * out_band, (index + 1) * out_band)
    band = pmesh.gather_rows(x, mesh, need, dim=1)
    in_rows = (need(index)[0], full_h)
    if nearest:
        return resize_nearest(band, size, align_corners=True, rows=rows, in_rows=in_rows)
    return resize_bilinear_mxu(band, size, align_corners=True, rows=rows, in_rows=in_rows)

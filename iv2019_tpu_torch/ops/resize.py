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
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = [
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
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def _weights(frac: np.ndarray, like):
    if isinstance(like, np.ndarray):
        return frac
    return torch.as_tensor(frac, device=like.device)


def _float32(x):
    return x.astype(np.float32) if isinstance(x, np.ndarray) else x.float()


def resize_bilinear(images, size: Sequence[int], align_corners: bool = False):
    """TF1 bilinear resize of NHWC (or HWC) images to ``size``; float32 out."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    _, in_h, in_w, _ = images.shape
    out_h, out_w = int(size[0]), int(size[1])
    imgs = _float32(images)
    if (in_h, in_w) != (out_h, out_w):
        y_lo, y_hi, y_frac = _bilinear_tables(in_h, out_h, align_corners)
        x_lo, x_hi, x_frac = _bilinear_tables(in_w, out_w, align_corners)
        # along W, then along H, as the reference lerps
        left = _take(imgs, x_lo, 2)
        right = _take(imgs, x_hi, 2)
        row = left + (right - left) * _weights(x_frac.reshape(1, 1, out_w, 1), imgs)
        top = _take(row, y_lo, 1)
        bot = _take(row, y_hi, 1)
        imgs = top + (bot - top) * _weights(y_frac.reshape(1, out_h, 1, 1), imgs)
    return imgs[0] if squeeze else imgs


def resize_bilinear_mxu(images: torch.Tensor, size: Sequence[int], align_corners: bool = False):
    """TF1-exact bilinear resize of NHWC as two f32 matrix products.

    The same function as :func:`resize_bilinear`, as contractions with
    constant interpolation matrices (the model's x8 logit upsampler).
    """
    n, in_h, in_w, c = images.shape
    out_h, out_w = int(size[0]), int(size[1])
    x = images.float()
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = torch.as_tensor(_bilinear_matrix(in_h, out_h, align_corners), device=x.device)
    ww = torch.as_tensor(_bilinear_matrix(in_w, out_w, align_corners), device=x.device)
    # (n, h, w, c) -> (n, c, h, w) @ ww.T -> wh @ . -> (n, out_h, out_w, c)
    x = x.permute(0, 3, 1, 2) @ ww.t()
    return (wh @ x).permute(0, 2, 3, 1)


def _resize_nearest_axes(features, size, align_corners: bool, axis0: int):
    in_h, in_w = features.shape[axis0], features.shape[axis0 + 1]
    out_h, out_w = int(size[0]), int(size[1])
    if (in_h, in_w) == (out_h, out_w):
        return features
    out = _take(features, _nearest_table(in_h, out_h, align_corners), axis0)
    return _take(out, _nearest_table(in_w, out_w, align_corners), axis0 + 1)


def resize_nearest(features, size: Sequence[int], align_corners: bool = False):
    """TF1 nearest resize; rank >= 3 is N,H,W[,C], rank 2 is H,W."""
    axis0 = 1 if features.ndim >= 3 else 0
    return _resize_nearest_axes(features, size, align_corners, axis0)

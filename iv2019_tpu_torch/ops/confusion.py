"""Confusion matrix and the metrics derived from it.

Port of iv2019_tpu/ops/confusion.py: the (K, K) matrix of one batch is a
count of ``label * K + prediction`` over the valid pixels, exact in int64,
scattered into a fixed-size vector (invalid pixels into one extra slot), so
that the device never waits on the host for a size.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batch_mean_iou", "confusion_matrix", "mean_iou_from_cm",
           "metrics_from_confusion_matrix"]

_EPSILON = 1e-9


def confusion_matrix(labels: torch.Tensor, predictions: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64; ``cm[i, j]`` counts label i
    predicted as j (``tf.confusion_matrix``). Entries outside
    [0, num_classes) are dropped."""
    labels = labels.reshape(-1).long()
    predictions = predictions.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes) & (predictions >= 0) & (
        predictions < num_classes)
    cells = num_classes * num_classes
    flat = torch.where(valid, labels * num_classes + predictions, cells)
    counts = torch.zeros(cells + 1, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts[:cells].reshape(num_classes, num_classes)


def batch_mean_iou(labels: torch.Tensor, decisions: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Batch mIoU, the online training metric (reference define_metrics.py:5-20):
    the mean over *all* classes of inter / (union + eps), a 0-d f32 tensor."""
    return mean_iou_from_cm(confusion_matrix(labels, decisions, num_classes))


def mean_iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """The ``batch_mean_iou`` formula on a (summed) confusion matrix."""
    cm = cm.float()
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return torch.mean(inter / (union + _EPSILON))


def metrics_from_confusion_matrix(cm) -> dict:
    """Global accuracy, per-class accuracies and IoUs (percent), and their
    nan-masked means (reference utils/utils.py:385-446)."""
    cm = np.asarray(cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        global_accuracy = np.trace(cm) / np.sum(cm) * 100
        accuracies = np.diagonal(cm) / np.sum(cm, 1) * 100
        inter = np.diagonal(cm)
        union = np.sum(cm, 0) + np.sum(cm, 1) - np.diagonal(cm)
        ious = inter / np.where(union > 0, union, np.ones_like(union)) * 100
    notnan_mask = np.logical_not(np.isnan(accuracies))
    return {
        "global_accuracy": float(global_accuracy),
        "accuracies": accuracies,
        "ious": ious,
        "notnan_mask": notnan_mask,
        "mean_accuracy": float(np.mean(accuracies[notnan_mask])),
        "mean_iou": float(np.mean(ious[notnan_mask])),
    }

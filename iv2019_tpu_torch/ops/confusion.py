"""Confusion matrix and the metrics derived from it.

Port of iv2019_tpu/ops/confusion.py: the (K, K) matrix of one batch is a
bincount of ``label * K + prediction`` over the valid pixels, exact in int64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["confusion_matrix", "metrics_from_confusion_matrix"]


def confusion_matrix(labels: torch.Tensor, predictions: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64; ``cm[i, j]`` counts label i
    predicted as j (``tf.confusion_matrix``). Entries outside
    [0, num_classes) are dropped."""
    labels = labels.reshape(-1).long()
    predictions = predictions.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes) & (predictions >= 0) & (
        predictions < num_classes)
    flat = (labels * num_classes + predictions)[valid]
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


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

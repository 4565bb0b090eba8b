"""Formatted confusion-matrix report (port of iv2019_tpu/utils/metrics.py,
reference utils/utils.py:385-446 layout)."""

from __future__ import annotations

from typing import Optional, Sequence, TextIO

import numpy as np

from iv2019_tpu_torch.ops.confusion import metrics_from_confusion_matrix

__all__ = ["metrics_from_confusion_matrix", "print_metrics_from_confusion_matrix"]


def print_metrics_from_confusion_matrix(
    cm: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    printfile: Optional[TextIO] = None,
    printcmd: bool = False,
    summary: bool = False,
) -> dict:
    """Compute and report metrics; returns the metrics dict."""
    cm = np.asarray(cm)
    if cm.ndim != 2 or cm.shape[0] != cm.shape[1]:
        raise ValueError("confusion matrix must be square")
    if not labels:
        labels = ["unknown"] * cm.shape[0]
    if len(labels) != cm.shape[0]:
        raise ValueError(
            f"labels ({len(labels)}) must index the confusion matrix ({cm.shape[0]}).")

    m = metrics_from_confusion_matrix(cm)
    accuracies, ious, mask = m["accuracies"], m["ious"], m["notnan_mask"]

    log_string = "\n"
    log_string += f"Global accuracy: {m['global_accuracy']:5.2f}\n"
    log_string += (
        "Per class accuracies (nans due to 0 #Trues) and ious (nans due to 0 #TPs):\n"
    )
    for label, acc, iou, ok in zip(labels, accuracies, ious, mask):
        log_string += (
            f"{label:<30s}  {acc:>5.2f}  {iou:>5.2f}  "
            f"{'' if ok else '(ignored in averages)'}\n"
        )
    log_string += f"Mean accuracy (ignoring nans): {m['mean_accuracy']:5.2f}\n"
    log_string += (
        f"Mean iou (ignoring accuracies' nans but including ious' 0s): "
        f"{m['mean_iou']:5.2f}\n"
    )

    if printcmd:
        print(log_string)
    if printfile:
        if summary:
            printfile.write(log_string)
        else:
            print(
                f"{m['global_accuracy']:>5.2f}",
                f"{m['mean_accuracy']:>5.2f}",
                f"{m['mean_iou']:>5.2f}",
                accuracies,
                ious,
                file=printfile,
            )
    return m

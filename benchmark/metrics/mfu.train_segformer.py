"""mfu.train_segformer: a ``segformer_*`` training window's share of the
chip's bf16 peak.

The operations of one training image, every linear and conv three times
(the first patch embedding twice) and the attention products forward and
backward (``benchmark/counts_segformer.py::train_flops``), times the images
the window's steps took, over the window's seconds and the data sheet's
989 TFLOP/s. Moves ``train_img_per_s``.
"""

from benchmark import counts, counts_segformer


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "train" or "embed_dims" not in run.config or peaks is None:
        return None
    ops = counts_segformer.train_flops(run.config, run.mix["height"], run.mix["width"])
    return 100.0 * ops * run.images / run.window_s / peaks["bf16"]

"""mfu.infer: the evaluation window's share of the chip's bf16 peak.

The model's convolutions a forward of one image, counted by
``benchmark/counts.py`` from the configuration, times the images the
window's steps took, over the window's seconds and the data sheet's 989
TFLOP/s. Moves ``infer_img_per_s``.
"""

from benchmark import counts


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "infer" or peaks is None:
        return None
    ops = counts.model_flops(run.config, run.mix["height"], run.mix["width"], train=False)
    return 100.0 * ops * run.images / run.window_s / peaks["bf16"]

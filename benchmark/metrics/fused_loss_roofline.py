"""fused_loss_roofline: kernels B1 and B2 (the fused hierarchical loss),
least time over device time, in a training step.

The least time is one B1 and one B2 call a step at the cell's shapes (the
three heads' stride-8 logits, the per-pixel and weak labels at full size),
each the larger of its bytes over 3.35 TB/s and its f32 operations over 67
TFLOP/s (``benchmark/counts.py::loss_counts``). The device time is the
profiled steps' ``fwd_walk_kernel`` with its ``sum_partials`` and
``bwd_walk_kernel``. Moves ``train_img_per_s``.
"""

from benchmark import counts
from benchmark.reference.model import stride8_size

NAMES = ("fwd_walk_kernel", "bwd_walk_kernel", "sum_partials(float")


def match(name: str) -> bool:
    return any(key in name for key in NAMES)


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "train" or run.trace is None or peaks is None:
        return None
    device_s = run.trace.device_ms(match) / 1e3
    if device_s <= 0:
        return None
    h, w = run.mix["height"], run.mix["width"]
    n_pp = run.mix["per_pixel"]
    n_weak = run.mix["per_bbox"] + run.mix["per_image"]
    c = counts.loss_counts(n_pp, n_weak, stride8_size(h, w), (h, w), run.config["heads"])
    least = sum(counts.bound_s(b, ops, peaks["f32"], peaks["bytes"]) for b, ops in c.values())
    return 100.0 * least * run.trace.steps / device_s

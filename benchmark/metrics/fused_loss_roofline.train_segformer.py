"""fused_loss_roofline.train_segformer: kernels B1 and B2 (the fused
hierarchical loss) in a ``segformer_*`` training step, least time over
device time.

As ``fused_loss_roofline``, at stride 4: one B1 and one B2 call a step from
the three heads' stride-4 logits (the first patch embedding's map,
``counts_segformer.stage_sizes``) to the labels at full size, each the
larger of its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(``benchmark/counts.py::loss_counts``); the device time is the profiled
steps' ``fwd_walk_kernel`` with its ``sum_partials`` and
``bwd_walk_kernel``. Moves ``train_img_per_s``.
"""

from benchmark import counts, counts_segformer

NAMES = ("fwd_walk_kernel", "bwd_walk_kernel", "sum_partials(float")


def match(name: str) -> bool:
    return any(key in name for key in NAMES)


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "train" or run.trace is None or peaks is None \
            or "embed_dims" not in run.config:
        return None
    device_s = run.trace.device_ms(match) / 1e3
    if device_s <= 0:
        return None
    h, w = run.mix["height"], run.mix["width"]
    n_pp = run.mix["per_pixel"]
    n_weak = run.mix["per_bbox"] + run.mix["per_image"]
    in_hw = counts_segformer.stage_sizes(run.config, h, w)[0]
    c = counts.loss_counts(n_pp, n_weak, in_hw, (h, w), run.config["heads"])
    least = sum(counts.bound_s(b, ops, peaks["f32"], peaks["bytes"]) for b, ops in c.values())
    return 100.0 * least * run.trace.steps / device_s

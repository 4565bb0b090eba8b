"""fused_bottleneck_roofline: kernels B4 and B5 (the fused bottleneck
units), least time over device time, in an evaluation step.

The least time sums, over the units one step runs fused (the
``iv2019::fused_bottleneck`` and ``iv2019::fused_bottleneck_ct`` operators
of a step profiled with input shapes), the larger of each unit's bytes over
3.35 TB/s and its bf16 operations over 989 TFLOP/s
(``benchmark/counts.py::unit_counts``). The device time is the profiled
steps' ``conv1_kernel`` and ``conv23_kernel``. Moves ``infer_img_per_s``.
"""

from benchmark import counts

OPS = ("iv2019::fused_bottleneck", "iv2019::fused_bottleneck_ct")
KERNELS = ("conv1_kernel", "conv23_kernel")


def match(name: str) -> bool:
    return any(key in name for key in KERNELS)


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "infer" or run.trace is None or run.shape_trace is None or peaks is None:
        return None
    device_s = run.trace.device_ms(match) / 1e3
    units = [h for op in OPS for h in run.shape_trace.host_ops(op)]
    if device_s <= 0 or not units:
        return None
    least = 0.0
    for _, _, _, args in units:
        (n, h, w, c), (_, m) = args["Input Dims"][0], args["Input Dims"][1]
        nbytes, ops = counts.unit_counts(n, h, w, c, m)
        least += counts.bound_s(nbytes, ops, peaks["bf16"], peaks["bytes"])
    return 100.0 * least / run.shape_trace.steps * run.trace.steps / device_s

"""copy_ms.train: device milliseconds a training step in dtype conversions
and layout copies.

The profiled steps' device events whose names hold one of ``NAMES``: the
element-wise copy kernels that casts and ``contiguous`` run
(``direct_copy_kernel``), concatenation's batched copies, cuDNN's layout
transposes and device-to-device memcpys, summed and divided by the steps.
Moves ``train_img_per_s``.
"""

NAMES = ("copy_kernel", "catarraybatchedcopy", "nchwtonhwc", "nhwctonchw", "memcpy dtod")


def match(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in NAMES)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = run.trace.device_ms(match)
    return ms / run.trace.steps if ms > 0 else None

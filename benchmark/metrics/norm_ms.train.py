"""norm_ms.train: device milliseconds a training step in batch norm.

The profiled steps' kernels whose names hold one of ``NAMES``: cuDNN's and
ATen's batch-norm forward and backward (statistics, transform, backward
reduce and element kernels) and the program's N1/N2 (``bn_fwd_kernel``,
``bn_bwd_kernel``), summed and divided by the steps. Moves
``train_img_per_s``.
"""

NAMES = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_fwd_kernel", "bn_bwd_kernel")


def match(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in NAMES)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = run.trace.device_ms(match)
    return ms / run.trace.steps if ms > 0 else None

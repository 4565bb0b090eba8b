"""attn_ms.train_segformer: device milliseconds a training step in the
attention kernels: the profiled steps' FlashAttention forward and backward
kernels (``flash_fwd``, ``flash_bwd``: the scores, the softmax and the
products fused) and the memory-efficient ones (``fmha_cutlass``), summed
and divided by the steps. Moves ``train_img_per_s``.
"""

NAMES = ("flash_fwd", "flash_bwd", "fmha_cutlass")


def match(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in NAMES)


def read(run):
    if run.kind != "train" or run.trace is None or "embed_dims" not in run.config:
        return None
    ms = run.trace.device_ms(match)
    return ms / run.trace.steps if ms > 0 else None

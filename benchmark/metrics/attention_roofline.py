"""attention_roofline: the attention kernels of a ``segformer_*`` training
step, least time over device time.

The least time is each image's attention forward and backward at the
cell's shapes, each the larger of its bytes over 3.35 TB/s and its
operations over 989 TFLOP/s (``benchmark/counts_segformer.py``:
``attention_flops``, ``attention_bytes``), times the step's images. The
device time is the profiled steps' kernels that ``attn_ms.train_segformer``
reads. Moves ``train_img_per_s``.
"""

from benchmark import counts, counts_segformer

# the kernels attn_ms.train_segformer reads
NAMES = ("flash_fwd", "flash_bwd", "fmha_cutlass")


def match(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in NAMES)


def read(run):
    peaks = counts.peaks(run.device_name)
    if run.kind != "train" or run.trace is None or peaks is None \
            or "embed_dims" not in run.config:
        return None
    device_s = run.trace.device_ms(match) / 1e3
    if device_s <= 0:
        return None
    h, w = run.mix["height"], run.mix["width"]
    images = run.mix["per_pixel"] + run.mix["per_bbox"] + run.mix["per_image"]
    ops = counts_segformer.attention_flops(run.config, h, w)
    nbytes = counts_segformer.attention_bytes(run.config, h, w)
    least = images * sum(counts.bound_s(b, o, peaks["bf16"], peaks["bytes"])
                         for b, o in zip(nbytes, ops))
    return 100.0 * least * run.trace.steps / device_s

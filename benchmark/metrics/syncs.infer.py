"""syncs.infer: host-device crossings an evaluation step: the program's
``iv.sync.*`` spans (each one synchronous copy to the card or one read that
waits on it, ``iv2019_tpu_torch/utils/spans.py``) in the profiled steps,
over the steps (``benchmark/spans.py``). Moves ``infer_img_per_s``.
"""

from benchmark import spans


def read(run):
    return spans.syncs(run, "infer")

"""syncs.train: host-device crossings a training step: the program's
``iv.sync.*`` spans (each one synchronous copy to the card or one read that
waits on it, ``iv2019_tpu_torch/utils/spans.py``) in the profiled steps,
over the steps (``benchmark/spans.py``). Moves ``train_img_per_s``.
"""

from benchmark import spans


def read(run):
    return spans.syncs(run, "train")

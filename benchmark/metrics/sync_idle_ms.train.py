"""sync_idle_ms.train: device idle milliseconds a training step in the gaps
that begin inside an ``iv.sync.*`` span, where the host was copying to the
card or waiting on it (``benchmark/spans.py``). Moves ``train_img_per_s``.
"""

from benchmark import spans


def read(run):
    idle = spans.idle_ms(run, "train")
    return None if idle is None else idle["sync"]

"""enqueue_idle_ms.train: device idle milliseconds a training step in the
gaps that begin inside ``iv.train_step`` and inside no ``iv.sync.*`` span:
the card waiting for the host to enqueue work (``benchmark/spans.py``).
Moves ``train_img_per_s``.
"""

from benchmark import spans


def read(run):
    idle = spans.idle_ms(run, "train")
    return None if idle is None else idle["enqueue"]

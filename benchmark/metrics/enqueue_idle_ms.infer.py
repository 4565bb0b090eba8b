"""enqueue_idle_ms.infer: device idle milliseconds an evaluation step in the
gaps that begin inside ``iv.eval_step`` and inside no ``iv.sync.*`` span:
the card waiting for the host to enqueue work (``benchmark/spans.py``).
Moves ``infer_img_per_s``.
"""

from benchmark import spans


def read(run):
    idle = spans.idle_ms(run, "infer")
    return None if idle is None else idle["enqueue"]

"""idle_share.infer: the share of the profiled evaluation steps' window in
which no device event ran: 1 - (union of kernel, copy and set intervals)
over (last event's end - first event's start). Moves ``infer_img_per_s``.
"""


def read(run):
    if run.kind != "infer" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

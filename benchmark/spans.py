"""The program's own spans in a ``trace.Trace``: its host-device crossings a
step, and the device's idle time put down to where each gap began.

The port marks each step call (``iv.train_step``, ``iv.eval_step``) and each
place where the host waits on the card or copies host memory to it
synchronously (``iv.sync.<site>``) with ``torch.profiler.record_function``
(``iv2019_tpu_torch/utils/spans.py``); the capture keeps them in
``Trace.host`` as ``user_annotation`` events, on the device events' clock.
Each idle gap between the device events' union (the idle time that
``idle_share`` counts) goes by the time it begins, whatever the thread (the
backward pass runs on the autograd engine's own thread):

- ``sync``: inside an ``iv.sync.*`` span: the host was copying or waiting;
- ``enqueue``: inside the step's span and no ``iv.sync.*`` span: the card
  waited for the host to enqueue work;
- ``outside``: inside no step span (between the benchmark's step calls).

The three add up to the traced window less its busy time. A trace without
the kind's step span (a program without spans) reads None.

The attribution compares device times with host times, so it needs the
capture's two clocks to agree; the device clock was seen to drift against
the host's by up to milliseconds within a one-second capture. Each
pageable host-to-card copy of the program is made inside its ``iv.sync.*``
span, which waits for it, one copy a span, so the copies show the drift:
where one lies outside every sync span, the device events are moved onto
the host's clock by the line that ends each copy inside its span (the
clocks' offset and rate fitted by least squares to the copies' ends, then
lowered until no copy ends after its span). Where the copies and spans differ in number,
or no such line puts every copy inside its span, ``idle_ms`` reads None
rather than a mislaid split. ``syncs`` counts host spans alone.
"""

from __future__ import annotations

import bisect

__all__ = ["HTOD", "SYNC", "STEP", "clock_line", "idle_ms", "syncs"]

HTOD = "Memcpy HtoD (Pageable -> Device)"
SYNC = "iv.sync."
STEP = {"train": "iv.train_step", "infer": "iv.eval_step"}


class _Union:
    """The union of (start, end) intervals (touching intervals merge, as
    ``Trace`` merges the device events), and whether it holds a time or an
    interval."""

    def __init__(self, intervals):
        self.spans = []
        for a, b in sorted(intervals):
            if self.spans and a <= self.spans[-1][1]:
                self.spans[-1][1] = max(self.spans[-1][1], b)
            else:
                self.spans.append([a, b])
        self.starts = [a for a, _ in self.spans]

    def holds(self, t: float, end: float | None = None) -> bool:
        """Whether one interval of the union holds [t, end] (t alone by
        default), its ends included."""
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1] and (end is None or end <= self.spans[i][1])


def _intervals(trace, match) -> list:
    return [(ts, ts + dur) for name, ts, dur, _ in trace.host if match(name)]


def _steps(run, kind: str):
    """The profiled steps' span intervals, or None where there are none."""
    if run.kind != kind or run.trace is None:
        return None
    return _intervals(run.trace, lambda name: name == STEP[kind]) or None


def syncs(run, kind: str):
    """``iv.sync.*`` spans a profiled step of ``kind``, or None."""
    if _steps(run, kind) is None:
        return None
    return len(_intervals(run.trace, lambda name: name.startswith(SYNC))) / run.trace.steps


def clock_line(trace, sync_spans: list):
    """(t0, offset, rate): the device time ``t`` on the host's clock is
    ``t + offset + rate * (t - t0)``, the line that puts the k-th pageable
    host-to-card copy inside the k-th ``iv.sync.*`` span of ``sync_spans``;
    (t0, 0, 0) where every copy lies in one already; None where none does."""
    copies = [(ts, ts + dur) for name, ts, dur in trace.device if name == HTOD]
    in_sync = _Union(sync_spans)
    if all(in_sync.holds(a, b) for a, b in copies):
        return 0.0, 0.0, 0.0
    spans = sorted(sync_spans)
    if len(copies) != len(spans) or len(copies) < 2:
        return None
    t0 = copies[0][1]
    xs = [b - t0 for _, b in copies]
    ys = [end - b for (_, b), (_, end) in zip(copies, spans)]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    rate = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    offset = min(y - rate * x for x, y in zip(xs, ys))
    moved = [(a + offset + rate * (a - t0), b + offset + rate * (b - t0)) for a, b in copies]
    if not all(start <= a and b <= end for (a, b), (start, end) in zip(moved, spans)):
        return None
    return t0, offset, rate


def idle_ms(run, kind: str):
    """{"sync", "enqueue", "outside"}: device idle ms a profiled step of
    ``kind`` by where each gap began; None without step spans, or where no
    clock line puts the copies inside their sync spans."""
    steps = _steps(run, kind)
    if steps is None:
        return None
    trace = run.trace
    sync_spans = _intervals(trace, lambda name: name.startswith(SYNC))
    line = clock_line(trace, sync_spans)
    if line is None:
        return None
    t0, offset, rate = line
    busy = trace._union if (offset, rate) == (0.0, 0.0) else _Union(
        (ts + offset + rate * (ts - t0), ts + dur + offset + rate * (ts + dur - t0))
        for _, ts, dur in trace.device).spans
    in_sync, in_step = _Union(sync_spans), _Union(steps)
    us = {"sync": 0.0, "enqueue": 0.0, "outside": 0.0}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        where = "sync" if in_sync.holds(end) else "enqueue" if in_step.holds(end) else "outside"
        us[where] += start - end
    return {k: v / 1e3 / trace.steps for k, v in us.items()}

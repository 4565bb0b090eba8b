"""Device time from a ``torch.profiler`` trace of a few steady steps.

``capture`` runs steps under the profiler (CPU and CUDA activities),
exports the Chrome trace to a temporary file, reads it back and deletes
it. ``Trace`` holds the device events (kernels, copies, sets) and the host
ops, and derives:

- the traced window: from the first device event's start to the last one's
  end, the device queue being empty when the capture starts;
- busy time: the union of the device events' intervals, so that work on
  two streams at once counts once;
- idle gaps between them, each named by the innermost host op running at
  its start ("what the host was doing");
- device time by name, summed over events, for the per-layer readers.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

__all__ = ["DEVICE_CATEGORIES", "Trace", "capture"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Events of one capture (Chrome-trace dicts, times in microseconds)."""

    def __init__(self, events: list, steps: int):
        self.steps = steps
        self.device = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                              for e in events if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda d: d[1])
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("args", {}))
                     for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
        self._union = self._merge()

    def _merge(self) -> list:
        spans = []
        for _, ts, dur in self.device:
            if spans and ts <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], ts + dur)
            else:
                spans.append([ts, ts + dur])
        return spans

    @property
    def window_s(self) -> float:
        if not self._union:
            return 0.0
        return (self._union[-1][1] - self._union[0][0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union) / 1e6

    def device_ms(self, match) -> float:
        """Summed device time (ms) of the events whose name ``match`` takes."""
        return sum(dur for name, _, dur in self.device if match(name)) / 1e3

    def top_device_ops(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for name, _, dur in self.device:
            by_name[name[:120]] += dur / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between device events, summed by the host op that
        was running (innermost) when each gap began; the longest ``n``."""
        by_host = defaultdict(float)
        ops = sorted(self.host, key=lambda h: h[1])
        i, running = 0, []
        for (_, end), (start, _) in zip(self._union, self._union[1:]):
            while i < len(ops) and ops[i][1] <= end:
                running.append(ops[i])
                i += 1
            running = [h for h in running if h[1] + h[2] > end]
            name = max(running, key=lambda h: h[1])[0][:120] if running else "(no host op)"
            by_host[name] += (start - end) / 1e6
        return sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:n]

    def host_ops(self, name: str) -> list:
        """The host ops called ``name``, with their arguments (input shapes
        under ``Input Dims`` when the capture records shapes)."""
        return [h for h in self.host if h[0] == name]


def capture(run_steps, steps: int, record_shapes: bool = False) -> Trace:
    """Profile ``run_steps(steps)``; the device is synchronized before and
    after, so the trace holds exactly those steps' device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        run_steps(steps)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, steps)

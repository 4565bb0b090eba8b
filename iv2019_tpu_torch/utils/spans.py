"""Named spans on the profiler's timeline, free when no profiler records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` capture is recording, and one shared no-op context
otherwise: the cost when off is one read of the profiler's flag, with no
``record_function`` made (it costs microseconds a call even with no
profiler). Nothing is kept and nothing is set: the spans land in whatever
capture is running (the training loop's ``profile_every`` trace, a
benchmark's), on the clock of its device events. ``torch.export`` traces
with the flag down, so an exported program holds no span.

The names the program uses:

- ``iv.train_step``, ``iv.eval_step``: one step call (train/step.py);
- ``iv.train.<phase>`` (``assemble``, ``forward``, ``backward``, ``update``,
  ``metrics``) and ``iv.eval.<phase>`` (``forward``, ``decide``,
  ``resize``, ``confusion``): the step's phases, inside its step span;
- ``iv.sync.<site>``: one place where the host waits on the device or
  copies host memory to it synchronously, around that one copy or read, in
  the helper that makes it. Their count a step is the program's count of
  host-device crossings.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["OFF", "copy_span", "span"]

OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler records; else OFF."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return OFF


def copy_span(name: str, value, device: torch.device):
    """``span(name)`` around moving ``value`` to ``device``; OFF where it is
    a tensor on that device already, which crosses nothing."""
    if isinstance(value, torch.Tensor) and value.device == device:
        return OFF
    return span(name)

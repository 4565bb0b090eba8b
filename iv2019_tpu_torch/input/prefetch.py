"""Host -> device batch prefetcher with double buffering.

Port of iv2019_tpu/input/prefetch.py. A producer thread drains the host
pipeline and copies each batch's numpy arrays to the device ahead of the
consumer, so the copy of step N+1 overlaps the compute of step N. Across
ranks the device is the rank's and the batch its batch shard's rows, which
no one splits further by rows: JAX's check that a process's rows divide by
its devices (prefetch.py:46-60) has nothing to check with one device a
process. Under spatial partitioning the images stay whole here; the train
and eval steps take the rank's band of rows on the device.

For a CUDA device the producer copies each array into pinned host memory
and issues a ``non_blocking`` copy on a side stream, then records an event
there. The consumer's stream waits on that event before the batch is
handed out, and every device tensor is marked with ``record_stream`` on the
consumer's stream, so the caching allocator does not reuse its memory while
work queued on that stream may still read it. A pinned buffer is released
when its copy is issued; PyTorch's pinned-memory allocator records the copy
on the side stream and reuses the buffer only after it finished. For a CPU
device the producer only turns the arrays into tensors. Values that are not
numpy arrays (ids, paths) pass through.

Closing the generator (or breaking out of the loop) stops the producer
thread and waits for it, so no copy races interpreter teardown.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["device_prefetch"]

_SENTINEL = object()


def _to_device(batch: dict, device: torch.device, stream) -> tuple[dict, object]:
    """(batch with device tensors, the event the consumer waits on or None)."""
    if stream is None:
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}, None
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                pinned = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = pinned.to(device, non_blocking=True)
            else:
                out[k] = v
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def device_prefetch(it: Iterator[dict], device, depth: int = 2) -> Iterator[dict]:
    """Wrap a host batch iterator with a background copy to ``device``,
    ``depth`` batches ahead."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def _producer():
        try:
            for batch in it:
                if stop.is_set():
                    return
                q.put(_to_device(batch, device, stream))
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=_producer, daemon=True, name="input-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        # unblock a producer stuck in q.put, then wait until no copy can be in flight
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.2)
        if stream is not None:
            stream.synchronize()

"""Label-space projection ops: channel segment sums and class-id gathers.

Port of iv2019_tpu/ops/segment_ops.py (the reference's
``tf.unsorted_segment_sum`` / ``tf.gather`` uses).

The tables (a class-id table, a 0/1 projection matrix) go to the device
once per table and device and are kept there (``_device_table``), so that
a step does not wait on the card for a copy of a few bytes: a copy from
pageable host memory waits for all the work queued before it. Under
``torch.export`` they are made afresh, as constants of the traced program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from iv2019_tpu_torch.utils.spans import span

__all__ = [
    "gather_cids",
    "projection_matrix",
    "remap_probabilities",
    "segment_sum_channels",
]


def projection_matrix(segment_ids, num_segments: int, dtype=np.float32) -> np.ndarray:
    """(Cin, Cout) 0/1 matrix M with M[i, segment_ids[i]] = 1."""
    segment_ids = np.asarray(segment_ids)
    m = np.zeros((len(segment_ids), num_segments), dtype=dtype)
    m[np.arange(len(segment_ids)), segment_ids] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _cached_table(data: bytes, dtype: str, shape: tuple, device: str, site: str):
    """A table's copy on the device, made in the ``iv.sync.<site>`` span on
    its first use only: a plain tensor, usable in and out of inference
    mode."""
    values = np.frombuffer(data, dtype=dtype).reshape(shape)
    with span(f"iv.sync.{site}"), torch.inference_mode(False):
        return torch.tensor(values, device=device)


def _device_table(values: np.ndarray, device: torch.device, site: str) -> torch.Tensor:
    """``values`` on ``device``, from the cache; afresh under ``torch.export``."""
    if torch.compiler.is_exporting():
        with span(f"iv.sync.{site}"):
            return torch.as_tensor(values, device=device)
    return _cached_table(values.tobytes(), values.dtype.str, values.shape, str(device), site)


def segment_sum_channels(labels: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """Sum the last-axis channels of ``labels`` into ``num_segments`` (f32)."""
    proj = _device_table(projection_matrix(segment_ids, num_segments), labels.device,
                         "segment_sum_channels")
    return labels.float() @ proj


def remap_probabilities(probs: torch.Tensor, old_cids2new_cids) -> torch.Tensor:
    """Sum probability channels mapped to the same new cid (voids replaced)."""
    table = np.asarray(old_cids2new_cids)
    return segment_sum_channels(probs, table, int(table.max()) + 1)


def gather_cids(table, cids: torch.Tensor) -> torch.Tensor:
    """out[...] = table[cids[...]] as int32; out-of-range indices clamp."""
    t = _device_table(np.asarray(table, dtype=np.int32), cids.device, "gather_cids")
    return t[cids.long().clamp(0, len(t) - 1)]

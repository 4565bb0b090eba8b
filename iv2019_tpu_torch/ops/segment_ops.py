"""Label-space projection ops: channel segment sums and class-id gathers.

Port of iv2019_tpu/ops/segment_ops.py (the reference's
``tf.unsorted_segment_sum`` / ``tf.gather`` uses).
"""

from __future__ import annotations

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


def segment_sum_channels(labels: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """Sum the last-axis channels of ``labels`` into ``num_segments`` (f32)."""
    with span("iv.sync.segment_sum_channels"):
        proj = torch.as_tensor(projection_matrix(segment_ids, num_segments), device=labels.device)
    return labels.float() @ proj


def remap_probabilities(probs: torch.Tensor, old_cids2new_cids) -> torch.Tensor:
    """Sum probability channels mapped to the same new cid (voids replaced)."""
    table = np.asarray(old_cids2new_cids)
    return segment_sum_channels(probs, table, int(table.max()) + 1)


def gather_cids(table, cids: torch.Tensor) -> torch.Tensor:
    """out[...] = table[cids[...]] as int32; out-of-range indices clamp."""
    with span("iv.sync.gather_cids"):
        t = torch.as_tensor(np.asarray(table, dtype=np.int32), device=cids.device)
    return t[cids.long().clamp(0, len(t) - 1)]

"""The ranks of a data-parallel run, their rows of the batch, and the two
collectives the port uses.

Port of iv2019_tpu/parallel/mesh.py. The JAX package lays one ``Mesh`` over
the chips and shards the batch on its ``data`` axis; XLA then inserts the
gradient all-reduce and makes BatchNorm statistics global by construction.
Here every device is driven by a rank of its own (``torch.distributed``),
and the collectives are written out where JAX gets them implicitly:

- BatchNorm in train mode all-reduces its per-channel sums
  (models/layers.py);
- the losses all-reduce their sums and counts before they normalize
  (ops/fused_loss.py, losses/hierarchical.py);
- the train step all-reduces the gradient once, and the batch confusion
  matrix (train/step.py).

Only ``all_reduce`` (a sum) and ``broadcast`` are used: the two collectives
gloo also runs on CUDA tensors, so two gloo ranks can share one card.

The per-type row split keeps the reference's per-tower contract
(``get_temp_Nb``; iv2019_tpu/parallel/mesh.py:124-158): each rank gets rows
``[r n / W, (r + 1) n / W)`` of *each* sub-batch ([per_pixel | per_bbox |
per_image]). With ``grad_accum_steps`` A the JAX step cuts the global batch
into A microbatches and shards each over the ranks; a rank's rows are then
its share of each microbatch in turn (``shard_rows``).

``num_slices`` (the outer ``replica`` axis of JAX's mesh) only checks the
layout: the port all-reduces over all ranks at once, which is the same sum.
``spatial_partitions`` (image height split over chips, with halo exchanges
in every convolution) is not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "active",
    "all_reduce",
    "barrier",
    "broadcast",
    "collective_stats",
    "create_mesh",
    "global_sum",
    "host_flag_any",
    "local_batch_size",
    "norm_mesh",
    "replicate",
    "reset_collective_stats",
    "set_active",
    "shard_rows",
    "unsynced_norms",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The rank of this process among ``world`` ranks.

    ``local_rank`` indexes the rank among the ``local_size`` ranks of its
    host, and its device there; a host is one launch of an entry point,
    which starts ``num_devices`` ranks (``host``, ``num_hosts``).
    ``cpu_group`` is the process group of host-side flags and barriers
    (None: the default group, when it is gloo's).
    """

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_size: int = 1
    device: torch.device = torch.device("cpu")
    cpu_group: Any = None

    @property
    def host(self) -> int:
        return self.rank // self.local_size

    @property
    def num_hosts(self) -> int:
        return self.world // self.local_size


def create_mesh(world: int = 1, rank: int = 0, *, local_rank: int = 0, local_size: int = 1,
                device="cpu", num_slices: int = 1, spatial_partitions: int = 1,
                cpu_group=None) -> Mesh:
    """The mesh of rank ``rank`` among ``world`` ranks, with the layout
    checks of the JAX package's ``create_mesh`` (:79-84)."""
    n = world
    if num_slices * spatial_partitions > n or n % (num_slices * spatial_partitions):
        raise ValueError(
            f"{n} devices not divisible into {num_slices} slices x "
            f"{spatial_partitions} spatial partitions.")
    if spatial_partitions > 1:
        raise NotImplementedError("spatial_partitions > 1 is not ported to the PyTorch package "
                                  "yet (ROADMAP.md queue A)")
    if not 0 <= rank < world or local_size < 1 or world % local_size:
        raise ValueError(f"rank {rank} of {world} ranks in hosts of {local_size}")
    return Mesh(world=world, rank=rank, local_rank=local_rank, local_size=local_size,
                device=torch.device(device), cpu_group=cpu_group)


def local_batch_size(global_nb: int, mesh: Mesh) -> int:
    """get_temp_Nb parity: the per-rank batch; the global one must divide."""
    div, mod = divmod(global_nb, mesh.world)
    if mod:
        raise ValueError(f"batch size {global_nb} not divisible by {mesh.world} batch shards.")
    return div


def shard_rows(x, index: int, count: int, accum: int = 1):
    """Rows of shard ``index`` of ``count`` of the leading axis of ``x`` (an
    array, tensor or list): with ``accum`` microbatches, its share of each
    microbatch, microbatch by microbatch."""
    n = len(x)
    if n % (accum * count):
        raise ValueError(f"batch size {n} not divisible by {accum} microbatches x {count} "
                         "batch shards.")
    size, share = n // accum, n // (accum * count)
    starts = [i * size + index * share for i in range(accum)]
    if isinstance(x, list):
        return [v for s in starts for v in x[s:s + share]]
    parts = [x[s:s + share] for s in starts]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)


# --------------------------------------------------------------- the active mesh

_active: Optional[Mesh] = None
_norms_synced = True


def set_active(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the run's mesh (multihost.initialize does)."""
    global _active
    _active = mesh


def active() -> Optional[Mesh]:
    """The run's mesh, None in a run of one process without a process group."""
    return _active


def norm_mesh() -> Optional[Mesh]:
    """The mesh train-mode BatchNorm reduces over: the active one when it has
    more than one rank (at one rank the single-device path runs as it is)."""
    if _norms_synced and _active is not None and _active.world > 1:
        return _active
    return None


@contextlib.contextmanager
def unsynced_norms():
    """BatchNorm on this rank's rows alone, for a forward that one rank runs
    by itself (the image summaries of train/loop.py)."""
    global _norms_synced
    saved, _norms_synced = _norms_synced, False
    try:
        yield
    finally:
        _norms_synced = saved


# ------------------------------------------------------------------ collectives

_stats = {"all_reduce": 0, "broadcast": 0, "bytes": 0}


def reset_collective_stats() -> None:
    _stats.update(all_reduce=0, broadcast=0, bytes=0)


def collective_stats() -> dict:
    """The collectives issued since the last reset, and their bytes."""
    return dict(_stats)


def _count(kind: str, t: torch.Tensor) -> None:
    _stats[kind] += 1
    _stats["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    _count("all_reduce", t)
    dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns it."""
    _count("broadcast", t)
    dist.broadcast(t, src)
    return t


def barrier(mesh: Mesh) -> None:
    """Wait for every rank, on the host (no device work)."""
    dist.barrier(group=mesh.cpu_group)


def host_flag_any(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` is set on any rank, through the host group."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=mesh.cpu_group)
    return bool(t.item())


def replicate(tensors, mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place."""
    with torch.no_grad():
        for t in tensors:
            broadcast(t, mesh)


class _GlobalSum(torch.autograd.Function):
    """The sum over ranks of ``x``, whose gradient reaches only the local
    ``x``: each rank differentiates its own part of a global loss, and the
    gradient all-reduce of the step adds the parts. (The backward of
    ``torch.distributed.nn.all_reduce`` sums the gradient over the ranks as
    well, which would count it ``world`` times.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks; the gradient flows to this rank's ``x``."""
    return _GlobalSum.apply(x, mesh)

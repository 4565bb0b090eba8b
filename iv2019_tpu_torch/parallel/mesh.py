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

``spatial_partitions`` P > 1 (JAX's ``spatial`` axis,
iv2019_tpu/parallel/mesh.py:24-31) splits image height over the P ranks of
a *spatial group*. The ranks are laid out
(replica?, data, spatial) with spatial the fastest axis, so a group is P
adjacent ranks: ``data_index`` = rank // P names the batch shard, and
``spatial_index`` = rank % P the band of rows, ``[i H / P, (i + 1) H / P)``
of every image and label (``shard_height``; H must divide by 8 P, so that
the band of every stride-s map of the trunk starts on a multiple of 8 / s).
Where XLA inserts the halo exchanges of each op with a spatial extent, the
port calls ``halo``: rows ``[s - lo, s)`` and ``[e, e + hi)`` of the global
map, from whichever ranks hold them, as one all-reduce over the spatial
group of a buffer indexed by the rows each rank asks for (gloo runs no
send/recv on CUDA tensors; every rank writes the rows it owns, zeros
elsewhere, so the sum is the rows). Its backward sends the halo's gradient
back and adds it into the owners' rows. Statistics over an image's rows
(group norm, PSP's pooled bins) are summed over the spatial group with
``spatial_sum``; BatchNorm and the losses already sum over every rank,
which holds each pixel once.
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
    "alone",
    "barrier",
    "broadcast",
    "collective_stats",
    "create_mesh",
    "gather_rows",
    "global_sum",
    "halo",
    "host_flag_any",
    "local_batch_size",
    "norm_mesh",
    "replicate",
    "reset_collective_stats",
    "set_active",
    "shard_height",
    "shard_rows",
    "spatial_groups",
    "spatial_mesh",
    "spatial_sum",
    "unsynced_norms",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The rank of this process among ``world`` ranks.

    ``local_rank`` indexes the rank among the ``local_size`` ranks of its
    host, and its device there; a host is one launch of an entry point,
    which starts ``num_devices`` ranks (``host``, ``num_hosts``).
    ``cpu_group`` is the process group of host-side flags and barriers
    (None: the default group, when it is gloo's). ``spatial`` ranks share
    each image (``spatial_group``: this rank's group of them, made by
    every rank in the same order, ``multihost.initialize``).
    """

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_size: int = 1
    device: torch.device = torch.device("cpu")
    cpu_group: Any = None
    spatial: int = 1
    spatial_group: Any = None

    @property
    def host(self) -> int:
        return self.rank // self.local_size

    @property
    def num_hosts(self) -> int:
        return self.world // self.local_size

    @property
    def data_index(self) -> int:
        """The batch shard this rank holds rows of (its spatial group)."""
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        """The band of image rows this rank holds within its group."""
        return self.rank % self.spatial

    @property
    def batch_shards(self) -> int:
        """The shards the batch splits into: the ranks over the spatial factor."""
        return self.world // self.spatial


def create_mesh(world: int = 1, rank: int = 0, *, local_rank: int = 0, local_size: int = 1,
                device="cpu", num_slices: int = 1, spatial_partitions: int = 1,
                cpu_group=None, spatial_group=None) -> Mesh:
    """The mesh of rank ``rank`` among ``world`` ranks, with the layout
    checks of the JAX package's ``create_mesh`` (:79-84)."""
    n = world
    if num_slices * spatial_partitions > n or n % (num_slices * spatial_partitions):
        raise ValueError(
            f"{n} devices not divisible into {num_slices} slices x "
            f"{spatial_partitions} spatial partitions.")
    if not 0 <= rank < world or local_size < 1 or world % local_size:
        raise ValueError(f"rank {rank} of {world} ranks in hosts of {local_size}")
    return Mesh(world=world, rank=rank, local_rank=local_rank, local_size=local_size,
                device=torch.device(device), cpu_group=cpu_group, spatial=spatial_partitions,
                spatial_group=spatial_group)


def spatial_groups(world: int, spatial: int) -> list:
    """The rank lists of the spatial groups, in the order every rank makes them."""
    return [list(range(g * spatial, (g + 1) * spatial)) for g in range(world // spatial)]


def local_batch_size(global_nb: int, mesh: Mesh) -> int:
    """get_temp_Nb parity: the per-rank batch; the global one must divide.
    Only the batch shards take rows: a spatial group shares its images."""
    div, mod = divmod(global_nb, mesh.batch_shards)
    if mod:
        raise ValueError(f"batch size {global_nb} not divisible by {mesh.batch_shards} batch "
                         "shards.")
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


def shard_height(x, mesh: Mesh, dim: int = 1):
    """This rank's band of rows (axis ``dim``, the height of an NHWC image
    or an (N, H, W) label) of its group's images: ``[i H / P, (i + 1) H /
    P)`` for spatial index i of P. H must divide by 8 P
    (iv2019_tpu/config.py:115-120): JAX's ``shard_batch`` would replicate
    such an array silently, the port refuses it."""
    p = mesh.spatial
    if p == 1:
        return x
    h = x.shape[dim]
    if h % (8 * p):
        raise ValueError(f"image height {h} must divide by 8 x spatial_partitions = {8 * p}")
    band = h // p
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.spatial_index * band, (mesh.spatial_index + 1) * band)
    return x[tuple(index)]


# --------------------------------------------------------------- the active mesh

_active: Optional[Mesh] = None
_norms_synced = True
_spatial_on = True


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


def spatial_mesh() -> Optional[Mesh]:
    """The active mesh when it splits image height (the model's inputs are
    then bands of rows), else None."""
    if _spatial_on and _active is not None and _active.spatial > 1:
        return _active
    return None


@contextlib.contextmanager
def unsynced_norms():
    """BatchNorm on this rank's rows alone."""
    global _norms_synced
    saved, _norms_synced = _norms_synced, False
    try:
        yield
    finally:
        _norms_synced = saved


@contextlib.contextmanager
def alone():
    """A forward that one rank runs by itself (the image summaries of
    train/loop.py): no collective, so BatchNorm on this rank's rows and
    whole images, not bands (a halo exchange would wait forever for the
    other ranks of the group)."""
    global _spatial_on
    saved, _spatial_on = _spatial_on, False
    try:
        with unsynced_norms():
            yield
    finally:
        _spatial_on = saved


# ------------------------------------------------------------------ collectives

_stats = {"all_reduce": 0, "broadcast": 0, "bytes": 0, "halo": 0, "halo_bytes": 0,
          "halo_buffer_bytes": 0}


def reset_collective_stats() -> None:
    _stats.update(all_reduce=0, broadcast=0, bytes=0, halo=0, halo_bytes=0, halo_buffer_bytes=0)


def collective_stats() -> dict:
    """The collectives issued since the last reset, and their bytes; halo
    exchanges (forward and backward) apart, with the largest halo buffer
    (``halo_buffer_bytes``: memory a rank holds for one exchange)."""
    return dict(_stats)


def _count(kind: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    _stats[kind] += 1
    if kind == "halo":
        _stats["halo_bytes"] += nbytes
        _stats["halo_buffer_bytes"] = max(_stats["halo_buffer_bytes"], nbytes)
    else:
        _stats["bytes"] += nbytes


def all_reduce(t: torch.Tensor, mesh: Mesh, group=None, kind: str = "all_reduce") -> torch.Tensor:
    """Sum ``t`` over the ranks (of ``group``, default all), in place; returns it."""
    _count(kind, t)
    dist.all_reduce(t, group=group)
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


class _SpatialSum(torch.autograd.Function):
    """The sum over the spatial group of a partial statistic of each band;
    the gradient of the sum is every band's, so it is summed too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.detach().clone(), mesh, mesh.spatial_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.mesh.spatial_group), None


def spatial_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over this rank's spatial group, differentiably."""
    return _SpatialSum.apply(x, mesh)


def _halo_pieces(mesh: Mesh, n: int, lo: int, hi: int):
    """(buffer row, local row, rows) of the rows this rank holds that the
    other ranks of its group ask for: slot q of the buffer is rank q's
    ``lo`` rows above its band and ``hi`` below, in global row order."""
    me, p = mesh.spatial_index, mesh.spatial
    own = (me * n, (me + 1) * n)
    pieces = []
    for q in range(p):
        if q == me:
            continue
        for first, count, slot in ((q * n - lo, lo, 0), ((q + 1) * n, hi, lo)):
            a, b = max(first, own[0]), min(first + count, own[1])
            if a < b:
                pieces.append((q * (lo + hi) + slot + a - first, a - own[0], b - a))
    return pieces


def _outside(mesh: Mesh, n: int, lo: int, hi: int):
    """Rows of this rank's slot that lie outside the image: (above, below)."""
    me, p = mesh.spatial_index, mesh.spatial
    return max(0, lo - me * n), max(0, (me + 1) * n + hi - p * n)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, dim, fill, mesh):
        n = x.shape[dim]
        xm = x.movedim(dim, 0)
        buf = xm.new_zeros((mesh.spatial * (lo + hi),) + xm.shape[1:])
        for b, l, c in _halo_pieces(mesh, n, lo, hi):
            buf[b:b + c] = xm[l:l + c]
        all_reduce(buf, mesh, mesh.spatial_group, kind="halo")
        me = mesh.spatial_index
        mine = buf[me * (lo + hi):(me + 1) * (lo + hi)]
        above, below = _outside(mesh, n, lo, hi)
        if fill != 0.0:
            mine[:above] = fill
            mine[lo + hi - below:] = fill
        shape = list(x.shape)
        shape[dim] += lo + hi
        fmt = (torch.channels_last if x.dim() == 4 and dim != 1
               and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)
        out.narrow(dim, lo, n).copy_(x)
        out.narrow(dim, 0, lo).copy_(mine[:lo].movedim(0, dim))
        out.narrow(dim, lo + n, hi).copy_(mine[lo:].movedim(0, dim))
        ctx.lo, ctx.hi, ctx.dim, ctx.n, ctx.mesh = lo, hi, dim, n, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        lo, hi, dim, n, mesh = ctx.lo, ctx.hi, ctx.dim, ctx.n, ctx.mesh
        gm = g.movedim(dim, 0)
        buf = gm.new_zeros((mesh.spatial * (lo + hi),) + gm.shape[1:])
        me = mesh.spatial_index
        mine = buf[me * (lo + hi):(me + 1) * (lo + hi)]
        mine[:lo] = gm[:lo]
        mine[lo:] = gm[lo + n:]
        # rows outside the image are the op's padding: their gradient goes nowhere
        above, below = _outside(mesh, n, lo, hi)
        mine[:above] = 0
        mine[lo + hi - below:] = 0
        all_reduce(buf, mesh, mesh.spatial_group, kind="halo")
        gx = g.narrow(dim, lo, n).clone()
        gxm = gx.movedim(dim, 0)
        for b, l, c in _halo_pieces(mesh, n, lo, hi):
            gxm[l:l + c] += buf[b:b + c]
        return gx, None, None, None, None, None


def halo(x: torch.Tensor, lo: int, hi: int, mesh: Mesh, dim: int = 2,
         fill: float = 0.0) -> torch.Tensor:
    """This rank's band of a map split by height (axis ``dim``; 2 for
    NCHW) with ``lo`` rows above it and ``hi`` below from the rest of its
    spatial group; rows outside the image are ``fill`` (the op's padding).
    Any widths work, also wider than a band. Differentiable: the backward
    adds each halo row's gradient into the rank that holds the row.
    Every rank of the group must call it with the same ``lo`` and ``hi``."""
    if lo == 0 and hi == 0:
        return x
    return _Halo.apply(x, lo, hi, dim, fill, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh, need, dim: int = 2):
    """Rows ``need(spatial_index)`` = [start, stop) of the global map whose
    band ``x`` holds, from whichever ranks hold them (``halo`` wide enough
    for every rank of the group, which each rank computes alike).
    ``need(q)`` must lie inside the image for every q."""
    n = x.shape[dim]
    lo = max(max(0, q * n - need(q)[0]) for q in range(mesh.spatial))
    hi = max(max(0, need(q)[1] - (q + 1) * n) for q in range(mesh.spatial))
    start, stop = need(mesh.spatial_index)
    first = mesh.spatial_index * n - lo
    return halo(x, lo, hi, mesh, dim).narrow(dim, start - first, stop - start)

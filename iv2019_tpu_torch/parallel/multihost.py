"""Starting the ranks of a run, and the input helpers of multi-process runs.

Port of iv2019_tpu/parallel/multihost.py. JAX runs one process per host,
each driving its local chips, and stitches them into one global device list.
The port runs one process per device: a *rank*. Every rank is a process of
its own, so ``process_index`` / ``process_count`` are the rank and the
number of ranks, and the input pipelines, the checkpoint writes and the
logs split or gate on them as the JAX package's do on its processes.

How the settings start the ranks (``initialize``):

- ``num_devices`` N: an entry point started once spawns N ranks
  (``launch``: train_cli, evaluate_cli), rank r on device ``cuda:r``, which
  meet at a free localhost port. None is every visible CUDA device (1 on
  the CPU) there, and this process's one device where a caller starts the
  rank itself (``SemanticSegmentation.train`` / ``.evaluate`` called
  directly): only ``launch`` starts ranks;
- ``num_processes`` P > 1 with ``coordinator_address`` host:port and
  ``process_id`` i: the entry point is started on P hosts; host i's N ranks
  are ranks ``i N .. i N + N - 1`` of ``P N``, and meet at the coordinator;
- ``num_processes`` 0: the ranks come from torchrun's environment (RANK,
  WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), one
  device each, a node's ranks one host;
- one process of one device: no process group, unless a ``backend`` is
  asked for (then a group of one rank).

The backend is NCCL for CUDA tensors and gloo for the CPU; ``backend``
overrides it (two gloo ranks can share one card, which NCCL refuses, and
``device`` then names the card). A group that cannot start raises: nothing
falls back to one process or to another backend. With
``spatial_partitions`` P every rank also makes the process group of each
spatial group (P adjacent ranks), in the same order.

The input of a run is read per batch shard: the P ranks of a spatial group
read the same stream (seed ``s + 7919 * data_index``, every
``batch_shards``-th record from ``data_index``) and hold the same images,
whose bands they take (``data_index``, ``data_count``). Without spatial
partitioning a batch shard is a rank. One stream per launch, split by
rows as JAX's single process does, would cost each rank the decode of the
whole launch's batch, and the training run is host-bound.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from iv2019_tpu_torch.parallel.mesh import (Mesh, active, create_mesh, set_active, shard_rows,
                                            spatial_groups)

__all__ = [
    "data_count",
    "data_index",
    "free_port",
    "initialize",
    "is_primary",
    "launch",
    "local_devices",
    "local_share",
    "process_count",
    "process_index",
    "put_sharded",
    "shard_records",
    "shutdown",
]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_devices(settings) -> int:
    """The ranks one launch of an entry point runs: ``num_devices``, by
    default every visible CUDA device (1 on the CPU)."""
    if settings.device != "cuda":
        return settings.num_devices or 1
    visible = torch.cuda.device_count()
    n = visible if settings.num_devices is None else settings.num_devices
    if n < 1 or n > visible:
        raise ValueError(f"num_devices={settings.num_devices} but {visible} CUDA devices are "
                         "visible")
    return n


def initialize(settings=None, backend: Optional[str] = None, local_rank: int = 0,
               init_method: Optional[str] = None, device=None) -> Optional[Mesh]:
    """Start this rank's process group and make its mesh the active one
    (``mesh.active``: one per process, as the process group is; a second
    call returns the mesh of the first).

    ``local_rank``: the rank's index on its host (``launch`` passes it);
    ``init_method``: where the ranks meet (default: the coordinator, or
    torchrun's environment); ``device``: the rank's CUDA device when not
    ``cuda:<local_rank>`` (gloo ranks that share a card; ``num_devices`` is
    then the host's ranks, not its cards). Returns None for one process of
    one device without a ``backend``.
    """
    if active() is not None:
        return active()
    if settings is None:
        return None
    if settings.num_processes == 0:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError("num_processes 0 takes the ranks from torchrun's environment; "
                             f"missing {', '.join(missing)}")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank, local_size = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
        init_method = init_method or "env://"
    else:
        # None: the count launch resolved and passes on, else this process's
        # one device; with ``device`` given, the ranks share cards and the
        # count is as given
        if settings.num_devices is None:
            local_size = 1
        else:
            local_size = settings.num_devices if device is not None else local_devices(settings)
        if not 0 <= local_rank < local_size:
            raise ValueError(f"local rank {local_rank} outside [0, {local_size})")
        world = settings.num_processes * local_size
        rank = settings.process_id * local_size + local_rank
    # the layout checks, before anything starts
    create_mesh(world, rank, local_size=local_size, num_slices=settings.num_slices,
                spatial_partitions=settings.spatial_partitions)
    if init_method is None:
        if settings.coordinator_address:
            init_method = "tcp://" + settings.coordinator_address
        elif settings.num_processes > 1:
            raise ValueError("num_processes > 1 requires --coordinator_address host:port (or "
                             "--num_processes 0 under torchrun)")
        elif world > 1:
            raise ValueError(f"num_devices={settings.num_devices}: the ranks of one process's "
                             "devices are started by multihost.launch (train_cli and "
                             "evaluate_cli use it), one process each")
        elif backend is None:
            return None  # one process of one device: no process group
        else:
            init_method = f"tcp://localhost:{free_port()}"
    if settings.device == "cuda":
        device = torch.device(device) if device is not None else torch.device("cuda", local_rank)
        if not torch.cuda.is_available() or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs {device}, and "
                               f"{torch.cuda.device_count()} CUDA devices are visible")
        # the CUDA runtime's current device is per thread: the kernels launch
        # on it (ops/*.py put each launch under its tensor's device too)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL was asked for and this PyTorch has no NCCL")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    # host-side flags and barriers go through gloo, off the device's stream
    cpu_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    spatial_group = None
    if settings.spatial_partitions > 1:
        # every rank makes every group, in the same order
        for ranks in spatial_groups(world, settings.spatial_partitions):
            group = dist.new_group(ranks)
            if rank in ranks:
                spatial_group = group
    mesh = create_mesh(world, rank, local_rank=local_rank, local_size=local_size, device=device,
                       num_slices=settings.num_slices,
                       spatial_partitions=settings.spatial_partitions, cpu_group=cpu_group,
                       spatial_group=spatial_group)
    set_active(mesh)
    return mesh


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    set_active(None)


def _rank_main(local_rank: int, fn: Callable, settings, init_method: str, args: tuple) -> None:
    initialize(settings, local_rank=local_rank, init_method=init_method)
    try:
        fn(settings, *args)
    finally:
        shutdown()


def launch(fn: Callable, settings, *args):
    """``fn(settings, *args)`` on every rank of this host. With one local
    device it runs in this process and its value is returned; with more,
    each rank is a spawned process (``fn`` must be a module-level function),
    this call returns None when all have ended, and raises if one failed.
    In a rank already started (``initialize``) it runs ``fn`` there."""
    if active() is not None:
        return fn(settings, *args)
    n = local_devices(settings) if settings.num_processes != 0 else 1
    if n == 1:
        return fn(settings, *args)
    # the ranks take the count as given (initialize reads None as one)
    settings = settings.replace(num_devices=n)
    if settings.coordinator_address:
        init_method = "tcp://" + settings.coordinator_address
    else:
        init_method = f"tcp://localhost:{free_port()}"
    torch.multiprocessing.start_processes(_rank_main, args=(fn, settings, init_method, args),
                                          nprocs=n, join=True, start_method="spawn")
    return None


def process_index() -> int:
    return active().rank if active() is not None else 0


def process_count() -> int:
    return active().world if active() is not None else 1


def is_primary() -> bool:
    """True on the rank that owns the file system's side effects."""
    return process_index() == 0


def data_index() -> int:
    """This rank's batch shard (its spatial group; the rank without one)."""
    return active().data_index if active() is not None else 0


def data_count() -> int:
    """The batch shards of the run: the ranks over the spatial factor."""
    return active().batch_shards if active() is not None else 1


def local_share(n_global: int, what: str = "batch size") -> int:
    """Per-batch-shard item count: global // data_count, exact division."""
    pc = data_count()
    div, mod = divmod(n_global, pc)
    if mod:
        raise ValueError(f"global {what} {n_global} not divisible by {pc} batch shards.")
    return div


def shard_records(it: Iterable, index: Optional[int] = None,
                  count: Optional[int] = None) -> Iterator:
    """Record k of a stream goes to batch shard ``k % count``."""
    index = data_index() if index is None else index
    count = data_count() if count is None else count
    if count == 1:
        return iter(it)
    return itertools.islice(iter(it), index, None, count)


def put_sharded(batch: dict, mesh: Mesh, accum: int = 1) -> dict:
    """This rank's batch shard's rows (``mesh.shard_rows``) of a global host
    batch, as tensors on the rank's device; lists are cut the same way and
    other values pass through. Images keep their height: a spatial group's
    ranks take their bands in the step, after the augmentations, and box
    tensors never split on their dim 1 (tests/test_spatial.py:104-124)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, list) or (isinstance(v, (np.ndarray, torch.Tensor))
                                   and v.ndim > 0 and v.shape[0] > 0):
            v = shard_rows(v, mesh.data_index, mesh.batch_shards, accum)
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            v = v.to(mesh.device)
        out[k] = v
    return out

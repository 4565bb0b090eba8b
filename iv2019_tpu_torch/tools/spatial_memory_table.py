"""Trainable image size under spatial partitioning: the memory of a rank,
measured.

Port of tools/spatial_memory_table.py, with the same grid and flags. The
JAX tool asks XLA for a static memory analysis of the train step compiled
for an 8-device mesh; PyTorch has no such analysis, so this tool runs the
step and reads the allocator. For each Vistas-like size x spatial factor
(``--remat``, ``--accum``, ``--ndev`` and ``--nb`` as in JAX) it runs the
real train step (bf16, fused loss B1/B2 where the mesh does not split
height, fused update B3) on seeded random weights and reports, for the
largest rank, temp, argument, output and total memory:

- args: ``memory_allocated()`` before the measured step (the model, the
  optimizer's flat buffers, the batch);
- total: ``max_memory_allocated()`` over the measured step, after one
  warm-up step (which allocates cuDNN workspaces and gloo's staging);
- temp = total - args; output = what the step leaves allocated beyond args
  (the state is updated in place, so about the metrics).

Also the allocator's reserved peak, the halo exchanges' bytes, and the
largest halo buffer: the port's ``halo`` all-reduces a buffer of
``spatial x (lo + hi)`` rows on every rank of a group (parallel/mesh.py),
memory JAX's collective-permute does not hold, which grows with the factor.
A buffer lives only inside its exchange, so its size bounds its share of the
peak.

One row is one spatial group. In an ``ndev``-device mesh at factor f every
data shard's f ranks hold the same bytes, so a row runs one group: f gloo
processes sharing ``cuda:0`` (one process at f 1), with the batch shard the
mesh would give it (``nb f / ndev`` images of each type). ``run_row(...,
full_mesh=True)`` runs every rank of the mesh instead, which the group is
held to. ``fits`` compares a rank's total with the card's memory, since the
table's question is per device. On the CPU (``--device cpu``) there is no
allocator peak: the same numbers come from ``LiveBytes``, a count of the
bytes of every tensor storage the step's operations create, less those
freed.

Usage:
  python -m iv2019_tpu_torch.tools.spatial_memory_table [--quick]
      [--sizes 920x1268,1240x1712] [--factors 2,8] [--nb N] [--remat]
      [--accum A] [--ndev N] [--device cuda|cpu]

Prints a markdown row per configuration as it goes, then one JSON line.
Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import weakref
from contextlib import nullcontext

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from iv2019_tpu_torch.config import Settings

LADDER = [(512, 1024), (832, 1140), (920, 1268), (1240, 1712), (1536, 2112)]
FACTORS = [1, 2, 4, 8]
QUICK_SIZES, QUICK_FACTORS = [(512, 1024)], [1, 4]
NUM_WEAK_CLASSES = 15
NUM_VISTAS_LABELS = 60  # the draws of the JAX tool's batch
ROW_TIMEOUT_S = 900
GB = 1024 ** 3
# the train path's kernels, by their wrappers' counters
KERNELS = ("fused_loss_fwd", "fused_loss_bwd", "fused_update", "root_conv_wgrad")
ROW_KEYS = ("h", "w", "spatial", "remat", "accum", "ndev", "nb")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m iv2019_tpu_torch.tools.spatial_memory_table")
    p.add_argument("--quick", action="store_true", help="1 size x 2 factors (smoke)")
    p.add_argument("--nb", type=int, default=None,
                   help="global per-type batch (default: ndev // factor, one image per data "
                        "shard)")
    p.add_argument("--sizes", type=str, default=None,
                   help="comma list of HxW (e.g. '920x1268,1240x1712')")
    p.add_argument("--factors", type=str, default=None,
                   help="comma list of spatial factors (e.g. '2,4,8')")
    p.add_argument("--remat", action="store_true", help="rematerialize the trunk's units")
    p.add_argument("--accum", type=int, default=1,
                   help="grad_accum_steps for the rows (nb must divide by it)")
    p.add_argument("--ndev", type=int, default=8,
                   help="mesh size (1 = the single-device lever rows)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def row_plan(args) -> list:
    """The JAX tool's grid (tools/spatial_memory_table.py:130-154), row for
    row: H rounded up to a multiple of 32 f, ``nb`` = ndev // f unless given,
    then lowered to a multiple of ``accum``."""
    sizes, factors = (QUICK_SIZES, QUICK_FACTORS) if args.quick else (LADDER, FACTORS)
    if args.sizes:
        sizes = [tuple(int(d) for d in s.split("x")) for s in args.sizes.split(",")]
    if args.factors:
        factors = [int(f) for f in args.factors.split(",")]
    rows = []
    for h, w in sizes:
        for f in factors:
            nb = max(args.ndev // f, 1) if args.nb is None else args.nb
            if nb % args.accum:
                nb = args.accum * max(nb // args.accum, 1)
            rows.append(dict(h=-(-h // (f * 32)) * (f * 32), w=w, spatial=f, remat=args.remat,
                             accum=args.accum, ndev=args.ndev, nb=nb))
    return rows


def row_settings(h: int, w: int, spatial: int, nb: int, remat: bool = False, accum: int = 1,
                 ndev: int = 8, device: str = "cuda") -> Settings:
    """The Settings of the JAX tool's ``analyze`` (:55-67) on the port: the
    Vistas heads, the global per-type batch ``nb``, bf16, every other field
    at its default (``root_wgrad_pallas`` off, as there)."""
    return Settings(
        mode="train", device=device, per_pixel_dataset_name="vistas",
        Nb_per_pixel=nb, Nb_per_bbox=nb, Nb_per_image=nb, Nb=nb,
        height_feature_extractor=h, width_feature_extractor=w,
        Ntrain=256, Ne=3, learning_rate_boundaries=(1, 2),
        learning_rate_values=(0.01, 0.005, 0.0025),
        compute_dtype="bfloat16", spatial_partitions=spatial, remat=remat,
        grad_accum_steps=accum, num_devices=ndev,
    ).finalize()


def row_batch(h: int, w: int, nb: int) -> dict:
    """The JAX tool's batch (:82-92): ``nb`` images of each type from
    ``np.random.RandomState(0)``, uniform in [-1, 1], per-pixel labels in
    [0, 60), dense one-hot weak labels over the 15 weak classes."""
    eye = np.eye(NUM_WEAK_CLASSES, dtype=np.float32)
    rng = np.random.RandomState(0)
    return {
        "proimages_per_pixel": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "proimages_per_bbox": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "proimages_per_image": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "prolabels_per_pixel": rng.randint(0, NUM_VISTAS_LABELS, (nb, h, w)).astype(np.int32),
        "prolabels_per_bbox": eye[rng.randint(0, NUM_WEAK_CLASSES, (nb, h, w))],
        "prolabels_per_image": eye[rng.randint(0, NUM_WEAK_CLASSES, (nb, h, w))],
    }


def shard_batch_size(nb: int, spatial: int, ndev: int, accum: int = 1) -> int:
    """Images of each type on one data shard of the ``ndev``-device mesh at
    factor ``spatial``; refuses a layout or a batch the mesh cannot shard,
    as JAX's ``create_mesh`` and ``shard_batch`` do, and a microbatch that
    does not divide over the shards, as the train step does."""
    if spatial > ndev or ndev % spatial:
        raise ValueError(f"{ndev} devices not divisible into {spatial} spatial partitions.")
    shards = ndev // spatial
    if nb % (accum * shards):
        raise ValueError(f"batch size {nb} not divisible by {accum} microbatches x {shards} "
                         "data shards.")
    return nb // shards


class LiveBytes(TorchDispatchMode):
    """Bytes held by the tensor storages that operations create while the
    mode is on, and their peak: a storage is counted once, when the first
    operation returns it (a view or an in-place result shares an input's
    storage and adds nothing), and uncounted when it is freed (a weak
    reference's callback). ``track`` adds storages made outside the mode
    (e.g. tensors of numpy arrays). Storages resized in place are recounted
    at their new size. Counts what the operations ask for: no allocator
    rounding, and no workspace a library takes from the allocator directly
    (cuDNN's)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._bytes = WeakIdKeyDictionary()

    def reset_peak(self) -> None:
        self.peak = self.live

    def _free(self, box: list) -> None:
        self.live -= box[0]

    def _count(self, storage, known) -> None:
        n = storage.nbytes()
        box = self._bytes.get(storage)
        if box is None:
            if id(storage) in known:
                return  # an input's storage from before the mode
            box = self._bytes[storage] = [n]
            weakref.finalize(storage, self._free, box)
            self.live += n
        elif box[0] != n:
            self.live += n - box[0]
            box[0] = n
        self.peak = max(self.peak, self.live)

    def track(self, tensors) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._count(t.untyped_storage(), ())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        known = {id(t.untyped_storage()) for t in tree_flatten((args, kwargs))[0]
                 if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._count(t.untyped_storage(), known)
        return out


def _kernel_counters() -> dict:
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.ops import root_wgrad as rw

    return {"fused_loss_fwd": fl.fused_loss_fwd, "fused_loss_bwd": fl.fused_loss_bwd,
            "fused_update": fu.fused_update, "root_conv_wgrad": rw.root_conv_wgrad}


def measure(settings: Settings, batch: dict, mesh=None, count_live: bool = False) -> dict:
    """One rank's memory over one train step, after a warm-up step.

    ``batch``: this rank's host arrays (its data shard's rows; the step cuts
    its band of rows). On the card the numbers are the allocator's, and with
    ``count_live`` also ``LiveBytes``'s of the same step (``live``); on the
    CPU they are ``LiveBytes``'s. Also the measured step's halo exchanges
    and kernel launches, and its wall time."""
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.parallel import mesh as pmesh
    from iv2019_tpu_torch.parallel import multihost
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    cuda = settings.device == "cuda"
    device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    live = LiveBytes() if count_live or not cuda else None
    counters = _kernel_counters()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with live if live is not None else nullcontext():
        model = init_model(build_model(settings), torch.Generator().manual_seed(0))
        opt = FusedSGDM(settings, model)
        state = create_fused_train_state(opt)
        step = make_train_step(settings, fused_opt=opt, mesh=mesh)
        if mesh is not None:
            batch = multihost.put_sharded(batch, mesh, settings.grad_accum_steps)
        else:
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if live is not None:
            live.track(batch.values())
        state, metrics = step(state, batch)
        del metrics
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            args_bytes = torch.cuda.memory_allocated(device)
        if live is not None:
            live.reset_peak()
            live_args = live.live
        for fn in counters.values():
            fn.launches = 0
        pmesh.reset_collective_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        finite = bool(all(np.isfinite(float(v)) for k, v in metrics.items()
                          if k != "weight_masks"))
        colls = pmesh.collective_stats()
        launches = {k: fn.launches for k, fn in counters.items()}
        out = dict(step_ms=step_ms, finite=finite, halo=colls["halo"],
                   halo_bytes=colls["halo_bytes"], halo_buffer_bytes=colls["halo_buffer_bytes"],
                   launches=launches)
        if live is not None:
            live_numbers = dict(args_bytes=live_args, total_bytes=live.peak,
                                temp_bytes=live.peak - live_args,
                                output_bytes=live.live - live_args)
        if cuda:
            total = torch.cuda.max_memory_allocated(device)
            out.update(args_bytes=args_bytes, total_bytes=total, temp_bytes=total - args_bytes,
                       output_bytes=torch.cuda.memory_allocated(device) - args_bytes,
                       reserved_bytes=torch.cuda.max_memory_reserved(device),
                       device_bytes=torch.cuda.get_device_properties(device).total_memory)
            if live is not None:
                out["live"] = live_numbers
        else:
            out.update(live_numbers, reserved_bytes=None, device_bytes=None)
    return out


def _rank_main(rank: int, ranks: int, port: int, settings: Settings, row: dict,
               full_mesh: bool, count_live: bool, blocks, out_dir: str) -> None:
    """One rank of a row (``rank`` of ``ranks`` gloo processes, or the one
    process of f 1): draws the row's batch, keeps its data shard's rows and
    writes ``measure``'s numbers to ``out_dir/rank<r>.json``."""
    from iv2019_tpu_torch.models import model as models
    from iv2019_tpu_torch.parallel import multihost
    from iv2019_tpu_torch.parallel.mesh import shard_rows

    if blocks is not None:
        models.FEATURE_EXTRACTOR_BLOCKS[settings.name_feature_extractor] = tuple(blocks)
    cuda = settings.device == "cuda"
    if not cuda:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    batch = row_batch(row["h"], row["w"], row["nb"])
    if not full_mesh:
        shards = row["ndev"] // row["spatial"]
        batch = {k: shard_rows(v, 0, shards, row["accum"]) for k, v in batch.items()}
    mesh = None
    if ranks > 1:
        mesh = multihost.initialize(
            settings.replace(coordinator_address=f"localhost:{port}"), backend="gloo",
            local_rank=rank, device="cuda:0" if cuda else None)
    try:
        out = measure(settings, batch, mesh, count_live)
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(out, rank=rank), f)


def _spawn(ranks: int, args: tuple, timeout: float) -> None:
    """``_rank_main(r, ranks, *args)`` in ``ranks`` spawned processes; a
    rank that fails ends the others, and so does a join past ``timeout``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(ranks,) + args, nprocs=ranks, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {ranks} ranks did not end in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _last_error_line(e: BaseException) -> str:
    lines = [ln.strip() for ln in str(e).strip().splitlines() if ln.strip()]
    return (lines[-1] if lines else type(e).__name__)[:400]


def run_row(row: dict, device: str = "cuda", *, full_mesh: bool = False,
            count_live: bool = False, blocks=None, timeout: float = ROW_TIMEOUT_S) -> dict:
    """Measure one row of ``row_plan`` (``h, w, spatial, remat, accum, ndev,
    nb``): its spatial group (``full_mesh``: every rank of the mesh), each
    rank a process. Returns the row with the JAX tool's keys for the largest
    rank, the allocator's reserved peak, the halo numbers, every rank's
    numbers and launches, or with ``error`` where a rank failed, ran out of
    memory or the batch does not shard (its traceback goes to stderr).
    ``blocks`` replaces the trunk's units in the ranks (tests cut it)."""
    out = {k: row[k] for k in ROW_KEYS}
    t0 = time.perf_counter()
    try:
        shard = shard_batch_size(row["nb"], row["spatial"], row["ndev"], row["accum"])
        ranks = row["ndev"] if full_mesh else row["spatial"]
        settings = row_settings(row["h"], row["w"], row["spatial"], row["nb"], row["remat"],
                                row["accum"], row["ndev"], device)
        settings = settings.replace(num_devices=ranks)
        if not full_mesh:
            # the group is a mesh of its own: its data shard is its whole batch
            settings = settings.replace(Nb_per_pixel=shard, Nb_per_bbox=shard,
                                        Nb_per_image=shard, Nb=shard)
        from iv2019_tpu_torch.parallel.multihost import free_port

        with tempfile.TemporaryDirectory(prefix="spatial_memory_") as out_dir:
            _spawn(ranks, (free_port(), settings, out, full_mesh, count_live, blocks, out_dir),
                   timeout)
            per_rank = []
            for r in range(ranks):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    per_rank.append(json.load(f))
    except Exception as e:  # noqa: BLE001 - a failed row is a row of the table
        print(f"row {out} failed: {e}", file=sys.stderr, flush=True)
        msg = _last_error_line(e)
        return dict(out, error=msg, oom="out of memory" in msg.lower(),
                    wall_s=time.perf_counter() - t0)
    top = max(per_rank, key=lambda r: r["total_bytes"])
    out.update({f"{k}_gb": round(top[f"{k}_bytes"] / GB, 3)
                for k in ("temp", "args", "output", "total")})
    reserved = top["reserved_bytes"]
    out.update(
        reserved_gb=None if reserved is None else round(reserved / GB, 3),
        halo_gb=round(top["halo_bytes"] / GB, 3),
        halo_buffer_gb=round(top["halo_buffer_bytes"] / GB, 3),
        halo_buffer_share=top["halo_buffer_bytes"] / top["total_bytes"],
        ranks=ranks, shard_nb=shard,
        fits=None if top["device_bytes"] is None else top["total_bytes"] <= top["device_bytes"],
        finite=all(r["finite"] for r in per_rank),
        launches={k: [r["launches"][k] for r in per_rank] for k in KERNELS},
        wall_s=time.perf_counter() - t0, per_rank=per_rank)
    return out


def markdown_row(row: dict) -> str:
    size, f = f"{row['h']}x{row['w']}", f"x{row['spatial']}"
    if "error" in row:
        return f"| {size} | {f} | - | - | - | error: {row['error'][:80]} |"
    fit = {True: "fits", False: "OOM", None: "n/a"}[row["fits"]]
    return (f"| {size} | {f} | {row['temp_gb']:.2f} | {row['args_gb']:.2f} | "
            f"{row['total_gb']:.2f} | {fit} |")


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"nvidia_smi": smi.stdout.strip().splitlines()[0],
            "name": torch.cuda.get_device_name(0)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spatial_memory_table: no CUDA device; pass --device cpu to "
                               "measure on the CPU")
        from iv2019_tpu_torch.ops import _build

        _build.build_all()  # once, before the ranks load the kernels
    t0 = time.perf_counter()
    rows = []
    print("| size | factor | temp GB | args GB | total GB | fits |", flush=True)
    print("|---|---|---|---|---|---|", flush=True)
    for plan in row_plan(args):
        row = run_row(plan, args.device)
        rows.append(row)
        print(markdown_row(row), flush=True)
    detail = {"rows": rows, "device": args.device,
              "measured_by": "allocator" if args.device == "cuda" else "live bytes",
              "nb_per_type": f"{args.ndev}//factor" if args.nb is None else args.nb,
              "wall_s": time.perf_counter() - t0, "torch": torch.__version__}
    if args.device == "cuda":
        detail.update(card())
    line = {"metric": "spatial_memory_table",
            "value": len([r for r in rows if "error" not in r]), "unit": "configs",
            "vs_baseline": None, "detail": detail}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

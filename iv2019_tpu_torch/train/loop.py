"""Training loop: prefetched batches -> train step -> checkpoints, metric
logs, image summaries and profiler traces.

Port of iv2019_tpu/train/loop.py:42-337, on every rank of the run
(parallel/multihost.py; one rank: the model's device):

- resume from the latest checkpoint in ``log_dir`` or, when ``log_dir``
  has none, warm start from ``init_ckpt_path``; both at once is an error
  (reference system_factory.py:438-445);
- scalar metrics to ``train_metrics.jsonl`` and TensorBoard event files
  (utils/tb_writer.py), read back to the host only every ``log_every``
  steps and at the last, with ``learning_rate`` and ``images_per_sec``;
- image summaries every ``save_summaries_steps``: the colorized decisions
  of one per-pixel image from a train-mode forward whose BatchNorm
  statistics are put back afterwards (JAX discards the mutated
  ``batch_stats``), its labels, and the loss weight masks;
- a checkpoint every ``save_checkpoints_steps`` and at the last step;
- SIGTERM: finish the step in flight, save at the true step, return;
- ``profile_every``: one step traced by ``torch.profiler`` into
  ``log_dir/profile/step_K/trace.json`` every K steps.

With several ranks the state is broadcast from rank 0 after the init, the
restore or the warm start (JAX ``replicate``); rank 0 alone writes
checkpoints, metrics, image summaries (only while ``num_processes`` is 1,
as JAX's while ``process_count()`` is 1; its forward runs alone, on the
whole image also under spatial partitioning, while the weight masks are
rank 0's band), traces and prints; every rank
waits at a barrier after each checkpoint save; and SIGTERM is decided by
all ranks at once (a host all-reduce of the flag each step), so no rank
leaves while the others wait in a collective.

The loop keeps the step count on the host; the device's ``state.step`` is
read once, at the start. ``fused_optimizer`` picks the optimizer: the fused
SGDM of train/fused_update.py, or the optax path's SGD and ``EmaState``
(train/optimizer.py, train/state.py), each with its own kind of checkpoint.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input.prefetch import device_prefetch
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.optimizer import make_optimizer
from iv2019_tpu_torch.train.state import TrainState, create_fused_train_state, create_train_state
from iv2019_tpu_torch.train.step import make_train_step
from iv2019_tpu_torch.utils.checkpoint import CheckpointManager, warm_start_from_npz
from iv2019_tpu_torch.utils.tb_writer import EventFileWriter

__all__ = ["MetricsLogger", "default_profile_every", "statistics_kept", "train"]


class MetricsLogger:
    """Scalar metrics to JSONL and TensorBoard; images to TensorBoard."""

    def __init__(self, log_dir: str, name: str = "train_metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._tb = EventFileWriter(os.path.join(log_dir, "tb"))

    def log(self, step: int, metrics: dict) -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            record[k] = float(v)
            self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_images(self, step: int, images: dict) -> None:
        """HWC uint8 images (reference tf.summary.image, define_estimator_hierarchical.py:317-378)."""
        for k, v in images.items():
            self._tb.add_image(k, np.asarray(v), int(step), dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        self._tb.close()


def default_profile_every(settings: Settings, num_steps: int) -> int:
    """The reference _RunMetadataHook cadence: every
    max(num_training_steps // 50, save_checkpoints_steps) steps."""
    return max(num_steps // 50, settings.save_checkpoints_steps or 1)


@contextlib.contextmanager
def statistics_kept(model: torch.nn.Module):
    """Run a train-mode forward without moving the BatchNorm running
    statistics: the model's buffers are put back on exit."""
    saved = [(b, b.detach().clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def _image_summaries(model, batch, palette, weight_masks) -> dict:
    """Colorized decisions and labels of the first per-pixel image, and the
    loss weight masks (reference define_losses_hierarchical.py:140,167,187)."""
    img = batch["proimages_per_pixel"][:1]
    # rank 0 alone runs this forward, on the whole image: no collective (no
    # BatchNorm all-reduce, no halo exchange)
    with torch.no_grad(), statistics_kept(model), pmesh.alone():
        decs = model(img)["decisions"][0].cpu().numpy()
    labels = batch["prolabels_per_pixel"][0].cpu().numpy()
    k = len(palette)
    images = {
        "proimage": ((img[0].float().cpu().numpy() + 1.0) * 127.5).astype(np.uint8),
        "decisions": palette[np.clip(decs, 0, k - 1)],
        "prolabels": palette[np.clip(labels, 0, k - 1)],
    }
    for name, m in (weight_masks or {}).items():
        m8 = (np.clip(m.float().cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        images[f"debug/{name}"] = m8[..., None]
    return images


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _state_tensors(state: TrainState, fused_opt: Optional[FusedSGDM]) -> list:
    """Every tensor of the train state, for the broadcast from rank 0."""
    model = state.model
    if fused_opt is not None:
        opt = state.opt_state
        out = [fused_opt.params, opt.momentum, opt.ema_biased, opt.ema_decay_product]
    else:
        out = [p.data for p in model.parameters()]
        out += [s["momentum_buffer"] for s in state.opt_state.state.values()
                if s.get("momentum_buffer") is not None]
        if state.ema is not None:
            out += list(state.ema.biased.values()) + [state.ema.decay_product]
    return out + list(model.buffers()) + [state.step]


def train(settings: Settings, batch_iterator: Iterator[dict], model=None, log_every: int = 20,
          profile_every: Optional[int] = None, max_steps: Optional[int] = None,
          image_summaries: bool = True) -> TrainState:
    """Train to ``max_steps`` (default ``settings.num_training_steps``);
    returns the final state.

    ``model``: a train-mode model whose current weights are the initial
    values; default ``build_model`` on ``settings.device`` with flax's
    initial values drawn from seed 0. ``profile_every=N`` traces one step
    every N steps.
    """
    settings = settings.replace(mode="train")
    if settings.optimizer not in ("SGD", "SGDM"):
        raise ValueError(f"unknown optimizer {settings.optimizer}")
    mesh = multihost.initialize(settings)
    primary = multihost.is_primary()
    if model is None:
        model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    device = _device_of(model)
    if settings.fused_optimizer:
        fused_opt = FusedSGDM(settings, model)
        state, layout, lr_fn = create_fused_train_state(fused_opt), fused_opt.layout, fused_opt.lr_fn
    else:
        fused_opt, layout = None, None
        tx, lr_fn = make_optimizer(settings, model)
        state = create_train_state(model, tx, settings.ema_decay)

    ckpt = CheckpointManager(settings.log_dir, async_save=settings.async_checkpoints,
                             primary=primary)
    logger = None
    prev_sigterm = None
    try:
        latest = ckpt.latest_step()
        if latest is not None:
            if settings.init_ckpt_path:
                raise ValueError("If init_ckpt_path is given log_dir must be empty of "
                                 "checkpoints; resume and warm start are mutually exclusive.")
            state = ckpt.restore(latest, state, layout)
        elif settings.init_ckpt_path:
            n = warm_start_from_npz(model, settings.init_ckpt_path)
            if primary:
                print(f"warm start: restored {n} backbone arrays from "
                      f"{settings.init_ckpt_path}")
        if mesh is not None:
            pmesh.replicate(_state_tensors(state, fused_opt), mesh)

        step_fn = make_train_step(settings, model=model, fused_opt=fused_opt)
        logger = MetricsLogger(settings.log_dir) if primary else None
        num_steps = max_steps or settings.num_training_steps
        save_every = settings.save_checkpoints_steps or max(num_steps, 1)
        summary_every = max(settings.save_summaries_steps, 1)
        palette = None
        if image_summaries and primary and settings.num_processes == 1:
            palette = load_problem_def(settings.training_problem_def_path).palette()
        images_per_batch = settings.Nb_per_pixel + settings.Nb_per_bbox + settings.Nb_per_image

        # preemption: finish the step in flight, save at the true step and
        # return. Handlers install only from the main thread; elsewhere the
        # caller's handler stays and the feature is off.
        preempted = threading.Event()
        try:
            prev_sigterm = signal.signal(signal.SIGTERM, lambda signum, frame: preempted.set())
        except ValueError:
            pass

        step = int(state.step)
        t_last = time.time()
        steps_since_log = 0
        profiler = None
        for batch in device_prefetch(batch_iterator, device):
            if step >= num_steps:
                break
            stop = preempted.is_set()
            if mesh is not None:
                stop = pmesh.host_flag_any(stop, mesh)
            if stop:
                ckpt.save(step, state, layout)
                ckpt.wait_until_finished()
                if mesh is not None:
                    pmesh.barrier(mesh)
                if primary:
                    print(f"preempted (SIGTERM): saved checkpoint at step {step} and exiting; "
                          "resume by re-running on this log_dir")
                break
            if primary and profile_every and step > 0 and step % profile_every == 0:
                profiler = _start_profiler(device)
                trace_dir = os.path.join(settings.log_dir, "profile", f"step_{step}")
            state, metrics = step_fn(state, {k: v for k, v in batch.items()
                                             if not isinstance(v, list)})
            step += 1
            steps_since_log += 1
            weight_masks = metrics.pop("weight_masks", None)
            if profiler is not None:
                _stop_profiler(profiler, device, trace_dir)
                profiler = None
            if logger is not None and (step % log_every == 0 or step == num_steps):
                host = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                host["learning_rate"] = float(lr_fn(torch.tensor(step, dtype=torch.int64)))
                host["images_per_sec"] = steps_since_log * images_per_batch / max(now - t_last,
                                                                                  1e-9)
                t_last, steps_since_log = now, 0
                logger.log(step, host)
            if palette is not None and step % summary_every == 0:
                try:
                    logger.log_images(step, _image_summaries(model, batch, palette,
                                                             weight_masks))
                except (RuntimeError, ValueError, IndexError, KeyError) as e:
                    # warn once, then stop trying
                    warnings.warn(f"image summaries disabled after error: {e!r}")
                    palette = None
            if step % save_every == 0 or step == num_steps:
                ckpt.save(step, state, layout)
                if mesh is not None:
                    pmesh.barrier(mesh)
                t_last = time.time()  # checkpoint time is not training throughput
    finally:
        # restore the caller's SIGTERM disposition and flush every writer,
        # also when a step raised
        if prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, prev_sigterm)
            except ValueError:
                pass
        if logger is not None:
            logger.close()
        ckpt.close()
    if mesh is not None:
        # every rank returns once rank 0's writes have landed
        pmesh.barrier(mesh)
    return state


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, device: torch.device, trace_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

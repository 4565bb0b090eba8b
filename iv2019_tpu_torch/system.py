"""The SemanticSegmentation system of the PyTorch port: train, evaluate, predict.

Port of iv2019_tpu/system.py (reference system_factory.py:27-461):
``SemanticSegmentation(input_fns, model_fn, settings)`` loads the
problem definitions and derives ``output_Nclasses``, the
training-to-inference and training-to-evaluation cid maps, the finalized
settings and the ``eval_NN`` directory numbering; ``train()`` writes
``settings.txt`` (refusing to overwrite one), snapshots the port's code into
``all_code.zip`` and runs train/loop.py; ``evaluate()`` writes
``eval_NN/settings.txt`` and, for each checkpoint ``checkpoint_steps``
names (all of them with ``--eval_all_ckpts``), restores the trained weights
and sums the eval step's confusion matrices over ``Neval // Nb`` batches,
returning one metrics dict per checkpoint; ``predict()`` restores the
trained weights and yields one predictions dict per image. Weights come
from ``restore_variables``: a checkpoint of the port's training run, or a
converted ``.npz``.

Across ranks (parallel/multihost.py): ``train()`` trains data-parallel and
writes ``settings.txt`` and ``all_code.zip`` on rank 0; ``evaluate()``
sweeps the checkpoints as JAX's multi-process sweep does (system.py:292-384):
checkpoint i goes to host i % hosts (a host: one launch of the entry point),
whose batch shards take their rows of each batch (grouped to at least their
number of rows, padded up to a multiple of it), and one all-reduce of the
zero-filled (checkpoints, K, K) int64 stack gives every rank every matrix.
Under ``spatial_partitions`` P the P ranks of a spatial group hold the same
rows and each evaluates its band of them (``make_eval_step``); as in JAX,
eval on a spatial mesh runs in one process only (JAX system.py:304-310), and
TTA and sliding windows refuse it (config.py).
"""

from __future__ import annotations

import glob
import itertools
import os
from os.path import exists, isdir, join, split
from typing import Callable, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input.prefetch import device_prefetch
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import EmaState, create_fused_train_state
from iv2019_tpu_torch.train.step import make_eval_step
from iv2019_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from iv2019_tpu_torch.utils.convert import (
    flax_variables,
    load_flax_variables,
    restore_trained_from_npz,
)
from iv2019_tpu_torch.utils.metrics import print_metrics_from_confusion_matrix
from iv2019_tpu_torch.utils.util_zip import zipit

__all__ = ["SemanticSegmentation", "checkpoint_steps", "restore_variables"]


def build_initialized_model(settings: Settings) -> torch.nn.Module:
    """``build_model`` with flax's initial values drawn from seed 0 (the
    JAX loop's ``model.init(PRNGKey(0), ...)``)."""
    return init_model(build_model(settings), torch.Generator().manual_seed(0))


def _pad_rows(v: np.ndarray, n: int) -> np.ndarray:
    """``v`` with ``n`` rows more: zero images, out-of-range labels (-1 for
    signed, the maximum for unsigned), which the confusion matrix drops."""
    pad = np.zeros((n,) + v.shape[1:], v.dtype)
    if np.issubdtype(v.dtype, np.integer):
        pad[:] = -1 if np.issubdtype(v.dtype, np.signedinteger) else np.iinfo(v.dtype).max
    return np.concatenate([v, pad], axis=0)


def _group_eval_batches(batches, group: int):
    """Concatenate consecutive eval batches into multiples of ``group`` rows
    (iv2019_tpu/system.py:45-109; one rank is group 1).

    Batches whose array shapes match are stacked along the leading axis; a
    shape change flushes the buffer. A final (or flushed) partial group is
    padded up to ``group`` rows with zero images and out-of-range labels
    (-1 for signed, the maximum for unsigned), which the confusion matrix
    drops.
    """
    if group <= 1:
        yield from batches
        return

    def _sig(b):
        return tuple(
            (k, v.shape[1:], v.dtype.str) for k, v in sorted(b.items())
            if isinstance(v, np.ndarray)
        )

    def _flush(buf, pad_to=0):
        out = {}
        for k, v in buf[0].items():
            if isinstance(v, np.ndarray):
                cat = np.concatenate([b[k] for b in buf], axis=0) if len(buf) > 1 else v
                short = pad_to - cat.shape[0]
                out[k] = _pad_rows(cat, short) if short > 0 else cat
            elif isinstance(v, (list, tuple)):
                out[k] = [x for b in buf for x in b[k]]
            else:
                out[k] = v if len(buf) == 1 else [b[k] for b in buf]
        return out

    def _rows(b):
        return next(
            (v.shape[0] for v in b.values() if isinstance(v, np.ndarray)), 1
        )

    buf: list[dict] = []
    sig = None
    for b in batches:
        s = _sig(b)
        if buf and s != sig:
            yield _flush(buf, pad_to=group)
            buf = []
        buf.append(b)
        sig = s
        if sum(_rows(x) for x in buf) >= group:
            yield _flush(buf)
            buf = []
    if buf:
        yield _flush(buf, pad_to=group)


def checkpoint_steps(settings: Settings) -> list[Union[int, str, None]]:
    """The checkpoints to restore (JAX system.py:388-405): with
    ``eval_all_ckpts`` every saved step of ``log_dir/checkpoints`` in step
    order; else ``ckpt_path`` as a converted ``.npz``, a step number or a
    path ending in one; without it the latest saved step (None if there is
    none)."""
    ckpt_dir = join(settings.log_dir, "checkpoints")
    if settings.eval_all_ckpts:
        steps = CheckpointManager(settings.log_dir).all_steps() if isdir(ckpt_dir) else []
        print(f"\n{len(steps)} checkpoint(s) will be evaluated.\n")
        return steps
    if settings.ckpt_path is not None:
        if str(settings.ckpt_path).endswith(".npz"):
            return [settings.ckpt_path]
        try:
            return [int(settings.ckpt_path)]
        except ValueError:
            return [int(os.path.basename(str(settings.ckpt_path).rstrip("/")))]
    return [CheckpointManager(settings.log_dir).latest_step() if isdir(ckpt_dir) else None]


def restore_variables(model: torch.nn.Module, settings: Settings,
                      step: Union[int, str, None] = None) -> str:
    """Load the trained weights into ``model`` in place (JAX system.py:407):
    checkpoint ``step`` of the port's training run in ``settings.log_dir``
    (None: ``checkpoint_steps``), of either kind (fused optimizer or optax
    path), or a converted ``.npz``. With ``restore_emas`` the zero-debiased
    EMA shadow replaces the parameters (BatchNorm statistics have none; on
    the optax path ``EmaState.debiased(fallback=params)``). Returns what was
    restored, for the log."""
    if step is None:
        (step,) = checkpoint_steps(settings)
    if isinstance(step, str) and step.endswith(".npz"):
        params, batch_stats, n = restore_trained_from_npz(
            flax_variables(model), step, restore_emas=settings.restore_emas)
        load_flax_variables(model, params, batch_stats)
        return f"{n} variables from converted checkpoint {step}"
    ckpt_dir = join(settings.log_dir, "checkpoints")
    if step is None or not exists(join(ckpt_dir, str(step), STATE_FILE)):
        raise FileNotFoundError(
            f"no checkpoint {'' if step is None else step} in {ckpt_dir}: give --ckpt_path a "
            "step the training run saved, a path ending in one, or a converted model.npz")
    manager = CheckpointManager(settings.log_dir)
    snap = manager.load(step)
    if snap["kind"] == "optax":
        with torch.no_grad():
            model.load_state_dict(snap["model"], strict=True)
            if settings.restore_emas:
                if snap["ema_biased"] is None:
                    raise ValueError(f"checkpoint {step} holds no EMA (ema_decay 0): "
                                     "drop --restore_emas")
                params = dict(model.named_parameters())
                ema = EmaState(biased=snap["ema_biased"], decay_product=snap["ema_decay_product"])
                for name, value in ema.debiased(
                        fallback={k: p.detach().cpu() for k, p in params.items()}).items():
                    params[name].copy_(value)
    else:
        # the fused optimizer's layout and state, only to read the checkpoint:
        # the parameters become views of its flat buffer, the gradients are
        # dropped
        opt = FusedSGDM(settings, model)
        state = manager.restore(step, create_fused_train_state(opt), opt.layout, snap=snap)
        if settings.restore_emas:
            ema = opt.ema_params(state.opt_state)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(ema[name])
        for p in model.parameters():
            p.grad = None
    return (f"checkpoint {step} of {ckpt_dir}"
            + (" (EMA weights)" if settings.restore_emas else ""))


def _rows_of(batches, index: int, count: int):
    """Shard ``index`` of ``count`` of each batch's array rows.

    A batch whose rows do not divide by ``count`` (a group of
    ``_group_eval_batches`` is at least ``count`` rows, not a multiple of
    it) is padded up to a multiple with ``_pad_rows``, which adds no pixel to
    the matrix (JAX replicates such a batch over its chips instead). Other
    values, the paths, stay whole: the eval step reads only the arrays.
    """
    for b in batches:
        out = {}
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                if len(v) % count:
                    v = _pad_rows(v, -len(v) % count)
                v = pmesh.shard_rows(v, index, count)
            out[k] = v
        yield out


class SemanticSegmentation:
    """A semantic-segmentation system on one device or across ranks.

    Args:
      input_fns: {'train' | 'eval' | 'predict': f(settings, problem_def) ->
        iterator of host batches} (input/heterogeneous.py:train_input,
        input/cityscapes.py:evaluate_input; predict takes the inference
        problem definition).
      model_fn: f(settings) -> model with its initial weights; default
        ``build_initialized_model``.
      settings: a Settings (config.build_argparser for the command line).
    """

    def __init__(self, input_fns: Mapping[str, Callable], model_fn: Optional[Callable] = None,
                 settings: Optional[Settings] = None):
        if settings is None:
            raise ValueError("settings must be provided.")
        self._input_fns = dict(input_fns)
        self._model_fn = model_fn or build_initialized_model
        self.training_problem_def = load_problem_def(settings.training_problem_def_path)
        self.inference_problem_def = (
            load_problem_def(settings.inference_problem_def_path)
            if settings.inference_problem_def_path else self.training_problem_def)
        self.evaluation_problem_def = (
            load_problem_def(settings.evaluation_problem_def_path)
            if settings.evaluation_problem_def_path else self.training_problem_def)
        self.output_Nclasses = self.training_problem_def.output_num_classes(
            settings.train_void_class)
        self.training_cids2inference_cids = (
            self.inference_problem_def.training_cids2inference_cids
            if self.inference_problem_def.training_cids2inference_cids is not None
            else self.training_problem_def.inference_cids_map(settings.train_void_class))
        self.training_cids2evaluation_cids = (
            self.evaluation_problem_def.training_cids2evaluation_cids
            if self.evaluation_problem_def.training_cids2evaluation_cids is not None
            else self.training_problem_def.evaluation_cids_map(settings.train_void_class))
        self._settings = settings.finalize()
        # eval-dir numbering eval_NN (system_factory.py:164-172)
        existing = [d for d in glob.glob(join(self._settings.log_dir, "eval_*")) if isdir(d)]
        max_cnt = max((int(split(d)[1][-2:]) for d in existing), default=-1)
        self.eval_res_dir = join(self._settings.log_dir, f"eval_{max_cnt + 1:02}")

    @property
    def settings(self) -> Settings:
        return self._settings

    def train(self, max_steps: Optional[int] = None, log_every: int = 20,
              profile_every: Optional[int] = None):
        """Train (train/loop.py) into ``settings.log_dir``; returns the final state."""
        from iv2019_tpu_torch.train.loop import default_profile_every, train as run_train

        s = self._settings
        # before the input pipelines, which split by rank
        mesh = multihost.initialize(s)
        os.makedirs(s.log_dir, exist_ok=True)
        settings_path = join(s.log_dir, "settings.txt")
        if exists(settings_path):
            raise FileExistsError(f"Previous settings.txt found in {s.log_dir}. Rename or "
                                  "delete it manually and restart training.")
        if mesh is not None:
            # every rank has looked before rank 0 writes
            pmesh.barrier(mesh)
        if multihost.is_primary():
            s.dump(settings_path)
            # code snapshot (reference train.py:38)
            zipit(os.path.dirname(os.path.abspath(__file__)), join(s.log_dir, "all_code.zip"))

        batches = self._input_fns["train"](s, self.training_problem_def)
        model = self._model_fn(s.replace(mode="train"))
        if profile_every is None:
            # the reference's periodic traces (define_estimator_hierarchical.py:408-474)
            profile_every = default_profile_every(s, max_steps or s.num_training_steps)
        return run_train(s, batches, model=model, max_steps=max_steps, log_every=log_every,
                         profile_every=profile_every)

    def predict(self) -> Iterator[dict]:
        """Yields one numpy predictions dict per image of
        ``input_fns['predict'](settings, inference_problem_def)``, from the
        weights ``restore_variables`` finds (JAX system.py:231)."""
        from iv2019_tpu_torch.predict_cli import predict, restore_model

        s = self._settings
        model = self._model_fn(s.replace(mode="predict"))
        restore_model(model, s)
        yield from predict(s, model, self._input_fns["predict"](s, self.inference_problem_def))

    def evaluate(self) -> list[dict]:
        """One metrics dict per checkpoint of ``checkpoint_steps`` (JAX
        system.py:292-384): ``global_step``, the int64 ``confusion_matrix``
        over ``Neval // Nb`` batches of ``input_fns['eval'](settings,
        evaluation_problem_def)`` (without the void row and column unless
        ``train_void_class``), and the metrics of
        ``print_metrics_from_confusion_matrix``, which rank 0 also prints.
        Across ranks every rank returns every checkpoint's metrics (see the
        module docstring)."""
        s = self._settings
        if s.num_processes != 1 and s.spatial_partitions > 1:
            raise NotImplementedError(
                "multi-process eval runs a per-process data mesh; "
                "spatial_partitions composes with multi-process training "
                "only.")
        mesh = multihost.initialize(s)
        primary = multihost.is_primary()
        if primary:
            os.makedirs(self.eval_res_dir, exist_ok=True)
            s.dump(join(self.eval_res_dir, "settings.txt"))
        steps = checkpoint_steps(s)
        model = self._model_fn(s.replace(mode="eval"))
        device = next(model.parameters()).device
        eval_fn = make_eval_step(s, model=model, tcids2ecids=self.training_cids2evaluation_cids)
        labels = list(self.evaluation_problem_def.cids2labels)
        void_exists = -1 in self.evaluation_problem_def.lids2cids
        if void_exists and not s.train_void_class:
            labels = labels[:-1]
        # one epoch: Neval examples (reference system_factory.py:338-342)
        num_eval_steps = max(int(s.Neval / max(s.Nb, 1)), 1)
        hosts, host = (mesh.num_hosts, mesh.host) if mesh else (1, 0)
        # the host's batch shards take rows; a spatial group's ranks then
        # take bands of the same rows (make_eval_step)
        p = mesh.spatial if mesh else 1
        ranks, index = (mesh.local_size // p, mesh.local_rank // p) if mesh else (1, 0)
        cms = {}
        for i, step in enumerate(steps):
            if i % hosts != host:
                continue  # another host's checkpoint
            restored = restore_variables(model, s, step)
            if primary:
                print(f"restored {restored}")
            cm = None
            batches = itertools.islice(self._input_fns["eval"](s, self.evaluation_problem_def),
                                       num_eval_steps)
            batches = _rows_of(_group_eval_batches(batches, ranks), index, ranks)
            for batch in device_prefetch(batches, device):
                bcm = eval_fn(batch["proimages"], batch["prolabels"])
                cm = bcm if cm is None else cm + bcm
            if cm is None:
                raise ValueError("the eval input yielded no batch")
            # void row/col trim (system_factory.py:399-405)
            if void_exists and not s.train_void_class:
                cm = cm[:-1, :-1]
            cms[i] = cm
        if mesh is not None:
            # each matrix in its checkpoint's slot, zeros elsewhere; summed in
            # int64 (the counts pass 2^24, so never in f32)
            k = len(labels)
            stack = torch.zeros((len(steps), k, k), dtype=torch.int64, device=device)
            for i, cm in cms.items():
                stack[i] = cm
            pmesh.all_reduce(stack, mesh)
            cms = dict(enumerate(stack))
        all_metrics = []
        for i, step in enumerate(steps):
            cm = cms[i].cpu().numpy().astype(np.int64)
            metrics = {"global_step": step, "confusion_matrix": cm}
            metrics.update(print_metrics_from_confusion_matrix(cm, labels, printcmd=primary))
            all_metrics.append(metrics)
        return all_metrics

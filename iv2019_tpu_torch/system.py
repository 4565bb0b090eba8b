"""The SemanticSegmentation system of the PyTorch port: training and prediction.

Port of iv2019_tpu/system.py:112-288,388-490 (reference
system_factory.py:27-461): ``SemanticSegmentation(input_fns, model_fn,
settings)`` loads the problem definitions and derives ``output_Nclasses``,
the training-to-inference and training-to-evaluation cid maps, the
finalized settings and the ``eval_NN`` directory numbering; ``train()``
writes ``settings.txt`` (refusing to overwrite one), snapshots the port's
code into ``all_code.zip`` and runs train/loop.py; ``predict()`` restores
the trained weights (``restore_variables``: a checkpoint of the port's
training run, or a converted ``.npz``) and yields one predictions dict per
image. ``evaluate`` and ``--eval_all_ckpts`` are not ported yet (ROADMAP.md
A10a).
"""

from __future__ import annotations

import glob
import os
from os.path import exists, isdir, join, split
from typing import Callable, Iterator, Mapping, Optional, Union

import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from iv2019_tpu_torch.utils.convert import (
    flax_variables,
    load_flax_variables,
    restore_trained_from_npz,
)
from iv2019_tpu_torch.utils.util_zip import zipit

__all__ = ["SemanticSegmentation", "checkpoint_steps", "restore_variables"]


def build_initialized_model(settings: Settings) -> torch.nn.Module:
    """``build_model`` with flax's initial values drawn from seed 0 (the
    JAX loop's ``model.init(PRNGKey(0), ...)``)."""
    return init_model(build_model(settings), torch.Generator().manual_seed(0))


def checkpoint_steps(settings: Settings) -> list[Union[int, str, None]]:
    """The checkpoints to restore (JAX system.py:388, without
    ``--eval_all_ckpts``): ``ckpt_path`` as a converted ``.npz``, a step
    number or a path ending in one; without it the latest step of
    ``log_dir/checkpoints`` (None if there is none)."""
    if settings.ckpt_path is not None:
        if str(settings.ckpt_path).endswith(".npz"):
            return [settings.ckpt_path]
        try:
            return [int(settings.ckpt_path)]
        except ValueError:
            return [int(os.path.basename(str(settings.ckpt_path).rstrip("/")))]
    ckpt_dir = join(settings.log_dir, "checkpoints")
    return [CheckpointManager(settings.log_dir).latest_step() if isdir(ckpt_dir) else None]


def restore_variables(model: torch.nn.Module, settings: Settings,
                      step: Union[int, str, None] = None) -> str:
    """Load the trained weights into ``model`` in place (JAX system.py:407):
    checkpoint ``step`` of the port's training run in ``settings.log_dir``
    (None: ``checkpoint_steps``), or a converted ``.npz``. With
    ``restore_emas`` the zero-debiased EMA shadow of the fused optimizer
    replaces the parameters (BatchNorm statistics have none). Returns what
    was restored, for the log."""
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
    # the fused optimizer's layout and state, only to read the checkpoint: the
    # parameters become views of its flat buffer, the gradients are dropped
    opt = FusedSGDM(settings, model)
    state = CheckpointManager(settings.log_dir).restore(step, create_fused_train_state(opt),
                                                        opt.layout)
    if settings.restore_emas:
        ema = opt.ema_params(state.opt_state)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(ema[name])
    for p in model.parameters():
        p.grad = None
    return (f"checkpoint {step} of {ckpt_dir}"
            + (" (EMA weights)" if settings.restore_emas else ""))


class SemanticSegmentation:
    """A semantic-segmentation system on one device.

    Args:
      input_fns: {'train': f(settings, problem_def) -> iterator of host
        batches} (input/heterogeneous.py:train_input is the default one).
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
        os.makedirs(s.log_dir, exist_ok=True)
        settings_path = join(s.log_dir, "settings.txt")
        if exists(settings_path):
            raise FileExistsError(f"Previous settings.txt found in {s.log_dir}. Rename or "
                                  "delete it manually and restart training.")
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

    def evaluate(self):
        raise NotImplementedError("SemanticSegmentation.evaluate is not ported yet "
                                  "(ROADMAP.md A10a)")

"""The SemanticSegmentation system of the PyTorch port: the training run.

Port of iv2019_tpu/system.py:112-227 (reference system_factory.py:27-461):
``SemanticSegmentation(input_fns, model_fn, settings)`` loads the problem
definitions and derives ``output_Nclasses``, the training-to-inference and
training-to-evaluation cid maps, the finalized settings and the
``eval_NN`` directory numbering; ``train()`` writes ``settings.txt``
(refusing to overwrite one), snapshots the port's code into
``all_code.zip`` and runs train/loop.py. ``evaluate`` and ``predict`` are
not ported yet (ROADMAP.md A10): the port predicts through predict_cli.py.
"""

from __future__ import annotations

import glob
import os
from os.path import exists, isdir, join, split
from typing import Callable, Mapping, Optional

import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.utils.util_zip import zipit

__all__ = ["SemanticSegmentation"]


def build_initialized_model(settings: Settings) -> torch.nn.Module:
    """``build_model`` with flax's initial values drawn from seed 0 (the
    JAX loop's ``model.init(PRNGKey(0), ...)``)."""
    return init_model(build_model(settings), torch.Generator().manual_seed(0))


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

    def predict(self):
        raise NotImplementedError("SemanticSegmentation.predict is not ported yet (ROADMAP.md "
                                  "A10); predict with iv2019_tpu_torch.predict_cli")

    def evaluate(self):
        raise NotImplementedError("SemanticSegmentation.evaluate is not ported yet "
                                  "(ROADMAP.md A10)")

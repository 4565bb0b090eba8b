"""The program under test, built through its entry functions only.

``iv2019_tpu_torch``'s ``config.Settings``, ``models/model.py::build_model``,
``train/step.py`` (``make_train_step``, ``make_eval_step``),
``train/fused_update.py::FusedSGDM`` and ``train/state.py``. A
configuration states the model and its training; every implementation
switch of ``Settings`` stays at the program's default, so that a change of
default is what these cells measure. The seeded weights are loaded by the
model's published names (``load_state_dict``, strict).
"""

from __future__ import annotations

import torch

__all__ = ["eval_step", "settings", "train_step"]


def settings(cfg: dict, mix: dict, device, mode: str, problem_path: str):
    """The program's Settings for a configuration and a traffic mix."""
    from iv2019_tpu_torch.config import Settings

    kw = dict(
        per_pixel_dataset_name=cfg["dataset"], device=device.type, mode=mode,
        height_feature_extractor=mix["height"], width_feature_extractor=mix["width"],
        name_feature_extractor=cfg["feature_extractor"],
        stride_feature_extractor=cfg["output_stride"],
        feature_dims_decreased=cfg["feature_dims_decreased"], psp_module=cfg["psp_module"],
        upsampling_method=cfg["upsampling_method"], compute_dtype=cfg["compute_dtype"],
        batch_norm_decay=cfg["batch_norm_decay"], training_problem_def_path=problem_path)
    if mode == "train":
        kw.update(
            Nb_per_pixel=mix["per_pixel"], Nb_per_bbox=mix["per_bbox"],
            Nb_per_image=mix["per_image"], Nb=mix["per_pixel"], Ntrain=cfg["Ntrain"],
            optimizer=cfg["optimizer"], momentum=cfg["momentum"],
            regularization_weight=cfg["weight_decay"], ema_decay=cfg["ema_decay"],
            learning_rate_values=tuple(cfg["learning_rate_values"]),
            learning_rate_boundaries=tuple(cfg["learning_rate_boundaries_epochs"]),
            weak_loss_coefficient=cfg["weak_loss_coefficient"])
        return Settings(**kw).finalize()
    kw.update(Nb=mix["images"], fused_block=bool(mix.get("fused_block", False)))
    return Settings(**kw)


def _model(s, weights: dict):
    from iv2019_tpu_torch.models.model import build_model

    model = build_model(s)
    with torch.no_grad():
        model.load_state_dict(weights, strict=True)
    return model


def train_step(s, weights: dict):
    """(model, optimizer, state, step) as the training command line builds
    them: the fused optimizer's flat state and ``make_train_step``."""
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    model = _model(s, weights)
    opt = FusedSGDM(s, model)
    return model, opt, create_fused_train_state(opt), make_train_step(s, fused_opt=opt)


def eval_step(s, weights: dict):
    """(model, step) as the evaluation command line builds them."""
    from iv2019_tpu_torch.train.step import make_eval_step

    model = _model(s, weights)
    return model, make_eval_step(s, model=model)

"""Predict and evaluate steps of the PyTorch port.

Port of iv2019_tpu/train/step.py without its test-time-augmentation and
sliding-window branches:

- ``make_predict_step``: forward -> the four supported outputs, resized to
  the system size (or a given ``output_size``) with align_corners=True,
  optional top-2 void replacement (step.py:843-934);
- ``make_eval_step``: forward -> training-to-evaluation cid remap ->
  optional void replacement -> nearest resize to the label size -> the
  batch confusion matrix (step.py:436-486).

A step runs on the model's device, under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.ops.confusion import confusion_matrix
from iv2019_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from iv2019_tpu_torch.ops.segment_ops import gather_cids, remap_probabilities
from iv2019_tpu_torch.problem.problem_def import load_problem_def, replace_voids
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

__all__ = ["PROB_KEYS", "forward", "make_eval_step", "make_predict_step", "settings_eval_map"]

PROB_KEYS = ("l1_probabilities", "l2_vehicle_probabilities", "l2_human_probabilities")


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def forward(model: torch.nn.Module, images) -> dict:
    """Eval-mode forward of NHWC images (tensor or numpy) on the model's device."""
    images = torch.as_tensor(images, dtype=torch.float32, device=_device_of(model))
    with torch.inference_mode():
        return model(images)


def settings_eval_map(settings: Settings):
    """training_cids2evaluation_cids from the settings' problem definitions."""
    train_pd = load_problem_def(settings.training_problem_def_path)
    if settings.evaluation_problem_def_path:
        eval_pd = load_problem_def(settings.evaluation_problem_def_path)
        if eval_pd.training_cids2evaluation_cids is not None:
            return list(eval_pd.training_cids2evaluation_cids)
    return train_pd.evaluation_cids_map(settings.train_void_class)


def _replace_void_decisions(probs: torch.Tensor, decs: torch.Tensor) -> torch.Tensor:
    """Where the decision is the void class (the last channel of ``probs``),
    take the second most probable class instead (reference _replace_voids)."""
    top2 = torch.topk(probs, 2, dim=-1).indices
    void_mask = decs == probs.shape[-1] - 1
    return torch.where(void_mask, top2[..., 1], top2[..., 0]).int()


def _pad_channels(probs: torch.Tensor, num: int) -> torch.Tensor:
    pad = num - probs.shape[-1]
    return F.pad(probs, (0, pad)) if pad > 0 else probs


def make_eval_step(settings: Settings, model=None, tcids2ecids=None) -> Callable:
    """Returns eval_step(images, prolabels) -> (K', K') int64 confusion matrix."""
    settings = settings.replace(mode="eval")
    model = model or build_model(settings)
    if tcids2ecids is None:
        tcids2ecids = settings_eval_map(settings)
    tcids2ecids = replace_voids(list(tcids2ecids))
    num_eval_classes = max(tcids2ecids) + 1
    tax = get_taxonomy(settings.per_pixel_dataset_name)
    # L1 -> common -> eval, so the probability remap matches the fused decisions
    l1_cids2ecids = [tcids2ecids[c] for c in tax.l1_cids2common_cids]

    def eval_step(images, prolabels) -> torch.Tensor:
        preds = forward(model, images)
        prolabels = torch.as_tensor(prolabels, device=preds["decisions"].device)
        decs = gather_cids(tcids2ecids, preds["decisions"])
        if settings.replace_voids:
            l1_probs = remap_probabilities(preds["l1_probabilities"], l1_cids2ecids)
            decs = _replace_void_decisions(_pad_channels(l1_probs, num_eval_classes), decs)
        decs = resize_nearest(decs, prolabels.shape[1:3], align_corners=True)
        return confusion_matrix(prolabels, decs, num_eval_classes)

    return eval_step


def make_predict_step(settings: Settings, output_size: Optional[tuple[int, int]] = None,
                      model=None) -> Callable:
    """Returns predict_step(images) -> dict of the four predict outputs (NHWC)."""
    settings = settings.replace(mode="predict")
    model = model or build_model(settings)
    if output_size is None and settings.height_system and settings.width_system:
        output_size = (settings.height_system, settings.width_system)
    tax = get_taxonomy(settings.per_pixel_dataset_name)

    def predict_step(images) -> dict:
        preds = forward(model, images)
        out = {k: preds[k] for k in PROB_KEYS + ("decisions",)}
        with torch.inference_mode():
            if output_size is not None:
                for k in PROB_KEYS:
                    out[k] = resize_bilinear(out[k], output_size, align_corners=True)
                out["decisions"] = resize_nearest(out["decisions"], output_size, align_corners=True)
            if settings.replace_voids:
                # L1 probabilities in the common space, the decisions' space
                common = remap_probabilities(out["l1_probabilities"], tax.l1_cids2common_cids)
                out["decisions"] = _replace_void_decisions(
                    _pad_channels(common, tax.num_common_classes), out["decisions"])
        return out

    return predict_step

"""Train, predict and evaluate steps of the PyTorch port.

Port of iv2019_tpu/train/step.py without its test-time-augmentation and
sliding-window branches:

- ``make_train_step``: one training step of the mixed [pp | pb | pi] batch
  (step.py:104-433): train-mode forward, the hierarchical losses (fused
  from stride-8 logits through kernels B1/B2 when the gate admits it, else
  ``define_losses`` on the upsampled logits), backward into the fused
  optimizer's flat gradient vector, the fused SGDM + weight-decay + EMA
  update (kernel B3), the batch mIoU and the summaries' weight masks;
- ``make_predict_step``: forward -> the four supported outputs, resized to
  the system size (or a given ``output_size``) with align_corners=True,
  optional top-2 void replacement (step.py:843-934);
- ``make_eval_step``: forward -> training-to-evaluation cid remap ->
  optional void replacement -> nearest resize to the label size -> the
  batch confusion matrix (step.py:436-486).

The predict and eval steps run on the model's device, under
``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.losses.hierarchical import define_losses
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.ops.confusion import batch_mean_iou, confusion_matrix
from iv2019_tpu_torch.ops.fused_loss import define_losses_fused, fused_loss_available
from iv2019_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from iv2019_tpu_torch.ops.segment_ops import gather_cids, remap_probabilities, segment_sum_channels
from iv2019_tpu_torch.problem.problem_def import load_problem_def, replace_voids
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import TrainState

__all__ = ["PROB_KEYS", "forward", "make_eval_step", "make_predict_step", "make_train_step",
           "settings_eval_map"]

PROB_KEYS = ("l1_probabilities", "l2_vehicle_probabilities", "l2_human_probabilities")


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def forward(model: torch.nn.Module, images) -> dict:
    """Eval-mode forward of NHWC images (tensor or numpy) on the model's device."""
    images = torch.as_tensor(images, dtype=torch.float32, device=_device_of(model))
    with torch.inference_mode():
        return model(images)


def _summary_weight_masks(labels, l1_decisions, tax, weak_ix):
    """Loss weight masks of one example per head, for summaries only (the
    fused loss keeps the full-batch weights to itself; step.py:48-92)."""
    pp = labels["prolabels_per_pixel"]
    l1_mask = (gather_cids(tax.per_pixel_cids2l1_cids, pp[0]) != tax.num_l1_classes - 1).float()
    pb, pi = labels["prolabels_per_bbox"], labels["prolabels_per_image"]
    if pb.shape[0] or pi.shape[0]:
        weak0 = pb[0] if pb.shape[0] else pi[0]

        def weak_mask(table, num, cid):
            lab = segment_sum_channels(weak0[None], table, num)[0]
            not_void = (1.0 - lab[..., -1]) > 0.01
            gate = (l1_decisions[weak_ix] == cid) & (torch.amax(lab[..., :-1], -1) >= 0.01)
            return (not_void & gate).float()

        veh = weak_mask(tax.per_bbox_cids2vehicle_cids, tax.num_vehicle_classes,
                        tax.cid_l1_vehicle)
        hum = weak_mask(tax.per_bbox_cids2human_cids, tax.num_human_classes, tax.cid_l1_human)
    else:
        veh = (gather_cids(tax.per_pixel_cids2vehicle_cids, pp[0])
               != tax.num_vehicle_classes - 1).float()
        hum = (gather_cids(tax.per_pixel_cids2human_cids, pp[0])
               != tax.num_human_classes - 1).float()
    return {"l1_weights": l1_mask, "l2_vehicle_weights": veh, "l2_human_weights": hum}


def make_train_step(settings: Settings, model=None, fused_opt: Optional[FusedSGDM] = None
                    ) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: 'proimages_per_pixel' (Npp, H, W, 3), 'proimages_per_bbox',
    'proimages_per_image', 'prolabels_per_pixel' (Npp, H, W) int32,
    'prolabels_per_bbox' (Npb, H, W, 15) f32 and 'prolabels_per_image'
    (Npi, H, W, 15) f32, or 'image_label_vecs' (Npi, 15) for compact image
    labels; numpy arrays or tensors. ``fused_opt`` (train/fused_update.py)
    owns the model's parameters and gradients; the L2 regularization enters
    through its weight-decay gradient, and ``metrics['total']`` includes it.
    ``model`` defaults to the optimizer's, which must be ``state.model``.
    The metrics are 0-d tensors on the model's device (and the weight masks).
    """
    settings = settings.replace(mode="train")
    if fused_opt is None or not settings.fused_optimizer:
        raise NotImplementedError("the optax path (fused_optimizer=False, EmaState) is not "
                                  "ported yet: pass a train/fused_update.FusedSGDM")
    if settings.grad_accum_steps > 1:
        raise NotImplementedError("grad_accum_steps > 1 is not ported yet")
    if settings.augmentations:
        raise NotImplementedError("on-device augmentations are not ported yet")
    model = model or fused_opt.model
    tax = get_taxonomy(settings.per_pixel_dataset_name)
    image_hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    # the fused loss runs the model to stride-8 logits only; degenerate
    # supervision mixes and bootstrapped CE (a batch-global sort of the raw
    # L1 losses) take the reference loss on the upsampled logits
    use_fused_loss = (
        settings.fused_loss
        and model.upsampling_method == "bilinear"
        and settings.Nb_per_pixel > 0
        and settings.Nb_per_bbox > 0
        and settings.Nb_per_image > 0
        and settings.bootstrapping_percentage == -1
        and fused_loss_available((1, 1), image_hw, tax)
    )
    num_classes = tax.num_common_classes
    device = fused_opt.params.device

    def tensor(value, dtype):
        return torch.as_tensor(value, dtype=dtype, device=device)

    def _assemble(batch: Mapping[str, Any]):
        """Images and labels of one batch: the [pp | pb | pi] concat, dense
        weak labels, compact image labels broadcast on the device."""
        if "bbox_cids" in batch:
            raise NotImplementedError("on-device bbox rasterizing (ops/rasterize.py) is not "
                                      "ported yet")
        images = torch.cat([tensor(batch[k], torch.float32) for k in (
            "proimages_per_pixel", "proimages_per_bbox", "proimages_per_image")], 0)
        if "image_label_vecs" in batch:
            vecs = tensor(batch["image_label_vecs"], torch.float32)
            h, w = images.shape[1], images.shape[2]
            per_image = vecs[:, None, None, :].expand(vecs.shape[0], h, w, vecs.shape[1])
        else:
            per_image = tensor(batch["prolabels_per_image"], torch.float32)
        labels = {
            "prolabels_per_pixel": tensor(batch["prolabels_per_pixel"], torch.int32),
            "prolabels_per_bbox": tensor(batch["prolabels_per_bbox"], torch.float32),
            "prolabels_per_image": per_image,
        }
        return images, labels

    def _loss_and_grad(images, labels):
        """Forward, losses, and backward into the optimizer's flat gradients."""
        fused_opt.zero_grad()
        if use_fused_loss:
            preds = model(images, upsampling_method="no")
            losses = define_losses_fused(preds, labels, tax, images.shape[1:3],
                                         weak_loss_coefficient=settings.weak_loss_coefficient)
            decisions = losses["decisions"]
        else:
            preds = model(images)
            losses = define_losses(preds, labels, tax,
                                   weak_loss_coefficient=settings.weak_loss_coefficient,
                                   bootstrapping_percentage=settings.bootstrapping_percentage)
            decisions = preds["decisions"]
        losses["total"].backward()
        return losses, decisions

    def _weight_masks(labels, losses, n_pp, n_total):
        # one per-pixel example for L1, one weak example for the gated L2
        # heads (reference define_losses_hierarchical.py:140,167,187)
        weak_ix = n_pp if n_total > n_pp else 0
        if use_fused_loss:
            return _summary_weight_masks(labels, losses["l1_decisions"], tax, weak_ix)
        return {"l1_weights": losses["l1_weights"][0],
                "l2_vehicle_weights": losses["l2_vehicle_weights"][weak_ix],
                "l2_human_weights": losses["l2_human_weights"][weak_ix]}

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was built for")
        images, labels = _assemble(batch)
        n_pp = labels["prolabels_per_pixel"].shape[0]
        losses, decisions = _loss_and_grad(images, labels)
        with torch.no_grad():
            miou = batch_mean_iou(labels["prolabels_per_pixel"], decisions[:n_pp], num_classes)
            weight_masks = _weight_masks(labels, losses, n_pp, images.shape[0])
            opt_state, reg = fused_opt.update(state.opt_state, state.step)
        new_state = state.replace(step=state.step + 1, opt_state=opt_state)
        metrics = {
            "total": losses["total"].detach() + reg,
            "l1_segmentation": losses["l1_segmentation"].detach(),
            "l2_vehicle_segmentation": losses["l2_vehicle_segmentation"].detach(),
            "l2_human_segmentation": losses["l2_human_segmentation"].detach(),
            "regularization": reg,
            # online batch mIoU on the per-pixel slice (reference define_metrics)
            "miou": miou,
            "weight_masks": weight_masks,
        }
        return new_state, metrics

    return train_step


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

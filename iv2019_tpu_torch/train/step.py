"""Train, predict and evaluate steps of the PyTorch port.

Port of iv2019_tpu/train/step.py:

- ``make_train_step``: one training step of the mixed [pp | pb | pi] batch
  (step.py:104-433): on-device augmentations of the per-pixel part and
  rasterizing of padded box tensors (``_assemble``), train-mode forward,
  the hierarchical losses (fused from the model's logits at its output
  stride, 8 or 4, through kernels B1/B2 when the gate admits it, else
  ``define_losses`` on the upsampled logits),
  backward into the fused optimizer's flat gradient vector, the fused SGDM
  + weight-decay + EMA update (kernel B3), the batch mIoU and the
  summaries' weight masks; with ``grad_accum_steps`` > 1 the forward and
  backward run once per microbatch before the one update. With
  ``fused_optimizer=False`` (the optax path, step.py:250-256,415-419) the
  L2 regularization enters the loss, and the update is the SGD of
  train/optimizer.py followed by the ``EmaState`` update;
- ``make_predict_step``: forward -> the four supported outputs, resized to
  the system size (or a given ``output_size``) with align_corners=True,
  optional top-2 void replacement (step.py:843-934);
- ``make_eval_step``: forward -> training-to-evaluation cid remap ->
  optional void replacement -> nearest resize to the label size -> the
  batch confusion matrix (step.py:436-486).

Both inference steps also have the JAX package's two ensembles, chosen by
the settings as there (step.py:459-471,866-874):

- test-time augmentation (``eval_scales``, ``eval_flip``): one forward per
  scale and flip, each member's probabilities resized back and summed;
- sliding windows (``sliding_window`` with ``eval_size``): per scale and
  flip, (hf, wf) windows at ``window_overlap`` overlap, each window's
  probabilities (times a ``window_blend`` weight) added into an f32 canvas
  that is divided by the per-pixel weight sum. JAX's ``lax.scan`` over the
  window origins is a Python loop over the same origins in the same order.

Evaluation averages the factorized common-space distribution
(models/model.py::hierarchical_common_probabilities) and takes the argmax in
the evaluation label space; prediction averages each head on its own and
fuses the argmaxes as the model does. The predict and eval steps run on the
model's device, under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.losses.hierarchical import define_losses, l2_regularization
from iv2019_tpu_torch.models.mit import mask_seed
from iv2019_tpu_torch.models.model import build_model, hierarchical_common_probabilities
from iv2019_tpu_torch.ops.augment import apply_augmentations, draw_augmentations
from iv2019_tpu_torch.ops.confusion import confusion_matrix, mean_iou_from_cm
from iv2019_tpu_torch.ops.fused_loss import define_losses_fused, fused_loss_available
from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes
from iv2019_tpu_torch.ops.resize import (resize_band, resize_bilinear, resize_bilinear_mxu,
                                         resize_nearest)
from iv2019_tpu_torch.ops.segment_ops import gather_cids, remap_probabilities, segment_sum_channels
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.problem.problem_def import load_problem_def, replace_voids
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.optimizer import make_learning_rate_fn
from iv2019_tpu_torch.train.state import TrainState
from iv2019_tpu_torch.utils.spans import copy_span, span

__all__ = ["PROB_KEYS", "make_eval_step", "make_predict_step", "make_train_step",
           "settings_eval_map", "uses_fused_loss", "window_origins", "window_weight"]

PROB_KEYS = ("l1_probabilities", "l2_vehicle_probabilities", "l2_human_probabilities")


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


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


def uses_fused_loss(settings: Settings, model, spatial: bool = False) -> bool:
    """Whether the train step of ``settings`` computes its loss with kernels
    B1/B2. The fused loss runs the model to its logits at the output stride
    (8, or 4 under ``mit_*``) and upsamples them inside B1/B2; degenerate
    supervision mixes and bootstrapped CE (a batch-global sort of the raw L1
    losses) take the reference loss on the upsampled logits, and so does a
    mesh that splits image height. Decided on the microbatch, the batch each
    loss call sees."""
    accum = settings.grad_accum_steps
    image_hw = (settings.height_feature_extractor, settings.width_feature_extractor)
    return bool(
        settings.fused_loss
        and model.upsampling_method == "bilinear"
        and settings.Nb_per_pixel // accum > 0
        and settings.Nb_per_bbox // accum > 0
        and settings.Nb_per_image // accum > 0
        and settings.bootstrapping_percentage == -1
        and not spatial
        and fused_loss_available((1, 1), image_hw, get_taxonomy(settings.per_pixel_dataset_name))
    )


def make_train_step(settings: Settings, model=None, fused_opt: Optional[FusedSGDM] = None,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: 'proimages_per_pixel' (Npp, H, W, 3), 'proimages_per_bbox',
    'proimages_per_image', 'prolabels_per_pixel' (Npp, H, W) int32,
    'prolabels_per_bbox' (Npb, H, W, 15) f32, or 'bbox_cids' (Npb, K) int32
    and 'bbox_coords' (Npb, K, 4) f32 rasterized on the device, and
    'prolabels_per_image' (Npi, H, W, 15) f32, or 'image_label_vecs' (Npi,
    15) for compact image labels; numpy arrays or tensors. With
    ``fused_optimizer`` (the default), ``fused_opt`` (train/fused_update.py)
    owns the model's parameters and gradients; the L2 regularization enters
    through its weight-decay gradient. ``model`` defaults to the
    optimizer's, which must be ``state.model``. With ``fused_optimizer``
    False (the optax path) pass ``model``; the step updates it with
    ``state.opt_state`` (train/optimizer.py::make_optimizer) and
    ``state.ema``, with the regularization in the differentiated loss, and
    reads ``state.step`` once for the schedule and the EMA decay (then
    counted on the host, as the augmentations' step). ``metrics['total']``
    includes the regularization either way. The metrics are 0-d tensors on
    the model's device (and the weight masks).

    ``augmentations`` draw from ``(random_seed, step)``, or ``(random_seed,
    step * accum + i)`` for microbatch i, as the JAX package folds its key;
    the step is read from ``state.step`` once and then counted on the host.
    A model whose training forward draws masks (``model.stochastic``: the
    stochastic depth and dropout of ``mit_*``) has its mask generator seeded
    with ``mit.mask_seed(random_seed, step * accum + i, data_index)`` before
    microbatch i, the step counted the same way.
    With ``grad_accum_steps`` = accum > 1 the batch splits into accum equal
    slices of each sub-batch (step.py:276-402): each runs forward (BatchNorm
    statistics per microbatch, so the running statistics take accum
    momentum updates) and backward, adding into the flat gradient buffer,
    which is divided by accum once before the one update; the losses are
    the microbatches' mean, the mIoU comes from their summed confusion
    matrices, and the weight masks from microbatch 0.

    With a ``mesh`` (default: the active one, parallel/mesh.py) each rank
    takes its rows of each sub-batch (``shard_rows``; of each microbatch in
    turn) and the step computes what the JAX package's does on the global
    batch: BatchNorm statistics over it (models/layers.py), losses normalized
    by its counts, the augmentations drawn for its rows, and one all-reduce
    (a sum) of the gradient after the microbatches, before the division by
    accum; on the optax path rank 0 alone differentiates the regularization.
    The confusion matrix is all-reduced in int64. ``Nb_per_*`` stay global,
    and each microbatch must divide by the batch shards.

    When the mesh splits image height (``spatial_partitions`` P; it must be
    the active mesh, which the model reads) the batch is the rank's batch
    shard's whole images, which the ranks of its spatial group all hold:
    each rank augments them with the shard's draws, takes its band of rows
    of the images and labels (``shard_height``; boxes are rasterized for the
    band alone, compact image labels broadcast over it) and runs the model
    and the unfused loss on the band (JAX turns the fused loss off on a
    spatial mesh, step.py:129-132). Every pixel lives on one rank, so the
    all-reduced loss sums, gradient and confusion matrix are those of the
    global batch.
    """
    settings = settings.replace(mode="train")
    fused = settings.fused_optimizer
    if fused and fused_opt is None:
        raise ValueError("fused_optimizer=True needs fused_opt, a train/fused_update.FusedSGDM")
    if not fused and (fused_opt is not None or model is None):
        raise ValueError("fused_optimizer=False (the optax path) takes the model, and no "
                         "FusedSGDM")
    model = model or fused_opt.model
    mesh = mesh if mesh is not None else pmesh.active()
    lr_fn = make_learning_rate_fn(settings)
    tax = get_taxonomy(settings.per_pixel_dataset_name)
    accum = settings.grad_accum_steps
    spatial = mesh is not None and mesh.spatial > 1
    if mesh is not None:
        # each microbatch must shard evenly over the batch shards (step.py:161-176)
        for name in ("Nb_per_pixel", "Nb_per_bbox", "Nb_per_image"):
            nb = getattr(settings, name)
            if nb and (nb // accum) % mesh.batch_shards:
                raise ValueError(
                    f"grad_accum_steps={accum}: microbatch {name}={nb}//"
                    f"{accum} must divide by the {mesh.batch_shards} batch shards of "
                    "the mesh.")
    use_fused_loss = uses_fused_loss(settings, model, spatial)
    stochastic = getattr(model, "stochastic", False)
    num_classes = tax.num_common_classes
    device = _device_of(model)
    params = list(model.parameters())
    augmentations = tuple(settings.augmentations)
    # the step's number is counted on the host where something draws from it
    host_counted = bool(augmentations) or not fused or stochastic
    # labels revealed by downscaling: the per-pixel space's void cid
    unlabeled_cid = len(tax.per_pixel_cids2l1_cids) - 1
    host_step = {"state": None, "step": 0}

    def tensor(value, dtype):
        with copy_span("iv.sync.batch", value, device):
            return torch.as_tensor(value, dtype=dtype, device=device)

    def _band(x):
        return pmesh.shard_height(x, mesh) if spatial else x

    def _assemble(batch: Mapping[str, Any], fold: int):
        """Images and labels of one (micro)batch: the per-pixel part
        augmented, the [pp | pb | pi] concat, box tensors rasterized and
        compact image labels broadcast, on the device; under spatial
        partitioning this rank's band of rows of each."""
        pp_images = tensor(batch["proimages_per_pixel"], torch.float32)
        pp_labels = tensor(batch["prolabels_per_pixel"], torch.int32)
        if augmentations:
            n, h, w = pp_images.shape[:3]
            # the draws of the global (micro)batch, and this batch shard's
            # rows of them: the ranks of a spatial group draw alike, and the
            # median filter and the rescale see whole images
            shards, index = (mesh.batch_shards, mesh.data_index) if mesh is not None else (1, 0)
            draws = draw_augmentations(settings.random_seed, fold, augmentations, n * shards, h,
                                       w, settings.scaling_poi)
            draws = {k: v[index * n:(index + 1) * n] if isinstance(v, torch.Tensor) else v
                     for k, v in draws.items()}
            pp_images, pp_labels = apply_augmentations(pp_images, pp_labels, augmentations,
                                                       draws, unlabeled_cid)
        images = _band(torch.cat([pp_images] + [tensor(batch[k], torch.float32) for k in (
            "proimages_per_bbox", "proimages_per_image")], 0))
        pp_labels = _band(pp_labels)
        h, w = images.shape[1], images.shape[2]
        if "bbox_cids" in batch:
            # box tensors are per image: the band's rows are rasterized from them
            rows = (mesh.spatial_index * h, (mesh.spatial_index + 1) * h) if spatial else None
            per_bbox = rasterize_bboxes(tensor(batch["bbox_cids"], torch.int32),
                                        tensor(batch["bbox_coords"], torch.float32),
                                        h * (mesh.spatial if spatial else 1), w, rows=rows)
        else:
            per_bbox = _band(tensor(batch["prolabels_per_bbox"], torch.float32))
        if "image_label_vecs" in batch:
            vecs = tensor(batch["image_label_vecs"], torch.float32)
            per_image = vecs[:, None, None, :].expand(vecs.shape[0], h, w, vecs.shape[1])
        else:
            per_image = _band(tensor(batch["prolabels_per_image"], torch.float32))
        labels = {
            "prolabels_per_pixel": pp_labels,
            "prolabels_per_bbox": per_bbox,
            "prolabels_per_image": per_image,
        }
        return images, labels

    def _loss_and_grad(images, labels):
        """Forward, losses (with the regularization on the optax path), and
        backward adding into the gradients; returns (losses, decisions, reg)."""
        with span("iv.train.forward"):
            if use_fused_loss:
                preds = model(images, upsampling_method="no")
                losses = define_losses_fused(preds, labels, tax, images.shape[1:3],
                                             weak_loss_coefficient=settings.weak_loss_coefficient,
                                             mesh=mesh)
                decisions = losses["decisions"]
            else:
                preds = model(images)
                losses = define_losses(preds, labels, tax,
                                       weak_loss_coefficient=settings.weak_loss_coefficient,
                                       bootstrapping_percentage=settings.bootstrapping_percentage,
                                       mesh=mesh)
                decisions = preds["decisions"]
            reg = None if fused else l2_regularization(model.named_parameters(),
                                                       settings.regularization_weight)
        with span("iv.train.backward"):
            if reg is not None and (mesh is None or mesh.rank == 0):
                # the parameters are replicated: the gradient all-reduce would
                # count the regularization's gradient once per rank
                (losses["total"] + reg).backward()
            else:
                losses["total"].backward()
        return losses, decisions, None if reg is None else reg.detach()

    def _weight_masks(labels, losses, n_pp, n_total):
        # one per-pixel example for L1, one weak example for the gated L2
        # heads (reference define_losses_hierarchical.py:140,167,187)
        weak_ix = n_pp if n_total > n_pp else 0
        if use_fused_loss:
            return _summary_weight_masks(labels, losses["l1_decisions"], tax, weak_ix)
        return {"l1_weights": losses["l1_weights"][0],
                "l2_vehicle_weights": losses["l2_vehicle_weights"][weak_ix],
                "l2_human_weights": losses["l2_human_weights"][weak_ix]}

    def _step_on_host(state: TrainState) -> int:
        """state.step without a wait on the device after the first call of a
        chain of states this function returned."""
        if host_step["state"] is not state:
            with span("iv.sync.step_read"):
                host_step["step"] = int(state.step)
        return host_step["step"]

    def _microbatch(batch: Mapping[str, Any], i: int) -> dict:
        out = {}
        for k, v in batch.items():
            if hasattr(v, "shape"):
                size = v.shape[0] // accum
                v = v[i * size:(i + 1) * size]
            out[k] = v
        return out

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        with span("iv.train_step"):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Mapping[str, Any]):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was built for")
        step = _step_on_host(state) if host_counted else 0
        if fused:
            fused_opt.zero_grad()
        else:
            state.opt_state.zero_grad(set_to_none=True)
        loss_keys = ("total", "l1_segmentation", "l2_vehicle_segmentation",
                     "l2_human_segmentation")
        sums, cm, weight_masks = None, None, None
        for i in range(accum):
            mb = batch if accum == 1 else _microbatch(batch, i)
            if stochastic:
                model.seed_stochastic(mask_seed(settings.random_seed, step * accum + i,
                                                mesh.data_index if mesh is not None else 0))
            with span("iv.train.assemble"):
                images, labels = _assemble(mb, step * accum + i)
            n_pp = labels["prolabels_per_pixel"].shape[0]
            losses, decisions, reg = _loss_and_grad(images, labels)
            with torch.no_grad(), span("iv.train.metrics"):
                part = confusion_matrix(labels["prolabels_per_pixel"], decisions[:n_pp],
                                        num_classes)
                cm = part if cm is None else cm + part
                values = [losses[k].detach() for k in loss_keys]
                sums = values if sums is None else [a + b for a, b in zip(sums, values)]
                if i == 0:
                    weight_masks = _weight_masks(labels, losses, n_pp, images.shape[0])
            del losses, decisions, images, labels
        with torch.no_grad(), span("iv.train.update"):
            if mesh is not None:
                # the gradient of the global loss: each rank's part, summed
                if fused:
                    pmesh.all_reduce(fused_opt.grads, mesh)
                else:
                    _all_reduce_grads(params, mesh)
                pmesh.all_reduce(cm, mesh)
            if accum > 1:
                if fused:
                    fused_opt.grads.div_(accum)
                else:
                    torch._foreach_div_([p.grad for p in params], accum)
                sums = [v / accum for v in sums]
            if fused:
                opt_state, reg = fused_opt.update(state.opt_state, state.step)
            else:
                opt_state = state.opt_state
                lr = float(lr_fn(torch.tensor(step, dtype=torch.int64)))
                for group in opt_state.param_groups:
                    group["lr"] = lr
                opt_state.step()
                if state.ema is not None:
                    state.ema.update(model, step, settings.ema_decay)
        new_state = state.replace(step=state.step + 1, opt_state=opt_state)
        if host_counted:
            host_step.update(state=new_state, step=step + 1)
        total, l1, veh, hum = sums
        with span("iv.train.metrics"):
            metrics = {
                "total": total + reg,
                "l1_segmentation": l1,
                "l2_vehicle_segmentation": veh,
                "l2_human_segmentation": hum,
                "regularization": reg,
                # online batch mIoU on the per-pixel slice (reference define_metrics)
                "miou": mean_iou_from_cm(cm),
                "weight_masks": weight_masks,
            }
        return new_state, metrics

    return train_step


def _all_reduce_grads(params, mesh) -> None:
    """Sum the parameters' gradients over the ranks as one flat bucket."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    pmesh.all_reduce(flat, mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


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


def _as_images(model: torch.nn.Module, images) -> torch.Tensor:
    device = _device_of(model)
    with copy_span("iv.sync.images", images, device):
        return torch.as_tensor(images, dtype=torch.float32, device=device)


def _members(settings: Settings) -> list[tuple[float, bool]]:
    """(scale, flipped) of each ensemble member, in the JAX package's order."""
    flips = (False, True) if settings.eval_flip else (False,)
    return [(s, f) for s in tuple(settings.eval_scales or (1.0,)) for f in flips]


def _scaled_size(h: int, w: int, scale: float, stride: int, floor_hw=(None, None)):
    """The stride-multiple size of a scaled image, at least ``floor_hw``
    (default one stride)."""
    fh, fw = floor_hw
    return (max(int(round(h * scale / stride)) * stride, fh or stride),
            max(int(round(w * scale / stride)) * stride, fw or stride))


def _flip_w(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(2,))


def _ensemble_sums(settings: Settings, model, probs_fn: Callable) -> Optional[Callable]:
    """images -> for each tensor ``probs_fn(model(...))`` returns, its sum
    over the ensemble's members at the input size: sliding windows with
    ``sliding_window``, else test-time augmentation when ``eval_scales`` is
    not (1.0,) or ``eval_flip`` is set; None for a plain forward
    (step.py:459-471,866-874)."""
    members = _members(settings)
    if settings.sliding_window:
        return _window_sums(settings, model, probs_fn, members)
    if members != [(1.0, False)]:
        return _tta_sums(settings, model, probs_fn, members)
    return None


def _tta_sums(settings: Settings, model, probs_fn, members) -> Callable:
    """Each member rescales the image to a stride multiple (and flips it),
    and its probabilities are flipped back and resized to the input size
    (step.py:489-536,730-764)."""
    stride = settings.stride_feature_extractor

    def compute(images):
        h, w = images.shape[1], images.shape[2]
        acc = None
        for scale, do_flip in members:
            sh, sw = _scaled_size(h, w, scale, stride)
            im = _flip_w(images) if do_flip else images
            if (sh, sw) != (h, w):
                im = resize_bilinear_mxu(im, (sh, sw), align_corners=True)
            member = []
            for p in probs_fn(model(im)):
                if do_flip:
                    p = _flip_w(p)
                if (sh, sw) != (h, w):
                    p = resize_bilinear_mxu(p, (h, w), align_corners=True)
                member.append(p)
            acc = member if acc is None else [a + m for a, m in zip(acc, member)]
        return acc

    return compute


def window_origins(full: int, win: int, overlap: float) -> list[int]:
    """Window start offsets covering [0, full): windows of ``win`` advance by
    ``win * (1 - overlap)``, the last one flush with the edge (step.py:539)."""
    if win >= full:
        return [0]
    stride = max(int(round(win * (1.0 - overlap))), 1)
    origins = list(range(0, full - win + 1, stride))
    if origins[-1] != full - win:
        origins.append(full - win)
    return origins


def window_weight(wh: int, ww: int, blend: str) -> np.ndarray:
    """(wh, ww, 1) f32 weight of each window pixel (step.py:556): 1 for
    ``uniform``; for ``gaussian`` a separable bump with sigma = size / 8,
    peak 1, floored at 1e-3."""
    if blend == "uniform":
        return np.ones((wh, ww, 1), np.float32)
    if blend != "gaussian":
        raise ValueError(f"unknown window_blend {blend!r}")

    def axis(n):
        c = (n - 1) / 2.0
        sigma = n / 8.0
        return np.exp(-0.5 * ((np.arange(n) - c) / sigma) ** 2)

    w = axis(wh)[:, None] * axis(ww)[None, :]
    return np.maximum(w / w.max(), 1e-3).astype(np.float32)[..., None]


def _window_plans(settings: Settings, full_hw, scales):
    """Per scale (sh, sw, origins, count): the image rescaled to a stride
    multiple of at least the window, the (y, x) window origins (int32), and
    the per-pixel sum of window weights (f32 (sh, sw, 1)); and the weight
    map (step.py:581-610)."""
    wh, ww = settings.height_feature_extractor, settings.width_feature_extractor
    stride = settings.stride_feature_extractor
    eh, ew = full_hw
    weight = window_weight(wh, ww, settings.window_blend)
    plans = []
    for s in scales:
        sh, sw = _scaled_size(eh, ew, s, stride, (wh, ww))
        oys = window_origins(sh, wh, settings.window_overlap)
        oxs = window_origins(sw, ww, settings.window_overlap)
        origins = np.array([(y, x) for y in oys for x in oxs], np.int32)
        count = np.zeros((sh, sw, 1), np.float32)
        for oy, ox in origins:
            count[oy:oy + wh, ox:ox + ww] += weight
        plans.append((sh, sw, origins, count))
    return plans, weight


def _window_sums(settings: Settings, model, probs_fn, members) -> Callable:
    """Each member rescales the eval_size image (at least to the window) and
    flips it, adds each (hf, wf) window's weighted probabilities into f32
    canvases, divides them by the per-pixel weight sums, flips back and
    resizes to eval_size (step.py:613-696,767-840)."""
    wh, ww = settings.height_feature_extractor, settings.width_feature_extractor
    eh, ew = settings.eval_size
    scales = list(dict.fromkeys(s for s, _ in members))
    plans, wmap = _window_plans(settings, (eh, ew), scales)
    device = _device_of(model)
    weight = torch.as_tensor(wmap, device=device)
    plans = {s: (sh, sw, origins.tolist(), torch.as_tensor(count, device=device))
             for s, (sh, sw, origins, count) in zip(scales, plans)}

    def compute(images):
        acc = None
        for scale, do_flip in members:
            sh, sw, origins, count = plans[scale]
            im = _flip_w(images) if do_flip else images
            if (sh, sw) != (eh, ew):
                im = resize_bilinear_mxu(im, (sh, sw), align_corners=True)
            canvases = None
            for oy, ox in origins:
                probs = probs_fn(model(im[:, oy:oy + wh, ox:ox + ww]))
                if canvases is None:
                    canvases = [torch.zeros((images.shape[0], sh, sw, p.shape[-1]),
                                            dtype=torch.float32, device=device) for p in probs]
                for canvas, p in zip(canvases, probs):
                    canvas[:, oy:oy + wh, ox:ox + ww] += p.float() * weight
            member = []
            for canvas in canvases:
                p = canvas / count
                if do_flip:
                    p = _flip_w(p)
                if (sh, sw) != (eh, ew):
                    p = resize_bilinear_mxu(p, (eh, ew), align_corners=True)
                member.append(p)
            acc = member if acc is None else [a + m for a, m in zip(acc, member)]
        return acc

    return compute


def make_eval_step(settings: Settings, model=None, tcids2ecids=None, mesh=None) -> Callable:
    """Returns eval_step(images, prolabels) -> (K', K') int64 confusion matrix.

    With an ensemble (``_ensemble_sums``) the decisions are the argmax, in
    the evaluation label space, of the summed common-space probabilities.
    When the mesh (default: the active one) splits image height, the images
    and labels are the rank's batch shard's whole ones: the step takes its
    band of rows of each, and the nearest resize of the decisions to the
    label size reads the decision rows its label rows map to, from
    whichever rank holds them; the rank's matrix counts its band's pixels
    (the caller sums the matrices)."""
    settings = settings.replace(mode="eval")
    model = model or build_model(settings)
    if tcids2ecids is None:
        tcids2ecids = settings_eval_map(settings)
    tcids2ecids = replace_voids(list(tcids2ecids))
    num_eval_classes = max(tcids2ecids) + 1
    tax = get_taxonomy(settings.per_pixel_dataset_name)
    # L1 -> common -> eval, so the probability remap matches the fused decisions
    l1_cids2ecids = [tcids2ecids[c] for c in tax.l1_cids2common_cids]
    ensemble = _ensemble_sums(settings, model,
                              lambda preds: [hierarchical_common_probabilities(preds, tax)])
    mesh = mesh if mesh is not None else pmesh.active()
    spatial = mesh if mesh is not None and mesh.spatial > 1 else None

    def eval_step(images, prolabels) -> torch.Tensor:
        with span("iv.eval_step"):
            return _eval_step(images, prolabels)

    def _eval_step(images, prolabels) -> torch.Tensor:
        images = _as_images(model, images)
        with copy_span("iv.sync.labels", prolabels, images.device):
            prolabels = torch.as_tensor(prolabels, device=images.device)
        label_hw = prolabels.shape[1:3]
        if spatial is not None:
            images = pmesh.shard_height(images, spatial)
            prolabels = pmesh.shard_height(prolabels, spatial)
        with torch.inference_mode():
            with span("iv.eval.forward"):
                if ensemble is None:
                    preds = model(images)
                else:
                    (common,) = ensemble(images)
            with span("iv.eval.decide"):
                if ensemble is None:
                    decs = gather_cids(tcids2ecids, preds["decisions"])
                    probs_e = (_pad_channels(remap_probabilities(preds["l1_probabilities"],
                                                                 l1_cids2ecids), num_eval_classes)
                               if settings.replace_voids else None)
                else:
                    probs_e = _pad_channels(remap_probabilities(common, tcids2ecids),
                                            num_eval_classes)
                    decs = torch.argmax(probs_e, dim=-1).int()
                if settings.replace_voids:
                    decs = _replace_void_decisions(probs_e, decs)
            with span("iv.eval.resize"):
                if spatial is not None:
                    decs = resize_band(decs, label_hw, spatial, nearest=True)
                else:
                    decs = resize_nearest(decs, label_hw, align_corners=True)
            with span("iv.eval.confusion"):
                return confusion_matrix(prolabels, decs, num_eval_classes)

    return eval_step


def make_predict_step(settings: Settings, output_size: Optional[tuple[int, int]] = None,
                      model=None) -> Callable:
    """Returns predict_step(images) -> dict of the four predict outputs (NHWC).

    With an ensemble (``_ensemble_sums``) the head probabilities are the
    members' means and the decisions their argmaxes fused as the model fuses
    them (step.py:866-913); sliding windows take only eval_size images."""
    settings = settings.replace(mode="predict")
    model = model or build_model(settings)
    if output_size is None and settings.height_system and settings.width_system:
        output_size = (settings.height_system, settings.width_system)
    tax = get_taxonomy(settings.per_pixel_dataset_name)
    ensemble = _ensemble_sums(settings, model, lambda preds: [preds[k] for k in PROB_KEYS])
    num_members = len(_members(settings))

    def _fuse(l1p, vehp, hump):
        # the model's two-level decision fusion over the averaged heads
        l1_decs = torch.argmax(l1p, -1).int()
        return torch.where(
            l1_decs == tax.cid_l1_vehicle,
            gather_cids(tax.l2_vehicle_cids2common_cids, torch.argmax(vehp, -1)),
            torch.where(
                l1_decs == tax.cid_l1_human,
                gather_cids(tax.l2_human_cids2common_cids, torch.argmax(hump, -1)),
                gather_cids(tax.l1_cids2common_cids, l1_decs),
            ),
        )

    def predict(images) -> dict:
        images = _as_images(model, images)
        if settings.sliding_window and tuple(images.shape[1:3]) != tuple(settings.eval_size):
            raise ValueError(f"sliding-window predict compiled for eval_size {settings.eval_size} "
                             f"but got images of {tuple(images.shape[1:3])}; the predict "
                             "pipeline must resize to eval_size")
        if ensemble is None:
            preds = model(images)
            out = {k: preds[k] for k in PROB_KEYS + ("decisions",)}
        else:
            heads = [a / num_members for a in ensemble(images)]
            out = dict(zip(PROB_KEYS, heads))
            out["decisions"] = _fuse(*heads)
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

    def predict_step(images) -> dict:
        with torch.inference_mode():
            return predict(images)

    # the step without inference mode, which torch.export cannot trace
    # (tools/export_model.py); JAX's jitted step has it as __wrapped__ too
    predict_step.__wrapped__ = predict
    return predict_step

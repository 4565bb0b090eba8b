"""Hierarchical mixed-supervision losses, in PyTorch.

Port of iv2019_tpu/losses/hierarchical.py (reference
define_losses_hierarchical.py:14-224):

- the batch is [per_pixel | per_bbox | per_image] along the batch axis;
- L1 (root) head: sparse softmax CE on the per-pixel images only, void
  pixels weighted 0 (optionally bootstrapped: only the hardest p% kept);
- L2 vehicle / human heads: dense softmax CE over the whole batch against
  labels projected into each head's space, weighted 1 - P(void) on the
  per-pixel images and, on the weak images, by the gate
  P(void) < 0.99 AND L1 decision == metaclass AND max label >= 0.01;
- total = L1 + weak_loss_coefficient * (L2_vehicle + L2_human);
- weighted-loss reduction: sum(loss * w) / count_nonzero(w), 0 when empty
  (tf.losses.compute_weighted_loss, SUM_BY_NONZERO_WEIGHTS).

Everything is f32 from the f32 logits; labels and gates carry no gradient.
This is the oracle of the fused loss (ops/fused_loss.py) and the train
step's loss when the fused gate is off.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.ops.segment_ops import gather_cids, segment_sum_channels
from iv2019_tpu_torch.problem.taxonomy import Taxonomy

__all__ = [
    "WEAK_LOSS_COEFFICIENT",
    "bootstrap_weights",
    "define_losses",
    "l2_regularization",
    "weighted_loss",
]

WEAK_LOSS_COEFFICIENT = 0.1  # reference :203


def weighted_loss(raw_loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """tf.losses.compute_weighted_loss with SUM_BY_NONZERO_WEIGHTS reduction."""
    raw_loss, weights = raw_loss.float(), weights.float()
    num_present = torch.sum(weights != 0.0).float()
    total = torch.sum(raw_loss * weights)
    return torch.where(num_present > 0, total / num_present.clamp_min(1.0),
                       torch.zeros_like(total))


def bootstrap_weights(raw_loss: torch.Tensor, weights: torch.Tensor,
                      percentage: int) -> torch.Tensor:
    """Keep the top ``percentage``% highest-loss pixels among the weighted
    ones, batch-globally, zeroing the rest (bootstrapped CE, Wu et al. 2016):
    the threshold is the k-th largest valid loss, k = max(1, floor(valid * p
    / 100)); ties at the threshold are kept.

    k is computed in int64: the JAX package's int32 product
    ``num_valid * percentage`` overflows above ~21.5M valid pixels.
    """
    flat_loss = raw_loss.reshape(-1).float()
    flat_w = weights.reshape(-1).float()
    valid = flat_w != 0.0
    num_valid = torch.sum(valid, dtype=torch.int64)
    masked = torch.where(valid, flat_loss, torch.finfo(torch.float32).min)
    sorted_desc = torch.sort(masked, descending=True).values
    k = torch.clamp(num_valid * percentage // 100, min=1)
    thr = sorted_desc[torch.clamp(k - 1, 0, masked.numel() - 1)]
    keep = (flat_loss >= thr) & valid
    return (flat_w * keep.float()).reshape(weights.shape)


def _sparse_softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel sparse CE over the last axis; labels clipped to valid indices."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long().clamp(0, logits.shape[-1] - 1)
    return -log_probs.gather(-1, labels[..., None])[..., 0]


def _dense_softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Dense (multinomial-label) CE per pixel."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    return -torch.sum(labels.float() * log_probs, dim=-1)


def _l2_head_loss(logits, per_pixel_labels_1h, weak_labels, l1_decisions, metaclass_cid: int,
                  n_pp: int):
    """Shared vehicle/human L2 loss with decision-gated weak weights."""
    labels = torch.cat([per_pixel_labels_1h, weak_labels], 0).detach()
    raw = _dense_softmax_ce(logits, labels)
    pp_weights = 1.0 - labels[:n_pp, ..., -1]
    not_void = (1.0 - labels[n_pp:, ..., -1]) > 0.01
    l1_correct = (l1_decisions[n_pp:].detach() == metaclass_cid) & (
        torch.amax(labels[n_pp:, ..., :-1], dim=-1) >= 0.01)
    weak_weights = (not_void & l1_correct).float()
    weights = torch.cat([pp_weights, weak_weights], 0)
    return weighted_loss(raw, weights), weights


def define_losses(predictions: Mapping[str, Any], labels: Mapping[str, Any], taxonomy: Taxonomy,
                  weak_loss_coefficient: float = WEAK_LOSS_COEFFICIENT,
                  bootstrapping_percentage: int = -1) -> dict:
    """Training losses of the mixed-supervision batch.

    predictions: the model's dict (``l1_logits`` (N, H, W, C1), ``l1_decisions``
    (N, H, W), ``l2_{vehicle,human}_logits``); labels: ``prolabels_per_pixel``
    (Npp, H, W) int32, ``prolabels_per_bbox`` / ``prolabels_per_image``
    (N*, H, W, 15) f32, any of them possibly empty. Returns total (without
    the regularization), the three head losses and their weight masks.
    """
    tax = taxonomy
    pp = labels["prolabels_per_pixel"]
    pb, pi = labels["prolabels_per_bbox"], labels["prolabels_per_image"]
    n_pp = pp.shape[0]
    l1_logits, l1_decisions = predictions["l1_logits"], predictions["l1_decisions"]

    l1_labels = gather_cids(tax.per_pixel_cids2l1_cids, pp)
    l1_raw = _sparse_softmax_ce(l1_logits[:n_pp], l1_labels)
    # void = the largest cid of the L1 table
    l1_weights = (l1_labels <= int(tax.per_pixel_cids2l1_cids.max()) - 1).float()
    if bootstrapping_percentage != -1:
        # the root head only: the L2 weights are the paper's decision gating
        l1_weights = bootstrap_weights(l1_raw.detach(), l1_weights, bootstrapping_percentage)
    l1_loss = weighted_loss(l1_raw, l1_weights)

    def project(weak, table, n):
        if weak.shape[0] == 0:
            return torch.zeros((0, *weak.shape[1:3], n), dtype=torch.float32, device=weak.device)
        return segment_sum_channels(weak, table, n)

    def head(logits, pp_table, weak_table, n, cid):
        pp_1h = F.one_hot(gather_cids(pp_table, pp).long(), n).float()
        weak = torch.cat([project(pb, weak_table, n), project(pi, weak_table, n)], 0)
        return _l2_head_loss(logits, pp_1h, weak, l1_decisions, cid, n_pp)

    veh_loss, veh_weights = head(predictions["l2_vehicle_logits"], tax.per_pixel_cids2vehicle_cids,
                                 tax.per_bbox_cids2vehicle_cids, tax.num_vehicle_classes,
                                 tax.cid_l1_vehicle)
    hum_loss, hum_weights = head(predictions["l2_human_logits"], tax.per_pixel_cids2human_cids,
                                 tax.per_bbox_cids2human_cids, tax.num_human_classes,
                                 tax.cid_l1_human)
    return {
        "total": l1_loss + weak_loss_coefficient * (veh_loss + hum_loss),
        "l1_segmentation": l1_loss,
        "l2_vehicle_segmentation": veh_loss,
        "l2_human_segmentation": hum_loss,
        "l1_weights": l1_weights,
        "l2_vehicle_weights": veh_weights,
        "l2_human_weights": hum_weights,
    }


def l2_regularization(named_parameters, weight_decay: float) -> torch.Tensor:
    """slim l2_regularizer parity: weight_decay * sum_k ||W_k||^2 / 2 over the
    conv kernels only (the port's ``<module>.conv.weight`` leaves, flax
    ``kernel``), not the norms' scale and bias."""
    total = sum(torch.sum(p.float() ** 2) for name, p in named_parameters
                if name.endswith(".weight"))
    return weight_decay * total * 0.5

"""The reference's training step and evaluation, in plain PyTorch.

- ``losses``: the paper's hierarchical losses (reference
  define_losses_hierarchical.py:14-224) on logits upsampled to the labels'
  size: sparse softmax CE of the L1 head on the per-pixel images (void
  weighted 0); dense CE of the vehicle and human heads over the whole batch
  against labels projected into each head's classes, weighted 1 - P(void)
  on the per-pixel images and, on the weak images, by the gate P(void) <
  0.99 and L1 decision == the metaclass and largest label >= 0.01; each a
  weighted sum over the count of nonzero weights, 0 when there is none;
  total = L1 + coefficient * (vehicle + human).
- ``train_steps``: SGD with momentum and weight decay on the kernels
  (``.weight`` leaves) at the configuration's first learning rate, from the
  given parameters, one step a batch.
- ``confusion``: the evaluation of one batch: eval-mode forward, the
  hierarchical decisions, the training-to-evaluation class map, the
  aligned-corners nearest resize to the labels, the confusion matrix.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import forward, nearest_table, upsample

__all__ = ["confusion", "decisions", "eval_class_map", "losses", "projection", "train_steps"]


def _table(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def projection(table, n: int, device) -> torch.Tensor:
    """(len(table), n) 0/1 matrix sending class i to class table[i]."""
    m = np.zeros((len(table), n), np.float32)
    m[np.arange(len(table)), np.asarray(table)] = 1.0
    return torch.as_tensor(m, device=device)


def _weighted(raw: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    count = torch.count_nonzero(weights).float()
    total = torch.sum(raw * weights)
    return torch.where(count > 0, total / count.clamp_min(1.0), torch.zeros_like(total))


def decisions(up: list, hier: dict) -> torch.Tensor:
    """The common-space decision of each pixel from the three heads'
    (N, C, H, W) logits: L1's argmax, replaced by the vehicle or human
    head's where L1 chose that metaclass."""
    dev = up[0].device
    l1, veh, hum = (torch.argmax(u, 1) for u in up)
    return torch.where(
        l1 == hier["cid_l1_vehicle"], _table(hier["l2_vehicle_cids2common_cids"], dev)[veh],
        torch.where(l1 == hier["cid_l1_human"], _table(hier["l2_human_cids2common_cids"], dev)[hum],
                    _table(hier["l1_cids2common_cids"], dev)[l1]))


def losses(up: list, per_pixel: torch.Tensor, weak: torch.Tensor, cfg: dict) -> dict:
    """up: the three heads' logits at the labels' size, (N, C, H, W)
    float32, the batch being [per-pixel | weak]; per_pixel (Npp, H, W)
    training class ids; weak (Nweak, H, W, 15) weak-label distributions."""
    hier = cfg["hierarchy"]
    dev = per_pixel.device
    n_pp = per_pixel.shape[0]
    pp = per_pixel.long()
    l1_up = up[0]
    l1_lab = _table(hier["per_pixel_cids2l1_cids"], dev)[pp]
    void = l1_up.shape[1] - 1
    raw = -F.log_softmax(l1_up[:n_pp], 1).gather(1, l1_lab[:, None])[:, 0]
    l1 = _weighted(raw, (l1_lab != void).float())
    l1_dec = torch.argmax(l1_up, 1)
    out = {"l1_segmentation": l1}
    for name, u, head in (("l2_vehicle_segmentation", up[1], "vehicle"),
                          ("l2_human_segmentation", up[2], "human")):
        n = u.shape[1]
        pp_lab = F.one_hot(_table(hier[f"per_pixel_cids2{head}_cids"], dev)[pp], n).float()
        weak_lab = weak.float() @ projection(hier[f"per_bbox_cids2{head}_cids"], n, dev)
        lab = torch.cat([pp_lab, weak_lab], 0).permute(0, 3, 1, 2)
        raw = -torch.sum(lab * F.log_softmax(u, 1), 1)
        gate = ((1.0 - lab[n_pp:, -1]) > 0.01) \
            & (l1_dec[n_pp:] == hier[f"cid_l1_{head}"]) \
            & (lab[n_pp:, :-1].amax(1) >= 0.01)
        weights = torch.cat([1.0 - lab[:n_pp, -1], gate.float()], 0)
        out[name] = _weighted(raw, weights)
    out["total"] = out["l1_segmentation"] + cfg["weak_loss_coefficient"] * (
        out["l2_vehicle_segmentation"] + out["l2_human_segmentation"])
    return out


def train_steps(params: dict, batches: list, cfg: dict, rnd=None) -> dict:
    """One SGD step a batch from ``params`` (which are left as they are).

    Each batch is a dict of tensors: 'proimages_per_pixel',
    'proimages_per_bbox', 'proimages_per_image' (N, H, W, 3),
    'prolabels_per_pixel' (N, H, W), 'prolabels_per_bbox',
    'prolabels_per_image' (N, H, W, 15). Returns the losses of each step
    (floats), the first step's loss gradient of every parameter, and the
    parameters after the last step. Each trunk unit recomputes its
    activations in the backward, so that the full-size cells' steps fit
    beside the program's freed memory.
    """
    names = [k for k in params if not k.endswith((".mean", ".var"))]
    w = {k: params[k].detach().clone().float() for k in params}
    mom = {k: torch.zeros_like(w[k]) for k in names}
    lr, mu, wd = cfg["learning_rate_values"][0], cfg["momentum"], cfg["weight_decay"]
    out = {"losses": [], "first_grads": None}
    for batch in batches:
        images = torch.cat([batch[k] for k in ("proimages_per_pixel", "proimages_per_bbox",
                                               "proimages_per_image")], 0)
        weak = torch.cat([batch["prolabels_per_bbox"], batch["prolabels_per_image"]], 0)
        leaves = {k: w[k].requires_grad_(k in mom) for k in w}
        logits = forward(leaves, images, cfg, train=True, rnd=rnd, remat=True)
        up = [upsample(t, images.shape[1:3]) for t in logits]
        del logits
        terms = losses(up, batch["prolabels_per_pixel"], weak, cfg)
        del up
        grads = torch.autograd.grad(terms["total"], [leaves[k] for k in names])
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        with torch.no_grad():
            if out["first_grads"] is None:
                out["first_grads"] = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                p = w[k].detach()
                if k.endswith(".weight"):
                    g = g + wd * p
                mom[k].mul_(mu).add_(g)
                w[k] = p - lr * mom[k]
        del grads, terms
    out["params"] = {k: w[k].detach() for k in names}
    return out


def eval_class_map(problem: dict) -> list:
    """Training -> evaluation class ids of a problem definition without its
    own map: the identity, the void class (-1 in ``lids2cids``) to the
    trailing id."""
    n = max(problem["lids2cids"]) + 1 + (-1 in problem["lids2cids"])
    return list(range(n))


@torch.no_grad()
def confusion(params: dict, images: torch.Tensor, labels: torch.Tensor, cfg: dict,
              problem: dict, rnd=None, chunk: int = 2) -> torch.Tensor:
    """(K, K) int64 confusion matrix of one evaluation batch, K the
    evaluation classes, counted ``chunk`` images at a time."""
    cmap = eval_class_map(problem)
    k = len(cmap)
    dev = images.device
    lh, lw = labels.shape[1], labels.shape[2]
    rows = torch.as_tensor(nearest_table(images.shape[1], lh), device=dev)
    cols = torch.as_tensor(nearest_table(images.shape[2], lw), device=dev)
    cm = torch.zeros(k * k, dtype=torch.int64, device=dev)
    for i in range(0, images.shape[0], chunk):
        logits = forward(params, images[i:i + chunk], cfg, train=False, rnd=rnd)
        dec = decisions([upsample(t, images.shape[1:3]) for t in logits], cfg["hierarchy"])
        dec = _table(cmap, dev)[dec][:, rows][:, :, cols]
        lab = labels[i:i + chunk].long()
        valid = (lab >= 0) & (lab < k)
        cm += torch.bincount((lab * k + dec)[valid], minlength=k * k)
    return cm.view(k, k)


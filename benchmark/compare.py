"""The numbers that decide ``correct``, each worked out from the program's
readings and the plain reference's.

Training (the first two steps of the window's own step):

- ``loss_gap``: |program - reference| / |reference| of the first step's
  loss, L1 + coefficient x (vehicle + human). Later steps' losses are no
  steady number: they follow parameters that the bf16 program and the
  float32 reference have already moved apart, and on the Vistas cell (PSP's
  norms over 8 pooled values) one seed's program read 13% at its third step
  in one run and 1.5% in the next; the later steps are the parameter
  change's to judge. Nor are the gated heads alone: a few hundred weak
  pixels pass the human head's gate there;
- ``grad_gap``: the first step's gradient, by the worst leaf: |program's
  norm - reference's norm| over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``delta_gap``: the same for each leaf's change over the two steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of both leaf gaps.

Evaluation (the confusion matrix the window accumulated):

- ``decision_gap``: the share of counted pixels whose decision differs,
  sum |program - expected| / (2 x expected pixels), the expected matrix
  being the reference's matrix of each batch times the times the window ran
  it;
- ``label_gap``: the pixels by which the matrix's count of each label (its
  row sums) departs from the expected, summed over the labels, exact: every
  label pixel of every step is counted once, whatever was decided there;
- ``decision_gap_vs_bf16``: ``decision_gap`` over the larger of
  ``RATIO_FLOOR`` and the ``decision_gap`` of the reference computed with
  bfloat16 rounding (the configuration's compute type). How many decisions
  sound rounding flips depends on the seed, through how many pixels sit
  near a tie: over a dozen Vistas seeds the sound program's share reached
  more than a third of the float8 control's least, while on each seed the
  control's was 8-47 times the program's. Over the seed's own bf16 share
  the two part (on the H100: sound 0.39-1.20, float8 7.0-46.6, over the
  two evaluation cells).
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["LOSS_KEYS", "RATIO_FLOOR", "confusion_gaps", "kept_leaves", "leaf_gap", "leaf_norms", "loss_gap",
           "step_loss", "train_gaps"]

# the least bf16 share that ``decision_gap_vs_bf16`` divides by
RATIO_FLOOR = 0.01
LOSS_KEYS = ("l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation")


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def kept_leaves(ref_grad_norms: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def leaf_gap(prog: dict, ref: dict, keep) -> tuple:
    """(gap, leaf) of the worst kept leaf."""
    med = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def step_loss(losses: dict, coefficient: float) -> float:
    return losses["l1_segmentation"] + coefficient * (losses["l2_vehicle_segmentation"]
                                                      + losses["l2_human_segmentation"])


def loss_gap(prog: list, ref: list, coefficient: float) -> tuple:
    """(gap, 0) of the first step's loss (dicts of the heads' floats)."""
    p, r = step_loss(prog[0], coefficient), step_loss(ref[0], coefficient)
    return abs(p - r) / max(abs(r), 1e-12), 0


def train_gaps(prog_losses, prog_grads, prog_deltas, ref_losses, ref_grads, ref_deltas,
               coefficient: float) -> dict:
    """{name: (gap, where)} of the three training numbers; the norms are
    dicts of floats by leaf."""
    keep = kept_leaves(ref_grads)
    return {"loss_gap": loss_gap(prog_losses, ref_losses, coefficient),
            "grad_gap": leaf_gap(prog_grads, ref_grads, keep),
            "delta_gap": leaf_gap(prog_deltas, ref_deltas, keep)}


def _decision_share(program: torch.Tensor, expected: torch.Tensor) -> float:
    return float((program - expected).abs().sum()) / (2.0 * float(expected.sum()))


def confusion_gaps(program: torch.Tensor, expected: torch.Tensor, rounded=None) -> dict:
    """{name: (gap, where)} of the evaluation numbers; with ``rounded``, the
    bf16-rounded reference's matrix, also ``decision_gap_vs_bf16`` (where:
    that reference's own ``decision_gap``)."""
    program, expected = program.double().cpu(), expected.double().cpu()
    gap = _decision_share(program, expected)
    out = {"decision_gap": (gap, None),
           "label_gap": (float((program.sum(1) - expected.sum(1)).abs().sum()), None)}
    if rounded is not None:
        base = _decision_share(rounded.double().cpu(), expected)
        out["decision_gap_vs_bf16"] = (gap / max(base, RATIO_FLOOR), base)
    return out

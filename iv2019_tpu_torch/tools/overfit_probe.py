"""Learning-evidence probe: overfit the flagship model on one fixed batch.

Port of tools/overfit_probe.py. Runs the real mixed-supervision train step
(hierarchical losses through kernels B1/B2, decision gates, the fused SGDM
+ EMA update, kernel B3: the program ``train_cli`` runs) on one fixed
synthetic batch and shows that optimization works: the total loss falls
and the train mIoU climbs toward 1. A broken gradient path, loss term or
optimizer wiring shows up as a flat curve.

The Settings (but for ``bn_impl``: the port's default, or
``IV_BN_IMPL``), the batch (the same draws from
``np.random.RandomState(0)``) and the JSON line's keys are the JAX tool's.
The initial weights are the port's own draw (``models/model.py::init_model``
from seed 0), not flax's, so the trajectory is not JAX's number for number.

Usage:
  python -m iv2019_tpu_torch.tools.overfit_probe [steps] [--size HxW]
      [--device cuda|cpu]

Prints one JSON line with the loss and mIoU trajectory; ``learned`` is
true when the last loss is below 0.1 x the first and the last mIoU above
0.8. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from iv2019_tpu_torch.config import Settings

NB = (2, 2, 2)  # per-pixel, bbox, image-label examples
NUM_WEAK_CLASSES = 15
BLOCK = 32  # side of the label regions, pixels


def probe_settings(h: int = 128, w: int = 256, device: str = "cuda") -> Settings:
    """The JAX tool's Settings: Cityscapes, Nb 2/2/2, bf16, no L2 pull."""
    npp, npb, npi = NB
    return Settings(
        per_pixel_dataset_name="cityscapes", device=device,
        Nb_per_pixel=npp, Nb_per_bbox=npb, Nb_per_image=npi, Nb=npp,
        height_feature_extractor=h, width_feature_extractor=w,
        Ntrain=64, Ne=17,
        learning_rate_boundaries=(8, 15, 17),
        learning_rate_values=(0.01, 0.005, 0.0025),
        compute_dtype="bfloat16",
        regularization_weight=0.0,  # pure fit: no pull away from the data
        bn_impl=os.environ.get("IV_BN_IMPL", Settings.bn_impl),
    ).finalize()


def probe_batch(h: int, w: int) -> dict:
    """The JAX tool's batch, numpy, in its order of draws: blocky per-pixel
    labels (a piecewise-constant function of position, so there is
    image -> label structure to learn), the three image sets, then the
    blocky bbox and image-label multinomials (one-hot)."""
    npp, npb, npi = NB
    rng = np.random.RandomState(0)

    def img(n):
        return rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)

    def blocky(n, num_classes):
        base = rng.randint(0, num_classes, (n, h // BLOCK, w // BLOCK))
        return np.repeat(np.repeat(base, BLOCK, axis=1), BLOCK, axis=2)

    eye = np.eye(NUM_WEAK_CLASSES, dtype=np.float32)
    pp_labels = blocky(npp, 20).astype(np.int32)
    batch = {
        "proimages_per_pixel": img(npp),
        "proimages_per_bbox": img(npb),
        "proimages_per_image": img(npi),
        "prolabels_per_pixel": pp_labels,
    }
    batch["prolabels_per_bbox"] = eye[blocky(npb, NUM_WEAK_CLASSES)]
    batch["prolabels_per_image"] = eye[blocky(npi, NUM_WEAK_CLASSES)]
    return batch


def run(settings: Settings, model: torch.nn.Module, steps: int) -> dict:
    """``steps`` fused train steps of ``model`` (its weights as given) on
    ``probe_batch``; returns the JSON line's dict."""
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    device = next(model.parameters()).device
    batch = {k: torch.as_tensor(v, device=device) for k, v in probe_batch(
        settings.height_feature_extractor, settings.width_feature_extractor).items()}
    fused_opt = FusedSGDM(settings, model)
    state = create_fused_train_state(fused_opt)
    step_fn = make_train_step(settings, fused_opt=fused_opt)

    losses, mious, trace_steps = [], [], []
    for i in range(steps):
        state, metrics = step_fn(state, batch)
        if i % max(steps // 20, 1) == 0 or i == steps - 1:
            losses.append(round(float(metrics["total"]), 4))
            # the step's own batch mIoU (confusion-matrix based, in the
            # label space the loss trains)
            mious.append(round(float(metrics["miou"]), 4))
            trace_steps.append(i)
    return {
        "metric": "overfit_probe",
        "steps": trace_steps,
        "loss": losses,
        "train_miou": mious,
        "loss_drop": round(losses[0] - losses[-1], 4),
        "final_miou": mious[-1],
        "learned": bool(losses[-1] < 0.1 * losses[0] and mious[-1] > 0.8),
    }


def main(argv=None) -> dict:
    from iv2019_tpu_torch.models.model import build_model, init_model

    p = argparse.ArgumentParser(description="overfit the flagship model on one batch")
    p.add_argument("steps", type=int, nargs="?", default=200)
    p.add_argument("--size", default="128x256", help="HxW")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("overfit_probe: no CUDA device; pass --device cpu to run on the CPU")
    h, w = (int(v) for v in args.size.split("x"))
    settings = probe_settings(h, w, args.device)
    model = init_model(build_model(settings.replace(mode="train")),
                       torch.Generator().manual_seed(0))
    result = run(settings, model, args.steps)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

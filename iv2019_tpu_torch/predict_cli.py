"""Prediction entry point of the PyTorch port.

Usage:
  python -m iv2019_tpu_torch.predict_cli LOG_DIR PROBLEM_DEF PREDICT_DIR \\
      [--ckpt_path STEP|PATH/STEP|model.npz] [--restore_emas] [--fused_block]
      [--device cpu] [export flags]

Port of iv2019_tpu/predict_cli.py with the predict loop of
iv2019_tpu/system.py:231-288, through ``SemanticSegmentation.predict``.
Weights come from the port's training run in LOG_DIR (the latest checkpoint
under LOG_DIR/checkpoints, or the step ``--ckpt_path`` names) or from a
converted trained checkpoint (``--ckpt_path model.npz``, reference variable
names); ``--restore_emas`` takes the zero-debiased EMA shadows
(system.py::restore_variables). Exports, per image, into ``results_dir``
(default LOG_DIR/predictions):

- ``--export_lids_images``: label-id PNGs via cids2lids
- ``--export_color_decisions``: palette-colorized decisions
- ``--export_overlapped_color_decisions``: 0.5-alpha blend of raw + color

With no export flag the colorized decisions are written. Without
``--height_system``/``--width_system`` the outputs are resized on the host
to each image's raw size.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Iterator

import numpy as np
from PIL import Image

from iv2019_tpu_torch.config import (
    PREDICT,
    build_argparser,
    resolve_dataset_name,
    resolve_trained_model,
    settings_from_args,
)
from iv2019_tpu_torch.input.predict_input import predict_input
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from iv2019_tpu_torch.system import SemanticSegmentation, restore_variables
from iv2019_tpu_torch.train.step import PROB_KEYS, make_predict_step

PREDICT_KEYS = (
    "decisions",
    "l1_probabilities",
    "l2_vehicle_probabilities",
    "rawimages",
    "rawimagespaths",
)


def _overlapped(item, palette) -> np.ndarray:
    color = palette[np.clip(item["decisions"], 0, len(palette) - 1)]
    raw = np.asarray(item["rawimages"])
    return (0.5 * raw + 0.5 * color).astype(np.uint8)


def _export(item, out_dir, palette, cids2lids, settings, default_color) -> None:
    stem = os.path.splitext(os.path.basename(str(item.get("rawimagespaths", "image"))))[0]
    decisions = np.asarray(item["decisions"], np.int32)
    if settings.export_lids_images and cids2lids.size:
        lids = cids2lids[np.clip(decisions, 0, len(cids2lids) - 1)]
        Image.fromarray(lids.astype(np.uint8)).save(
            os.path.join(out_dir, f"{stem}_result_lids.png"))
    if settings.export_color_decisions or default_color:
        color = palette[np.clip(decisions, 0, len(palette) - 1)]
        Image.fromarray(color).save(os.path.join(out_dir, f"{stem}_result_color.png"))
    if settings.export_overlapped_color_decisions and "rawimages" in item:
        Image.fromarray(_overlapped(item, palette)).save(
            os.path.join(out_dir, f"{stem}_result_overlapped_color.png"))


def restore_model(model, settings) -> None:
    """Load the trained weights ``settings`` names into ``model``
    (``system.restore_variables``: a checkpoint of the training run in
    ``log_dir`` or a converted ``.npz``); raises FileNotFoundError, with
    what to give instead, where there is none."""
    print(f"restored {restore_variables(model, settings)}")


def predict(settings, model, features: Iterator[dict] = None) -> Iterator[dict]:
    """Yields one numpy predictions dict per image of ``features`` (default
    ``predict_input(settings)``), as system.py:231-288."""
    predict_fn = make_predict_step(settings, model=model)
    arbitrary = not (settings.height_system and settings.width_system)
    for features in (predict_input(settings) if features is None else features):
        out = {k: v.cpu().numpy() for k, v in predict_fn(features["proimages"]).items()}
        item = {k: v[0] for k, v in out.items()}
        item["rawimages"] = features["rawimages"]
        item["rawimagespaths"] = features["rawimagespaths"]
        if arbitrary:
            raw_hw = item["rawimages"].shape[:2]
            for k in PROB_KEYS:
                item[k] = resize_bilinear(item[k], raw_hw, align_corners=True)
            item["decisions"] = resize_nearest(item["decisions"], raw_hw, align_corners=True)
        yield {k: v for k, v in item.items() if k in settings.predict_keys}


def main(argv):
    args = build_argparser(PREDICT).parse_args(argv)
    settings = settings_from_args(args, PREDICT, predict_keys=PREDICT_KEYS)
    settings = resolve_dataset_name(settings, args.per_pixel_dataset_name)
    settings = resolve_trained_model(settings, argv)

    # the weights are restored over the uninitialized model
    system = SemanticSegmentation({"predict": lambda s, _pd: predict_input(s)},
                                  model_fn=build_model, settings=settings)
    pd = system.inference_problem_def
    palette = pd.palette()
    cids2lids = np.asarray(pd.cids2lids, np.int64)

    results_dir = settings.results_dir or os.path.join(settings.log_dir, "predictions")
    os.makedirs(results_dir, exist_ok=True)
    default_color = not (
        settings.export_lids_images or settings.export_color_decisions
        or settings.export_overlapped_color_decisions
    )

    n = 0
    total = 0.0
    t0 = time.time()
    for item in system.predict():
        dt = time.time() - t0
        total += dt
        sys.stdout.write(f"Time per image (input pipeline + network): {dt:.3f}s\r")
        sys.stdout.flush()
        _export(item, results_dir, palette, cids2lids, settings, default_color)
        n += 1
        t0 = time.time()
    print(f"\nTotal time (input pipeline + network): {total:.3f}s; "
          f"predicted {n} images -> {results_dir}")
    return n


if __name__ == "__main__":
    main(sys.argv[1:])

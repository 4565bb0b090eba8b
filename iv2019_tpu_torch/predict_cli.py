"""Prediction entry point of the PyTorch port.

Usage:
  python -m iv2019_tpu_torch.predict_cli LOG_DIR PROBLEM_DEF PREDICT_DIR \\
      [--ckpt_path STEP|PATH/STEP|model.npz] [--restore_emas] [--fused_block]
      [--device cpu] [--eval_scales S ... --eval_flip]
      [--eval_size H W [--sliding_window]] [export and plotting flags]

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
- ``--plotting [--plot_l1_confidence --plot_l2_confidence]``: one figure
  per image, raw | colorized decisions | optional confidence panel (max
  over classes of p^50, the nipy_spectral colormap), as ``plot_NNNNN.png``
- ``--plotting_overlapped``: the overlapped blend as
  ``plot_overlapped_NNNNN.png``

The reference shows its plots in live windows; here they are saved
(matplotlib's Agg backend, imported only under a plotting flag), so
``--timeout`` is accepted and has no effect. With no export or plotting
flag the colorized decisions are written. ``--eval_scales``/``--eval_flip``
average the heads over a scale/flip ensemble, ``--sliding_window`` stitches
them from (hf, wf) windows of the ``--eval_size`` image
(train/step.py::make_predict_step). Without
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


def _confidence_panel(item) -> np.ndarray:
    """[max_c l1_p^50 | max_c l2v_p^50] (reference predict.py:113-118)."""
    panels = []
    for key in ("l1_probabilities", "l2_vehicle_probabilities"):
        p = np.asarray(item[key], np.float32)
        panels.append(np.amax(np.power(p, 50), axis=2))
    return np.concatenate(panels, axis=1)


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


def _plot_frame(item, out_dir, palette, settings, n, plt) -> None:
    """One frame of the plotting modes, written as a PNG."""
    if settings.plotting_overlapped:
        plt.imsave(os.path.join(out_dir, f"plot_overlapped_{n:05}.png"), _overlapped(item, palette))
        return
    with_conf = settings.plot_l1_confidence or settings.plot_l2_confidence
    ncols = 3 if with_conf else 2
    fig, axs = plt.subplots(1, ncols, figsize=(5 * ncols, 4))
    axs[0].imshow(np.asarray(item["rawimages"]))
    axs[0].set_title("input")
    axs[1].imshow(palette[np.clip(item["decisions"], 0, len(palette) - 1)])
    axs[1].set_title("decisions")
    if with_conf:
        conf = axs[2].imshow(_confidence_panel(item), cmap="nipy_spectral")
        axs[2].set_title("confidence (p^50)")
        fig.colorbar(conf, ax=axs[2], ticks=[])
    for ax in axs:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"plot_{n:05}.png"))
    plt.close(fig)


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
        settings.plotting or settings.plotting_overlapped
        or settings.export_lids_images or settings.export_color_decisions
        or settings.export_overlapped_color_decisions
    )
    plt = None
    if settings.plotting or settings.plotting_overlapped:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt  # noqa: PLC0415

    n = 0
    total = 0.0
    t0 = time.time()
    for item in system.predict():
        dt = time.time() - t0
        total += dt
        sys.stdout.write(f"Time per image (input pipeline + network): {dt:.3f}s\r")
        sys.stdout.flush()
        _export(item, results_dir, palette, cids2lids, settings, default_color)
        if plt is not None:
            _plot_frame(item, results_dir, palette, settings, n, plt)
        n += 1
        t0 = time.time()
    print(f"\nTotal time (input pipeline + network): {total:.3f}s; "
          f"predicted {n} images -> {results_dir}")
    return n


if __name__ == "__main__":
    main(sys.argv[1:])

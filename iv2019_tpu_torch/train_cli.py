"""Training entry point of the PyTorch port (reference code/train.py).

Usage:
  python -m iv2019_tpu_torch.train_cli LOG_DIR {cityscapes,vistas} [flags]

Port of iv2019_tpu/train_cli.py. Runs on the CUDA card unless given
``--device cpu``. Per-dataset constants follow reference train.py:42-68;
explicit ``--Nb_per_*`` flags win over them. ``--num_devices N`` trains
data-parallel on N ranks, spawned here, one per device (default: every
visible card); ``--num_processes P --coordinator_address HOST:PORT
--process_id I`` adds hosts, each started with its own I; ``--num_processes
0`` takes the ranks torchrun starts (parallel/multihost.py). ``Nb_per_*``
are the global batch. ``--spatial_partitions S`` splits each image's height
over groups of S ranks (the height must divide by 8 S).
"""

from __future__ import annotations

import os
import sys

from iv2019_tpu_torch.config import TRAIN, build_argparser, settings_from_args
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.system import SemanticSegmentation

_PKG = os.path.dirname(os.path.abspath(__file__))


def _add_extra_args(settings):
    """Per-dataset constants (reference train.py:42-68)."""
    extra = {}
    if settings.per_pixel_dataset_name == "vistas":
        extra.update(
            Ntrain=settings.Ntrain if settings.Ntrain != 2975 else 18000,
            height_feature_extractor=621 if settings.height_feature_extractor == 512
            else settings.height_feature_extractor,
            width_feature_extractor=855 if settings.width_feature_extractor == 1024
            else settings.width_feature_extractor,
        )
    if not settings.training_problem_def_path:
        extra["training_problem_def_path"] = os.path.join(
            _PKG, "problem_definitions", settings.per_pixel_dataset_name, "problem01.json")
    extra.update(
        Nb_per_pixel=4,
        Nb_per_bbox=8,
        Nb_per_image=4,
        Nb=4,
        preserve_aspect_ratio_per_pixel=False,
        preserve_aspect_ratio_per_bbox=True,
        preserve_aspect_ratio_per_image=True,
        norm_train_variables=True,
        batch_norm_accumulate_statistics=True,
    )
    return settings.replace(**extra)


def _apply_sub_batch_overrides(settings, args):
    """Explicit --Nb_per_* flags win over the hard-coded reference constants."""
    overrides = {}
    for k in ("Nb_per_pixel", "Nb_per_bbox", "Nb_per_image"):
        v = getattr(args, k, None)
        if v is not None:
            overrides[k] = v
    if overrides:
        overrides["Nb"] = overrides.get("Nb_per_pixel", settings.Nb_per_pixel)
        settings = settings.replace(**overrides)
    return settings


def main(argv):
    args = build_argparser(TRAIN).parse_args(argv)
    settings = settings_from_args(args, TRAIN)
    settings = _apply_sub_batch_overrides(_add_extra_args(settings), args)
    return multihost.launch(_train, settings)


def _train(settings):
    """One rank's run (every rank's, when this process is the only one)."""
    return SemanticSegmentation({"train": train_input}, settings=settings).train()


if __name__ == "__main__":
    main(sys.argv[1:])

"""Evaluation entry point of the PyTorch port.

Usage:
  python -m iv2019_tpu_torch.evaluate_cli LOG_DIR NEVAL PROBLEM_DEF \\
      [--eval_all_ckpts | --ckpt_path STEP|PATH/STEP|model.npz] [--restore_emas]
      [--eval_scales S ...] [--eval_flip] [--eval_size H W [--sliding_window]]
      [--fused_block] [--device cpu] [--synthetic_data | --tfrecords_path PATH]

Port of iv2019_tpu/evaluate_cli.py, through ``SemanticSegmentation.evaluate``:
evaluates one checkpoint of the port's training run in LOG_DIR (the latest,
or the one ``--ckpt_path`` names) or all of them (``--eval_all_ckpts``) on
NEVAL examples of ``input/cityscapes.py::evaluate_input``, prints per-class
metrics, and writes ``all_metrics.txt`` and ``all_metrics.p`` beside the
settings in ``LOG_DIR/eval_NN``. The dataset name and the architecture come
from the run's settings.txt; pass the input size
(``--height_feature_extractor/--width_feature_extractor``) again.
``--num_devices``, ``--num_processes``, ``--coordinator_address`` and
``--process_id`` sweep across ranks as training does (system.py); rank 0
alone prints and writes, and the call returns the metrics in the process
that ran rank 0 when it ran in this process (None after a spawn).
``--spatial_partitions S`` splits each image's height over groups of S of
one process's ``--num_devices`` ranks (plain eval only: TTA, windows and
several processes refuse it, as in the JAX package).
"""

from __future__ import annotations

import os
import pickle
import sys

from iv2019_tpu_torch.config import (
    EVAL,
    build_argparser,
    resolve_dataset_name,
    resolve_trained_model,
    settings_from_args,
)
from iv2019_tpu_torch.input.cityscapes import evaluate_input
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.system import SemanticSegmentation
from iv2019_tpu_torch.utils.metrics import print_metrics_from_confusion_matrix


def main(argv):
    args = build_argparser(EVAL).parse_args(argv)
    settings = settings_from_args(args, EVAL)
    settings = resolve_dataset_name(settings, args.per_pixel_dataset_name)
    settings = resolve_trained_model(settings, argv)
    return multihost.launch(_evaluate, settings)


def _evaluate(settings):
    """One rank's sweep; rank 0 writes the files."""
    # the weights are restored over the uninitialized model
    system = SemanticSegmentation({"eval": evaluate_input}, model_fn=build_model,
                                  settings=settings)
    all_metrics = system.evaluate()
    if not multihost.is_primary():
        return all_metrics

    out_dir = system.eval_res_dir
    labels = list(system.evaluation_problem_def.cids2labels)
    if -1 in system.evaluation_problem_def.lids2cids and not settings.train_void_class:
        labels = labels[:-1]
    with open(os.path.join(out_dir, "all_metrics.txt"), "w") as f:
        for metrics in all_metrics:
            print(f"step: {metrics['global_step']}", file=f)
            print_metrics_from_confusion_matrix(metrics["confusion_matrix"], labels, printfile=f,
                                                summary=True)
    with open(os.path.join(out_dir, "all_metrics.p"), "wb") as f:
        pickle.dump(all_metrics, f)
    return all_metrics


if __name__ == "__main__":
    main(sys.argv[1:])

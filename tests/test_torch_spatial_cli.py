"""The port's command lines under spatial partitioning, on the CPU with gloo.

- ``train_cli --num_devices 2 --spatial_partitions 2 --device cpu`` spawns
  2 ranks that split each image's height and trains 2 steps (64x128, 2 + 2
  + 2 images a step, the full ResNet-50): checkpoints and metrics written
  by rank 0 alone, finite metrics, ``spatial_partitions : 2`` in
  settings.txt.
- ``evaluate_cli --num_devices 2 --spatial_partitions 2`` on that run's
  checkpoint, in f32, gives the confusion matrix of the single-process
  ``evaluate_cli``, integer for integer.
- The refusals keep the JAX package's wording: TTA and sliding windows
  (``ValueError``) and multi-process eval (``NotImplementedError``) with
  ``--spatial_partitions 2``.

Every command runs under its own timeout (180 s), so a rank that hangs
fails its test.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from iv2019_tpu_torch import evaluate_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")
SIZE = ["--height_feature_extractor", "64", "--width_feature_extractor", "128"]
TRAIN_ARGS = ["cityscapes", "--synthetic_data", *SIZE, "--Nb_per_pixel", "2", "--Nb_per_bbox",
              "2", "--Nb_per_image", "2", "--Ne", "1", "--learning_rate_boundaries", "1",
              "--learning_rate_values", "0.01", "--input_seed", "3", "--device", "cpu",
              "--Ntrain", "4", "--num_devices", "2", "--spatial_partitions", "2"]
SPATIAL = ["--num_devices", "2", "--spatial_partitions", "2"]
TIMEOUT = 180


def _run(module, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log = p.communicate(timeout=TIMEOUT)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, log[-4000:]
    return log


def _eval_argv(log_dir, *flags):
    return [str(log_dir), "4", PROBLEM, "--synthetic_data", *SIZE, "--Nb", "2", "--device",
            "cpu", "--compute_dtype", "float32", *flags]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("spatial_cli") / "log"
    _run("iv2019_tpu_torch.train_cli", [str(log_dir), *TRAIN_ARGS])
    matrices = []
    for flags in ((), SPATIAL):
        _run("iv2019_tpu_torch.evaluate_cli", _eval_argv(log_dir, *flags))
        with open(log_dir / f"eval_0{len(matrices)}" / "all_metrics.p", "rb") as f:
            matrices.append([m["confusion_matrix"] for m in pickle.load(f)])
    return {"log_dir": log_dir, "matrices": matrices}


def test_spatial_training_through_train_cli(run):
    log_dir = run["log_dir"]
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["2"]
    records = [json.loads(r) for r in (log_dir / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for v in records[0].values())
    settings = (log_dir / "settings.txt").read_text()
    assert " : spatial_partitions : 2" in settings
    assert len(os.listdir(log_dir / "tb")) == 1


def test_spatial_evaluate_cli_equals_one_process(run):
    (single,), (spatial,) = run["matrices"]
    assert single.dtype == spatial.dtype == np.int64
    assert 0 < single.sum() <= 4 * 64 * 128
    np.testing.assert_array_equal(spatial, single)


@pytest.mark.parametrize("flags,error,match", [
    (["--eval_flip"], ValueError, "TTA"),
    (["--eval_size", "64", "128", "--sliding_window"], ValueError, "sliding_window"),
    (["--num_processes", "2", "--coordinator_address", "localhost:1", "--process_id", "0"],
     NotImplementedError, "multi-process eval"),
], ids=["tta", "windows", "multi_process"])
def test_evaluate_cli_refusals_stay(run, flags, error, match):
    argv = _eval_argv(run["log_dir"], "--spatial_partitions", "2", *flags)
    with pytest.raises(error, match=match):
        evaluate_cli.main(argv)

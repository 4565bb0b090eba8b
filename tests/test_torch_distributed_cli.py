"""The port's command lines across ranks, on the CPU with gloo.

- ``train_cli --num_devices 2 --device cpu`` spawns 2 ranks and trains 2
  steps (64x128, 2 + 2 + 2 images a step, the full ResNet-50): one
  settings.txt and all_code.zip, checkpoints and metrics written by rank 0
  alone (one TensorBoard file, one metrics record a logged step, no temp
  directory left), finite metrics; a rerun on the directory with
  settings.txt moved aside resumes at step 2 and stops at 4.
- ``evaluate_cli --eval_all_ckpts`` over that run's checkpoints 2 and 4:
  the 2-process sweep (``--num_processes 2 --coordinator_address
  localhost:P --process_id I``, each process evaluating every other
  checkpoint) and the 2-rank sweep of one launch (``--num_devices 2``, the
  ranks taking rows of each batch) give, on rank 0, files whose confusion
  matrices equal the single-process sweep's, integer for integer.

- ``python -m torch.distributed.run --nproc_per_node 2 -m
  iv2019_tpu_torch.train_cli ... --num_processes 0``: the ranks torchrun
  starts train 2 steps, rank 0 alone writing.

Every command runs under its own timeout (180 s), so a rank that hangs
fails its test.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from iv2019_tpu_torch.parallel.multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")
SIZE = ["--height_feature_extractor", "64", "--width_feature_extractor", "128"]
RUN_ARGS = ["cityscapes", "--synthetic_data", *SIZE, "--Nb_per_pixel", "2", "--Nb_per_bbox", "2",
            "--Nb_per_image", "2", "--Ne", "1", "--learning_rate_boundaries", "1",
            "--learning_rate_values", "0.01", "--input_seed", "3", "--device", "cpu"]
TRAIN_ARGS = RUN_ARGS + ["--num_devices", "2"]
TIMEOUT = 180


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _popen(module, argv):
    return subprocess.Popen([sys.executable, "-m", module, *argv], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def _train(log_dir, steps):
    # Ntrain / Nb steps in the one epoch
    return _wait([_popen("iv2019_tpu_torch.train_cli",
                         [str(log_dir), *TRAIN_ARGS, "--Ntrain", str(2 * steps)])])[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("dist_cli") / "log"
    first = _train(log_dir, 2)
    snapshot = {"checkpoints": sorted(os.listdir(log_dir / "checkpoints")),
                "records": (log_dir / "train_metrics.jsonl").read_text().splitlines(),
                "tb": os.listdir(log_dir / "tb")}
    shutil.move(str(log_dir / "settings.txt"), str(log_dir / "settings_1.txt"))
    resumed = _train(log_dir, 4)
    return {"log_dir": log_dir, "first": first, "snapshot": snapshot, "resumed": resumed}


def test_two_rank_training_writes_once(run):
    log_dir, snap = run["log_dir"], run["snapshot"]
    assert snap["checkpoints"] == ["2"]
    assert len(snap["tb"]) == 1
    records = [json.loads(r) for r in snap["records"]]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for v in records[0].values())
    assert (log_dir / "all_code.zip").is_file()
    settings = (log_dir / "settings_1.txt").read_text()
    assert " : num_devices : 2" in settings


def test_two_rank_training_resumes(run):
    log_dir = run["log_dir"]
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["2", "4"]
    records = [json.loads(r) for r in (log_dir / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2, 4]
    assert (log_dir / "settings.txt").is_file()


def _eval_argv(log_dir, *flags):
    return [str(log_dir), "4", PROBLEM, "--synthetic_data", *SIZE, "--Nb", "2",
            "--eval_all_ckpts", "--device", "cpu", *flags]


def _metrics(eval_dir):
    with open(eval_dir / "all_metrics.p", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def sweeps(run):
    log_dir = run["log_dir"]
    _wait([_popen("iv2019_tpu_torch.evaluate_cli", _eval_argv(log_dir))])
    port = free_port()
    _wait([_popen("iv2019_tpu_torch.evaluate_cli", _eval_argv(
        log_dir, "--num_processes", "2", "--coordinator_address", f"localhost:{port}",
        "--process_id", str(i))) for i in range(2)])
    _wait([_popen("iv2019_tpu_torch.evaluate_cli", _eval_argv(log_dir, "--num_devices", "2"))])
    return [_metrics(log_dir / f"eval_0{i}") for i in range(3)]


@pytest.mark.parametrize("which", [1, 2], ids=["two_processes", "two_devices"])
def test_sweep_across_ranks_equals_one_process(sweeps, which):
    single, got = sweeps[0], sweeps[which]
    assert [m["global_step"] for m in single] == [2, 4]
    assert [m["global_step"] for m in got] == [2, 4]
    for a, b in zip(single, got):
        assert a["confusion_matrix"].dtype == b["confusion_matrix"].dtype == np.int64
        np.testing.assert_array_equal(a["confusion_matrix"], b["confusion_matrix"])
        # the labeled pixels of the 4 images (void is not counted)
        assert 0 < a["confusion_matrix"].sum() <= 4 * 64 * 128


def test_torchrun_ranks_train(tmp_path):
    log_dir = tmp_path / "log"
    _wait([subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(free_port()), "-m", "iv2019_tpu_torch.train_cli", str(log_dir),
         *RUN_ARGS, "--Ntrain", "4", "--num_processes", "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["2"]
    records = [json.loads(r) for r in (log_dir / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for v in records[0].values())

"""The port's training command line, end to end on the CPU.

``python -m iv2019_tpu_torch.train_cli LOG cityscapes --synthetic_data
--device cpu`` at 64x128 with one image of each supervision, two steps:
settings.txt, all_code.zip of the port's package, checkpoints/2, a
train_metrics.jsonl record at the last step with finite values, and a
TensorBoard event file with the scalars and the image summaries. A second
run on the same directory refuses on settings.txt. The settings the port's
command line builds agree with the JAX package's for the same arguments,
and the multi-device flags refuse what cannot run (spatial partitions with
NotImplementedError).
"""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from iv2019_tpu import train_cli as jax_train_cli
from iv2019_tpu.config import TRAIN as JAX_TRAIN
from iv2019_tpu.config import build_argparser as jax_build_argparser
from iv2019_tpu.config import settings_from_args as jax_settings_from_args
from iv2019_tpu_torch import train_cli
from iv2019_tpu_torch.config import TRAIN, build_argparser, settings_from_args
from iv2019_tpu_torch.input.tfrecord import read_tfrecords

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["cityscapes", "--synthetic_data", "--height_feature_extractor", "64",
        "--width_feature_extractor", "128", "--Nb_per_pixel", "1", "--Nb_per_bbox", "1",
        "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1", "--learning_rate_boundaries", "1",
        "--learning_rate_values", "0.01", "--input_seed", "3", "--save_summaries_steps", "2"]


def _run(log_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "iv2019_tpu_torch.train_cli", str(log_dir), *ARGS,
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("cli") / "log"
    out = _run(log_dir)
    assert out.returncode == 0, out.stderr[-3000:]
    return log_dir


def test_cli_writes_the_run_artifacts(log_dir):
    settings = (log_dir / "settings.txt").read_text().splitlines()
    assert " : device : cpu" in settings[[" : device : " in s for s in settings].index(True)]
    for line in (" : root_wgrad_pallas : False", " : Nb_per_pixel : 1", " : synthetic_data : True"):
        assert any(s.endswith(line) for s in settings), line
    # "i : key : value" lines sorted by key, as Settings.dump writes them
    keys = [s.split(" : ")[1] for s in settings]
    assert keys == sorted(keys) and settings[0].startswith(" 0 : ")
    with zipfile.ZipFile(log_dir / "all_code.zip") as zf:
        names = set(zf.namelist())
    assert {"train_cli.py", "system.py", "ops/root_wgrad.py", "train/loop.py"} <= names
    assert all(n.endswith(".py") for n in names)
    assert (log_dir / "checkpoints" / "2" / "state.pt").is_file()
    records = [json.loads(line) for line in (log_dir / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for v in records[0].values())
    assert {"total", "miou", "learning_rate", "images_per_sec"} <= records[0].keys()


def test_cli_writes_tensorboard_scalars_and_images(log_dir):
    events = os.listdir(log_dir / "tb")
    assert len(events) == 1 and events[0].startswith("events.out.tfevents.")
    payload = b"".join(read_tfrecords(str(log_dir / "tb" / events[0])))
    assert b"brain.Event:2" in payload
    for tag in (b"total", b"l1_segmentation", b"decisions", b"prolabels", b"debug/l1_weights"):
        assert tag in payload, tag


def test_second_run_refuses_on_settings_txt(log_dir):
    out = _run(log_dir)
    assert out.returncode != 0
    assert "settings.txt" in out.stderr


def test_cli_settings_match_jax(tmp_path):
    argv = [str(tmp_path), *ARGS]
    args = build_argparser(TRAIN).parse_args(argv)
    got = train_cli._apply_sub_batch_overrides(
        train_cli._add_extra_args(settings_from_args(args, TRAIN)), args).finalize()
    jargs = jax_build_argparser(JAX_TRAIN).parse_args(argv)
    want = jax_train_cli._apply_sub_batch_overrides(
        jax_train_cli._add_extra_args(jax_settings_from_args(jargs, JAX_TRAIN)), jargs).finalize()
    common = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
    assert len(common) > 80
    differ = {k for k in common if getattr(got, k) != getattr(want, k)}
    # the problem definitions are each package's own copy of the same file;
    # train-mode BatchNorm defaults to N1/N2 in the port, to flax in JAX
    assert differ == {"training_problem_def_path", "bn_impl"}
    assert (got.bn_impl, want.bn_impl) == ("fused", "flax")
    assert got.device == "cuda"  # the card unless --device cpu


@pytest.mark.parametrize("flags,error,match", [
    # one device cannot hold two slices (the mesh's layout check)
    (["--num_slices", "2"], ValueError, "not divisible into 2 slices"),
    # a global batch of 1 + 1 + 1 cannot split over two processes
    (["--num_processes", "2", "--coordinator_address", "localhost:1"], ValueError,
     "must divide by num_processes=2"),
    # one device cannot hold a spatial group of two (the mesh's layout check)
    (["--spatial_partitions", "2"], ValueError, "not divisible into 1 slices x 2 spatial"),
    # more devices than are visible
    (["--device", "cuda", "--num_devices", "99"], ValueError, "CUDA devices are visible"),
])
def test_unported_flags_are_refused(tmp_path, flags, error, match):
    """What the multi-device flags still refuse (they run otherwise:
    tests/test_torch_distributed_cli.py); nothing is written first."""
    with pytest.raises(error, match=match):
        train_cli.main([str(tmp_path / "log"), *ARGS, "--device", "cpu", *flags])
    assert not (tmp_path / "log" / "settings.txt").exists()


def test_system_derives_what_the_jax_system_does(tmp_path):
    """SemanticSegmentation.__init__: output_Nclasses, the cid maps, the
    finalized settings and the eval_NN numbering, as the JAX system's."""
    from iv2019_tpu.system import SemanticSegmentation as JaxSystem
    from iv2019_tpu_torch.system import SemanticSegmentation
    from torch_parity import torch_tiny_settings

    for name in ("eval_00", "eval_03"):
        (tmp_path / name).mkdir()
    jax_json = os.path.join(ROOT, "iv2019_tpu", "problem_definitions", "vistas", "problem01.json")
    port_json = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "vistas",
                             "problem01.json")
    jax_settings, settings = torch_tiny_settings(log_dir=str(tmp_path), train_void_class=True,
                                                 training_problem_def_path=jax_json)
    want = JaxSystem({}, settings=jax_settings)
    got = SemanticSegmentation({}, settings=settings.replace(training_problem_def_path=port_json))
    assert got.output_Nclasses == want.output_Nclasses
    assert list(got.training_cids2inference_cids) == list(want.training_cids2inference_cids)
    assert list(got.training_cids2evaluation_cids) == list(want.training_cids2evaluation_cids)
    assert got.eval_res_dir == want.eval_res_dir == os.path.join(str(tmp_path), "eval_04")
    assert got.settings.num_training_steps == want.settings.num_training_steps
    # evaluate runs: with no saved step to sweep it writes eval_04's settings
    sweep = SemanticSegmentation({}, settings=settings.replace(
        training_problem_def_path=port_json, eval_all_ckpts=True))
    assert sweep.evaluate() == []
    assert os.path.isfile(os.path.join(str(tmp_path), "eval_04", "settings.txt"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):  # the log dir holds no run
        next(got.predict())


def test_cli_trains_on_real_format_files_with_augmentations_and_accumulation(tmp_path):
    """``train_cli`` on files the port's synthetic_scenes writes, with
    ``--augmentations color,blur,flip,scale --grad_accum_steps 2``."""
    from iv2019_tpu_torch.tools.synthetic_scenes import generate

    data = generate(str(tmp_path / "data"), n_train=4, n_val=1, n_weak=4, h=80, w=160)
    log_dir = tmp_path / "log"
    argv = [str(log_dir), "cityscapes", "--tfrecords_path_per_pixel", data["tfrecords_train"],
            "--openimages_image_dir", data["openimages_image_dir"],
            "--openimages_bboxes_path", data["openimages_bboxes_path"],
            "--openimages_image_labels_path", data["openimages_image_labels_path"],
            "--height_feature_extractor", "64", "--width_feature_extractor", "128",
            "--Nb_per_pixel", "2", "--Nb_per_bbox", "2", "--Nb_per_image", "2", "--Ntrain", "4",
            "--Ne", "1", "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
            "--input_seed", "3", "--augmentations", "color,blur,flip,scale",
            "--grad_accum_steps", "2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "iv2019_tpu_torch.train_cli", *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    records = [json.loads(line) for line in (log_dir / "train_metrics.jsonl").read_text()
               .splitlines()]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for v in records[0].values())
    assert (log_dir / "checkpoints" / "2" / "state.pt").is_file()
    settings = (log_dir / "settings.txt").read_text()
    assert " : augmentations : ('color', 'blur', 'flip', 'scale')" in settings
    assert " : grad_accum_steps : 2" in settings

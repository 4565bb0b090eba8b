"""The port's training loop (train/loop.py) against the JAX package's.

Both loops train the tiny f32 model (helpers.tiny_model, weights carried
across by utils/convert.py) for three steps on the same synthetic
heterogeneous batches (bit-equal, tests/test_torch_input.py), JAX on one
device, with checkpoints every 2 steps and metrics logged every step:

- the ``train_metrics.jsonl`` records: the same keys and steps, losses and
  regularization within 1e-4 relative, batch mIoU within 2e-3 absolute,
  the learning rate equal (the train step's tolerances,
  tests/test_torch_train_step.py, whose reasons hold here);
- the same checkpoint steps (2 and the last, 3).

The port alone (the JAX loop's behaviour, tests/test_resume_export.py and
tests/test_preemption.py):

- resume: 2 steps, then a second run on the same directory to step 4 fed
  the batches after the first two, equals an uninterrupted 4-step run
  within 1e-6 (parameters, BatchNorm statistics, momentum, EMA, metrics);
- warm start from a slim-named npz equals the JAX package's
  ``warm_start_from_npz``, exactly, and the loop applies it;
- resume and warm start together raise;
- an image-summary forward leaves the BatchNorm running statistics as they
  were;
- SIGTERM saves a checkpoint at the true step and restores the caller's
  handler; a rerun resumes from it.
"""

import itertools
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_model
from iv2019_tpu.input.heterogeneous import train_input as jax_train_input
from iv2019_tpu.problem.problem_def import load_problem_def as jax_load_problem_def
from iv2019_tpu.train.loop import train as jax_train
from iv2019_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from iv2019_tpu.utils.checkpoint import warm_start_from_npz as jax_warm_start
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.train.loop import _image_summaries, train
from iv2019_tpu_torch.utils.checkpoint import CheckpointManager, warm_start_from_npz
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_JSON = os.path.join(ROOT, "iv2019_tpu", "problem_definitions", "cityscapes", "problem01.json")
PORT_JSON = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                         "problem01.json")
LOSS_RTOL = 1e-4
MIOU_ATOL = 2e-3
RESUME_TOL = 1e-6
LOSS_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
             "regularization")


def _settings(log_dir, **kw):
    kw = dict(dict(log_dir=str(log_dir), training_problem_def_path=JAX_JSON, synthetic_data=True,
                   input_seed=13, save_checkpoints_steps=2, num_devices=1,
                   async_checkpoints=False), **kw)
    jax_settings, settings = torch_tiny_settings(**kw)
    return jax_settings, settings.replace(training_problem_def_path=PORT_JSON)



def _variables(seed=42):
    jax_settings, _ = _settings("/unused")
    jmodel = tiny_model(jax_settings, train=True)
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((2, 32, 64, 3), np.float32))
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _records(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _port_train(settings, variables, batches=None, **kw):
    model = torch_tiny_model(settings, variables)
    if batches is None:
        batches = train_input(settings, load_problem_def(PORT_JSON))
    kw = dict(dict(log_every=1, image_summaries=False), **kw)
    return train(settings, batches, model=model, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads()
    jax_dir, port_dir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jmodel, variables = _variables()
    jax_settings, _ = _settings(jax_dir)
    jax_train(jax_settings, jax_train_input(jax_settings, jax_load_problem_def(JAX_JSON)),
              model=jmodel, init_variables=variables, max_steps=3, log_every=1,
              image_summaries=False)
    _, settings = _settings(port_dir)
    _port_train(settings, variables, max_steps=3)
    return dict(jax_dir=str(jax_dir), port_dir=str(port_dir))


@pytest.mark.parametrize("i", range(3))
def test_metrics_records_match_jax(runs, i):
    want, got = _records(runs["jax_dir"])[i], _records(runs["port_dir"])[i]
    assert got.keys() == want.keys()
    assert got["step"] == want["step"] == i + 1
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert abs(got["miou"] - want["miou"]) <= MIOU_ATOL
    assert got["learning_rate"] == pytest.approx(want["learning_rate"], rel=1e-7)
    assert np.isfinite(got["images_per_sec"]) and got["images_per_sec"] > 0


def test_checkpoint_steps_match_jax(runs):
    jax_mgr = JaxCheckpointManager(runs["jax_dir"])
    want = jax_mgr.all_steps()
    jax_mgr.close()
    assert CheckpointManager(runs["port_dir"]).all_steps() == sorted(want) == [2, 3]
    for name in ("settings.txt", "all_code.zip"):  # written by system.py, not the loop
        assert not os.path.exists(os.path.join(runs["port_dir"], name))
    assert os.listdir(os.path.join(runs["port_dir"], "tb"))


def _final(state):
    opt = state.opt_state
    params, stats = flax_from_state_dict(state.model.state_dict())
    return dict(params=params, stats=stats, momentum=opt.momentum.numpy().copy(),
                ema=opt.ema_biased.numpy().copy(), prod=float(opt.ema_decay_product),
                step=int(state.step))


def _assert_close(a, b, tol, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_close(a[k], b[k], tol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=path)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    threads()
    _, variables = _variables()
    _, whole = _settings(tmp_path / "whole")
    want = _final(_port_train(whole, variables, max_steps=4))
    _, split = _settings(tmp_path / "split")
    _port_train(split, variables, max_steps=2)
    assert CheckpointManager(split.log_dir).latest_step() == 2
    # a data pipeline positioned after the two batches the first run took
    rest = itertools.islice(train_input(split, load_problem_def(PORT_JSON)), 2, None)
    state = _port_train(split, variables, batches=rest, max_steps=4)
    got = _final(state)
    assert got["step"] == want["step"] == 4
    # restored in place: the parameters are still views of one flat buffer
    assert len({p.untyped_storage().data_ptr() for p in state.model.parameters()}) == 1
    _assert_close(got, want, RESUME_TOL)
    assert CheckpointManager(split.log_dir).all_steps() == [2, 4]
    records = {r["step"]: r for r in _records(split.log_dir)}
    for r in _records(whole.log_dir)[2:]:
        for k in LOSS_KEYS + ("miou",):
            assert records[r["step"]][k] == pytest.approx(r[k], rel=RESUME_TOL, abs=RESUME_TOL)


def _slim_npz(path, variables, seed=3):
    """Slim resnet_v1_50 names for the tiny trunk, random values, plus
    excluded and unknown names."""
    from iv2019_tpu.utils.checkpoint import slim_name_to_flax_path

    rng = np.random.RandomState(seed)
    arrays = {"global_step": np.asarray(7),
              "resnet_v1_50/conv1/weights/Momentum": np.zeros((7, 7, 3, 64), np.float32),
              "resnet_v1_50/logits/weights": np.zeros((1, 1, 2048, 1000), np.float32),
              "resnet_v1_50/block9/unit_1/bottleneck_v1/conv1/weights":
                  np.zeros((1, 1, 8, 8), np.float32)}
    leaves = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
              "moving_mean": ("batch_stats", "mean"), "moving_variance": ("batch_stats", "var")}
    base = variables["params"]["feature_extractor/base"]
    names = ["resnet_v1_50/conv1/weights"] + [f"resnet_v1_50/conv1/BatchNorm/{k}" for k in leaves]
    for unit in (u for u in base if u.startswith("block")):
        for conv in base[unit]:
            prefix = f"resnet_v1_50/{unit}/bottleneck_v1/{conv}"
            names += [f"{prefix}/weights"] + [f"{prefix}/BatchNorm/{k}" for k in leaves]
    for name in names:
        node = variables
        for p in slim_name_to_flax_path(name):
            node = node[p]
        value = rng.randn(*node.shape).astype(np.float32)
        arrays[name] = np.abs(value) + 0.5 if name.endswith("variance") else value
    np.savez(path, **arrays)
    return str(path)


def test_warm_start_matches_jax(tmp_path, capsys):
    threads()
    _, variables = _variables()
    npz = _slim_npz(tmp_path / "imagenet.npz", variables)
    want_params, want_stats, want_n = jax_warm_start(variables["params"],
                                                     variables["batch_stats"], npz)
    _, settings = _settings(tmp_path / "log")
    model = torch_tiny_model(settings, variables)
    assert warm_start_from_npz(model, npz) == want_n > 0
    params, stats = flax_from_state_dict(model.state_dict())
    _assert_close(params, numpy_tree(want_params), 0.0)
    _assert_close(stats, numpy_tree(want_stats), 0.0)
    # the loop applies it to a fresh log dir
    _port_train(settings.replace(init_ckpt_path=npz), variables, max_steps=1)
    assert f"warm start: restored {want_n} backbone arrays" in capsys.readouterr().out


def test_resume_and_warm_start_are_exclusive(tmp_path):
    threads()
    _, variables = _variables()
    _, settings = _settings(tmp_path, save_checkpoints_steps=1)
    _port_train(settings, variables, max_steps=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port_train(settings.replace(init_ckpt_path="/nonexistent.npz"), variables, max_steps=2)


def test_summary_forward_keeps_running_statistics():
    threads()
    _, variables = _variables()
    _, settings = _settings("/unused")
    model = torch_tiny_model(settings, variables)
    batch = next(train_input(settings, load_problem_def(PORT_JSON)))
    batch = {k: torch.as_tensor(v) for k, v in batch.items() if not isinstance(v, list)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    palette = load_problem_def(PORT_JSON).palette()
    masks = {"l1_weights": torch.ones(32, 64)}
    images = _image_summaries(model, batch, palette, masks)
    assert images["decisions"].shape == (32, 64, 3) and images["proimage"].dtype == np.uint8
    assert images["debug/l1_weights"].shape == (32, 64, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a plain train-mode forward would have moved them
    with torch.no_grad():
        model(batch["proimages_per_pixel"][:1])
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def _preempting(batches, after):
    """Deliver SIGTERM to this process after ``after`` batches (from the
    prefetch thread; Python runs the handler on the main thread)."""
    for i, b in enumerate(batches):
        if i == after:
            os.kill(os.getpid(), signal.SIGTERM)
        yield b


def test_sigterm_saves_at_the_true_step(tmp_path):
    threads()
    _, variables = _variables()
    _, settings = _settings(tmp_path, save_checkpoints_steps=50)
    prev = signal.getsignal(signal.SIGTERM)
    batches = _preempting(train_input(settings, load_problem_def(PORT_JSON)), after=4)
    state = _port_train(settings, variables, batches=batches, max_steps=50, log_every=100)
    final = int(state.step)
    assert 0 < final < 50
    assert CheckpointManager(settings.log_dir).latest_step() == final
    assert signal.getsignal(signal.SIGTERM) == prev
    state = _port_train(settings, variables, max_steps=final + 1, log_every=100)
    assert int(state.step) == final + 1

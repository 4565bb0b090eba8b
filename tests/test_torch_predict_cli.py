"""The port's predict CLI on the CPU, and its input pipeline against JAX's.

The CLI runs over two small PNGs of different raw sizes with a small-stack
.npz under the reference's names; exports must exist at the raw size and
the label-id PNGs hold raw Cityscapes ids. The preprocessed images agree
with the JAX pipeline's to 1e-6 (uint8 scaling by 1/255 vs the reference's
native decode, same TF1 resize tables).
"""

import os

import numpy as np
import pytest
from PIL import Image

from iv2019_tpu_torch import predict_cli
from iv2019_tpu_torch.models import resnet
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from torch_parity import SMALL_BLOCKS, SMALL_FDIMS, small_variables, threads, write_trained_npz

PROBLEM = "iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json"
SIZES = {"street_a": (40, 60), "street_b": (48, 64)}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    threads()
    root = tmp_path_factory.mktemp("predict")
    img_dir = root / "images" / "nested"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for stem, hw in SIZES.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(img_dir / f"{stem}.png")
    npz = write_trained_npz(root / "model.npz", small_variables(seed=3), with_ema=False)
    return root, npz


@pytest.fixture
def small_trunk(monkeypatch):
    monkeypatch.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)


def _argv(root, npz, *flags):
    return [str(root / "log"), PROBLEM, str(root / "images"), "--ckpt_path", npz,
            "--device", "cpu", "--height_feature_extractor", "128",
            "--width_feature_extractor", "128", "--feature_dims_decreased", str(SMALL_FDIMS),
            "--compute_dtype", "float32", *flags]


def test_cli_exports_at_raw_size(workdir, small_trunk):
    root, npz = workdir
    n = predict_cli.main(_argv(root, npz, "--export_lids_images", "--export_color_decisions",
                               "--export_overlapped_color_decisions", "--fused_block"))
    assert n == len(SIZES)
    lids = set(load_problem_def(PROBLEM).cids2lids)
    out = root / "log" / "predictions"
    for stem, hw in SIZES.items():
        got = np.asarray(Image.open(out / f"{stem}_result_lids.png"))
        assert got.shape == hw
        assert set(np.unique(got).tolist()) <= lids
        assert np.asarray(Image.open(out / f"{stem}_result_color.png")).shape == (*hw, 3)
        assert np.asarray(Image.open(out / f"{stem}_result_overlapped_color.png")).shape == (*hw, 3)


def test_cli_system_size_and_default_export(workdir, small_trunk, tmp_path):
    root, npz = workdir
    n = predict_cli.main(_argv(root, npz, "--height_system", "32", "--width_system", "24",
                               "--results_dir", str(tmp_path)))
    assert n == len(SIZES)
    for stem in SIZES:  # no export flag: colorized decisions at the system size
        assert np.asarray(Image.open(tmp_path / f"{stem}_result_color.png")).shape == (32, 24, 3)


def test_cli_requires_npz(workdir, small_trunk):
    """Without a converted .npz the weights come from the log dir's own
    training run: a step it did not save is refused, naming what to give."""
    root, _ = workdir
    with pytest.raises(FileNotFoundError, match="model.npz"):
        predict_cli.main(_argv(root, "checkpoints/8"))


@pytest.mark.parametrize("preserve", [False, True])
def test_preprocess_matches_jax_pipeline(workdir, preserve):
    from iv2019_tpu.config import Settings as JaxSettings
    from iv2019_tpu.input.dataset_agnostic import predict_input as jax_input
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.predict_input import predict_input

    root, _ = workdir
    kw = dict(predict_dir=str(root / "images"), height_feature_extractor=32,
              width_feature_extractor=56, preserve_aspect_ratio=preserve)
    want = list(jax_input(JaxSettings(**kw)))
    got = list(predict_input(Settings(**kw)))
    assert [g["rawimagespaths"] for g in got] == [w["rawimagespaths"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["rawimages"], w["rawimages"])
        assert g["proimages"].shape == w["proimages"].shape == (1, 32, 56, 3)
        if not preserve:  # the aspect-preserving crop offset is random
            np.testing.assert_allclose(g["proimages"], w["proimages"], atol=1e-6, rtol=0)


# ------------------------------------------------- predict from the port's own training run

TRAIN_ARGS = ["cityscapes", "--synthetic_data", "--device", "cpu", "--compute_dtype", "float32",
              "--height_feature_extractor", "64", "--width_feature_extractor", "64",
              "--feature_dims_decreased", str(SMALL_FDIMS), "--Nb_per_pixel", "1",
              "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
              "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
              "--input_seed", "3", "--save_checkpoints_steps", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, workdir):
    """Two steps of the port's train_cli on synthetic data at a tiny size
    (checkpoints 1 and 2); returns (images root, log dir, final state)."""
    from iv2019_tpu_torch import train_cli

    threads()
    root, _ = workdir
    log = tmp_path_factory.mktemp("run") / "log"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)
        state = train_cli.main([str(log), *TRAIN_ARGS])
    assert sorted(p.name for p in (log / "checkpoints").iterdir()) == ["1", "2"]
    return root, log, state


def _predict_settings(root, log, *flags):
    """The predict CLI's settings for the training run in ``log`` (its
    architecture read back from settings.txt), finalized as the system
    finalizes them."""
    from iv2019_tpu_torch.config import (PREDICT, build_argparser, resolve_dataset_name,
                                         resolve_trained_model, settings_from_args)

    argv = [str(log), PROBLEM, str(root / "images"), "--device", "cpu", "--compute_dtype",
            "float32", "--height_feature_extractor", "64", "--width_feature_extractor", "64",
            *flags]
    args = build_argparser(PREDICT).parse_args(argv)
    s = settings_from_args(args, PREDICT, predict_keys=predict_cli.PREDICT_KEYS)
    s = resolve_trained_model(resolve_dataset_name(s, None), argv)
    assert s.feature_dims_decreased == SMALL_FDIMS  # from the run's settings.txt
    return s.finalize()


def _system_predictions(settings):
    from iv2019_tpu_torch.input.predict_input import predict_input
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import SemanticSegmentation

    system = SemanticSegmentation({"predict": lambda s, _pd: predict_input(s)},
                                  model_fn=build_model, settings=settings)
    return list(system.predict())


def _model_predictions(settings, state_dict):
    """Predictions of a model that holds ``state_dict``."""
    from iv2019_tpu_torch.models.model import build_model

    model = build_model(settings)
    model.load_state_dict(state_dict)
    return list(predict_cli.predict(settings, model))


def _assert_same(got, want):
    assert len(got) == len(want) == len(SIZES)
    for g, w in zip(got, want):
        assert g["rawimagespaths"] == w["rawimagespaths"]
        for k in ("decisions", "l1_probabilities", "l2_vehicle_probabilities"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _ema_state_dict(state, log, step):
    """The trained model's state dict with the EMA shadow, unbiased by the
    decay product, in place of each parameter (from the checkpoint's layout,
    not through the restore code)."""
    import torch

    layout = torch.load(log / "checkpoints" / str(step) / "state.pt", weights_only=True)["layout"]
    opt = state.opt_state
    flat = opt.ema_biased / (1.0 - opt.ema_decay_product)
    out = dict(state.model.state_dict())
    for name, shape, stride, offset in layout:
        out[name] = torch.as_strided(flat, shape, stride, offset)
    return out


@pytest.mark.parametrize("ckpt", [None, "2", "checkpoints/2/"])
def test_predict_from_training_run_matches_the_trained_model(trained, small_trunk, ckpt):
    """The latest checkpoint, by default, by step and by a path ending in the
    step: the predictions are bit-equal to those of the trained weights."""
    root, log, state = trained
    flags = () if ckpt is None else ("--ckpt_path", str(log / ckpt) if "/" in ckpt else ckpt)
    settings = _predict_settings(root, log, *flags)
    _assert_same(_system_predictions(settings), _model_predictions(settings, state.model.state_dict()))


def test_predict_from_an_earlier_checkpoint(trained, small_trunk):
    import torch

    root, log, _ = trained
    settings = _predict_settings(root, log, "--ckpt_path", "1")
    snap = torch.load(log / "checkpoints" / "1" / "state.pt", weights_only=True)
    _assert_same(_system_predictions(settings), _model_predictions(settings, snap["model"]))


def test_predict_with_restore_emas_takes_the_unbiased_ema(trained, small_trunk):
    root, log, state = trained
    settings = _predict_settings(root, log, "--restore_emas")
    ema = _ema_state_dict(state, log, 2)
    raw = state.model.state_dict()
    assert any(not np.array_equal(ema[k].numpy(), raw[k].numpy()) for k in raw)
    _assert_same(_system_predictions(settings), _model_predictions(settings, ema))


@pytest.mark.parametrize("flags", [(), ("--restore_emas",)])
def test_cli_predicts_from_the_log_dir(trained, small_trunk, tmp_path, flags):
    root, log, _ = trained
    argv = [str(log), PROBLEM, str(root / "images"), "--device", "cpu", "--compute_dtype",
            "float32", "--height_feature_extractor", "64", "--width_feature_extractor", "64",
            "--results_dir", str(tmp_path), "--export_lids_images", *flags]
    assert predict_cli.main(argv) == len(SIZES)
    lids = set(load_problem_def(PROBLEM).cids2lids)
    for stem, hw in SIZES.items():
        got = np.asarray(Image.open(tmp_path / f"{stem}_result_lids.png"))
        assert got.shape == hw and set(np.unique(got).tolist()) <= lids


@pytest.mark.parametrize("ckpt_path,want", [(None, [2]), ("7", [7]), ("run/checkpoints/12", [12]),
                                            ("run/checkpoints/12/", [12]),
                                            ("weights/model.npz", ["weights/model.npz"])])
def test_checkpoint_steps_follow_the_jax_rule(trained, ckpt_path, want):
    """iv2019_tpu/system.py:388 without --eval_all_ckpts: a converted .npz,
    a step, a path ending in one, else the latest saved step."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.system import checkpoint_steps

    _, log, _ = trained
    assert checkpoint_steps(Settings(log_dir=str(log), ckpt_path=ckpt_path)) == want


def test_checkpoint_steps_without_a_run(tmp_path):
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.system import checkpoint_steps

    assert checkpoint_steps(Settings(log_dir=str(tmp_path))) == [None]
    assert not (tmp_path / "checkpoints").exists()  # looking creates nothing
    with pytest.raises(ValueError):
        checkpoint_steps(Settings(log_dir=str(tmp_path), ckpt_path="latest"))


def test_system_evaluate_still_refuses(trained, small_trunk):
    """SemanticSegmentation.evaluate runs on the trained run: the latest
    checkpoint over synthetic eval batches, one metrics dict."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.cityscapes import evaluate_input
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import SemanticSegmentation

    _, log, _ = trained
    system = SemanticSegmentation({"eval": evaluate_input}, model_fn=build_model, settings=Settings(
        log_dir=str(log), training_problem_def_path=PROBLEM, device="cpu",
        compute_dtype="float32", feature_dims_decreased=SMALL_FDIMS, height_feature_extractor=64,
        width_feature_extractor=64, synthetic_data=True, Neval=2, Nb=1))
    (metrics,) = system.evaluate()
    assert metrics["global_step"] == 2
    assert metrics["confusion_matrix"].shape == (19, 19)
    assert 0 < metrics["confusion_matrix"].sum() <= 2 * 64 * 64
    assert {"global_accuracy", "mean_accuracy", "mean_iou"} <= metrics.keys()
    assert os.path.isfile(os.path.join(system.eval_res_dir, "settings.txt"))

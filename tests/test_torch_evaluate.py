"""The port's evaluation (system, command line, input) against JAX's, on the CPU.

- ``SemanticSegmentation.evaluate`` of both packages on synthetic eval
  batches from one converted ``.npz`` of the small model's weights: the
  confusion matrices equal up to the pixels whose decision flipped
  (<= 0.1% of them, as tests/test_torch_step.py), the void row and column
  trimmed alike, ``mean_iou`` and the metric keys alike.
- ``--eval_all_ckpts`` over the port's own 2-step training run: one dict
  per saved step, in step order, each bit-equal to the eval step of a fresh
  model that holds that checkpoint's weights.
- ``evaluate_cli`` writes ``eval_NN/{settings.txt,all_metrics.txt,
  all_metrics.p}``, numbering a second run ``eval_01``.
- ``_group_eval_batches``, ``synthetic_eval_batches``, ``evaluate_input``
  on a TFRecord, the TFRecord writer and ``tools/make_tfrecords``: equal
  to the JAX package's (images within 1e-6, as tests/test_torch_input.py).
- The EVAL and PREDICT command lines and ``validate()`` against JAX's, and
  the plotting modes of ``predict_cli``.
"""

import argparse
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from iv2019_tpu import config as jconfig
from iv2019_tpu.input import cityscapes as jax_cityscapes
from iv2019_tpu.problem.problem_def import load_problem_def as jax_load_problem_def
from iv2019_tpu.system import SemanticSegmentation as JaxSystem
from iv2019_tpu.system import _group_eval_batches as jax_group
from iv2019_tpu_torch import config as tconfig
from iv2019_tpu_torch import evaluate_cli, predict_cli
from iv2019_tpu_torch.input import cityscapes
from iv2019_tpu_torch.models import resnet
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.system import SemanticSegmentation, _group_eval_batches, checkpoint_steps
from test_torch_predict_cli import TRAIN_ARGS
from torch_parity import (
    SMALL_BLOCKS,
    SMALL_FDIMS,
    jax_small_model,
    small_variables,
    threads,
    torch_small_model,
    write_trained_npz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROBLEM = os.path.join(ROOT, "iv2019_tpu", "problem_definitions", "cityscapes",
                           "problem01.json")
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")
IMAGE_ATOL = 1e-6


@pytest.fixture
def small_trunk(monkeypatch):
    monkeypatch.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)


# --------------------------------------------- evaluate of both packages, same weights


@pytest.fixture(scope="module")
def both_evaluations(tmp_path_factory):
    threads()
    variables = small_variables(seed=2)
    root = tmp_path_factory.mktemp("evaluate")
    npz = write_trained_npz(root / "model.npz", variables, with_ema=False, own_values=True)
    common = dict(ckpt_path=npz, Neval=4, Nb=2, height_feature_extractor=64,
                  width_feature_extractor=64, compute_dtype="float32", synthetic_data=True)
    jax_system = JaxSystem({"eval": jax_cityscapes.evaluate_input},
                           model_fn=lambda s: jax_small_model(),
                           settings=jconfig.Settings(log_dir=str(root / "jax"), mode="eval",
                                                     training_problem_def_path=JAX_PROBLEM,
                                                     **common))
    system = SemanticSegmentation({"eval": cityscapes.evaluate_input},
                                  model_fn=lambda s: torch_small_model(variables),
                                  settings=tconfig.Settings(log_dir=str(root / "port"),
                                                            mode="eval", device="cpu",
                                                            training_problem_def_path=PROBLEM,
                                                            **common))
    return system, system.evaluate(), jax_system.evaluate()


def test_evaluate_matches_jax(both_evaluations):
    _, got, want = both_evaluations
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g["global_step"] == w["global_step"] and g.keys() == w.keys()
    # the void row and column are trimmed: 19 Cityscapes eval classes
    assert g["confusion_matrix"].shape == w["confusion_matrix"].shape == (19, 19)
    assert g["confusion_matrix"].dtype == np.int64
    pixels = 4 * 64 * 64
    assert np.abs(g["confusion_matrix"] - w["confusion_matrix"]).sum() <= 2 * 0.001 * pixels
    assert abs(g["mean_iou"] - w["mean_iou"]) <= 0.01


def test_evaluate_writes_its_settings(both_evaluations):
    system, _, _ = both_evaluations
    assert system.eval_res_dir.endswith("eval_00")
    lines = open(os.path.join(system.eval_res_dir, "settings.txt")).read().splitlines()
    assert any(line.endswith(" : Neval : 4") for line in lines)
    assert any(line.endswith(" : mode : eval") for line in lines)


# --------------------------------------------- the port's own training run


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of the port's train_cli (checkpoints 1 and 2); the log dir."""
    from iv2019_tpu_torch import train_cli

    threads()
    log = tmp_path_factory.mktemp("run") / "log"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)
        train_cli.main([str(log), *TRAIN_ARGS])
    return log


def _eval_argv(log, *flags):
    return [str(log), "4", PROBLEM, "--synthetic_data", "--device", "cpu", "--compute_dtype",
            "float32", "--height_feature_extractor", "64", "--width_feature_extractor", "64",
            "--Nb", "2", *flags]


def _eval_settings(argv):
    args = tconfig.build_argparser(tconfig.EVAL).parse_args(argv)
    s = tconfig.settings_from_args(args, tconfig.EVAL)
    s = tconfig.resolve_trained_model(tconfig.resolve_dataset_name(s, None), argv)
    assert s.feature_dims_decreased == SMALL_FDIMS  # from the run's settings.txt
    return s.finalize()


def _fresh_model_matrix(settings, state_dict):
    """The summed matrix of the eval step of a fresh model holding
    ``state_dict`` over the run's eval batches, void trimmed."""
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.train.step import make_eval_step

    model = build_model(settings)
    model.load_state_dict(state_dict)
    step = make_eval_step(settings, model=model)
    batches = cityscapes.synthetic_eval_batches(settings, load_problem_def(PROBLEM))
    n = settings.Neval // settings.Nb
    cm = sum(step(b["proimages"], b["prolabels"]) for _, b in zip(range(n), batches))
    return cm.numpy()[:-1, :-1]


def _state_dict(log, step):
    return torch.load(log / "checkpoints" / str(step) / "state.pt", weights_only=True)["model"]


def test_eval_all_ckpts_is_each_checkpoint_alone(trained, small_trunk, tmp_path):
    log = tmp_path / "log"
    shutil.copytree(trained, log)
    argv = _eval_argv(log, "--eval_all_ckpts")
    all_metrics = evaluate_cli.main(argv)
    assert [m["global_step"] for m in all_metrics] == [1, 2]
    settings = _eval_settings(argv)
    for m in all_metrics:
        want = _fresh_model_matrix(settings, _state_dict(log, m["global_step"]))
        np.testing.assert_array_equal(m["confusion_matrix"], want)
    # the restores into one model leave nothing of the one before
    assert not np.array_equal(all_metrics[0]["confusion_matrix"],
                              all_metrics[1]["confusion_matrix"])


def test_cli_writes_metrics_and_numbers_eval_dirs(trained, small_trunk, tmp_path):
    log = tmp_path / "log"
    shutil.copytree(trained, log)
    first = evaluate_cli.main(_eval_argv(log))
    assert [m["global_step"] for m in first] == [2]
    out = log / "eval_00"
    assert {p.name for p in out.iterdir()} == {"settings.txt", "all_metrics.txt", "all_metrics.p"}
    text = (out / "all_metrics.txt").read_text()
    assert text.startswith("step: 2") and "Mean iou" in text
    with open(out / "all_metrics.p", "rb") as f:
        saved = pickle.load(f)
    np.testing.assert_array_equal(saved[0]["confusion_matrix"], first[0]["confusion_matrix"])
    evaluate_cli.main(_eval_argv(log, "--ckpt_path", "1"))
    assert (log / "eval_01" / "all_metrics.p").is_file()


def test_system_evaluate_returns_what_the_cli_does(trained, small_trunk, tmp_path):
    from iv2019_tpu_torch.models.model import build_model

    log = tmp_path / "log"
    shutil.copytree(trained, log)
    argv = _eval_argv(log, "--restore_emas")
    system = SemanticSegmentation({"eval": cityscapes.evaluate_input}, model_fn=build_model,
                                  settings=_eval_settings(argv))
    got = system.evaluate()
    want = evaluate_cli.main(argv)
    assert [m["global_step"] for m in got] == [m["global_step"] for m in want] == [2]
    assert got[0].keys() == want[0].keys()
    np.testing.assert_array_equal(got[0]["confusion_matrix"], want[0]["confusion_matrix"])
    assert sorted(p.name for p in log.iterdir() if p.name.startswith("eval_")) == \
        ["eval_00", "eval_01"]


def test_a_step_the_run_did_not_save_is_refused_alike(trained, small_trunk):
    """evaluate and predict raise the same FileNotFoundError text."""
    from iv2019_tpu_torch.models.model import build_model

    settings = _eval_settings(_eval_argv(trained, "--ckpt_path", "7"))
    with pytest.raises(FileNotFoundError, match="no checkpoint 7") as in_eval:
        SemanticSegmentation({"eval": cityscapes.evaluate_input}, model_fn=build_model,
                             settings=settings).evaluate()
    with pytest.raises(FileNotFoundError) as in_predict:
        next(SemanticSegmentation({"predict": lambda s, pd: iter(())}, model_fn=build_model,
                                  settings=settings.replace(mode="predict")).predict())
    assert str(in_eval.value) == str(in_predict.value)


def test_checkpoint_steps_with_eval_all_ckpts(trained, tmp_path):
    assert checkpoint_steps(tconfig.Settings(log_dir=str(trained), eval_all_ckpts=True)) == [1, 2]
    assert checkpoint_steps(tconfig.Settings(log_dir=str(tmp_path), eval_all_ckpts=True)) == []
    assert not (tmp_path / "checkpoints").exists()


# --------------------------------------------- input


def _batches(rng):
    """Three batches of one shape, then two of another; a uint8 array for
    the unsigned padding and a scalar passthrough."""
    out = []
    for i, hw in enumerate([(4, 6)] * 3 + [(5, 6)] * 2):
        out.append({
            "proimages": rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32),
            "prolabels": rng.randint(0, 20, (1, *hw)).astype(np.int32),
            "masks": rng.randint(0, 255, (1, *hw)).astype(np.uint8),
            "rawimagespaths": [f"im{i}"],
            "index": i,
        })
    return out


@pytest.mark.parametrize("group", [1, 2, 3])
def test_group_eval_batches_matches_jax(group):
    batches = _batches(np.random.RandomState(group))
    got, want = list(_group_eval_batches(iter(batches), group)), list(jax_group(iter(batches), group))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("eval_size", [None, (24, 40)])
def test_synthetic_eval_batches_are_bit_equal(eval_size):
    kw = dict(Nb=2, height_feature_extractor=16, width_feature_extractor=32, eval_size=eval_size)
    want = list(jax_cityscapes.synthetic_eval_batches(jconfig.Settings(**kw),
                                                      jax_load_problem_def(JAX_PROBLEM), seed=3))
    got = list(cityscapes.synthetic_eval_batches(tconfig.Settings(**kw), load_problem_def(PROBLEM),
                                                 seed=3))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("proimages", "prolabels"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        assert g["rawimagespaths"] == w["rawimagespaths"]


def _write_records(path, writer_module, rng):
    """Three Cityscapes-like records of different raw sizes: RGB PNG images,
    labelIds PNG labels with every lid of the table."""
    with writer_module.TFRecordWriter(str(path)) as writer:
        for i, (h, w) in enumerate([(30, 50), (40, 40), (22, 70)]):
            image = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            label = rng.randint(0, 34, (h, w), dtype=np.uint8)
            writer.write(writer_module.encode_example({
                "image/encoded": _png_bytes(image), "image/format": "png",
                "image/dtype": "uint8", "image/shape": [h, w, 3], "image/path": f"img{i}.png",
                "label/encoded": _png_bytes(label), "label/format": "png",
                "label/dtype": "uint8", "label/shape": [h, w, 1], "label/path": f"lab{i}.png"}))


def _png_bytes(arr):
    import io

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_writer_writes_the_jax_writers_bytes(tmp_path):
    from iv2019_tpu.input import tfrecord_writer as jax_writer
    from iv2019_tpu_torch.input import tfrecord_writer

    _write_records(tmp_path / "port.tfrecords", tfrecord_writer, np.random.RandomState(0))
    _write_records(tmp_path / "jax.tfrecords", jax_writer, np.random.RandomState(0))
    assert (tmp_path / "port.tfrecords").read_bytes() == (tmp_path / "jax.tfrecords").read_bytes()
    assert tfrecord_writer.masked_crc32c(b"abc") == jax_writer.masked_crc32c(b"abc")


@pytest.mark.parametrize("eval_size", [None, (24, 40)])
def test_evaluate_input_on_a_tfrecord_matches_jax(tmp_path, eval_size):
    from iv2019_tpu_torch.input import tfrecord_writer

    path = tmp_path / "val.tfrecords"
    _write_records(path, tfrecord_writer, np.random.RandomState(1))
    kw = dict(Nb=1, height_feature_extractor=16, width_feature_extractor=32, eval_size=eval_size,
              tfrecords_path=str(path))
    want = list(jax_cityscapes.evaluate_input(jconfig.Settings(**kw),
                                              jax_load_problem_def(JAX_PROBLEM)))
    got = list(cityscapes.evaluate_input(tconfig.Settings(**kw), load_problem_def(PROBLEM)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["proimages"].shape == w["proimages"].shape == (1, *(eval_size or (16, 32)), 3)
        np.testing.assert_allclose(g["proimages"], w["proimages"], rtol=0, atol=IMAGE_ATOL)
        assert g["prolabels"].dtype == w["prolabels"].dtype
        np.testing.assert_array_equal(g["prolabels"], w["prolabels"])
        assert g["rawimagespaths"] == w["rawimagespaths"]
        assert g["rawlabelspaths"] == w["rawlabelspaths"]


def test_make_tfrecords_tool_matches_jax(tmp_path):
    from iv2019_tpu.tools import make_tfrecords as jax_tool
    from iv2019_tpu_torch.tools import make_tfrecords

    rng = np.random.RandomState(2)
    for city, stem in (("aachen", "aachen_000000_000019"), ("bochum", "bochum_000000_000313")):
        for sub, suffix, shape in (("leftImg8bit", "_leftImg8bit.png", (20, 30, 3)),
                                   ("gtFine", "_gtFine_labelIds.png", (20, 30))):
            d = tmp_path / "cs" / sub / "val" / city
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.randint(0, 34, shape, dtype=np.uint8)).save(d / f"{stem}{suffix}")
    root = str(tmp_path / "cs")
    assert make_tfrecords.main(["cityscapes", root, "val", str(tmp_path / "port.tfrecords")]) == 0
    assert jax_tool.main(["cityscapes", root, "val", str(tmp_path / "jax.tfrecords")]) == 0
    assert (tmp_path / "port.tfrecords").read_bytes() == (tmp_path / "jax.tfrecords").read_bytes()
    settings = tconfig.Settings(Nb=1, height_feature_extractor=16, width_feature_extractor=24,
                                tfrecords_path=str(tmp_path / "port.tfrecords"))
    assert len(list(cityscapes.evaluate_input(settings, load_problem_def(PROBLEM)))) == 2


# --------------------------------------------- command lines and checks


def _flag_values(action):
    """A non-default command-line value for an argparse action."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[-1])]
    if action.nargs == 2:
        return ["96", "128"]
    if action.nargs == "*":
        return ["0.5", "1.5"] if action.type is float else ["3", "4"]
    if action.type is int:
        return ["3"]
    if action.type is float:
        return ["0.25"]
    return ["x.npz" if action.dest == "ckpt_path" else "somewhere"]


def _jax_flag_parser(mode):
    p = argparse.ArgumentParser()
    if mode == jconfig.EVAL:
        jconfig._add_evaluate_arguments(p)
    else:
        jconfig._add_inference_arguments(p)
    return p


@pytest.mark.parametrize("mode", [tconfig.EVAL, tconfig.PREDICT])
def test_parsers_take_every_jax_inference_flag(mode):
    flags = [a for a in _jax_flag_parser(mode)._actions if a.option_strings and a.dest != "help"]
    tta = argparse.ArgumentParser()
    jconfig._add_tta_arguments(tta)
    assert {a.dest for a in tta._actions if a.option_strings} - {"help"} <= {a.dest for a in flags}
    positional = (["log", "16", "problem.json"] if mode == tconfig.EVAL
                  else ["log", "problem.json", "images"])
    argv = list(positional)
    for a in flags:
        argv += [a.option_strings[0], *_flag_values(a)]
    got = tconfig.settings_from_args(tconfig.build_argparser(mode).parse_args(argv), mode)
    want = jconfig.settings_from_args(jconfig.build_argparser(mode).parse_args(argv), mode)
    common = {f for f in tconfig.Settings.__dataclass_fields__} & set(
        jconfig.Settings.__dataclass_fields__)
    assert {a.dest for a in flags} - {"per_pixel_dataset_name", "enable_xla"} <= common
    # no flag sets bn_impl: each package's default (the port's N1/N2, JAX's
    # flax), which eval mode ignores
    assert (got.bn_impl, want.bn_impl) == ("fused", "flax")
    for k in common - {"bn_impl"}:
        assert getattr(got, k) == getattr(want, k), k
    assert isinstance(got.eval_scales, tuple) and got.eval_size == (96, 128)


def test_parsers_default_to_the_jax_defaults():
    for mode, positional in ((tconfig.EVAL, ["log", "16", "p.json"]),
                             (tconfig.PREDICT, ["log", "p.json", "images"])):
        got = tconfig.settings_from_args(tconfig.build_argparser(mode).parse_args(positional), mode)
        want = jconfig.settings_from_args(jconfig.build_argparser(mode).parse_args(positional), mode)
        for k in ("eval_scales", "eval_flip", "eval_size", "sliding_window", "window_overlap",
                  "window_blend", "Nb", "Neval", "timeout", "plotting", "eval_all_ckpts"):
            assert getattr(got, k) == getattr(want, k), (mode, k)
        assert got.device == "cuda"


VALIDATE_CASES = [
    dict(eval_scales=(0.0,)),
    dict(eval_scales=(1.0, -0.5)),
    dict(eval_flip=True, spatial_partitions=2),
    dict(eval_scales=(0.5, 1.0), spatial_partitions=2),
    dict(window_overlap=1.0),
    dict(window_overlap=-0.1),
    dict(window_blend="cosine"),
    dict(eval_size=(0, 64)),
    dict(sliding_window=True),
    dict(sliding_window=True, eval_size=(16, 128)),
    dict(sliding_window=True, eval_size=(64, 128), spatial_partitions=2),
]


@pytest.mark.parametrize("kw", VALIDATE_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_validate_refuses_what_jax_refuses(kw):
    common = dict(height_feature_extractor=32, width_feature_extractor=64)
    with pytest.raises(Exception) as jax_err:
        jconfig.Settings(**common, **kw).finalize()
    with pytest.raises(type(jax_err.value), match=re.escape(str(jax_err.value))):
        tconfig.Settings(**common, **kw).finalize()


def test_validate_accepts_what_jax_accepts():
    for kw in (dict(eval_size=(48, 80)), dict(eval_size=(48, 80), sliding_window=True,
                                              window_overlap=0.0, window_blend="gaussian"),
               dict(eval_scales=(0.5, 1.0, 2.0), eval_flip=True)):
        common = dict(height_feature_extractor=32, width_feature_extractor=64, **kw)
        assert jconfig.Settings(**common).finalize().eval_size == \
            tconfig.Settings(**common).finalize().eval_size


# --------------------------------------------- plotting


def _item(rng, hw=(20, 30)):
    def probs(c):
        p = rng.uniform(0, 1, (*hw, c)).astype(np.float32)
        return p / p.sum(-1, keepdims=True)

    return {"decisions": rng.randint(0, 20, hw).astype(np.int32), "l1_probabilities": probs(14),
            "l2_vehicle_probabilities": probs(7),
            "rawimages": rng.randint(0, 256, (*hw, 3), dtype=np.uint8), "rawimagespaths": "x.png"}


def test_confidence_panel_matches_jax():
    from iv2019_tpu import predict_cli as jax_predict_cli

    item = _item(np.random.RandomState(0))
    np.testing.assert_array_equal(predict_cli._confidence_panel(item),
                                  jax_predict_cli._confidence_panel(item))


@pytest.mark.parametrize("flags", [dict(plotting=True), dict(plotting=True, plot_l1_confidence=True),
                                   dict(plotting_overlapped=True)])
def test_plot_frames_match_jax(tmp_path, flags):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from iv2019_tpu import predict_cli as jax_predict_cli

    item = _item(np.random.RandomState(1))
    palette = load_problem_def(PROBLEM).palette()
    for name, module, settings in (("port", predict_cli, tconfig.Settings(**flags)),
                                   ("jax", jax_predict_cli, jconfig.Settings(**flags))):
        (tmp_path / name).mkdir()
        for n in range(2):
            module._plot_frame(item, str(tmp_path / name), palette, settings, n, plt)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ([f"plot_overlapped_{n:05}.png" for n in range(2)]
                     if "plotting_overlapped" in flags else [f"plot_{n:05}.png" for n in range(2)])
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))


@pytest.mark.parametrize("flags", [["--plotting", "--plot_l1_confidence"], ["--plotting_overlapped"]])
def test_cli_plotting_modes(trained, small_trunk, tmp_path, flags):
    pytest.importorskip("matplotlib")
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(3)
    for stem, hw in (("a", (40, 60)), ("b", (48, 64))):
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(images / f"{stem}.png")
    out = tmp_path / "out"
    n = predict_cli.main([str(trained), PROBLEM, str(images), "--device", "cpu", "--compute_dtype",
                          "float32", "--height_feature_extractor", "64",
                          "--width_feature_extractor", "64", "--results_dir", str(out),
                          "--timeout", "0", *flags])
    assert n == 2
    prefix = "plot_overlapped" if "--plotting_overlapped" in flags else "plot"
    assert sorted(os.listdir(out)) == [f"{prefix}_{i:05}.png" for i in range(2)]

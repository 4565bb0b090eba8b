"""The port's bench entry point (iv2019_tpu_torch/bench.py) on the CPU.

Every mode runs at a tiny size with ``--device cpu``: the trunk cut to
helpers.TINY_BLOCKS (put in the port's ``FEATURE_EXTRACTOR_BLOCKS`` for
resnet_v1_50, which ``build_model`` reads), 32x64 images, one or two steps;
the kernels run as their plain versions.

Tolerances:
- one train step of the bench's path (``make_train`` on ``train_batch``,
  the Settings of bench.py:61-75 in f32) against the JAX package's
  ``make_train_step`` on the same arrays and weights (carried across by
  utils/convert.py): losses and regularization within 1e-4 relative, the
  bound of tests/test_torch_train_step.py (f32 on both sides; summation
  orders of the convolutions, BatchNorm statistics and the loss sums);
- ``train_batch`` against the draws of bench.py:78-93: bit for bit.
"""

import json
import math
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from helpers import TINY_BLOCKS, tiny_model
from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from iv2019_tpu.train.state import create_fused_train_state as jax_create_fused_state
from iv2019_tpu.train.state import create_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch import bench
from iv2019_tpu_torch.models import model as port_model
from iv2019_tpu_torch.ops import fused_block as fb
from torch_parity import SMALL_BLOCKS, threads, torch_tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
KNOBS = ("IV_SHAPE", "IV_NB", "IV_FUSED_BLOCK", "IV_DENSE_LABELS", "IV_ROOT_WGRAD_PALLAS",
         "IV_BN_IMPL")
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


@pytest.fixture
def tiny(monkeypatch):
    """The tiny trunk, no knob but those a test sets, one torch thread."""
    threads()
    monkeypatch.setitem(port_model.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", TINY_BLOCKS)
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def run(capsys, argv, device="cpu"):
    """One bench run; returns its one printed JSON line (and checks that the
    returned line is the printed one)."""
    capsys.readouterr()
    line = bench.main([*argv, "--device", device])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    printed = json.loads(lines[0])
    assert printed == json.loads(json.dumps(line))
    return printed


# (mode label, argv, knobs, metric of bench.py)
MODES = [
    ("train", ["train", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1"},
     "train_images_per_sec_per_chip"),
    ("predict", ["predict", "2"], {"IV_SHAPE": "32,64"}, "predict_p50_latency_ms"),
    ("eval", ["eval", "1"], {"IV_SHAPE": "32x64", "IV_NB": "2"}, "eval_images_per_sec_per_chip"),
    ("input", ["input", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1"},
     "input_pipeline_images_per_sec"),
    ("e2e", ["e2e", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1"},
     "e2e_train_images_per_sec_per_chip"),
]


@pytest.mark.parametrize("label,argv,knobs,metric", MODES, ids=[m[0] for m in MODES])
def test_mode_prints_one_json_line(tiny, capsys, label, argv, knobs, metric):
    for k, v in knobs.items():
        tiny.setenv(k, v)
    line = run(capsys, argv)
    assert set(line) == LINE_KEYS
    assert line["metric"] == metric
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["unit"] == ("ms" if label == "predict" else "img/s")
    # the step's operations and the card's peaks are the benchmark's
    assert line["vs_baseline"] is None
    if label in ("train", "predict", "eval", "e2e"):
        assert line["detail"]["device"] == "cpu"
        # on the CPU the wrappers run the plain versions: no kernel launches
        assert set(line["detail"]["launches"].values()) == {0}


@pytest.mark.parametrize("shape", [(32, 64, 1, 1, 1), (16, 40, 2, 3, 1)])
def test_train_batch_matches_bench_draws(shape):
    h, w, npp, npb, npi = shape
    got = bench.train_batch(h, w, npp, npb, npi)
    # the draw sequence of bench.py:78-93
    rng = np.random.RandomState(0)
    want = {}
    for key, n in (("proimages_per_pixel", npp), ("proimages_per_bbox", npb),
                   ("proimages_per_image", npi)):
        want[key] = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    eye = np.eye(15, dtype=np.float32)
    want["prolabels_per_pixel"] = rng.randint(0, 20, (npp, h, w)).astype(np.int32)
    want["prolabels_per_bbox"] = eye[rng.randint(0, 15, (npb, h, w))]
    want["prolabels_per_image"] = eye[rng.randint(0, 15, (npi, h, w))]
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _jax_bench_settings(h, w, nb, **kw):
    """bench.py:61-75's Settings (no knob set), with ``kw``."""
    npp, npb, npi = nb
    return JaxSettings(
        per_pixel_dataset_name="cityscapes", Nb_per_pixel=npp, Nb_per_bbox=npb,
        Nb_per_image=npi, Nb=npp, height_feature_extractor=h, width_feature_extractor=w,
        Ntrain=2975, Ne=17, learning_rate_boundaries=(8, 15, 17),
        learning_rate_values=(0.01, 0.005, 0.0025), compute_dtype="bfloat16", conv_impl="conv",
        bn_impl="flax", dilation_mode="dilated", root_conv_s2d=False, root_wgrad_pallas=False,
        **kw).finalize()


@pytest.mark.parametrize("fused_optimizer", [True, False], ids=["fused", "optax"])
def test_train_step_loss_matches_jax(tiny, fused_optimizer):
    """One step of the bench's train path against the JAX package's step, in
    f32, on the bench's batch and the same weights."""
    h, w, nb = 32, 64, (1, 1, 1)
    jax_settings = _jax_bench_settings(h, w, nb, fused_optimizer=fused_optimizer).replace(
        compute_dtype="float32")
    jmodel = tiny_model(jax_settings, train=True)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), np.zeros((2, h, w, 3), np.float32)))
    batch = bench.train_batch(h, w, *nb)
    if fused_optimizer:
        jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
        jstate = jax_create_fused_state(variables, jopt)
        jstep = jax_make_train_step(jax_settings, model=jmodel, fused_opt=jopt)
    else:
        tx, _ = jax_make_optimizer(jax_settings)
        jstate = jax_create_state(variables, tx, jax_settings.ema_decay)
        jstep = jax_make_train_step(jax_settings, model=jmodel, tx=tx)
    _, want = jstep(jstate, batch)

    settings = bench.train_settings(h, w, *nb, device="cpu").replace(
        compute_dtype="float32", fused_optimizer=fused_optimizer, bn_impl="flax")
    assert settings.fused_loss and settings.pallas_update
    model = torch_tiny_model(settings, variables)
    state, step = bench.make_train(settings, model)
    _, got = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
                "regularization"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("argv", [[], ["5"], ["predict"], ["eval", "2"], ["input"], ["e2e"]],
                         ids=["train", "train-steps", "predict", "eval", "input", "e2e"])
def test_without_a_card_the_bench_raises(tiny, capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(argv)
    assert capsys.readouterr().out == ""


def _spy_fused_units(monkeypatch):
    calls = []
    for name in ("fused_bottleneck", "fused_bottleneck_ct"):
        wrapper = getattr(fb, name)

        def spy(*args, _wrapper=wrapper, _name=name, **kw):
            calls.append(_name)
            return _wrapper(*args, **kw)

        monkeypatch.setattr(fb, name, spy)
    return calls


# (case, argv, knobs, check of the line's detail and the fused units' calls)
KNOB_CASES = [
    ("nb-train", ["train", "1"], {"IV_SHAPE": "32,64", "IV_NB": "2,1,1"},
     lambda d, c: d["images_per_step"] == 4 and d["Nb"] == [2, 1, 1]),
    ("shape-comma-train", ["train", "1"], {"IV_SHAPE": "16,32", "IV_NB": "1,1,1"},
     lambda d, c: d["input_hw"] == [16, 32]),
    ("shape-x-train", ["train", "1"], {"IV_SHAPE": "16x32", "IV_NB": "1,1,1"},
     lambda d, c: d["input_hw"] == [16, 32]),
    ("shape-x-eval", ["eval", "1"], {"IV_SHAPE": "16x32", "IV_NB": "1"},
     lambda d, c: d["input_hw"] == [16, 32]),
    ("nb-eval", ["eval", "1"], {"IV_SHAPE": "16x32", "IV_NB": "3"},
     lambda d, c: d["Nb"] == 3),
    ("shape-predict", ["predict", "1"], {"IV_SHAPE": "16,32"},
     lambda d, c: d["input_hw"] == [16, 32] and d["output_hw"] == [32, 64]),
    ("fused-0-predict", ["predict", "1"], {"IV_SHAPE": "128,128", "IV_FUSED_BLOCK": "0"},
     lambda d, c: d["fused_block"] is False and not c),
    ("fused-1-predict", ["predict", "1"], {"IV_SHAPE": "128,128", "IV_FUSED_BLOCK": "1"},
     lambda d, c: d["fused_block"] is True and len(c) > 0),
    ("fused-0-eval", ["eval", "1"], {"IV_SHAPE": "128x128", "IV_NB": "1", "IV_FUSED_BLOCK": "0"},
     lambda d, c: d["fused_block"] is False and not c),
    ("fused-1-eval", ["eval", "1"], {"IV_SHAPE": "128x128", "IV_NB": "1", "IV_FUSED_BLOCK": "1"},
     lambda d, c: d["fused_block"] is True and len(c) > 0),
    ("dense-0-e2e", ["e2e", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1"},
     lambda d, c: d["weak_label_transfer"] == "compact"),
    ("dense-1-e2e", ["e2e", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1",
                                   "IV_DENSE_LABELS": "1"},
     lambda d, c: d["weak_label_transfer"] == "dense"),
    ("root-wgrad-0-train", ["train", "1"],
     {"IV_SHAPE": "32,64", "IV_NB": "1,1,1", "IV_ROOT_WGRAD_PALLAS": "0"},
     lambda d, c: d["root_wgrad_pallas"] is False),
    ("root-wgrad-1-train", ["train", "1"],
     {"IV_SHAPE": "32,64", "IV_NB": "1,1,1", "IV_ROOT_WGRAD_PALLAS": "1"},
     lambda d, c: d["root_wgrad_pallas"] is True),
    ("bn-flax-train", ["train", "1"], {"IV_SHAPE": "32,64", "IV_NB": "1,1,1", "IV_BN_IMPL": "flax"},
     lambda d, c: d["bn_impl"] == "flax"),
    ("bn-fused-train", ["train", "1"],
     {"IV_SHAPE": "32,64", "IV_NB": "1,1,1", "IV_BN_IMPL": "fused"},
     lambda d, c: d["bn_impl"] == "fused"),
]


@pytest.mark.parametrize("case,argv,knobs,check", KNOB_CASES, ids=[c[0] for c in KNOB_CASES])
def test_knobs_keep_their_meaning(tiny, capsys, case, argv, knobs, check):
    if "fused" in case:
        # a trunk whose identity units the dispatch rule fuses at 16x16
        tiny.setitem(port_model.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)
    calls = _spy_fused_units(tiny)
    for k, v in knobs.items():
        tiny.setenv(k, v)
    line = run(capsys, argv)
    assert check(line["detail"], calls), (line["detail"], calls)


@pytest.mark.parametrize("dense", ["0", "1"])
def test_e2e_hands_the_step_the_batch_of_its_label_transfer(tiny, capsys, dense):
    """Compact labels ship boxes and vectors (rasterized and broadcast on the
    device), dense ones the host's rasters; the prefetch thread is stopped."""
    seen = []
    make_train = bench.make_train

    def spying_make_train(settings, model):
        state, step = make_train(settings, model)

        def spy(state, batch):
            seen.append(set(batch))
            return step(state, batch)

        return state, spy

    tiny.setattr(bench, "make_train", spying_make_train)
    for k, v in {"IV_SHAPE": "32,64", "IV_NB": "1,1,1", "IV_DENSE_LABELS": dense}.items():
        tiny.setenv(k, v)
    run(capsys, ["e2e", "1"])
    assert len(seen) == 4  # 3 warm-up steps and the timed one
    compact = {"bbox_cids", "bbox_coords", "image_label_vecs"}
    dense_keys = {"prolabels_per_bbox", "prolabels_per_image"}
    want, absent = (dense_keys, compact) if dense == "1" else (compact, dense_keys)
    assert all(want <= keys and not absent & keys for keys in seen), seen
    assert not [t for t in threading.enumerate() if t.name == "input-prefetch"]


@pytest.mark.parametrize("argv,want", [
    ([], {"mode": "train", "steps": 20}),
    (["10"], {"mode": "train", "steps": 10}),
    (["predict"], {"mode": "predict", "steps": 30}),
    (["eval"], {"mode": "eval", "steps": 12}),
    (["eval", "5", "--device", "cpu"], {"mode": "eval", "steps": 5, "device": "cpu"}),
    (["input"], {"mode": "input", "steps": 12}),
    (["e2e"], {"mode": "e2e", "steps": 20, "device": "cuda"}),
], ids=["default", "train-steps", "predict", "eval", "eval-cpu", "input", "e2e"])
def test_parse_args(argv, want):
    got = bench.parse_args(argv)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("argv", [["bogus"], ["train", "2", "3"]],
                         ids=["unknown-mode", "two-counts"])
def test_parse_args_refuses(argv):
    with pytest.raises(SystemExit):
        bench.parse_args(argv)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_runs_as_a_module(device):
    """``python -m iv2019_tpu_torch.bench``: one JSON line on the CPU when
    asked for it; without a card and without ``--device cpu``, an error and
    no line."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and k not in KNOBS}
    env.update(IV_SHAPE="32,64", IV_NB="1,1,1")
    proc = subprocess.run(
        [sys.executable, "-m", "iv2019_tpu_torch.bench", "input", "1", "--device", device],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if device == "cuda":
        assert proc.returncode != 0 and proc.stdout == ""
        assert "no CUDA device" in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "input_pipeline_images_per_sec"

"""Port predict/eval steps, metrics and checkpoint restore against JAX.

Same small f32 model and weights on both sides (torch_parity.py).
Tolerances: probabilities 1e-4 absolute (f32, another summation order);
decisions equal on >= 99.9% of pixels (near-ties may flip); confusion
matrices equal up to the pixels whose decision flipped (<= 0.1% of them);
restored trees, name mappings and metrics exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu.train import step as jstep
from iv2019_tpu.utils import checkpoint as jckpt
from iv2019_tpu.utils import metrics as jmetrics
from iv2019_tpu_torch.config import Settings as TorchSettings
from iv2019_tpu_torch.train import step as tstep
from iv2019_tpu_torch.utils import convert
from iv2019_tpu_torch.utils import metrics as tmetrics
from torch_parity import (
    jax_small_model,
    small_images,
    small_variables,
    threads,
    to_numpy,
    torch_small_model,
    write_trained_npz,
)

PROBLEM = "iv2019_tpu/problem_definitions/cityscapes/problem01.json"
PORT_PROBLEM = "iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json"


@pytest.fixture(scope="module")
def models():
    threads()
    variables = small_variables(seed=2)
    return variables, jax_small_model(), torch_small_model(variables)


def _settings(**kw):
    common = dict(per_pixel_dataset_name="cityscapes", height_feature_extractor=128,
                  width_feature_extractor=128, compute_dtype="float32",
                  training_problem_def_path=PROBLEM)
    common.update(kw)
    return JaxSettings(**common), TorchSettings(device="cpu", **common)


@pytest.mark.parametrize("output_size", [None, (200, 152)])
@pytest.mark.parametrize("replace_voids", [False, True])
def test_predict_step_matches_jax(models, output_size, replace_voids):
    variables, jmodel, tmodel = models
    js, ts = _settings(replace_voids=replace_voids)
    images = small_images(seed=3)
    want = jstep.make_predict_step(js, output_size=output_size, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(images))
    got = tstep.make_predict_step(ts, output_size=output_size, model=tmodel)(images)
    assert set(got) == set(want)
    for k in want:
        g, w = to_numpy(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == "decisions":
            assert g.dtype == np.int32
            assert (g == w).mean() >= 0.999
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("replace_voids", [False, True])
def test_eval_step_matches_jax(models, replace_voids):
    variables, jmodel, tmodel = models
    js, ts = _settings(replace_voids=replace_voids)
    images = small_images(seed=4, n=2)
    labels = np.random.RandomState(4).randint(0, 20, (2, 96, 160)).astype(np.int32)
    labels[:, :5] = -1  # ignored pixels
    want = np.asarray(jstep.make_eval_step(js, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(labels)))
    got = tstep.make_eval_step(ts, model=tmodel)(images, labels).numpy()
    assert got.shape == want.shape
    assert got.sum() == want.sum() == (labels >= 0).sum()
    assert np.abs(got - want).sum() <= 2 * 0.001 * labels.size


def test_settings_eval_map_matches_jax():
    js, ts = _settings()
    assert tstep.settings_eval_map(ts) == jstep.settings_eval_map(js)


@pytest.mark.parametrize("decs", [[0, 19, 19, 3], [19, 19, 19, 19]])
def test_replace_void_decisions_matches_jax(decs):
    probs = np.random.RandomState(5).dirichlet(np.ones(20), size=4).astype(np.float32)
    want = np.asarray(jstep._replace_void_decisions(jnp.asarray(probs), jnp.asarray(decs)))
    got = tstep._replace_void_decisions(torch.from_numpy(probs), torch.tensor(decs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_metrics_match_jax(tmp_path):
    cm = np.random.RandomState(6).randint(0, 50, (5, 5))
    cm[2] = 0  # a class with no labels: nan accuracy
    labels = ["a", "b", "c", "d", "e"]
    with open(tmp_path / "j.txt", "w") as fj, open(tmp_path / "t.txt", "w") as ft:
        want = jmetrics.print_metrics_from_confusion_matrix(cm, labels, printfile=fj, summary=True)
        got = tmetrics.print_metrics_from_confusion_matrix(cm, labels, printfile=ft, summary=True)
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_confusion_matrix_matches_jax():
    from iv2019_tpu.ops.confusion import confusion_matrix as jcm
    from iv2019_tpu_torch.ops.confusion import confusion_matrix as tcm

    rng = np.random.RandomState(7)
    labels = rng.randint(-1, 22, (3, 17, 9)).astype(np.int32)
    preds = rng.randint(0, 21, (3, 17, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        tcm(torch.from_numpy(labels), torch.from_numpy(preds), 20).numpy(),
        np.asarray(jcm(jnp.asarray(labels), jnp.asarray(preds), 20)))


def test_state_dict_round_trip(models):
    """flax tree -> port state dict -> flax tree is the identity."""
    variables, _, tmodel = models
    got = convert.flax_variables(tmodel)
    flat_want = jax.tree_util.tree_leaves_with_path(
        {"params": dict(variables["params"]), "batch_stats": dict(variables["batch_stats"])})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(value))


@pytest.mark.parametrize("restore_emas", [False, True])
def test_restore_trained_from_npz_matches_jax(models, tmp_path, restore_emas):
    variables, _, tmodel = models
    npz = write_trained_npz(tmp_path / "model.npz", variables)
    jp, jb, jn = jckpt.restore_trained_from_npz(variables, npz, restore_emas=restore_emas)
    tp, tb, tn = convert.restore_trained_from_npz(
        convert.flax_variables(tmodel), npz, restore_emas=restore_emas)
    assert tn == jn
    want = dict(jax.tree_util.tree_leaves_with_path({"p": dict(jp), "b": dict(jb)}))
    got = dict(jax.tree_util.tree_leaves_with_path({"p": tp, "b": tb}))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], np.asarray(want[path]))
    # and the restored weights load into the port model
    convert.load_flax_variables(tmodel, tp, tb)
    convert.load_flax_variables(tmodel, jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
                                jax.tree_util.tree_map(np.asarray, dict(variables["batch_stats"])))


def test_restore_refuses_incomplete_npz(models, tmp_path):
    variables, _, tmodel = models
    full = np.load(write_trained_npz(tmp_path / "full.npz", variables, with_ema=False))
    partial = {k: full[k] for k in full.files if "l2_human" not in k}
    np.savez(tmp_path / "partial.npz", **partial)
    with pytest.raises(ValueError, match="missing"):
        convert.restore_trained_from_npz(convert.flax_variables(tmodel), str(tmp_path / "partial.npz"))


NAMES = [
    "global_step", "train_ops/foo",
    "feature_extractor/resnet_v1_50/conv1/weights",
    "resnet_v1_50/conv1/BatchNorm/moving_variance",
    "feature_extractor/resnet_v1_50/block3/unit_4/bottleneck_v1/conv2/BatchNorm/gamma",
    "feature_extractor/resnet_v1_101/block1/unit_1/bottleneck_v1/shortcut/weights",
    "feature_extractor/resnet_v1_50/block1/unit_1/bottleneck_v1/shortcut/weights/Momentum",
    "feature_extractor/extension/decrease_fdims/BatchNorm/beta",
    "feature_extractor/extension/increase_fov/weights",
    "feature_extractor/pyramid_module/Conv_3/BatchNorm/moving_mean",
    "feature_extractor/pyramid_module/Conv_9/weights",
    "adaptation_module/l2_human_features/bottleneck_v1/conv3/weights",
    "softmax_classifier/l1_logits/BatchNorm/moving_mean",
    "softmax_classifier/upsampling_1/Conv2d_transpose/biases",
    "exponential_moving_averages/softmax_classifier/l2_vehicle_logits/weights/"
    "ExponentialMovingAverage",
    "something/else",
]


@pytest.mark.parametrize("name", NAMES)
def test_tf_trained_name_mapping_matches_jax(name):
    assert convert.tf_trained_name_to_flax_path(name) == jckpt.tf_trained_name_to_flax_path(name)


def test_port_problem_definitions_match_jax():
    from iv2019_tpu.problem.problem_def import load_problem_def as jload
    from iv2019_tpu_torch.problem.problem_def import load_problem_def as tload

    for dataset in ("cityscapes", "vistas"):
        j = jload(PROBLEM.replace("cityscapes", dataset))
        t = tload(PORT_PROBLEM.replace("cityscapes", dataset))
        assert t.lids2cids == j.lids2cids and t.cids2lids == j.cids2lids
        assert t.cids2colors == j.cids2colors and t.cids2labels == j.cids2labels

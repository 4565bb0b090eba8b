"""The port's test-time augmentation and sliding windows against JAX.

Same small f32 model and weights on both sides (torch_parity.py), at small
sizes. Tolerances are those of tests/test_torch_step.py: probabilities 1e-4
absolute; decisions equal on >= 99.9% of pixels; confusion matrices equal up
to the pixels whose decision flipped (<= 0.1% of them). The window tables
(origins, weights, plans) are numpy on both sides and must be bit-equal;
the common-space distribution agrees to 1e-6.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu.models.model import hierarchical_common_probabilities as jax_common
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu.train import step as jstep
from iv2019_tpu_torch.config import Settings as TorchSettings
from iv2019_tpu_torch.models.model import hierarchical_common_probabilities as torch_common
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy as torch_taxonomy
from iv2019_tpu_torch.train import step as tstep
from torch_parity import jax_small_model, small_images, small_variables, threads, to_numpy, \
    torch_small_model

PROBLEM = "iv2019_tpu/problem_definitions/cityscapes/problem01.json"

# (name, settings) of the ensembles: TTA at the input size; windows of
# 32x48 over a 56x80 image (9 windows at scale 1, 4 at 0.75)
TTA = dict(eval_scales=(0.75, 1.0, 1.25), eval_flip=True)
WINDOWS = {
    "uniform": dict(height_feature_extractor=32, width_feature_extractor=48, eval_size=(56, 80),
                    sliding_window=True),
    "gaussian_multiscale_flip": dict(height_feature_extractor=32, width_feature_extractor=48,
                                     eval_size=(56, 80), sliding_window=True,
                                     window_blend="gaussian", eval_scales=(0.75, 1.0),
                                     eval_flip=True),
}


@pytest.fixture(scope="module")
def models():
    threads()
    variables = small_variables(seed=2)
    return variables, jax_small_model(), torch_small_model(variables)


def _settings(**kw):
    common = dict(per_pixel_dataset_name="cityscapes", height_feature_extractor=64,
                  width_feature_extractor=64, compute_dtype="float32",
                  training_problem_def_path=PROBLEM)
    common.update(kw)
    return JaxSettings(**common), TorchSettings(device="cpu", **common)


def _assert_cm_close(got, want, labels):
    assert got.shape == want.shape
    assert got.sum() == want.sum() == (labels >= 0).sum()
    assert np.abs(got - want).sum() <= 2 * 0.001 * labels.size


def _assert_predictions_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = to_numpy(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == "decisions":
            assert g.dtype == np.int32
            assert (g == w).mean() >= 0.999
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)


# ------------------------------------------------------------- common space


@pytest.mark.parametrize("dataset", ["cityscapes", "vistas"])
def test_common_probabilities_match_jax(dataset):
    import torch

    jtax, ttax = jax_taxonomy(dataset), torch_taxonomy(dataset)
    rng = np.random.RandomState(0)
    preds = {}
    for k, c in (("l1", jtax.num_l1_classes), ("l2_vehicle", jtax.num_vehicle_classes),
                 ("l2_human", jtax.num_human_classes)):
        logits = rng.normal(0, 2, (2, 6, 10, c)).astype(np.float32)
        preds[f"{k}_probabilities"] = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    want = np.asarray(jax_common({k: jnp.asarray(v) for k, v in preds.items()}, jtax))
    got = torch_common({k: torch.from_numpy(v) for k, v in preds.items()}, ttax).numpy()
    assert got.shape == want.shape == (2, 6, 10, ttax.num_common_classes)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# ------------------------------------------------------------- window tables


@pytest.mark.parametrize("full,win,overlap", [
    (64, 32, 0.0), (64, 32, 0.5), (70, 32, 0.5), (32, 32, 0.5), (20, 32, 0.5),
    (100, 32, 0.3), (57, 16, 0.5), (128, 64, 0.75), (1024, 512, 0.5), (2048, 1024, 0.5),
    (1000, 333, 0.9)])
def test_window_origins_match_jax(full, win, overlap):
    assert tstep.window_origins(full, win, overlap) == jstep.window_origins(full, win, overlap)


@pytest.mark.parametrize("blend", ["uniform", "gaussian"])
@pytest.mark.parametrize("hw", [(32, 48), (7, 5), (64, 128)])
def test_window_weight_matches_jax(blend, hw):
    got, want = tstep.window_weight(*hw, blend), jstep.window_weight(*hw, blend)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_window_weight_refuses_an_unknown_blend():
    with pytest.raises(ValueError, match="unknown window_blend"):
        tstep.window_weight(8, 8, "cosine")


@pytest.mark.parametrize("blend,overlap,scales,full_hw", [
    ("uniform", 0.5, (1.0,), (56, 80)),
    ("gaussian", 0.5, (0.75, 1.0, 1.25), (56, 80)),
    ("gaussian", 0.25, (0.5, 2.0), (40, 48)),
    ("uniform", 0.0, (1.0, 1.5), (33, 95)),
])
def test_window_plans_match_jax(blend, overlap, scales, full_hw):
    kw = dict(height_feature_extractor=32, width_feature_extractor=48, window_overlap=overlap,
              window_blend=blend)
    js, ts = JaxSettings(**kw), TorchSettings(**kw)
    (got, got_w), (want, want_w) = (tstep._window_plans(ts, full_hw, scales),
                                    jstep._window_plans(js, full_hw, scales))
    np.testing.assert_array_equal(got_w, want_w)
    assert len(got) == len(want) == len(scales)
    for (gh, gw, go, gc), (wh, ww, wo, wc) in zip(got, want):
        assert (gh, gw) == (wh, ww)
        assert go.dtype == wo.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gc, wc)


# ------------------------------------------------------------- eval steps


def _eval_both(models, images, labels, **kw):
    variables, jmodel, tmodel = models
    js, ts = _settings(**kw)
    want = np.asarray(jstep.make_eval_step(js, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(labels)))
    got = tstep.make_eval_step(ts, model=tmodel)(images, labels).numpy()
    return got, want


def test_tta_eval_step_matches_jax(models):
    images = small_images(seed=5, n=2, hw=(64, 96))
    labels = np.random.RandomState(5).randint(0, 20, (2, 64, 96)).astype(np.int32)
    labels[:, :3] = -1
    got, want = _eval_both(models, images, labels, **TTA)
    _assert_cm_close(got, want, labels)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_eval_step_matches_jax(models, name):
    images = small_images(seed=6, n=1, hw=(56, 80))
    labels = np.random.RandomState(6).randint(0, 20, (1, 56, 80)).astype(np.int32)
    got, want = _eval_both(models, images, labels, **WINDOWS[name])
    _assert_cm_close(got, want, labels)


def _common_argmax_cm(model, settings, images, labels, flip=False):
    """The confusion matrix of the eval argmax of one forward's common-space
    probabilities (with ``flip``, the mean with the flipped forward's), by
    hand from the model and the label-space ops."""
    import torch

    from iv2019_tpu_torch.ops.confusion import confusion_matrix
    from iv2019_tpu_torch.ops.segment_ops import remap_probabilities
    from iv2019_tpu_torch.problem.problem_def import replace_voids

    tax = torch_taxonomy("cityscapes")
    tcids2ecids = replace_voids(tstep.settings_eval_map(settings))
    x = torch.from_numpy(images)
    with torch.inference_mode():
        p = torch_common(model(x), tax)
        if flip:
            p = (p + torch.flip(torch_common(model(torch.flip(x, dims=(2,))), tax), dims=(2,))) / 2
        decs = torch.argmax(remap_probabilities(p, tcids2ecids), -1).int()
        return confusion_matrix(torch.from_numpy(labels), decs, max(tcids2ecids) + 1).numpy()


def test_window_eval_at_the_window_size_is_one_forward(models):
    """eval_size equal to the window: one window of weight 1, so the step's
    matrix is that of one forward's common-space argmax, bit for bit. (The
    plain step's fused decisions differ from the factorized argmax where
    the heads are near-uniform: on 15% of these pixels.)"""
    _, _, tmodel = models
    images = small_images(seed=7, n=2, hw=(32, 48))
    labels = np.random.RandomState(7).randint(0, 20, (2, 32, 48)).astype(np.int32)
    _, window = _settings(height_feature_extractor=32, width_feature_extractor=48,
                          eval_size=(32, 48), sliding_window=True)
    got = tstep.make_eval_step(window, model=tmodel)(images, labels).numpy()
    np.testing.assert_array_equal(got, _common_argmax_cm(tmodel, window, images, labels))


def test_flip_eval_is_the_mean_of_two_forwards(models):
    _, _, tmodel = models
    images = small_images(seed=12, n=2, hw=(32, 48))
    labels = np.random.RandomState(12).randint(0, 20, (2, 32, 48)).astype(np.int32)
    _, ts = _settings(height_feature_extractor=32, width_feature_extractor=48, eval_flip=True)
    got = tstep.make_eval_step(ts, model=tmodel)(images, labels).numpy()
    want = _common_argmax_cm(tmodel, ts, images, labels, flip=True)
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() <= 2 * 0.0001 * labels.size


# ------------------------------------------------------------- predict steps


@pytest.mark.parametrize("name", ["tta", "uniform", "gaussian_multiscale_flip"])
def test_predict_step_ensembles_match_jax(models, name):
    variables, jmodel, tmodel = models
    kw = TTA if name == "tta" else WINDOWS[name]
    hw = (64, 96) if name == "tta" else kw["eval_size"]
    js, ts = _settings(**kw)
    images = small_images(seed=8, n=1, hw=hw)
    want = jstep.make_predict_step(js, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(images))
    got = tstep.make_predict_step(ts, model=tmodel)(images)
    _assert_predictions_close(got, want)
    np.testing.assert_allclose(to_numpy(got["l1_probabilities"]).sum(-1), 1.0, atol=1e-5)


def test_window_predict_refuses_other_sizes(models):
    _, _, tmodel = models
    _, ts = _settings(**WINDOWS["uniform"])
    with pytest.raises(ValueError, match="must resize to eval_size"):
        tstep.make_predict_step(ts, model=tmodel)(small_images(seed=9, n=1, hw=(64, 80)))


def test_tta_predict_with_output_size_and_void_replacement(models):
    variables, jmodel, tmodel = models
    js, ts = _settings(replace_voids=True, height_system=40, width_system=72, **TTA)
    images = small_images(seed=10, n=1, hw=(64, 96))
    want = jstep.make_predict_step(js, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(images))
    got = tstep.make_predict_step(ts, model=tmodel)(images)
    _assert_predictions_close(got, want)
    assert to_numpy(got["decisions"]).shape == (1, 40, 72)


# ------------------------------------------------------------- predict input


@pytest.mark.parametrize("eval_size", [None, (40, 72)])
def test_predict_input_honours_eval_size_as_jax(tmp_path, eval_size):
    from iv2019_tpu.input.dataset_agnostic import predict_input as jax_input
    from iv2019_tpu_torch.input.predict_input import predict_input

    rng = np.random.RandomState(11)
    for stem, hw in (("a", (30, 50)), ("b", (48, 36))):
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(tmp_path / f"{stem}.png")
    kw = dict(predict_dir=str(tmp_path), height_feature_extractor=24, width_feature_extractor=32,
              eval_size=eval_size)
    want = list(jax_input(JaxSettings(**kw)))
    got = list(predict_input(TorchSettings(**kw)))
    hw = eval_size or (24, 32)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["rawimagespaths"] == w["rawimagespaths"]
        assert g["proimages"].shape == w["proimages"].shape == (1, *hw, 3)
        np.testing.assert_allclose(g["proimages"], w["proimages"], atol=1e-6, rtol=0)


def test_members_follow_the_jax_order():
    """Scales outer, flip inner: the order in which JAX sums the members."""
    two = TorchSettings(eval_scales=(0.75, 1.0), eval_flip=True)
    assert tstep._members(two) == list(itertools.product((0.75, 1.0), (False, True)))
    assert tstep._members(TorchSettings()) == [(1.0, False)]

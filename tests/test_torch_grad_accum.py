"""Gradient accumulation in the port's train step against the JAX package's.

Both take the same steps from the same flax-initialized weights (loaded into
the port by utils/convert.py) on the tiny f32 model at
``grad_accum_steps=2`` on 4 + 4 + 4 images (microbatches of two of each
kind, as tests/test_grad_accum.py splits them), with the
fused loss (plain B1/B2 on the CPU; Pallas in interpret mode in JAX) and the
fused optimizer: three steps on helpers.synthetic_batch; two steps with all
four augmentations, the port's draws replaced by the JAX package's for the
same (seed, step * accum + i) folds; two steps on box tensors rasterized on
the device with compact image labels.

Tolerances are those of tests/test_grad_accum.py: metrics 1e-3 relative
(1e-6 absolute), parameters 2e-3 relative and 1e-5 absolute; the batch mIoU
(from the summed confusion matrices) within 2e-3 absolute, as in
tests/test_torch_train_step.py. BatchNorm normalizes per microbatch, so the
running statistics take two momentum updates a step (held to JAX's within
1e-4 of the largest value) and differ from the accum=1 step's.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import synthetic_batch, tiny_model
from iv2019_tpu.input.openimages import MAX_N_BBOXES
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.state import create_fused_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.train import step as port_step
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.train.step import make_train_step
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from test_torch_augment import _jax_draws
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-3, 1e-5
MIOU_ATOL = 2e-3
STATS_RTOL = 1e-4
METRIC_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
               "regularization")
AUGMENTATIONS = ("color", "blur", "flip", "scale")


def _variables(settings, seed=42):
    jmodel = tiny_model(settings, train=True)
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((2, 32, 64, 3), np.float32))
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _box_batch(settings, seed=5):
    """synthetic_batch with the bbox labels as padded box tensors and the
    image labels as compact vectors."""
    batch = synthetic_batch(settings, seed=seed)
    rng = np.random.RandomState(seed)
    n = settings.Nb_per_bbox
    cids = np.full((n, MAX_N_BBOXES), -1, np.int32)
    coords = np.zeros((n, MAX_N_BBOXES, 4), np.float32)
    for i in range(n):
        k = 3 + i
        cids[i, :k] = rng.randint(0, 15, k)
        coords[i, :k] = np.sort(rng.rand(k, 2, 2), axis=2).reshape(k, 4)
    del batch["prolabels_per_bbox"], batch["prolabels_per_image"]
    vecs = np.zeros((settings.Nb_per_image, 15), np.float32)
    vecs[:, 2], vecs[:, 11] = 0.5, 0.5
    return dict(batch, bbox_cids=cids, bbox_coords=coords, image_label_vecs=vecs)


def _jax_draw(seed, fold, names, n, h, w, poi=(1.0, 2.0)):
    """The JAX train step's draws for ``fold``: fold_in(PRNGKey(seed), fold)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    return _jax_draws(key, names, n, h, w, poi)


def _run(case, steps):
    threads()
    kw = dict(grad_accum_steps=2, Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4)
    if case == "augment":
        kw.update(augmentations=AUGMENTATIONS, random_seed=3)
    if case == "boxes":
        kw.update(rasterize_on_device=True, compact_image_labels=True)
    jax_settings, settings = torch_tiny_settings(**kw)
    batch = _box_batch(jax_settings) if case == "boxes" else synthetic_batch(jax_settings,
                                                                             seed=42)
    jmodel, variables = _variables(jax_settings)
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    jstate = jax_create_state(variables, jopt)
    jstep = jax_make_train_step(jax_settings, model=jmodel, fused_opt=jopt)
    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    state = create_fused_train_state(opt)
    folds = []

    def draw(seed, fold, names, n, h, w, poi):
        folds.append(fold)
        return _jax_draw(seed, fold, names, n, h, w, poi)

    real_draw = port_step.draw_augmentations
    port_step.draw_augmentations = draw
    try:
        step = make_train_step(settings, fused_opt=opt)
        out = dict(jhistory=[], history=[], jparams=[], params=[], folds=folds)
        for _ in range(steps):
            jstate, jm = jstep(jstate, batch)
            out["jhistory"].append(jm)
            out["jparams"].append(numpy_tree(jstate.params))
            state, m = step(state, batch)
            out["history"].append(m)
            out["params"].append(flax_from_state_dict(model.state_dict())[0])
    finally:
        port_step.draw_augmentations = real_draw
    out.update(jstate=jstate, state=state, model=model, settings=settings, batch=batch,
               variables=variables)
    return out


@pytest.fixture(scope="module")
def plain():
    return _run("plain", 3)


@pytest.fixture(scope="module")
def augmented():
    return _run("augment", 2)


@pytest.fixture(scope="module")
def boxes():
    return _run("boxes", 2)


def _check_metrics(run, i):
    want, got = run["jhistory"][i], run["history"][i]
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    assert abs(float(got["miou"]) - float(want["miou"])) <= MIOU_ATOL


def _check_params(run, i):
    got, want = run["params"][i], run["jparams"][i]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, g in flat_got.items():
        np.testing.assert_allclose(np.asarray(g), np.asarray(flat_want[path]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=str(path))


@pytest.mark.parametrize("i", range(3))
def test_accum_step_metrics_match_jax(plain, i):
    _check_metrics(plain, i)


@pytest.mark.parametrize("i", range(3))
def test_accum_step_params_match_jax(plain, i):
    _check_params(plain, i)


def test_accum_batch_norm_statistics_advance_per_microbatch(plain):
    """Two momentum updates a step, as JAX's scan over microbatches; not the
    one update of the accum=1 step."""
    _, batch_stats = flax_from_state_dict(plain["state"].model.state_dict())
    want = numpy_tree(plain["jstate"].batch_stats)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(batch_stats)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, g in flat_got.items():
        w = np.asarray(flat_want[path])
        assert float(np.abs(np.asarray(g) - w).max()) <= STATS_RTOL * float(np.abs(w).max()), path
    # against three accum=1 steps from the same start: other statistics
    settings = plain["settings"].replace(grad_accum_steps=1)
    model = torch_tiny_model(settings, plain["variables"])
    opt = FusedSGDM(settings, model)
    state, step = create_fused_train_state(opt), make_train_step(settings, fused_opt=opt)
    for _ in range(3):
        state, _ = step(state, plain["batch"])
    _, one = flax_from_state_dict(model.state_dict())
    diffs = [float(np.abs(np.asarray(a) - np.asarray(flat_got[p])).max())
             for p, a in jax.tree_util.tree_flatten_with_path(one)[0]]
    assert max(diffs) > 10 * STATS_RTOL


def test_accum_weight_masks_come_from_microbatch_zero(plain):
    got = plain["history"][0]["weight_masks"]
    want = plain["jhistory"][0]["weight_masks"]
    np.testing.assert_array_equal(got["l1_weights"].numpy(), np.asarray(want["l1_weights"]))
    for k in ("l2_vehicle_weights", "l2_human_weights"):
        agree = float((got[k].numpy() == np.asarray(want[k])).mean())
        assert agree >= 0.99, (k, agree)
    assert int(plain["state"].step) == 3


@pytest.mark.parametrize("i", range(2))
def test_accum_step_with_augmentations_matches_jax(augmented, i):
    _check_metrics(augmented, i)
    _check_params(augmented, i)


def test_augmentation_folds_are_step_times_accum_plus_microbatch(augmented):
    assert augmented["folds"] == [0, 1, 2, 3]
    assert augmented["history"][0]["total"] != augmented["history"][1]["total"]


@pytest.mark.parametrize("i", range(2))
def test_accum_step_on_box_tensors_and_compact_labels_matches_jax(boxes, i):
    _check_metrics(boxes, i)
    _check_params(boxes, i)


def test_accum_must_divide_every_sub_batch():
    with pytest.raises(ValueError, match="grad_accum_steps"):
        torch_tiny_settings(grad_accum_steps=2, Nb_per_bbox=3)


def test_accum_of_identical_halves_equals_one_step_of_a_half():
    """A batch made of two identical halves at accum=2 gives the parameters
    of one accum=1 step on a half (BatchNorm sees the same microbatch), up
    to the rounding of adding two equal gradients and halving."""
    threads()
    jax_settings, settings = torch_tiny_settings(Nb_per_pixel=1, Nb_per_bbox=1, Nb_per_image=1)
    _, variables = _variables(jax_settings, seed=1)
    half = synthetic_batch(jax_settings, seed=9)
    doubled = {k: np.concatenate([v, v]) for k, v in half.items()}
    results = []
    for accum, batch in ((1, half), (2, doubled)):
        s = settings.replace(grad_accum_steps=accum, Nb_per_pixel=accum, Nb_per_bbox=accum,
                             Nb_per_image=accum)
        model = torch_tiny_model(s, variables)
        opt = FusedSGDM(s, model)
        state, metrics = make_train_step(s, fused_opt=opt)(create_fused_train_state(opt), batch)
        results.append((opt.params.detach().clone(),
                        {k: float(v) for k, v in metrics.items() if k != "weight_masks"}))
    (p1, m1), (p2, m2) = results
    assert torch.equal(p1, p2)
    for k in METRIC_KEYS + ("miou",):
        assert m1[k] == pytest.approx(m2[k], rel=1e-6, abs=1e-7), k

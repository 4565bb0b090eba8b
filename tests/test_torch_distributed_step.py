"""The port's train step on 2 gloo ranks on the CPU, against its own
single-process step and the JAX package's single-device ``make_train_step``
on the global batch: the fused optimizer, ``grad_accum_steps=2``, and
``num_slices=2``.

Every run starts from the same flax-initialized weights of the tiny f32
model (tests/helpers.py) and takes 2 steps on helpers.synthetic_batch at
4 + 4 + 4 images (each rank: its 2 + 2 + 2 rows, or its 1 + 1 + 1 of each
microbatch at accum 2). The ranks run tests/torch_dist_worker.py.

Tolerances, those of tests/test_torch_train_step.py where JAX is the
reference (``LOSS_RTOL``, ``MIOU_ATOL``, ``STEP1_UPDATE_RTOL``, which hold
here for the same reasons):
- per-step losses and regularization: 1e-4 relative against JAX and
  against the single-process port, the batch mIoU 2e-3;
- the all-reduced gradient of step 1 against the single-process port's:
  1e-4 in relative norm (measured 8e-6 to 1e-5: the same gradient, with the
  BatchNorm statistics from E[x^2] - E[x]^2 and sums in another order);
- parameters after step 1: within ``STEP1_UPDATE_RTOL`` (5e-3) of each
  leaf's largest |update|, plus 4 ulps, of the single-process port's
  (measured 8e-4 and 1.7e-3), and within 5e-2 of JAX's, as the
  single-process port itself (measured 2.7e-2 and 3.3e-3 for both: at 4 +
  4 + 4 images the train-mode BatchNorm gradient of the random net is less
  well conditioned than at the 2 + 2 + 2 of test_torch_train_step.py);
- state after 2 steps (parameters, BatchNorm statistics, momentum, EMA)
  equal bit for bit on the two ranks, and with ``num_slices=2`` bit for bit
  what it is with 1;
- collectives a step: 2 per train-mode BatchNorm (per microbatch), 1 for
  the fused loss's sums (per microbatch), 1 for the gradient, 1 for the
  confusion matrix.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from helpers import TINY_BLOCKS, synthetic_batch, tiny_model
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from iv2019_tpu.train.state import create_fused_train_state as jax_create_fused_state
from iv2019_tpu.train.state import create_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from test_torch_train_step import (
    LOSS_RTOL,
    MIOU_ATOL,
    STEP1_UPDATE_RTOL,
    _assert_trees_close,
)
from torch_parity import numpy_tree, run_ranks, threads, torch_tiny_model, torch_tiny_settings

STEPS = 2
GRAD_REL_NORM = 1e-4
JAX_STEP1_UPDATE_RTOL = 5e-2
NB4 = dict(Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4)
VARIANTS = {"fused": {}, "accum2": dict(grad_accum_steps=2)}
LOSS_METRICS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
                "regularization")


def build_runs(variants, tmp, slices_of=None, jax_variants=None):
    """Per variant (``torch_tiny_settings`` keywords): JAX's steps on the
    global batch, the single-process port's, and the 2 ranks'; with
    ``slices_of`` the ranks also run that variant with ``num_slices=2``."""
    threads()
    settings, jax_settings = {}, {}
    for name, kw in variants.items():
        jax_settings[name], settings[name] = torch_tiny_settings(**NB4, **kw)
    first = next(iter(variants))
    jmodel = tiny_model(jax_settings[first], train=True)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(42), np.zeros((2, 32, 64, 3), np.float32)))
    batch = synthetic_batch(jax_settings[first], seed=42)
    state_dict = {k: v.clone() for k, v in
                  torch_tiny_model(settings[first], variables).state_dict().items()}
    inp = {"variants": settings, "state_dict": state_dict, "blocks": TINY_BLOCKS,
           "batch": batch, "steps": STEPS}
    out = {"variables": variables, "ranks": run_ranks("step", inp, tmp),
           "single": worker.run_steps(inp, None), "jax": {}}
    if slices_of is not None:
        sliced = dict(inp, variants={slices_of: settings[slices_of]})
        out["slices2"] = run_ranks("step", sliced, tmp, slices=2)
    for name in jax_variants if jax_variants is not None else variants:
        js = jax_settings[name]
        if js.fused_optimizer:
            jopt = JaxFusedSGDM(js, variables["params"], use_pallas=False)
            jstate = jax_create_fused_state(variables, jopt)
            jstep = jax_make_train_step(js, model=tiny_model(js, train=True), fused_opt=jopt)
        else:
            tx, _ = jax_make_optimizer(js)
            jstate = jax_create_state(variables, tx, js.ema_decay)
            jstep = jax_make_train_step(js, model=tiny_model(js, train=True))
        history, params = [], []
        for _ in range(STEPS):
            jstate, m = jstep(jstate, batch)
            history.append({k: float(v) for k, v in m.items() if k != "weight_masks"})
            params.append(numpy_tree(jstate.params))
        out["jax"][name] = {"history": history, "params": params}
    return out


def params_of(result, key="model"):
    return flax_from_state_dict({k: torch.from_numpy(v) for k, v in result[key].items()})[0]


def assert_state_equal(a, b):
    """Parameters, BatchNorm statistics, momentum and EMA, bit for bit."""
    for key in ("model", "momentum", "ema"):
        x, y = a[key], b[key]
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{key} {k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)


def assert_metrics_close(got, want, what):
    for k in LOSS_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=f"{what} {k}")
    assert abs(got["miou"] - want["miou"]) <= MIOU_ATOL, what


def grad_rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build_runs(VARIANTS, tmp_path_factory.mktemp("dist_step"), slices_of="fused")


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics_match_one_process_and_jax(runs, name, step):
    for rank in runs["ranks"]:
        got = rank[name]["metrics"][step]
        assert_metrics_close(got, runs["single"][name]["metrics"][step], "single process")
        assert_metrics_close(got, runs["jax"][name]["history"][step], "jax")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step1_gradient_is_the_global_gradient(runs, name):
    want = runs["single"][name]["grads"]
    for rank in runs["ranks"]:
        assert grad_rel_norm(rank[name]["grads"], want) <= GRAD_REL_NORM


@pytest.mark.parametrize("name", list(VARIANTS))
def test_params_after_one_step_match_jax(runs, name):
    initial = numpy_tree(runs["variables"]["params"])
    single = params_of(runs["single"][name], "model1")
    _assert_trees_close(single, runs["jax"][name]["params"][0], "single vs jax", rtol=0.0,
                        initial=initial, update_rtol=JAX_STEP1_UPDATE_RTOL, ulps=4)
    for rank in runs["ranks"]:
        got = params_of(rank[name], "model1")
        _assert_trees_close(got, runs["jax"][name]["params"][0], "ranks vs jax", rtol=0.0,
                            initial=initial, update_rtol=JAX_STEP1_UPDATE_RTOL, ulps=4)
        _assert_trees_close(got, single, "ranks vs single", rtol=0.0, initial=initial,
                            update_rtol=STEP1_UPDATE_RTOL, ulps=4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_is_replicated_bit_for_bit(runs, name):
    a, b = (r[name] for r in runs["ranks"])
    assert_state_equal(a, b)


def test_two_slices_equal_one_slice(runs):
    for one, two in zip(runs["ranks"], runs["slices2"]):
        assert_state_equal(one["fused"], two["fused"])
        assert one["fused"]["metrics"] == two["fused"]["metrics"]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_collectives_per_step(runs, name):
    model = worker.tiny_model(torch_tiny_settings(**NB4)[1],
                              {k: torch.from_numpy(v) for k, v in
                               runs["single"][name]["model"].items()}, TINY_BLOCKS)
    norms = sum(1 for m in model.modules() if type(m).__name__ == "Norm"
                and m.norm_type == "batch")
    accum = VARIANTS[name].get("grad_accum_steps", 1)
    for rank in runs["ranks"]:
        for stats in rank[name]["collectives"]:
            assert stats["all_reduce"] == accum * (2 * norms + 1) + 2
            assert stats["broadcast"] == 0
    for stats in runs["single"][name]["collectives"]:
        assert stats["all_reduce"] == 0

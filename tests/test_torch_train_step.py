"""The port's train step against the JAX package's, on the tiny f32 model.

Both start from the same flax-initialized weights (loaded into the port by
utils/convert.py) and take three steps on helpers.synthetic_batch with the
fused loss (plain B1/B2 on the CPU; Pallas in interpret mode on the JAX
side) and the fused optimizer (plain B3; FusedSGDM's jnp path).

Tolerances (f32 on both sides; the differences are summation orders in the
convolutions, BatchNorm statistics (flax E[x^2] - E[x]^2, torch two-pass)
and the loss sums, compounded over three SGD steps):
- per-step losses and regularization: 1e-4 relative;
- batch mIoU: 2e-3 absolute (a near-tie decision flip on one of the 4096
  per-pixel labels moves it by up to ~1e-3);
- parameters after step 1: the port's update within 5e-3 of the largest
  |update| of each leaf, plus 4 ulps of the leaf (measured: 1.4e-3 and
  1.2e-7 absolute, the parameters' last bits);
- parameters after step 3: within 1e-4 of each leaf's largest |value| plus
  3e-2 of its largest |update| (measured 1.4e-2: a randomly initialized net
  with batch-statistics BatchNorm amplifies the step-1 rounding over the
  next two steps; a wrong gradient term moves an update by its own size);
- running statistics and the EMA shadow vector after step 3: 1e-4
  relative to the largest value (measured 2.8e-5 and 2.5e-5); the
  debiased EMA parameters as the parameters (measured 1.2e-2 of the
  update);
- the momentum vector after step 3 (the sum of the three steps' gradients,
  which diverge as the updates do): 3e-2 of its largest value (measured
  6.4e-3);
- the EMA decay product (1/10)(2/11)(3/12): 1e-6 relative.
"""

import jax
import numpy as np
import pytest

from helpers import synthetic_batch, tiny_model
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.state import create_fused_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.train.step import make_train_step
from iv2019_tpu_torch.utils.convert import flax_from_state_dict, opt_state_to_jax
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

STEPS = 3
LOSS_RTOL = 1e-4
MIOU_ATOL = 2e-3
STATE_RTOL = 1e-4
STEP1_UPDATE_RTOL = 5e-3
STEP3_UPDATE_RTOL = 3e-2
METRIC_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
               "regularization")


def _init(seed=42):
    jax_settings, settings = torch_tiny_settings()
    jmodel = tiny_model(jax_settings, train=True)
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((2, 32, 64, 3), np.float32))
    return jax_settings, settings, jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _port_run(settings, variables, batch, steps=STEPS):
    """(optimizer, state, metrics per step, flax params after each step)."""
    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    state = create_fused_train_state(opt)
    step = make_train_step(settings, fused_opt=opt)
    history, params = [], []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
        params.append(flax_from_state_dict(model.state_dict())[0])
    return opt, state, history, params


@pytest.fixture(scope="module")
def runs():
    threads()
    jax_settings, settings, jmodel, variables = _init()
    batch = synthetic_batch(jax_settings, seed=42)
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    jstate = jax_create_state(variables, jopt)
    jstep = jax_make_train_step(jax_settings, model=jmodel, fused_opt=jopt)
    jhistory, jparams = [], []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, batch)
        jhistory.append({k: np.asarray(v) for k, v in m.items() if k != "weight_masks"})
        jparams.append(numpy_tree(jstate.params))
    opt, state, history, params = _port_run(settings, variables, batch)
    return dict(jstate=jstate, jhistory=jhistory, jparams=jparams, opt=opt, state=state,
                history=history, params=params, initial=numpy_tree(variables["params"]))


@pytest.mark.parametrize("i", range(STEPS))
def test_step_metrics_match_jax(runs, i):
    want, got = runs["jhistory"][i], runs["history"][i]
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert abs(float(got["miou"]) - float(want["miou"])) <= MIOU_ATOL


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _assert_trees_close(got, want, what, rtol=STATE_RTOL, initial=None, update_rtol=0.0,
                        ulps=0):
    """Per leaf: |got - want| <= rtol * max|want| + update_rtol *
    max|want - initial| + ulps * spacing(max|want|)."""
    flat_got, flat_want = _leaves(got), _leaves(want)
    flat_init = _leaves(initial) if initial is not None else {}
    assert flat_got.keys() == flat_want.keys()
    for path, g in flat_got.items():
        w = np.asarray(flat_want[path])
        scale = float(np.abs(w).max())
        bound = rtol * scale + ulps * float(np.spacing(np.float32(scale)))
        if path in flat_init:
            bound += update_rtol * float(np.abs(w - np.asarray(flat_init[path])).max())
        assert float(np.abs(np.asarray(g) - w).max()) <= max(bound, 1e-30), (what, path)


def test_params_match_jax_after_one_step(runs):
    _assert_trees_close(runs["params"][0], runs["jparams"][0], "params", rtol=0.0,
                        initial=runs["initial"], update_rtol=STEP1_UPDATE_RTOL, ulps=4)


def test_params_and_batch_stats_match_jax_after_three_steps(runs):
    jstate = runs["jstate"]
    _assert_trees_close(runs["params"][-1], numpy_tree(jstate.params), "params",
                        initial=runs["initial"], update_rtol=STEP3_UPDATE_RTOL)
    _, batch_stats = flax_from_state_dict(runs["state"].model.state_dict())
    _assert_trees_close(batch_stats, numpy_tree(jstate.batch_stats), "batch_stats")


def test_optimizer_state_matches_jax_after_three_steps(runs):
    jstate, opt, state = runs["jstate"], runs["opt"], runs["state"]
    got = opt_state_to_jax(state.opt_state, opt.layout)
    for key, rtol in (("momentum", STEP3_UPDATE_RTOL), ("ema_biased", STATE_RTOL)):
        want = np.asarray(getattr(jstate.opt_state, key))
        assert got[key].shape == want.shape
        assert float(np.abs(got[key] - want).max()) <= rtol * float(np.abs(want).max()), key
    assert int(state.step) == STEPS
    prod = (1 / 10) * (2 / 11) * (3 / 12)
    assert float(state.opt_state.ema_decay_product) == pytest.approx(prod, rel=1e-6)
    assert float(jstate.opt_state.ema_decay_product) == pytest.approx(prod, rel=1e-6)


def test_ema_params_match_jax(runs):
    """Zero-debiased EMA parameters per leaf, through the port's names."""
    jstate, opt, state = runs["jstate"], runs["opt"], runs["state"]
    jax_settings, _, _, variables = _init()
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    want = numpy_tree(jopt.ema_params(jstate.opt_state, jstate.params))
    ema = opt.ema_params(state.opt_state)
    ema_params, _ = flax_from_state_dict(ema)
    _assert_trees_close(ema_params, want, "ema_params", initial=runs["initial"],
                        update_rtol=STEP3_UPDATE_RTOL)


def test_three_step_descent_and_state_evolution():
    """tests/test_golden.py for the port: on a constant batch the loss falls,
    and momentum, EMA and the decay product evolve."""
    threads()
    jax_settings, settings, _, variables = _init(seed=42)
    batch = synthetic_batch(jax_settings, seed=42)
    _, state, history, _ = _port_run(settings, variables, batch)
    totals = []
    for i, metrics in enumerate(history):
        m = {k: float(v) for k, v in metrics.items() if k != "weight_masks"}
        assert np.isfinite(m["total"]), f"step {i}: non-finite loss"
        assert m["total"] > 0 and m["l1_segmentation"] > 0 and m["regularization"] > 0
        assert 0.0 <= m["miou"] <= 1.0
        assert set(metrics["weight_masks"]) == {"l1_weights", "l2_vehicle_weights",
                                                "l2_human_weights"}
        totals.append(m["total"])
    assert totals[-1] < totals[0], totals
    assert int(state.step) == 3
    assert float(state.opt_state.momentum.abs().max()) > 0
    assert float(state.opt_state.ema_biased.abs().max()) > 0
    prod = float(state.opt_state.ema_decay_product)
    assert prod == pytest.approx((1 / 10) * (2 / 11) * (3 / 12), rel=1e-6)


def test_step_refuses_unported_paths():
    threads()
    jax_settings, settings, _, variables = _init()
    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    for bad in (dict(grad_accum_steps=2), dict(augmentations=("flip",)),
                dict(fused_optimizer=False)):
        with pytest.raises(NotImplementedError):
            make_train_step(settings.replace(**bad), fused_opt=opt)
    with pytest.raises(NotImplementedError):
        make_train_step(settings)
    batch = dict(synthetic_batch(jax_settings), bbox_cids=np.zeros((2, 4), np.int32))
    with pytest.raises(NotImplementedError):
        make_train_step(settings, fused_opt=opt)(create_fused_train_state(opt), batch)



def test_compact_image_labels_match_dense():
    """``image_label_vecs`` (Npi, 15), broadcast on the device, gives the
    same step as the dense (Npi, H, W, 15) labels it stands for."""
    threads()
    jax_settings, settings, _, variables = _init()
    dense = synthetic_batch(jax_settings, seed=3)
    rng = np.random.RandomState(3)
    vecs = rng.dirichlet(np.ones(15), size=dense["prolabels_per_image"].shape[0]).astype(np.float32)
    dense["prolabels_per_image"] = np.broadcast_to(
        vecs[:, None, None, :], dense["prolabels_per_image"].shape).copy()
    compact = {k: v for k, v in dense.items() if k != "prolabels_per_image"}
    compact["image_label_vecs"] = vecs
    results = []
    for batch in (dense, compact):
        _, _, history, params = _port_run(settings, variables, batch, steps=1)
        results.append((history[0], params[0]))
    (m_dense, p_dense), (m_compact, p_compact) = results
    for k in METRIC_KEYS + ("miou",):
        assert float(m_compact[k]) == float(m_dense[k]), k
    _assert_trees_close(p_compact, p_dense, "params", rtol=0.0)

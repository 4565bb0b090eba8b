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

from helpers import TINY_BLOCKS, synthetic_batch, tiny_model
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.state import create_fused_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.bench import step_launches
from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models import model as port_model
from iv2019_tpu_torch.models.layers import Norm
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.optimizer import make_optimizer
from iv2019_tpu_torch.train.state import create_fused_train_state, create_train_state
from iv2019_tpu_torch.train.step import make_train_step, uses_fused_loss
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


def test_default_settings_step_matches_jax_fused_bn():
    """The port's default Settings (train-mode BatchNorm as ops/fused_bn.py)
    against the JAX step with ``bn_impl="fused"``, three steps at this
    file's tolerances: the port's default path held to its JAX counterpart
    (the other tests name ``"flax"`` on both sides)."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.layers import Norm

    threads()
    jax_settings, settings = torch_tiny_settings(bn_impl="fused")
    # the port's default bn_impl; the tiny sizes and f32 as the other tests
    assert settings.bn_impl == Settings.bn_impl == "fused"
    jmodel = tiny_model(jax_settings, train=True).clone(bn_impl="fused")
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(42), np.zeros((2, 32, 64, 3), np.float32)))
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
    norms = [m for m in state.model.modules() if isinstance(m, Norm) and m.norm_type == "batch"]
    assert norms and all(m.bn_impl == "fused" for m in norms)
    for want, got in zip(jhistory, history):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
        assert abs(float(got["miou"]) - float(want["miou"])) <= MIOU_ATOL
    initial = numpy_tree(variables["params"])
    _assert_trees_close(params[0], jparams[0], "params", rtol=0.0, initial=initial,
                        update_rtol=STEP1_UPDATE_RTOL, ulps=4)
    _assert_trees_close(params[-1], jparams[-1], "params", initial=initial,
                        update_rtol=STEP3_UPDATE_RTOL)
    _, batch_stats = flax_from_state_dict(state.model.state_dict())
    _assert_trees_close(batch_stats, numpy_tree(jstate.batch_stats), "batch_stats")
    got = opt_state_to_jax(state.opt_state, opt.layout)
    for key, rtol in (("momentum", STEP3_UPDATE_RTOL), ("ema_biased", STATE_RTOL)):
        want = np.asarray(getattr(jstate.opt_state, key))
        assert float(np.abs(got[key] - want).max()) <= rtol * float(np.abs(want).max()), key


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
    """The optax path runs (its parity with JAX is
    tests/test_torch_optax_path.py); a step without the optimizer its path
    needs, and an augmentation the JAX package does not have, are refused."""
    threads()
    jax_settings, settings, _, variables = _init()
    model = torch_tiny_model(settings, variables)
    optax_settings = settings.replace(fused_optimizer=False)
    tx, _ = make_optimizer(optax_settings, model)
    state, metrics = make_train_step(optax_settings, model=model)(
        create_train_state(model, tx, optax_settings.ema_decay), synthetic_batch(jax_settings))
    assert int(state.step) == 1 and np.isfinite(float(metrics["total"]))
    assert float(metrics["regularization"]) > 0
    opt = FusedSGDM(settings, model)
    # the fused path needs its FusedSGDM; the optax path takes none
    with pytest.raises(ValueError, match="fused_opt"):
        make_train_step(settings)
    with pytest.raises(ValueError, match="optax"):
        make_train_step(optax_settings, fused_opt=opt)
    # an augmentation the JAX package does not have
    batch = synthetic_batch(jax_settings)
    with pytest.raises(ValueError, match="unknown augmentations"):
        make_train_step(settings.replace(augmentations=("rotate",)), fused_opt=opt)(
            create_fused_train_state(opt), batch)


# (case, Settings overrides, hand-written kernels on the step's path)
PATH_CASES = [
    ("default", {}, {"fused_loss_fwd", "fused_loss_bwd", "fused_update"}),
    ("b6", {"root_wgrad_pallas": True},
     {"fused_loss_fwd", "fused_loss_bwd", "fused_update", "root_conv_wgrad"}),
    # B6 takes bf16 operands only; a degenerate mix and bootstrapped CE take
    # the reference loss; the optax path has no B3
    ("b6-f32", {"root_wgrad_pallas": True, "compute_dtype": "float32"},
     {"fused_loss_fwd", "fused_loss_bwd", "fused_update"}),
    ("no-bbox", {"Nb_per_bbox": 0}, {"fused_update"}),
    ("bootstrapping", {"bootstrapping_percentage": 10}, {"fused_update"}),
    ("optax", {"fused_optimizer": False}, {"fused_loss_fwd", "fused_loss_bwd"}),
]


@pytest.mark.parametrize("case,overrides,kernels", PATH_CASES, ids=[c[0] for c in PATH_CASES])
def test_step_decides_which_kernels_it_runs(monkeypatch, case, overrides, kernels):
    """The step's own decisions, at a bf16 1 + 1 + 1 batch of 32x64: B1/B2
    where ``uses_fused_loss`` holds, B3 under the fused optimizer with
    ``pallas_update``, B6 where the root conv's ``runs_wgrad_kernel`` takes
    the batch's images; and the bench's ``step_launches`` from them, with
    N1/N2 once a batch norm under the default ``bn_impl``."""
    monkeypatch.setitem(port_model.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", TINY_BLOCKS)
    settings = Settings(
        per_pixel_dataset_name="cityscapes", device="cpu", mode="train", Nb_per_pixel=1,
        Nb_per_bbox=1, Nb_per_image=1, Nb=1, height_feature_extractor=32,
        width_feature_extractor=64, compute_dtype="bfloat16").finalize().replace(**overrides)
    model = port_model.build_model(settings)
    n = settings.Nb_per_pixel + settings.Nb_per_bbox + settings.Nb_per_image
    root = model.get_submodule("feature_extractor/base").conv1
    assert uses_fused_loss(settings, model) is ("fused_loss_fwd" in kernels)
    assert ("fused_loss_fwd" in kernels) is ("fused_loss_bwd" in kernels)
    assert bool(settings.fused_optimizer and settings.pallas_update) is ("fused_update" in kernels)
    assert root.runs_wgrad_kernel((n, 3, 32, 64)) is ("root_conv_wgrad" in kernels)
    # the bench's launch check: these kernels once a step, N1/N2 once a batch norm
    norms = sum(1 for m in model.modules() if isinstance(m, Norm) and m.norm_type == "batch")
    assert settings.bn_impl == "fused" and norms
    assert step_launches(settings, model) == {
        **dict.fromkeys(kernels, 1), "fused_bn_fwd": norms, "fused_bn_bwd": norms}


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

"""The port's optax path (``fused_optimizer=False``) against the JAX package's.

Both start from the same flax-initialized weights of the tiny f32 model
and take three ``make_train_step`` steps on helpers.synthetic_batch: SGD
with momentum, with Nesterov momentum, plain SGD, and momentum at
``grad_accum_steps=2`` (on 4 + 4 + 4 images). The JAX side is ``optax.sgd`` with the L2
regularization in the loss and ``EmaState``; the port's is
``torch.optim.SGD`` with the same loss and its own ``EmaState``. Compared
with the bounds of tests/test_torch_train_step.py (``LOSS_RTOL``,
``STEP1_UPDATE_RTOL``, ``STEP3_UPDATE_RTOL``, ``STATE_RTOL``, whose reasons
hold here): losses and the regularization metric, parameters after one and
three steps, the running statistics, the momentum trace, the EMA shadow and
``decay_product``.

Also: the port's optax path against its own FusedSGDM from the same
weights (the same function: parameters within ``STEP3_UPDATE_RTOL`` after
three steps); the learning rate at and around each schedule boundary; a
JAX state after one step carried into the port (utils/convert.py) and both
continued; resume from an optax checkpoint equal to an unbroken run;
``restore_variables(..., restore_emas=True)`` equal to
``EmaState.debiased``; and checkpoints of one kind refused by the other.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import synthetic_batch, tiny_model
from iv2019_tpu.train.optimizer import make_learning_rate_fn as jax_lr_fn
from iv2019_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from iv2019_tpu.train.state import create_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.system import restore_variables
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.loop import train
from iv2019_tpu_torch.train.optimizer import make_optimizer
from iv2019_tpu_torch.train.state import (
    EmaState,
    create_fused_train_state,
    create_train_state,
    momentum_buffers,
)
from iv2019_tpu_torch.train.step import make_train_step
from iv2019_tpu_torch.utils.checkpoint import CheckpointManager
from iv2019_tpu_torch.utils.convert import (
    flax_from_state_dict,
    flax_params,
    load_flax_variables,
    load_optax_state,
    optax_state_to_jax,
)
from test_torch_train_loop import PORT_JSON, RESUME_TOL, _records
from test_torch_train_loop import _settings as loop_settings
from test_torch_train_step import (
    LOSS_RTOL,
    METRIC_KEYS,
    STATE_RTOL,
    STEP1_UPDATE_RTOL,
    STEP3_UPDATE_RTOL,
    _assert_trees_close,
)
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

STEPS = 3
# at accum 2, 4 + 4 + 4 images, as tests/test_torch_grad_accum.py: each
# microbatch's BatchNorm sees the 2 + 2 + 2 of the accum=1 cases
NB4 = dict(Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4)
CASES = {
    "sgdm": dict(optimizer="SGDM"),
    "nesterov": dict(optimizer="SGDM", use_nesterov=True),
    "sgd": dict(optimizer="SGD"),
    "sgdm_accum2": dict(optimizer="SGDM", grad_accum_steps=2, **NB4),
}


def _init(seed=42, **kw):
    jax_settings, settings = torch_tiny_settings(fused_optimizer=False, **kw)
    jmodel = tiny_model(jax_settings, train=True)
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((2, 32, 64, 3), np.float32))
    return jax_settings, settings, jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _jax_state_arrays(jstate):
    """The JAX optax-path state in utils/convert.py's form."""
    trace = jstate.opt_state[0]
    return {"trace": numpy_tree(trace.trace) if hasattr(trace, "trace") else None,
            "count": int(jstate.opt_state[1].count),
            "ema_biased": numpy_tree(jstate.ema.biased) if jstate.ema is not None else None,
            "ema_decay_product": (np.asarray(jstate.ema.decay_product)
                                  if jstate.ema is not None else None)}


def _assert_vector_close(got, want, rtol, what):
    """The trees as one vector each, within ``rtol`` of the largest |value|:
    the bound tests/test_torch_train_step.py holds the fused optimizer's
    flat momentum and EMA vectors to."""
    def flat(tree):
        return np.concatenate([np.asarray(v).ravel()
                               for _, v in sorted(jax.tree_util.tree_flatten_with_path(tree)[0],
                                                  key=lambda kv: jax.tree_util.keystr(kv[0]))])

    g, w = flat(got), flat(want)
    assert g.shape == w.shape, what
    assert float(np.abs(g - w).max()) <= rtol * float(np.abs(w).max()), what


def _jax_steps(jax_settings, jmodel, jstate, batch, steps):
    jstep = jax_make_train_step(jax_settings, model=jmodel)
    history, params = [], []
    for _ in range(steps):
        jstate, m = jstep(jstate, batch)
        history.append({k: np.asarray(v) for k, v in m.items() if k != "weight_masks"})
        params.append(numpy_tree(jstate.params))
    return jstate, history, params


def _port_steps(settings, state, batch, steps):
    step = make_train_step(settings, model=state.model)
    history, params = [], []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
        params.append(flax_from_state_dict(state.model.state_dict())[0])
    return state, history, params


def _port_state(settings, variables):
    model = torch_tiny_model(settings, variables)
    tx, _ = make_optimizer(settings, model)
    return create_train_state(model, tx, settings.ema_decay)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    threads()
    jax_settings, settings, jmodel, variables = _init(**CASES[request.param])
    batch = synthetic_batch(jax_settings, seed=42)
    tx, _ = jax_make_optimizer(jax_settings)
    jstate, jhistory, jparams = _jax_steps(
        jax_settings, jmodel, jax_create_state(variables, tx, jax_settings.ema_decay), batch,
        STEPS)
    state, history, params = _port_steps(settings, _port_state(settings, variables), batch,
                                         STEPS)
    return dict(jstate=jstate, jhistory=jhistory, jparams=jparams, state=state, history=history,
                params=params, initial=numpy_tree(variables["params"]), case=request.param)


def test_metrics_match_jax(runs):
    for want, got in zip(runs["jhistory"], runs["history"]):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
        assert float(got["regularization"]) > 0


def test_params_match_jax(runs):
    """After one step at STEP1_UPDATE_RTOL, after three at STEP3_UPDATE_RTOL.
    Plain SGD's three-step update weighs the third gradient as much as the
    first, and the net amplifies the step-1 rounding in each later gradient
    (largest difference over the largest |update| of a leaf: 1.4e-3, 1.6e-2,
    4.2e-2 after steps 1, 2, 3, against 1.4e-3 after step 1 and under 3e-2
    after step 3 with momentum, whose update is mostly the first gradient):
    its parameters are held to STEP3_UPDATE_RTOL after two steps."""
    _assert_trees_close(runs["params"][0], runs["jparams"][0], "params", rtol=0.0,
                        initial=runs["initial"], update_rtol=STEP1_UPDATE_RTOL, ulps=4)
    last = 1 if runs["case"] == "sgd" else STEPS - 1
    _assert_trees_close(runs["params"][last], runs["jparams"][last], "params",
                        initial=runs["initial"], update_rtol=STEP3_UPDATE_RTOL)
    _, stats = flax_from_state_dict(runs["state"].model.state_dict())
    _assert_trees_close(stats, numpy_tree(runs["jstate"].batch_stats), "batch_stats")


def test_optimizer_state_matches_jax(runs):
    state, jstate = runs["state"], runs["jstate"]
    got, want = optax_state_to_jax(state), _jax_state_arrays(jstate)
    assert got["count"] == want["count"] == int(state.step) == STEPS
    if runs["case"] == "sgd":
        assert got["trace"] is None and want["trace"] is None
    else:
        _assert_vector_close(got["trace"], want["trace"], STEP3_UPDATE_RTOL, "momentum")
    _assert_vector_close(got["ema_biased"], want["ema_biased"], STATE_RTOL, "ema")
    prod = (1 / 10) * (2 / 11) * (3 / 12)
    assert float(got["ema_decay_product"]) == pytest.approx(prod, rel=1e-6)
    assert float(want["ema_decay_product"]) == pytest.approx(prod, rel=1e-6)


def test_optax_path_matches_fused_optimizer():
    """The optax path and FusedSGDM compute the same function (L2 in the loss
    against decay in the update; EMA per parameter against flat)."""
    threads()
    jax_settings, settings, _, variables = _init()
    batch = synthetic_batch(jax_settings, seed=42)
    state, history, params = _port_steps(settings, _port_state(settings, variables), batch,
                                         STEPS)
    fused = settings.replace(fused_optimizer=True)
    model = torch_tiny_model(fused, variables)
    opt = FusedSGDM(fused, model)
    fstate = create_fused_train_state(opt)
    step = make_train_step(fused, fused_opt=opt)
    for i in range(STEPS):
        fstate, metrics = step(fstate, batch)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(history[i][k]), float(metrics[k]), rtol=LOSS_RTOL)
    want = flax_from_state_dict(model.state_dict())[0]
    _assert_trees_close(params[-1], want, "params", initial=numpy_tree(variables["params"]),
                        update_rtol=STEP3_UPDATE_RTOL)
    ema = flax_from_state_dict(state.ema.debiased())[0]
    _assert_trees_close(ema, flax_from_state_dict(opt.ema_params(fstate.opt_state))[0], "ema",
                        initial=numpy_tree(variables["params"]), update_rtol=STEP3_UPDATE_RTOL)


def test_learning_rate_at_schedule_boundaries():
    """One batch an epoch and boundaries at epochs 1 and 2: the lr of the
    update at steps 0..3 is JAX's schedule at optax's count, the step
    (step == boundary keeps the left value)."""
    threads()
    jax_settings, settings, _, variables = _init(Ntrain=6, Nb=6, Ne=3)
    assert settings.learning_rate_boundaries_steps == (1, 2)
    batch = synthetic_batch(jax_settings, seed=1)
    state = _port_state(settings, variables)
    step = make_train_step(settings, model=state.model)
    jax_lr = jax_lr_fn(jax_settings)
    got = []
    for _ in range(4):
        state, _ = step(state, batch)
        got.append(state.opt_state.param_groups[0]["lr"])
    want = [float(jax_lr(jnp.asarray(i))) for i in range(4)]
    assert want == pytest.approx([0.01, 0.01, 0.005, 0.0025], rel=1e-7)
    assert got == pytest.approx(want, rel=1e-7)


def test_state_carried_from_jax_continues_as_jax():
    """JAX takes one step; its parameters, statistics, trace, count and EMA
    go to the port (load_optax_state), and both take two more."""
    threads()
    jax_settings, settings, jmodel, variables = _init()
    batch = synthetic_batch(jax_settings, seed=5)
    tx, _ = jax_make_optimizer(jax_settings)
    jstate, _, _ = _jax_steps(jax_settings, jmodel,
                              jax_create_state(variables, tx, jax_settings.ema_decay), batch, 1)
    after_one = {"params": numpy_tree(jstate.params), "batch_stats": numpy_tree(jstate.batch_stats)}
    state = _port_state(settings, after_one)
    load_optax_state(state, _jax_state_arrays(jstate))
    assert int(state.step) == 1
    jstate, jhistory, jparams = _jax_steps(jax_settings, jmodel, jstate, batch, 2)
    state, history, params = _port_steps(settings, state, batch, 2)
    for want, got in zip(jhistory, history):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    _assert_trees_close(params[-1], jparams[-1], "params", initial=after_one["params"],
                        update_rtol=STEP3_UPDATE_RTOL)
    got, want = optax_state_to_jax(state), _jax_state_arrays(jstate)
    assert got["count"] == want["count"] == 3
    _assert_vector_close(got["ema_biased"], want["ema_biased"], STATE_RTOL, "ema")
    assert float(got["ema_decay_product"]) == pytest.approx(float(want["ema_decay_product"]),
                                                            rel=1e-6)


def _final(state):
    params, stats = flax_from_state_dict(state.model.state_dict())
    return dict(params=params, stats=stats, step=int(state.step),
                momentum=flax_params(momentum_buffers(state), state.model),
                ema=flax_params(state.ema.biased, state.model),
                prod=float(state.ema.decay_product))


def _loop_train(settings, variables, batches=None, **kw):
    model = torch_tiny_model(settings, variables)
    if batches is None:
        batches = train_input(settings, load_problem_def(PORT_JSON))
    return train(settings, batches, model=model, log_every=1, image_summaries=False, **kw)


def _optax_loop_settings(log_dir, **kw):
    _, settings = loop_settings(log_dir, fused_optimizer=False, **kw)
    return settings


def test_resume_from_optax_checkpoint_equals_unbroken_run(tmp_path):
    threads()
    _, _, _, variables = _init()
    whole = _optax_loop_settings(tmp_path / "whole")
    want = _final(_loop_train(whole, variables, max_steps=4))
    split = _optax_loop_settings(tmp_path / "split")
    _loop_train(split, variables, max_steps=2)
    snap = CheckpointManager(split.log_dir).load(2)
    assert snap["kind"] == "optax" and snap["count"] == 2 and snap["momentum"] is not None
    rest = itertools.islice(train_input(split, load_problem_def(PORT_JSON)), 2, None)
    got = _final(_loop_train(split, variables, batches=rest, max_steps=4))
    assert got["step"] == want["step"] == 4
    for key in ("params", "stats", "momentum", "ema"):
        _assert_trees_close(got[key], want[key], key, rtol=RESUME_TOL)
    assert got["prod"] == pytest.approx(want["prod"], rel=RESUME_TOL)
    records = {r["step"]: r for r in _records(split.log_dir)}
    for r in _records(whole.log_dir)[2:]:
        for k in METRIC_KEYS + ("learning_rate",):
            assert records[r["step"]][k] == pytest.approx(r[k], rel=RESUME_TOL, abs=RESUME_TOL)


def test_restore_emas_from_optax_checkpoint(tmp_path):
    threads()
    _, _, _, variables = _init()
    settings = _optax_loop_settings(tmp_path / "run")
    state = _loop_train(settings, variables, max_steps=2)
    want = state.ema.debiased(fallback=dict(state.model.named_parameters()))
    for emas in (True, False):
        model = torch_tiny_model(settings, variables, train=False)
        restore_variables(model, settings.replace(restore_emas=emas), 2)
        for name, p in model.named_parameters():
            ref = want[name] if emas else dict(state.model.named_parameters())[name]
            torch.testing.assert_close(p.detach(), ref.detach(), rtol=0, atol=0)
        assert p.grad is None
    # statistics come from the checkpoint either way
    torch.testing.assert_close(dict(model.named_buffers()), dict(state.model.named_buffers()),
                               rtol=0, atol=0)


def test_ema_debiased_falls_back_before_the_first_update():
    threads()
    _, settings, _, variables = _init()
    state = _port_state(settings, variables)
    params = dict(state.model.named_parameters())
    out = state.ema.debiased(fallback=params)
    for name, p in params.items():
        assert torch.equal(out[name], p.detach())
    assert EmaState.create(state.model).decay_product.item() == 1.0


def test_checkpoint_kinds_refuse_each_other(tmp_path):
    threads()
    _, _, _, variables = _init()
    optax_run = _optax_loop_settings(tmp_path / "optax")
    _loop_train(optax_run, variables, max_steps=2)
    fused_run = optax_run.replace(fused_optimizer=True, log_dir=str(tmp_path / "fused"))
    _loop_train(fused_run, variables, max_steps=2)
    # a run of one kind does not resume from the other's checkpoint
    for settings, other in ((fused_run, optax_run), (optax_run, fused_run)):
        with pytest.raises(ValueError, match="optimizer"):
            _loop_train(settings.replace(log_dir=other.log_dir), variables, max_steps=4)
    # both kinds restore for inference
    for settings in (optax_run, fused_run):
        model = torch_tiny_model(settings, variables, train=False)
        assert "checkpoint 2" in restore_variables(model, settings.replace(restore_emas=True), 2)


def test_momentum_trace_of_plain_sgd_is_absent(tmp_path):
    threads()
    _, _, _, variables = _init()
    settings = _optax_loop_settings(tmp_path / "sgd", optimizer="SGD")
    state = _loop_train(settings, variables, max_steps=2)
    assert momentum_buffers(state) is None
    assert CheckpointManager(settings.log_dir).load(2)["momentum"] is None
    # an SGDM run does not resume from it
    with pytest.raises(ValueError, match="SGD"):
        _loop_train(settings.replace(optimizer="SGDM"), variables, max_steps=4)


def test_load_flax_variables_roundtrip_keeps_group_norm_names():
    """A group-norm model's parameters go to flax GroupNorm paths and back."""
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel, init_model
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.utils.convert import flax_variables

    model = HierarchicalSegmentationModel(get_taxonomy("cityscapes"), resnet_blocks=((1, 64, 16),),
                                          feature_dims_decreased=32, dtype=torch.float32,
                                          norm_type="group", upsampling_method="hybrid")
    init_model(model, torch.Generator().manual_seed(0))
    tree = flax_variables(model)
    assert tree["batch_stats"] == {}
    norm = tree["params"]["feature_extractor/base"]["conv1_norm"]
    assert set(norm) == {"GroupNorm"} and set(norm["GroupNorm"]) == {"scale", "bias"}
    up = tree["params"]["softmax_classifier/l1_logits/upsampling/conv_transpose"]
    assert set(up) == {"kernel", "bias"} and up["kernel"].shape == (3, 3, 14, 14)
    other = HierarchicalSegmentationModel(get_taxonomy("cityscapes"), resnet_blocks=((1, 64, 16),),
                                          feature_dims_decreased=32, dtype=torch.float32,
                                          norm_type="group", upsampling_method="hybrid")
    load_flax_variables(other, tree["params"], tree["batch_stats"])
    for (k, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k

"""Remat (``--remat``) in the port's train step.

Each trunk unit runs under ``torch.utils.checkpoint`` (``nn.remat`` of
BottleneckV1 in the JAX package): the backward recomputes the unit's
activations, and the recompute must not move the BatchNorm running
statistics a second time.

- A train step with remat against one without, on the same batch from the
  same weights (tiny f32 model, fused loss and fused optimizer, plain
  versions of the kernels on the CPU): the flat gradient vector, the
  parameters after the update and the running statistics equal bit for
  bit, for two steps.
- The port's remat step against the JAX package's remat step over three
  steps, at the bounds of tests/test_torch_train_step.py.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import synthetic_batch, tiny_model
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.state import create_fused_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.models.layers import Norm
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.train.step import make_train_step
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from test_torch_train_step import (
    LOSS_RTOL,
    METRIC_KEYS,
    STEP1_UPDATE_RTOL,
    STEP3_UPDATE_RTOL,
    _assert_trees_close,
)
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings


def _init(seed=42):
    jax_settings, settings = torch_tiny_settings(remat=True)
    jmodel = tiny_model(jax_settings, train=True)
    assert jmodel.remat
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((2, 32, 64, 3), np.float32))
    return jax_settings, settings, jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _port(settings, variables, remat):
    model = torch_tiny_model(settings, variables)
    model.get_submodule("feature_extractor/base").remat = remat
    opt = FusedSGDM(settings, model)
    return opt, create_fused_train_state(opt), make_train_step(settings, fused_opt=opt)


def test_remat_step_equals_plain_step_bit_for_bit():
    threads()
    jax_settings, settings, _, variables = _init()
    batch = synthetic_batch(jax_settings, seed=3)
    runs = {remat: _port(settings, variables, remat) for remat in (False, True)}
    recomputed = []
    # the unit's forward runs twice a step under remat (once recomputed)
    unit = runs[True][0].model.get_submodule("feature_extractor/base").units()[0]
    unit.register_forward_pre_hook(lambda m, args: recomputed.append(
        all(n.update_stats for n in m.modules() if isinstance(n, Norm))))
    for _ in range(2):
        out = {}
        for remat, (opt, state, step) in runs.items():
            state, metrics = step(state, batch)
            runs[remat] = (opt, state, step)
            out[remat] = (opt.grads.clone(), opt.params.clone(),
                          {k: v.clone() for k, v in opt.model.named_buffers()},
                          {k: float(metrics[k]) for k in METRIC_KEYS})
        (g0, p0, b0, m0), (g1, p1, b1, m1) = out[False], out[True]
        assert torch.equal(g0, g1)
        assert torch.equal(p0, p1)
        assert b0.keys() == b1.keys() and all(torch.equal(b0[k], b1[k]) for k in b0)
        assert m0 == m1
    # first call moves the statistics, the recompute does not
    assert recomputed == [True, False, True, False]
    assert all(n.update_stats for n in unit.modules() if isinstance(n, Norm))


def test_remat_skipped_without_autograd():
    threads()
    _, settings, _, variables = _init()
    model = torch_tiny_model(settings, variables, train=False)
    model.get_submodule("feature_extractor/base").remat = True
    calls = []
    unit = model.get_submodule("feature_extractor/base").units()[0]
    unit.register_forward_pre_hook(lambda m, args: calls.append(1))
    with torch.no_grad():
        model(torch.zeros(1, 32, 64, 3))
    assert calls == [1]


def test_remat_step_matches_jax_remat_step():
    threads()
    jax_settings, settings, jmodel, variables = _init()
    batch = synthetic_batch(jax_settings, seed=42)
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    jstate = jax_create_state(variables, jopt)
    jstep = jax_make_train_step(jax_settings, model=jmodel, fused_opt=jopt)
    opt, state, step = _port(settings, variables, remat=True)
    initial = numpy_tree(variables["params"])
    for i in range(3):
        jstate, want = jstep(jstate, batch)
        state, got = step(state, batch)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
        params, stats = flax_from_state_dict(opt.model.state_dict())
        bound = STEP1_UPDATE_RTOL if i == 0 else STEP3_UPDATE_RTOL
        _assert_trees_close(params, numpy_tree(jstate.params), "params", rtol=0.0 if i == 0 else
                            1e-4, initial=initial, update_rtol=bound, ulps=4 if i == 0 else 0)
    _assert_trees_close(stats, numpy_tree(jstate.batch_stats), "batch_stats")
    assert int(state.step) == 3


@pytest.mark.parametrize("remat", [False, True])
def test_train_cli_remat_flag_trains(tmp_path, remat):
    """``--remat`` trains through the CLI (it was refused before the port
    had it); the run's settings.txt records it."""
    from iv2019_tpu_torch import train_cli

    log_dir = tmp_path / "log"
    flags = ["--remat"] if remat else []
    train_cli.main([str(log_dir), "cityscapes", "--synthetic_data", "--device", "cpu",
                    "--Ntrain", "2", "--Ne", "1", "--learning_rate_boundaries", "1",
                    "--learning_rate_values", "0.01", "--height_feature_extractor", "64",
                    "--width_feature_extractor", "128", "--Nb_per_pixel", "1",
                    "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--input_seed", "1",
                    "--save_checkpoints_steps", "2", *flags])
    text = (log_dir / "settings.txt").read_text()
    assert f": remat : {remat}" in text
    assert (log_dir / "checkpoints" / "2" / "state.pt").is_file()

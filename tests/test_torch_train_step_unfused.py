"""The port's train step on the reference loss branch, against the JAX step.

The fused loss's gate is off for a per-pixel-only batch (no weak images)
and for bootstrapped CE (a batch-global sort of the raw L1 losses): both
packages then run ``define_losses`` on the bilinearly upsampled logits.
Two steps on the tiny f32 model from the same weights; tolerances as in
tests/test_torch_train_step.py: losses and regularization 1e-4 relative,
batch mIoU 2e-3 absolute, the parameters after step 1 within 5e-3 of each
leaf's largest |update| plus 4 ulps; the summary weight masks equal on
>= 99.9% of pixels (the weak gate reads the L1 decisions, which a near-tie
may flip). And the descent check of tests/test_golden.py on the
per-pixel-only batch.
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
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from test_torch_train_step import METRIC_KEYS, MIOU_ATOL, LOSS_RTOL, STEP1_UPDATE_RTOL
from test_torch_train_step import _assert_trees_close
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

CASES = {
    "per_pixel_only": dict(Nb_per_bbox=0, Nb_per_image=0),
    "bootstrapped": dict(bootstrapping_percentage=50),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unfused_branch_matches_jax(case):
    threads()
    jax_settings, settings = torch_tiny_settings(**CASES[case])
    jmodel = tiny_model(jax_settings, train=True)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(7), np.zeros((2, 32, 64, 3), np.float32)))
    batch = synthetic_batch(jax_settings, seed=7)
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    jstate = jax_create_state(variables, jopt)
    jstep = jax_make_train_step(jax_settings, model=jmodel, fused_opt=jopt)

    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    state = create_fused_train_state(opt)
    step = make_train_step(settings, fused_opt=opt)
    for i in range(2):
        jstate, want = jstep(jstate, batch)
        state, got = step(state, batch)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        assert abs(float(got["miou"]) - float(want["miou"])) <= MIOU_ATOL
        for k, mask in got["weight_masks"].items():
            assert (mask.numpy() == np.asarray(want["weight_masks"][k])).mean() >= 0.999, k
        if i == 0:
            _assert_trees_close(flax_from_state_dict(model.state_dict())[0],
                                numpy_tree(jstate.params), "params", rtol=0.0,
                                initial=numpy_tree(variables["params"]),
                                update_rtol=STEP1_UPDATE_RTOL, ulps=4)


def test_per_pixel_only_descent():
    threads()
    jax_settings, settings = torch_tiny_settings(**CASES["per_pixel_only"])
    variables = jax.tree_util.tree_map(np.asarray, tiny_model(jax_settings).init(
        jax.random.PRNGKey(42), np.zeros((2, 32, 64, 3), np.float32)))
    batch = synthetic_batch(jax_settings, seed=42)
    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    state = create_fused_train_state(opt)
    step = make_train_step(settings, fused_opt=opt)
    totals = []
    for _ in range(3):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["total"]))
        totals.append(float(metrics["total"]))
    assert totals[-1] < totals[0], totals
    assert float(state.opt_state.ema_decay_product) == pytest.approx(
        (1 / 10) * (2 / 11) * (3 / 12), rel=1e-6)

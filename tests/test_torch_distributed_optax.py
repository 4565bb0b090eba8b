"""The port's train step on 2 gloo ranks on the CPU: the optax path
(``fused_optimizer=False``) and the on-device augmentations.

As tests/test_torch_distributed_step.py, whose runs, helpers and
tolerances these are: 2 steps of the tiny f32 model at 4 + 4 + 4 images,
the ranks against the single-process port on the global batch and, on the
optax path, against JAX's ``make_train_step`` with ``optax.sgd``. On the
optax path the regularization's gradient must count once (rank 0 alone
differentiates it), which the step-1 gradient and the parameters show. The
augmentations are drawn for the global batch and each rank applies its
rows' draws, so the ranks take the single-process step; the JAX package
draws from its own PRNG, so that run has no JAX reference here (the
applies are held to JAX's with shared draws in tests/test_torch_augment.py).
"""

import numpy as np
import pytest

from test_torch_distributed_step import (
    GRAD_REL_NORM,
    JAX_STEP1_UPDATE_RTOL,
    STEPS,
    assert_metrics_close,
    assert_state_equal,
    build_runs,
    grad_rel_norm,
    params_of,
)
from test_torch_train_step import STEP1_UPDATE_RTOL, _assert_trees_close
from torch_parity import numpy_tree

VARIANTS = {"optax": dict(fused_optimizer=False),
            "augment": dict(augmentations=("color", "blur", "flip", "scale"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build_runs(VARIANTS, tmp_path_factory.mktemp("dist_optax"), jax_variants=["optax"])


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics_match_one_process(runs, name, step):
    for rank in runs["ranks"]:
        got = rank[name]["metrics"][step]
        assert_metrics_close(got, runs["single"][name]["metrics"][step], "single process")
        if name in runs["jax"]:
            assert_metrics_close(got, runs["jax"][name]["history"][step], "jax")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step1_gradient_is_the_global_gradient(runs, name):
    want = runs["single"][name]["grads"]
    for rank in runs["ranks"]:
        assert grad_rel_norm(rank[name]["grads"], want) <= GRAD_REL_NORM


@pytest.mark.parametrize("name", list(VARIANTS))
def test_params_after_one_step(runs, name):
    initial = numpy_tree(runs["variables"]["params"])
    single = params_of(runs["single"][name], "model1")
    for rank in runs["ranks"]:
        got = params_of(rank[name], "model1")
        _assert_trees_close(got, single, "ranks vs single", rtol=0.0, initial=initial,
                            update_rtol=STEP1_UPDATE_RTOL, ulps=4)
        if name in runs["jax"]:
            _assert_trees_close(got, runs["jax"][name]["params"][0], "ranks vs jax", rtol=0.0,
                                initial=initial, update_rtol=JAX_STEP1_UPDATE_RTOL, ulps=4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_is_replicated_bit_for_bit(runs, name):
    a, b = (r[name] for r in runs["ranks"])
    assert_state_equal(a, b)


def test_regularization_counts_once(runs):
    """The optax path's metric and gradient: the regularization of the
    replicated parameters, once (the ranks' gradients would differ from the
    single-process one by (world - 1) x its gradient otherwise)."""
    reg = [r["optax"]["metrics"][0]["regularization"] for r in runs["ranks"]]
    assert reg[0] == reg[1]
    np.testing.assert_allclose(reg[0], runs["single"]["optax"]["metrics"][0]["regularization"],
                               rtol=1e-6)
    single = runs["single"]["optax"]["grads"]
    fused_like = runs["ranks"][0]["optax"]["grads"]
    assert grad_rel_norm(fused_like, single) <= GRAD_REL_NORM

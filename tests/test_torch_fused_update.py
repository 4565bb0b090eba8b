"""The fused update (B3 plain), FusedSGDM, the learning-rate schedule and the
optimizer-state converter of the port against the JAX package.

Tolerances: B3's plain version against ``fused_update_pallas`` in
interpret mode on the same f32 vectors: the vectors equal to 1e-6 of the
largest |value| (one rounding per operation on both sides, up to XLA's
fusion choices), reg 1e-6 relative (a sum in another order). FusedSGDM
over three steps with the same gradients: parameters, momentum, EMA, reg
and EMA parameters 1e-6 of the largest |value|, the decay product 1e-6
relative. The schedule: equal in f32. The converter: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from iv2019_tpu.ops.pallas_update import TILE, fused_update_pallas
from iv2019_tpu.train.fused_update import FusedOptState as JaxOptState
from iv2019_tpu.train.fused_update import FusedSGDM as JaxFusedSGDM
from iv2019_tpu.train.optimizer import make_learning_rate_fn as jax_lr_fn
from iv2019_tpu_torch.ops.fused_update import fused_update, fused_update_plain
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.optimizer import make_learning_rate_fn
from iv2019_tpu_torch.utils.convert import (
    JAX_UPDATE_TILE,
    flax_from_state_dict,
    opt_state_from_jax,
    opt_state_to_jax,
)
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

KW = dict(momentum=0.9, weight_decay=0.00017)


def _vectors(n, seed=0):
    rng = np.random.RandomState(seed)
    vecs = [(rng.randn(n) * s).astype(np.float32) for s in (0.05, 0.01, 0.01, 0.05)]
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    return vecs + [mask]


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    assert float(np.abs(np.asarray(got) - want).max()) <= rtol * float(np.abs(want).max())


@pytest.mark.parametrize("nesterov", [False, True])
def test_plain_update_matches_pallas_interpret(nesterov):
    threads()
    n = 2 * TILE
    w, g, m, s, mask = _vectors(n)
    lr, decay = np.float32(0.01), np.float32(0.3)
    want = fused_update_pallas(*(jnp.asarray(v) for v in (w, g, m, s, mask)), jnp.asarray(lr),
                               jnp.asarray(decay), nesterov=nesterov, interpret=True, **KW)
    got = fused_update(*(torch.from_numpy(v) for v in (w, g, m, s, mask)), torch.tensor(lr),
                       torch.tensor(decay), nesterov=nesterov, **KW)
    for a, b in zip(got[:3], want[:3]):
        _close(a.numpy(), b)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)


def test_plain_update_in_place_and_unpadded():
    """``out`` may be the inputs; an unpadded length equals the padded
    Pallas result's prefix."""
    n = 100_003
    w, g, m, s, mask = _vectors(n, seed=1)
    pad = TILE - n % TILE
    want = fused_update_pallas(*(jnp.asarray(np.pad(v, (0, pad))) for v in (w, g, m, s, mask)),
                               jnp.asarray(np.float32(0.01)), jnp.asarray(np.float32(0.9)),
                               interpret=True, **KW)
    tw, tm, ts = (torch.from_numpy(v.copy()) for v in (w, m, s))
    got = fused_update_plain(tw, torch.from_numpy(g), tm, ts, torch.from_numpy(mask),
                             torch.tensor(0.01), torch.tensor(0.9), out=(tw, tm, ts), **KW)
    assert got[0] is tw and got[1] is tm and got[2] is ts
    for a, b in zip((tw, tm, ts), want[:3]):
        _close(a.numpy(), np.asarray(b)[:n])
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)


def test_fused_sgdm_matches_jax_over_three_steps():
    """The same gradients on both sides, three steps of the schedule."""
    threads()
    jax_settings, settings = torch_tiny_settings()
    variables = jax.tree_util.tree_map(np.asarray, tiny_model(jax_settings).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32)))
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    jstate, jparams = jopt.init(), variables["params"]
    model = torch_tiny_model(settings, variables)
    opt = FusedSGDM(settings, model)
    state = opt.init()
    rng = np.random.RandomState(2)
    for t in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), jparams)
        jparams, jstate, jreg = jopt.update(grads, jstate, jparams, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            for (name, p), (_, g) in zip(model.named_parameters(),
                                         _state_items(model, grads)):
                p.grad.copy_(g)
        state, reg = opt.update(state, torch.tensor(t))
        np.testing.assert_allclose(float(reg), float(jreg), rtol=1e-6)
    got_params, _ = flax_from_state_dict(model.state_dict())
    _tree_close(got_params, numpy_tree(jparams))
    got = opt_state_to_jax(state, opt.layout)
    for key in ("momentum", "ema_biased"):
        _close(got[key], getattr(jstate, key))
    prod = (1 / 10) * (2 / 11) * (3 / 12)
    assert float(state.ema_decay_product) == pytest.approx(prod, rel=1e-6)
    ema, _ = flax_from_state_dict(opt.ema_params(state))
    _tree_close(ema, numpy_tree(jopt.ema_params(jstate, jparams)))
    # before any update the EMA parameters fall back to the raw parameters
    fresh = opt.ema_params(opt.init())
    for name, p in model.named_parameters():
        torch.testing.assert_close(fresh[name], p.detach(), rtol=0, atol=0)


def _state_items(model, flax_grads):
    """flax gradients in the port's parameter order and layout."""
    from iv2019_tpu_torch.utils.convert import state_dict_from_flax

    sd = state_dict_from_flax(flax_grads, {})
    return [(name, sd[name]) for name, _ in model.named_parameters()]


def _tree_close(got, want):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path in flat_got:
        _close(flat_got[path], flat_want[path])


def test_weight_decay_mask_covers_conv_kernels_only():
    _, settings = torch_tiny_settings()
    jax_settings, _ = torch_tiny_settings()
    variables = jax.tree_util.tree_map(np.asarray, tiny_model(jax_settings).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32)))
    opt = FusedSGDM(settings, torch_tiny_model(settings, variables))
    for name, shape, stride, offset in opt.layout:
        size = int(np.prod(shape))
        assert offset % 128 == 0  # 512-byte aligned views
        want = 1.0 if name.endswith(".conv.weight") else 0.0
        assert set(opt.wd_mask[offset:offset + size].tolist()) == {want}, name
    assert float(opt.wd_mask.sum()) == sum(
        int(np.prod(s)) for n, s, _, _ in opt.layout if n.endswith(".weight"))


@pytest.mark.parametrize("schedule", ["piecewise_constant", "polynomial_decay"])
def test_learning_rate_schedule_matches_jax(schedule):
    jax_settings, settings = torch_tiny_settings(learning_rate_schedule=schedule)
    want_fn, got_fn = jax_lr_fn(jax_settings), make_learning_rate_fn(settings)
    steps = [0, 1, 7, 8, 9, 15, 16, 17, 23, 24, 25, 100]
    for step in steps:
        want = np.float32(want_fn(jnp.asarray(step, jnp.int32)))
        got = got_fn(torch.tensor(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.float32(got) == want, (schedule, step)
    if schedule == "piecewise_constant":
        # value i holds while boundaries[i-1] < step <= boundaries[i]
        assert settings.learning_rate_boundaries_steps == (8, 16)
        assert [float(got_fn(torch.tensor(s))) for s in (8, 9, 16, 17)] == pytest.approx(
            [0.01, 0.005, 0.005, 0.0025])


def test_opt_state_converter_round_trips():
    """JAX -> port -> JAX returns the same arrays, tile padding included,
    and port -> JAX -> port the same vectors."""
    jax_settings, settings = torch_tiny_settings()
    variables = jax.tree_util.tree_map(np.asarray, tiny_model(jax_settings).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32)))
    jopt = JaxFusedSGDM(jax_settings, variables["params"], use_pallas=False)
    opt = FusedSGDM(settings, torch_tiny_model(settings, variables))
    rng = np.random.RandomState(3)
    n = jopt.num_params
    assert n == opt.num_params and jopt.n_flat % JAX_UPDATE_TILE == 0
    vecs = {k: np.pad(rng.randn(n).astype(np.float32), (0, jopt.n_flat - n))
            for k in ("momentum", "ema_biased")}
    jstate = JaxOptState(momentum=jnp.asarray(vecs["momentum"]),
                         ema_biased=jnp.asarray(vecs["ema_biased"]),
                         ema_decay_product=jnp.asarray(0.25, jnp.float32))
    port = opt_state_from_jax({k: np.asarray(getattr(jstate, k)) for k in (
        "momentum", "ema_biased", "ema_decay_product")}, opt.layout)
    back = opt_state_to_jax(port, opt.layout)
    for k, v in vecs.items():
        np.testing.assert_array_equal(back[k], v)
    assert float(back["ema_decay_product"]) == 0.25
    again = opt_state_from_jax(back, opt.layout)
    torch.testing.assert_close(again.momentum, port.momentum, rtol=0, atol=0)
    # the port's vectors hold each parameter in its own layout: the momentum
    # of a conv kernel is its HWIO JAX slice as OIHW
    flat = jax.flatten_util.ravel_pytree(jax.tree_util.tree_map(
        lambda p: np.zeros(p.shape, np.float32), variables["params"]))[1](
        jnp.asarray(vecs["momentum"][:n]))
    name, shape, stride, offset = next(e for e in opt.layout if e[0].endswith(".weight"))
    view = torch.as_strided(port.momentum, shape, stride, offset)
    node = flat
    for part in name.split(".")[:-1]:
        node = node[part]
    np.testing.assert_array_equal(view.numpy(), np.asarray(node["kernel"]).transpose(3, 2, 0, 1))

"""Train-mode BatchNorm and the train-mode model of the port against flax.

- ``Norm`` in train mode against iv2019_tpu.models.layers.Norm
  (flax nn.BatchNorm, momentum 0.9, eps 1e-5): the output, the running mean
  and variance after one update (biased variance), and the gradients with
  respect to x, scale and bias. f32; rtol 1e-5, with an absolute floor of
  1e-6 of the largest value for elements near zero (the gradient through
  the batch statistics is a difference of sums over the batch; flax takes
  the variance as E[x^2] - E[x]^2, torch in two passes).
- The tiny model in train mode with ``upsampling_method="no"``: the
  stride-8 f32 logits and the updated running statistics against the flax
  model applied with ``mutable=["batch_stats"]``; logits within 1e-4 of
  their largest value (f32, ~12 layers of convolutions in another
  summation order), statistics 1e-4 relative to their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from iv2019_tpu.models.layers import Norm as JaxNorm
from iv2019_tpu_torch.models.layers import Norm
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from torch_parity import numpy_tree, threads, torch_tiny_model, torch_tiny_settings

RTOL = 1e-5
FLOOR = 1e-6


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=FLOOR * float(np.abs(want).max()), err_msg=err_msg)


@pytest.mark.parametrize("shape,offset", [((4, 6, 10, 8), 0.0), ((2, 5, 3, 16), 3.0)])
def test_train_norm_matches_flax(shape, offset):
    threads()
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (offset + 2 * rng.randn(*shape)).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    jnorm = JaxNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"BatchNorm": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    stats = {"BatchNorm": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(x, params):
        y, mutated = jnorm.apply({"params": params, "batch_stats": stats}, x,
                                 mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mutated["batch_stats"])

    (_, (y_want, stats_want)), (dx_want, dparams_want) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)

    norm = Norm(c).train()
    with torch.no_grad():
        for name, value in (("scale", scale), ("bias", bias), ("mean", mean0), ("var", var0)):
            getattr(norm, name).copy_(torch.from_numpy(value))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = norm(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

    _close(y.detach().permute(0, 2, 3, 1), y_want, "y")
    _close(norm.mean, stats_want["BatchNorm"]["mean"], "running mean")
    _close(norm.var, stats_want["BatchNorm"]["var"], "running var")
    _close(xt.grad.permute(0, 2, 3, 1), dx_want, "dx")
    _close(norm.scale.grad, dparams_want["BatchNorm"]["scale"], "dscale")
    _close(norm.bias.grad, dparams_want["BatchNorm"]["bias"], "dbias")


def test_eval_mode_norm_uses_running_statistics():
    """``.eval()`` switches the same module back to the running statistics."""
    norm = Norm(3).eval()
    with torch.no_grad():
        norm.mean.copy_(torch.tensor([1.0, 2.0, 3.0]))
        norm.var.copy_(torch.tensor([4.0, 4.0, 4.0]))
    x = torch.full((1, 3, 2, 2), 3.0)
    y = norm(x)
    want = (3.0 - torch.tensor([1.0, 2.0, 3.0])) / torch.sqrt(torch.tensor(4.0 + 1e-5))
    torch.testing.assert_close(y[0, :, 0, 0], want)
    assert float(norm.mean[0]) == 1.0  # no update in eval mode


def test_train_model_stride8_logits_match_flax():
    threads()
    jax_settings, settings = torch_tiny_settings(upsampling_method="no")
    jmodel = tiny_model(jax_settings, train=True)
    images = np.random.RandomState(1).uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(3), images[:1]))
    want, mutated = jmodel.apply(variables, jnp.asarray(images), mutable=["batch_stats"])
    model = torch_tiny_model(settings, variables)
    assert model.training
    got = model(torch.from_numpy(images))
    for k in ("l1_logits", "l2_vehicle_logits", "l2_human_logits"):
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (3, 4, 8, g.shape[-1]) and g.dtype == np.float32
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max()), k
    _, batch_stats = flax_from_state_dict(model.state_dict())
    flat_got = jax.tree_util.tree_flatten_with_path(batch_stats)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(numpy_tree(mutated["batch_stats"]))[0])
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max()), path


def test_build_model_train_mode_and_no_fused_blocks():
    """mode=train builds the model in train mode, and a unit never takes the
    fused (eval-only) route while training."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model

    settings = Settings(device="cpu", mode="train", fused_block=True,
                        height_feature_extractor=64, width_feature_extractor=64)
    model = build_model(settings)
    assert model.training
    units = model.get_submodule("feature_extractor/base").units()
    assert all(unit.fused_kernel(1, 64, 128) is None for unit in units)
    assert not build_model(settings.replace(batch_norm_accumulate_statistics=False)).training
    assert not build_model(settings.replace(mode="predict")).training

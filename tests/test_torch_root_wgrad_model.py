"""The root-conv flag ``root_wgrad_pallas`` in the port's model (kernel B6's
plain version on the CPU) against the JAX package's flag.

The tiny bf16 ResNet (``blocks=((1, 32, 8),)``, 2x32x64, eval-mode
BatchNorm, loss sum(out^2)), as tests/test_pallas_wgrad.py builds it:

- the port with the flag against JAX with it: every gradient within 2e-2
  (the JAX test's own tolerance for its flag) of its leaf's largest
  |value|. Both compute in bf16 but round the activations at different
  places, so single elements of a leaf whose values cancel (a BatchNorm
  scale's gradient, a sum over all pixels) differ by more than 2e-2 of
  themselves (one by 2.2% at this seed) while every leaf agrees within
  4.7e-3 of its largest value (root dW 4.5e-3);
- the flag on against off in the port: the same state-dict keys, dW within
  2e-2 of its largest |value| (one bf16 rounding of the result), and B6's
  dW rounded to bf16 as JAX's ``dw.astype(k.dtype)``;
- in f32, where the flag takes the library's exact wgrad: on against off
  within 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.models.resnet import ResNetV1 as JaxResNetV1
from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.models.resnet import ResNetV1
from iv2019_tpu_torch.utils.convert import state_dict_from_flax
from torch_parity import threads

TINY_BLOCKS = ((1, 32, 8),)
MODEL_TOL = 2e-2
F32_TOL = 5e-5


def _jax_grads(flag, dtype, x):
    model = JaxResNetV1(blocks=TINY_BLOCKS, output_stride=8, use_running_average=True,
                        root_wgrad_pallas=flag, dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), x)

    def loss(v):
        out, _ = model.apply(v, x)  # (last block's map, end points)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    grads = jax.grad(loss)(variables)
    return variables, jax.tree_util.tree_map(np.asarray, grads["params"])


def _port_grads(variables, flag, dtype, x):
    model = ResNetV1(blocks=TINY_BLOCKS, output_stride=8, dtype=dtype, root_wgrad_pallas=flag)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    model.load_state_dict(state_dict_from_flax(params, stats))
    model = model.to(memory_format=torch.channels_last).eval()
    out = model(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    torch.sum(out.float() ** 2).backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)


def test_bf16_model_grads_match_jax_with_the_flag(images):
    threads()
    variables, jgrads = _jax_grads(True, jnp.bfloat16, jnp.asarray(images))
    want = state_dict_from_flax(jgrads, {})
    got = _port_grads(variables, True, torch.bfloat16, images)
    assert got.keys() == want.keys()
    worst = {}
    for key, g in got.items():
        w = want[key].numpy()
        worst[key] = float(np.abs(g - w).max()) / float(np.abs(w).max())
    assert max(worst.values()) <= MODEL_TOL, worst


def test_flag_on_matches_flag_off_in_the_port(images):
    threads()
    variables, _ = _jax_grads(False, jnp.bfloat16, jnp.asarray(images))
    on = _port_grads(variables, True, torch.bfloat16, images)
    off = _port_grads(variables, False, torch.bfloat16, images)
    assert on.keys() == off.keys()
    dw_on, dw_off = on["conv1.conv.weight"], off["conv1.conv.weight"]
    assert float(np.abs(dw_on - dw_off).max()) <= MODEL_TOL * float(np.abs(dw_off).max())
    # B6's dW is rounded to bf16, as the JAX custom VJP returns it
    assert np.array_equal(dw_on, torch.from_numpy(dw_on).bfloat16().float().numpy())


def test_f32_flag_takes_the_exact_library_wgrad(images):
    threads()
    variables, _ = _jax_grads(False, jnp.float32, jnp.asarray(images))
    on = _port_grads(variables, True, torch.float32, images)
    off = _port_grads(variables, False, torch.float32, images)
    for key in on:
        np.testing.assert_allclose(on[key], off[key], rtol=F32_TOL, atol=F32_TOL, err_msg=key)


def test_build_model_passes_the_flag():
    for flag in (False, True):
        model = build_model(Settings(device="cpu", mode="train", root_wgrad_pallas=flag))
        assert model.get_submodule("feature_extractor/base").conv1.wgrad_kernel is flag


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gives_the_library_dx_when_asked(dtype):
    """dx is computed only where autograd asks for it, by the library."""
    from iv2019_tpu_torch.models.layers import conv_same
    from iv2019_tpu_torch.models.resnet import _RootConvWgrad

    threads()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, 32, generator=gen).to(dtype).requires_grad_()
    w = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(dtype).requires_grad_()
    g = torch.randn(2, 64, 8, 16, generator=gen).to(dtype)
    dx, dw = torch.autograd.grad(_RootConvWgrad.apply(x, w, 2), (x, w), g)
    want_dx, want_dw = torch.autograd.grad(conv_same(x, w, stride=2), (x, w), g)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    tol = (F32_TOL if dtype == torch.float32 else MODEL_TOL) * float(want_dw.float().abs().max())
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=0, atol=tol)

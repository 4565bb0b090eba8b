"""Port model (iv2019_tpu_torch/models) against the JAX model, same weights.

Algorithm check, f32 and unfused on both sides: all ten prediction keys.
Probabilities within 1e-4 absolute, logits within 1e-3 absolute (f32
convolutions summed in another order through ~20 layers), decisions equal
on at least 99.9% of pixels (a near-tie may flip).

bf16 check, fused_block=True on both sides (the Pallas kernels in interpret
mode against the port's plain version): the two packages round bf16 at
different places, so each is measured against an f32 truth, as
tests/test_pallas_block.py::test_resnet_fused_flag_matches_unfused does.
The JAX side runs op by op for it (~10 s), so it is marked slow; the port's
fused path is also held to its own unfused bf16 path against the same
truth, which is fast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    jax_small_model,
    small_images,
    small_variables,
    threads,
    to_numpy,
    torch_small_model,
)

KEYS = ("l1_logits", "l1_probabilities", "l1_decisions",
        "l2_vehicle_logits", "l2_vehicle_probabilities", "l2_vehicle_decisions",
        "l2_human_logits", "l2_human_probabilities", "l2_human_decisions", "decisions")


@pytest.fixture(scope="module")
def f32_outputs():
    threads()
    variables = small_variables()
    images = small_images()
    want = jax.jit(jax_small_model().apply)(variables, jnp.asarray(images))
    with torch.inference_mode():
        got = torch_small_model(variables)(torch.from_numpy(images))
    return {k: to_numpy(got[k]) for k in KEYS}, {k: np.asarray(want[k]) for k in KEYS}


@pytest.mark.parametrize("key", KEYS)
def test_f32_algorithm_matches_jax(f32_outputs, key):
    got, want = f32_outputs[0][key], f32_outputs[1][key]
    assert got.shape == want.shape
    if key.endswith("decisions"):
        assert got.dtype == np.int32
        assert (got == want).mean() >= 0.999
    elif key.endswith("probabilities"):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


@pytest.mark.slow
def test_bf16_fused_matches_jax_fused():
    threads()
    variables = small_variables(seed=1)
    images = small_images(seed=1)
    x = jnp.asarray(images)
    truth = np.asarray(jax.jit(jax_small_model().apply)(variables, x)["l1_logits"])
    jax_fused = np.asarray(
        jax_small_model(jnp.bfloat16, fused_block=True).apply(variables, x)["l1_logits"])

    port = torch_small_model(variables, torch.bfloat16, fused_block=True)
    fused_units = [u for u in port.get_submodule("feature_extractor/base").units()
                   if u.fused_kernel(1, 16, 16) is not None]
    assert len(fused_units) == 3  # block2/unit_2, block3/unit_1, block3/unit_2
    with torch.inference_mode():
        port_fused = to_numpy(port(torch.from_numpy(images))["l1_logits"])

    ej, ep = _rel(jax_fused, truth), _rel(port_fused, truth)
    print(f"mean rel err vs f32: jax {ej.mean():.4g} port {ep.mean():.4g}; "
          f"max: jax {ej.max():.4g} port {ep.max():.4g}; "
          f"port vs jax mean {_rel(port_fused, jax_fused).mean():.4g}")
    assert ep.mean() < 1.3 * ej.mean() + 1e-5, (ep.mean(), ej.mean())
    assert np.quantile(ep, 0.99) < 1.3 * np.quantile(ej, 0.99) + 1e-4
    assert ep.max() < 2 * ej.max() + 1e-3, (ep.max(), ej.max())
    # and the two bf16 fused paths agree in aggregate: each is ej from the
    # truth, so they are at most about 2 ej apart
    assert _rel(port_fused, jax_fused).mean() < 2 * ej.mean() + 1e-4


def test_bf16_fused_as_close_to_f32_as_unfused():
    """The port's fused bf16 path is as close to the f32 model as its
    unfused bf16 path, on the same weights (the criterion chip_smoke.py
    applies on the card). Measured ratios of fused to unfused error on
    three seeds: mean 0.99-1.01, q99 0.96-1.01, max 0.87-0.92; the bounds
    leave room for other seeds."""
    threads()
    variables = small_variables()
    images = torch.from_numpy(small_images())
    logits = {}
    for key, dtype, fused in (("truth", torch.float32, False),
                              ("unfused", torch.bfloat16, False),
                              ("fused", torch.bfloat16, True)):
        model = torch_small_model(variables, dtype, fused_block=fused)
        with torch.inference_mode():
            logits[key] = to_numpy(model(images)["l1_logits"])
    units = model.get_submodule("feature_extractor/base").units()
    assert sum(u.fused_kernel(1, 16, 16) is not None for u in units) == 3
    eu, ef = _rel(logits["unfused"], logits["truth"]), _rel(logits["fused"], logits["truth"])
    assert ef.mean() < 1.1 * eu.mean(), (ef.mean(), eu.mean())
    assert np.quantile(ef, 0.99) < 1.1 * np.quantile(eu, 0.99)
    assert ef.max() < 1.5 * eu.max(), (ef.max(), eu.max())


def test_fused_unit_receives_channels_last_without_copy():
    """The trunk hands each fused unit an NCHW channels_last tensor, whose
    NHWC view is contiguous (no copy before the kernel)."""
    threads()
    port = torch_small_model(small_variables(), torch.bfloat16, fused_block=True)
    seen = []
    for unit in port.get_submodule("feature_extractor/base").units():
        unit.register_forward_pre_hook(
            lambda m, args: seen.append(args[0].permute(0, 2, 3, 1).is_contiguous()))
    with torch.inference_mode():
        port(torch.from_numpy(small_images()))
    assert seen and all(seen)


@pytest.mark.parametrize("mode", ["predict", "train"])
def test_entry_points_refuse_missing_cuda(mode):
    """No silent CPU fallback: asking for cuda without a card raises."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(Settings(mode=mode))

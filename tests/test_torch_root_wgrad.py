"""The port's root-conv weight gradient (B6) against the JAX package's.

- The plain version (``root_conv_wgrad_reference``, what the wrapper runs
  for CPU tensors) against the Pallas kernel in interpret mode, at the
  shapes of tests/test_pallas_wgrad.py, with k=5, and with f32 inputs that
  both round to bf16: rtol/atol 1e-4 (the same bf16 operands, f32 sums in
  another order).
- The gate: the JAX cases, and shapes the port takes that only Mosaic's
  tiling refuses.

The flag in the model is tests/test_torch_root_wgrad_model.py (the two
files stay under a minute each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.ops.pallas_wgrad import root_conv_wgrad as jax_root_conv_wgrad
from iv2019_tpu.ops.pallas_wgrad import wgrad_supported as jax_wgrad_supported
from iv2019_tpu_torch.ops.root_wgrad import (
    root_conv_wgrad,
    root_conv_wgrad_reference,
    wgrad_supported,
)
from torch_parity import threads

WGRAD_TOL = 1e-4


def _case(n, h, w, c, cout, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, h, w, c)).astype(dtype)
    dy = rng.uniform(-1, 1, (n, h // 2, w // 2, cout)).astype(dtype)
    return x, dy


def _port_wgrad(x, dy, k=7):
    """NHWC numpy in, HWIO numpy out, through the port's NCHW/OIHW wrapper."""
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    dyt = torch.tensor(dy).permute(0, 3, 1, 2)
    return root_conv_wgrad(xt, dyt, k, 2).permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("n,h,w,c,cout,ot,k", [
    (1, 16, 16, 3, 8, 8, 7),
    (2, 32, 64, 3, 16, 16, 7),
    (2, 32, 64, 3, 16, 8, 7),   # several output-row tiles on the JAX side
    (1, 16, 32, 1, 8, 8, 7),    # one channel
    (1, 24, 40, 3, 8, 4, 7),    # OH=12: the 4-row tile
    (1, 24, 24, 2, 8, 12, 5),   # k=5
])
def test_plain_matches_jax_kernel(n, h, w, c, cout, ot, k):
    threads()
    x, dy = _case(n, h, w, c, cout)
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    want = np.asarray(jax_root_conv_wgrad(xb, dyb, kernel_size=k, ot=ot, interpret=True))
    got = _port_wgrad(np.asarray(xb.astype(jnp.float32)), np.asarray(dyb.astype(jnp.float32)), k)
    assert got.shape == (k, k, c, cout) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=WGRAD_TOL, atol=WGRAD_TOL)


def test_f32_inputs_are_rounded_to_bf16():
    """Both round f32 operands to bf16 before the products."""
    threads()
    x, dy = _case(2, 32, 32, 3, 16, seed=1)
    want = np.asarray(jax_root_conv_wgrad(jnp.asarray(x), jnp.asarray(dy), ot=16,
                                          interpret=True))
    got = _port_wgrad(x, dy)
    np.testing.assert_allclose(got, want, rtol=WGRAD_TOL, atol=WGRAD_TOL)
    # and not the f32 product: the rounding is visible at this size
    exact = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).permute(0, 3, 1, 2), (16, 3, 7, 7),
        torch.from_numpy(dy).permute(0, 3, 1, 2), stride=2, padding=3).permute(2, 3, 1, 0)
    assert float(np.abs(got - exact.numpy()).max()) > 10 * WGRAD_TOL


@pytest.mark.parametrize("x_shape,dy_shape,k,stride,port,jax_gate", [
    ((16, 512, 1024, 3), (16, 256, 512, 64), 7, 2, True, True),   # the flagship step
    ((16, 512, 1024, 3), (16, 256, 512, 64), 7, 1, False, False),  # stride 1
    ((16, 512, 1024, 3), (16, 256, 512, 64), 6, 2, False, False),  # even kernel
    ((16, 511, 1024, 3), (16, 256, 512, 64), 7, 2, False, False),  # odd height
    ((16, 512, 1023, 3), (16, 256, 512, 64), 7, 2, False, False),  # odd width
    ((16, 512, 1024, 3), (16, 255, 512, 64), 7, 2, False, False),  # dy not at half
    ((1, 14, 256, 3), (1, 7, 128, 3), 7, 2, True, False),  # no 4/8/16-row tile: Mosaic only
    ((2, 36, 70, 3), (2, 18, 35, 64), 7, 2, True, False),  # ragged 35-pixel rows
])
def test_gate(x_shape, dy_shape, k, stride, port, jax_gate):
    """The port's gate takes NCHW shapes; JAX's NHWC."""
    def nchw(s):
        return (s[0], s[3], s[1], s[2])

    assert wgrad_supported(nchw(x_shape), nchw(dy_shape), k, stride) is port
    assert bool(jax_wgrad_supported(x_shape, dy_shape, k, stride)) is jax_gate


def test_wrapper_refuses_mismatched_dy_on_cpu():
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError):
        root_conv_wgrad_reference(x, torch.zeros(1, 8, 7, 8))

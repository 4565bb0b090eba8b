"""Port resize (iv2019_tpu_torch/ops/resize.py) against the JAX package's.

Index tables must be identical (TF1 float32 coordinates, integer-boundary
cases included); values agree to 1e-6 (f32 lerps in the same order; the
matmul form sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.ops import resize as jr
from iv2019_tpu_torch.ops import resize as tr
from torch_parity import threads

# (in, out) pairs: up/down/odd sizes, the x8 logit upsample, the predict
# output resize, and exact integer boundaries (31 -> 23 aligned hits
# 11 * 30/22 = 15 exactly; float64 would round it below)
AXIS_CASES = [(4, 8), (8, 4), (5, 7), (7, 5), (1, 3), (31, 23), (23, 31), (16, 128),
              (64, 512), (128, 1024), (512, 1024), (30, 22), (600, 512), (1024, 2048)]


@pytest.fixture(autouse=True)
def _threads():
    threads()


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("in_size,out_size", AXIS_CASES)
def test_tables_identical(in_size, out_size, align):
    for got, want in zip(tr._bilinear_tables(in_size, out_size, align),
                         jr._bilinear_tables(in_size, out_size, align)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr._nearest_table(in_size, out_size, align),
                                  jr._nearest_table(in_size, out_size, align))
    np.testing.assert_array_equal(tr._bilinear_matrix(in_size, out_size, align),
                                  jr._bilinear_matrix(in_size, out_size, align))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 8), (32, 64)), ((7, 13), (5, 9)),
                                          ((31, 30), (23, 22)), ((16, 16), (16, 16))])
def test_bilinear_tensor_and_numpy(in_hw, out_hw, align):
    img = np.random.RandomState(0).normal(0, 1, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jr.resize_bilinear(jnp.asarray(img), out_hw, align_corners=align))
    got = tr.resize_bilinear(torch.from_numpy(img), out_hw, align_corners=align)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # numpy in, numpy out (the host pipeline), HWC as well as NHWC
    want_np = jr.resize_bilinear(img[0], out_hw, align_corners=align)
    got_np = tr.resize_bilinear(img[0], out_hw, align_corners=align)
    assert isinstance(got_np, np.ndarray) and got_np.shape == want_np.shape
    np.testing.assert_allclose(got_np, want_np, atol=1e-6, rtol=0)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 8), (32, 64)), ((7, 13), (5, 9)),
                                          ((16, 16), (128, 128))])
def test_bilinear_mxu(in_hw, out_hw, align):
    img = np.random.RandomState(1).normal(0, 1, (2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(jr.resize_bilinear_mxu(jnp.asarray(img), out_hw, align_corners=align))
    got = tr.resize_bilinear_mxu(torch.from_numpy(img), out_hw, align_corners=align)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape,out_hw", [((2, 31, 30), (23, 22)), ((1, 16, 16, 15), (128, 96)),
                                          ((9, 11), (4, 20)), ((2, 8, 8), (8, 8))])
def test_nearest(shape, out_hw, align):
    lab = np.random.RandomState(2).randint(0, 20, shape).astype(np.int32)
    want = np.asarray(jr.resize_nearest(jnp.asarray(lab), out_hw, align_corners=align))
    got = tr.resize_nearest(torch.from_numpy(lab), out_hw, align_corners=align)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tr.resize_nearest(lab, out_hw, align_corners=align), want)

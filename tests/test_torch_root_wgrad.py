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
from iv2019_tpu_torch.ops import root_wgrad as trw
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


# ---------------------------------------------------------------- the launch plan

MAX_SMEM = 232_448
SMS = 132
# (x NCHW shape, Cout, k): the flagship step; the ragged shape of the general
# kernel; OW not a multiple of 128; one chunk only; four channels; k = 5; a
# row narrower than one chunk on the root kernel; a batch whose chunks
# outnumber the blocks unevenly
PLAN_SHAPES = [
    ((16, 3, 512, 1024), 64, 7),
    ((2, 3, 36, 70), 64, 7),
    ((2, 3, 20, 400), 64, 7),
    ((1, 3, 2, 256), 64, 7),
    ((1, 4, 16, 32), 64, 7),
    ((1, 2, 24, 40), 8, 5),
    ((2, 3, 36, 72), 64, 7),
    ((3, 3, 94, 520), 64, 7),
    ((1, 3, 16, 256), 32, 7),
]


@pytest.mark.parametrize("x_shape,cout,k", PLAN_SHAPES)
def test_plan_covers_every_output_pixel_once(x_shape, cout, k):
    n, c, h, w = x_shape
    oh, ow = h // 2, w // 2
    plan = trw._plan(x_shape, cout, k, SMS)
    assert plan.root is (k == 7 and c == 3 and cout == 64 and w % 8 == 0)
    assert plan.pixels == (128 if plan.root else 64)
    seen = np.zeros((n, oh, ow), int)
    for q in range(plan.chunks):
        img, r, ow0 = plan.chunk(q, oh)
        assert 0 <= ow0 < ow
        seen[img, r, ow0:ow0 + plan.pixels] += 1  # the slice clips at the row's end
    assert (seen == 1).all()
    # every chunk belongs to one block's range, and no block is empty-handed by the rule
    assert 1 <= plan.blocks <= max(1, min(plan.chunks, (1 if plan.root else 2) * SMS))
    assert plan.blocks * plan.chunks_per_block >= plan.chunks
    assert (plan.blocks - 1) * plan.chunks_per_block < plan.chunks
    taps_pad, cout_pad = -(-k * k * c // 16) * 16, -(-cout // 16) * 16
    assert plan.partial_floats == plan.blocks * taps_pad * cout_pad
    if plan.root:  # the 64 x 160 partial of the root kernel is the same size
        assert taps_pad * cout_pad == 64 * trw._ROOT_COLUMNS
    assert plan.smem_bytes <= MAX_SMEM
    assert not trw._plan(x_shape, cout, k, SMS, aligned=False).root


@pytest.mark.parametrize("x_shape,cout,k", [s for s in PLAN_SHAPES
                                            if trw._plan(*s, SMS).root])
def test_root_plan_boxes(x_shape, cout, k):
    """The TMA boxes as the kernel asks for them: the dy box at the chunk's
    pixels, the x box starting on 16 bytes of device memory, three columns
    left of the first window's edge or more, and wide enough for the last
    pixel's taps."""
    n, c, h, w = x_shape
    oh = h // 2
    plan = trw._plan(x_shape, cout, k, SMS)
    for q in {0, 1, plan.chunks // 2, plan.chunks - 1}:
        img, r, ow0 = plan.chunk(q, oh)
        boxes = plan.boxes(q, oh)
        assert boxes["dy"] == (0, ow0, img * oh + r)
        c0, c1, c2 = boxes["x"]
        assert (c0 * 8) % 16 == 0 and (c1, c2) == (2 * r - 3, img)
        column, row = boxes["slab_origin"]
        assert c0 * 4 == column * 3 and row == 2 * r - 3  # 8-byte elements hold 4 values
        assert column <= 2 * ow0 - 3
        # pixel 0's first tap (kw = 0, c = 0) sits one value after its stray column
        assert (2 * ow0 - 3 - column) * 3 - 1 == trw._ROOT_SLAB_FIRST
        last = 6 * (plan.pixels - 1) + trw._ROOT_SLAB_FIRST + trw._ROOT_TAP_ROW
        assert last <= trw._ROOT_SLAB_VALUES and trw._ROOT_SLAB_VALUES * 2 % 16 == 0
        assert trw._ROOT_SLAB_VALUES // 4 <= 256  # a box holds at most 256 elements a side
        assert trw._ROOT_SLAB_FIRST % 2 == 0  # 4-byte copies: source and column both even
    assert 7 * trw._ROOT_TAP_ROW <= trw._ROOT_COLUMNS and trw._ROOT_COLUMNS % 8 == 0


def _emulate_root_kernel(x, dy, plan):
    """The root kernel's data path in numpy: per chunk the zero-padded slab
    (what the x box brings, zeros outside the image), the im2row tile by the
    kernel's index formula (column kh * 22 + e <- slab value 6 p + 14 + e of
    row kh), the product with the chunk's dy rows (zeros past the row's end),
    summed over the chunks; then the reduce kernel's column map."""
    n, h, w, _ = x.shape
    _, oh, ow, cout = dy.shape
    flat = x.reshape(n, h, w * 3)
    acc = np.zeros((cout, trw._ROOT_COLUMNS), np.float64)
    for q in range(plan.chunks):
        img, r, ow0 = plan.chunk(q, oh)
        column, row = plan.boxes(q, oh)["slab_origin"]
        slab = np.zeros((7, trw._ROOT_SLAB_VALUES), np.float32)
        for kh in range(7):
            if 0 <= row + kh < h:
                lo, hi = column * 3, column * 3 + trw._ROOT_SLAB_VALUES
                src_lo, src_hi = max(lo, 0), min(hi, w * 3)
                slab[kh, src_lo - lo:src_hi - lo] = flat[img, row + kh, src_lo:src_hi]
        tile = np.zeros((plan.pixels, trw._ROOT_COLUMNS), np.float32)
        for p in range(plan.pixels):
            for kh in range(7):
                first = 6 * p + trw._ROOT_SLAB_FIRST
                tile[p, kh * trw._ROOT_TAP_ROW:(kh + 1) * trw._ROOT_TAP_ROW] = slab[
                    kh, first:first + trw._ROOT_TAP_ROW]
        a = np.zeros((plan.pixels, cout), np.float32)
        valid = min(plan.pixels, ow - ow0)
        a[:valid] = dy[img, r, ow0:ow0 + valid]
        acc += a.T.astype(np.float64) @ tile
    dw = np.zeros((cout, 3, 7, 7), np.float32)
    for kh in range(7):
        for kw in range(7):
            for c in range(3):
                dw[:, c, kh, kw] = acc[:, kh * trw._ROOT_TAP_ROW + 1 + 3 * kw + c]
    return dw


@pytest.mark.parametrize("n,h,w", [(1, 4, 256), (2, 6, 72), (1, 4, 400)])
def test_root_tile_formula_matches_reference(n, h, w):
    """Slab with zero padding -> (pixels, columns) tile -> product with dy,
    against the plain version: 1e-5 of the largest |dW| (the same bf16
    operands; f64 sums here, f32 there)."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)).bfloat16().float()
    dy = torch.tensor(rng.uniform(-1, 1, (n, h // 2, w // 2, 64)).astype(np.float32))
    dy = dy.bfloat16().float()
    plan = trw._plan((n, 3, h, w), 64, 7, SMS)
    assert plan.root
    got = _emulate_root_kernel(x.numpy(), dy.numpy(), plan)
    want = root_conv_wgrad_reference(x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

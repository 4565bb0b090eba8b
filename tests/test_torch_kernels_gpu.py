"""The CUDA kernels against their plain versions on the card.

Imports no JAX, so it runs on the GPU machine, from the repo root:
``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``
(tests/conftest.py imports JAX). Skips where there is no card: a CUDA
kernel has no CPU mode. Tolerances as in chip_smoke.py (reasons there):
fused units max |got - want| / max(1, |want|) < 2e-2; fused loss sums 1e-4
relative, decisions >= 99.99% equal to the plain version's and 100% to
the 4-tap blend done as separate tensor multiplies and adds, gradients
1e-4 of the largest; update vectors 1e-6 of the largest, reg 1e-5
relative; root-conv wgrad within 1e-4 of the largest |dW| (the same bf16
products, f32 sums in another order). The fused-loss forward and backward
and the root-conv wgrad must also give the same bits on two launches.
"""

import numpy as np
import pytest
import torch

from iv2019_tpu_torch.ops import fused_block as tb
from iv2019_tpu_torch.ops import fused_loss as fl
from iv2019_tpu_torch.ops import fused_update as fu
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

SHAPES = [("fused_bottleneck", 512, 128, 1), ("fused_bottleneck", 1024, 256, 2),
          ("fused_bottleneck_ct", 2048, 512, 4), ("fused_bottleneck", 256, 128, 3),
          ("fused_bottleneck_ct", 256, 128, 1),
          # block4 on a small feature map: the rule picks the full-window kernel
          ("fused_bottleneck", 2048, 512, 4)]

# (wrapper, n, h, w, C, M, rate): batch 2 at the flagship map (the y1
# scratch and the conv2 TMA boxes must not cross images), a map smaller than
# one 8x8 tile (every tap's box lies partly outside the image), and rate 8
# at block4 widths
CASES = [("fused_bottleneck_ct", 2, 64, 128, 2048, 512, 4),
         ("fused_bottleneck", 1, 6, 10, 2048, 512, 4),
         ("fused_bottleneck_ct", 1, 16, 16, 2048, 512, 8)]


def _check_unit(wrapper, n, h, w, c, m, rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    u = chip_smoke.random_unit(rng, c, m, "cuda")
    x = torch.tensor(rng.normal(0, 1, (n, h, w, c)), dtype=torch.bfloat16, device="cuda")
    args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
    fn = getattr(tb, wrapper)
    before = fn.launches
    got = fn(*args, rate=rate).float()
    want = tb.bottleneck_plain(*args, rate=rate).float()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel < chip_smoke.KERNEL_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,c,m,rate", SHAPES)
@pytest.mark.parametrize("h,w", [(64, 128), (20, 36)])
def test_kernel_matches_plain_on_card(wrapper, c, m, rate, h, w):
    """Flagship units and ragged tiles (20x36 fills no 8x8 tile row)."""
    _check_unit(wrapper, 1, h, w, c, m, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,n,h,w,c,m,rate", CASES)
def test_kernel_matches_plain_on_card_edges(wrapper, n, h, w, c, m, rate):
    _check_unit(wrapper, n, h, w, c, m, rate)


# (dataset, n_pp, n_weak, stride-8 size, output size): the flagship step,
# a small one, no weak images, no per-pixel images, and a ragged Vistas
# shape whose rows and columns fill no block evenly
LOSS_SHAPES = [("cityscapes", 4, 12, (64, 128), (512, 1024)),
               ("cityscapes", 2, 2, (4, 8), (32, 64)),
               ("cityscapes", 2, 0, (4, 8), (32, 64)),
               ("cityscapes", 0, 3, (5, 9), (37, 67)),
               ("vistas", 1, 2, (9, 16), (36, 64)),
               # the backward's walk: out == in, one stride-8 row, a last chunk of one
               # column and a last band of one row, Vistas at a ragged mid size, a
               # factor of 32 (the plan halves the chunk)
               ("cityscapes", 2, 1, (6, 7), (6, 7)),
               ("cityscapes", 1, 2, (1, 9), (8, 72)),
               ("cityscapes", 1, 1, (9, 17), (70, 131)),
               ("vistas", 1, 1, (39, 54), (310, 427)),
               ("cityscapes", 1, 1, (4, 16), (128, 512)),
               # one stride-8 column that touches 700 pixels: several trips a row
               ("cityscapes", 1, 1, (1, 1), (8, 700))]


@pytest.mark.gpu
@pytest.mark.parametrize("dataset,n_pp,n_weak,in_hw,out_hw", LOSS_SHAPES)
def test_fused_loss_matches_plain_on_card(dataset, n_pp, n_weak, in_hw, out_hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    tax = get_taxonomy(dataset)
    args = chip_smoke.loss_inputs(np.random.RandomState(0), tax, n_pp, n_weak, in_hw, out_hw,
                                  "cuda")
    g3 = torch.tensor([0.5, 0.07, 0.11], device="cuda")
    before = (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches)
    check = chip_smoke.compare_loss(tax, args, out_hw, g3)
    assert (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert chip_smoke.loss_ok(check), check


@pytest.mark.gpu
@pytest.mark.parametrize("dataset,n_pp,n_weak,in_hw,out_hw", [LOSS_SHAPES[0], LOSS_SHAPES[3],
                                                             LOSS_SHAPES[8]])
def test_fused_loss_bwd_is_deterministic_on_card(dataset, n_pp, n_weak, in_hw, out_hw):
    """Two launches on the same inputs give the same bits: every logit is
    summed by one thread in a fixed order, without atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    tax = get_taxonomy(dataset)
    args = chip_smoke.loss_inputs(np.random.RandomState(1), tax, n_pp, n_weak, in_hw, out_hw,
                                  "cuda")
    g3 = torch.tensor([0.5, 0.07, 0.11], device="cuda")
    first = fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)
    second = fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dataset,n_pp,n_weak,in_hw,out_hw", [LOSS_SHAPES[0], LOSS_SHAPES[3],
                                                             LOSS_SHAPES[8]])
def test_fused_loss_fwd_is_deterministic_on_card(dataset, n_pp, n_weak, in_hw, out_hw):
    """Two launches give the same sums and maps: each block sums into its
    own slot in a fixed order and the slots are added in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    tax = get_taxonomy(dataset)
    args = chip_smoke.loss_inputs(np.random.RandomState(1), tax, n_pp, n_weak, in_hw, out_hw,
                                  "cuda")
    first = fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)
    second = fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dataset,n_pp,n_weak,in_hw,out_hw", [LOSS_SHAPES[1], LOSS_SHAPES[8]])
def test_fused_loss_takes_unaligned_labels_on_card(dataset, n_pp, n_weak, in_hw, out_hw, offset):
    """Label views that start 1-3 elements off 16 bytes are read right by
    both kernels (rows copied from the address rounded down, with a skew)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    tax = get_taxonomy(dataset)
    args = chip_smoke.loss_inputs(np.random.RandomState(1), tax, n_pp, n_weak, in_hw, out_hw,
                                  "cuda")
    shifted = chip_smoke.unaligned_labels(args, offset)
    assert all(t.data_ptr() % 16 == 4 * offset for t in shifted[3:] if t.numel())
    check = chip_smoke.compare_loss(tax, shifted, out_hw, torch.tensor([0.5, 0.07, 0.11],
                                                                        device="cuda"))
    assert chip_smoke.loss_ok(check), check


@pytest.mark.gpu
@pytest.mark.parametrize("k,img,value", [(0, 0, float("inf")), (1, 3, float("nan")),
                                         (0, 2, float("-inf"))])
def test_fused_loss_fwd_nonfinite_logits_on_card(k, img, value):
    """A non-finite logit makes exactly the sums non-finite that the plain
    version's are (the skipped weight-0 terms do not hide it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    tax = get_taxonomy("cityscapes")
    args = list(chip_smoke.loss_inputs(np.random.RandomState(1), tax, 2, 2, (4, 8), (32, 64),
                                       "cuda"))
    args[k] = args[k].clone()
    args[k][img, 1, 2, 3] = value
    sums, _, _ = fl.fused_loss_fwd(*args, tax=tax, out_hw=(32, 64))
    want, _, _ = fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=(32, 64))
    assert torch.equal(torch.isfinite(sums), torch.isfinite(want))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 1_000_003, 26_000_000])
@pytest.mark.parametrize("nesterov", [False, True])
def test_fused_update_matches_plain_on_card(n, nesterov):
    """Sizes with and without a ragged tail (n % 4), up to the model's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    args = chip_smoke.update_inputs(n, "cuda")
    before = fu.fused_update.launches
    check = chip_smoke.compare_update(args, nesterov)
    assert fu.fused_update.launches == before + 1
    assert chip_smoke.update_ok(check), check


@pytest.mark.gpu
def test_fused_update_in_place_on_card():
    """Outputs written over the inputs (the optimizer's flat buffers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    w, g, m, s, mask, lr, decay = chip_smoke.update_inputs(10_001, "cuda")
    kw = dict(momentum=0.9, weight_decay=0.00017)
    want = fu.fused_update_plain(w, g, m, s, mask, lr, decay, **kw)
    got = fu.fused_update(w, g, m, s, mask, lr, decay, out=(w, m, s), **kw)
    torch.cuda.synchronize()
    assert got[0] is w and got[1] is m and got[2] is s
    for a, b in zip((w, m, s), want[:3]):
        assert float((a - b).abs().max() / b.abs().max()) <= chip_smoke.UPDATE_REL_TOL


@pytest.mark.gpu
def test_train_norm_on_card_matches_cpu():
    """Train-mode BatchNorm through the card's kernels (cuDNN, channels_last)
    moves the running statistics as on the CPU: the batch mean and the
    *biased* variance (rtol 1e-5, f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iv2019_tpu_torch.models.layers import Norm

    x = torch.randn(4, 64, 33, 17, generator=torch.Generator().manual_seed(0)) * 2 + 1
    norms = {}
    for device in ("cpu", "cuda"):
        norm = Norm(64).to(device).train()
        norm(x.to(device).contiguous(memory_format=torch.channels_last))
        norms[device] = norm
    for name in ("mean", "var"):
        torch.testing.assert_close(getattr(norms["cuda"], name).cpu(), getattr(norms["cpu"], name),
                                   rtol=1e-5, atol=1e-6)
    want = 0.9 + 0.1 * x.permute(1, 0, 2, 3).reshape(64, -1).var(1, unbiased=False)
    torch.testing.assert_close(norms["cuda"].var.cpu(), want, rtol=1e-5, atol=1e-6)


# (x NCHW, Cout, k, dy channels_last). The root kernel (wgmma, TMA): a
# flagship-width batch of 4, 200-pixel rows that fill no 128-pixel chunk, rows
# narrower than one chunk (both TMA boxes reach past the tensors), two input
# rows only, more chunks than blocks by an uneven count. The general kernel:
# 35-pixel rows (W = 70 is no multiple of 8), the same with an NCHW
# contiguous dy (as autograd may hand it over), k = 5 with two channels and
# eight outputs (no 16-byte dy loads), and 32 outputs at the root's k and C
WGRAD_SHAPES = [((4, 3, 512, 1024), 64, 7, True), ((2, 3, 20, 400), 64, 7, False),
                ((2, 3, 36, 72), 64, 7, True), ((1, 3, 2, 256), 64, 7, True),
                ((3, 3, 94, 520), 64, 7, True),
                ((2, 3, 36, 70), 64, 7, True), ((2, 3, 36, 70), 64, 7, False),
                ((1, 2, 24, 40), 8, 5, False), ((1, 3, 16, 256), 32, 7, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,cout,k,channels_last", WGRAD_SHAPES)
def test_root_wgrad_matches_plain_on_card(x_shape, cout, k, channels_last):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    check = chip_smoke.compare_wgrad(x_shape, cout, k, channels_last)
    assert check["launches"] == 1
    assert check["rel_err"] <= chip_smoke.WGRAD_REL_TOL, check


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,cout,k,channels_last", [WGRAD_SHAPES[0], WGRAD_SHAPES[1],
                                                          WGRAD_SHAPES[5]])
def test_root_wgrad_is_deterministic_on_card(x_shape, cout, k, channels_last):
    """Two launches give the same bits on both kernels: the per-block
    partials are added in block order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke
    from iv2019_tpu_torch.ops.root_wgrad import root_conv_wgrad

    x, dy = chip_smoke.wgrad_inputs(x_shape, cout, k, channels_last, seed=1)
    first, second = root_conv_wgrad(x, dy, k, 2), root_conv_wgrad(x, dy, k, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)

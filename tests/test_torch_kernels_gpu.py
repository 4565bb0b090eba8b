"""The CUDA kernels against their plain versions on the card.

Imports no JAX, so it runs on the GPU machine, from the repo root:
``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``
(tests/conftest.py imports JAX). Skips where there is no card: a CUDA
kernel has no CPU mode. Tolerances as in chip_smoke.py (reasons there):
fused units max |got - want| / max(1, |want|) < 2e-2; fused loss sums 1e-4
relative, decisions >= 99.99% equal, gradients 1e-4 of the largest; update
vectors 1e-6 of the largest, reg 1e-5 relative; root-conv wgrad within
1e-5 of the largest |dW| (the same bf16 products, f32 sums in another
order).
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
               ("vistas", 1, 2, (9, 16), (36, 64))]


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


# (x NCHW, Cout, k, dy channels_last): a flagship-width batch of 4, a ragged
# shape whose 35-pixel rows fill no 64-pixel chunk, the same with an NCHW
# contiguous dy (as autograd may hand it over), and the generic kernel
# (k=5, two channels, eight outputs: no 16-byte dy loads)
WGRAD_SHAPES = [((4, 3, 512, 1024), 64, 7, True), ((2, 3, 36, 70), 64, 7, True),
                ((2, 3, 36, 70), 64, 7, False), ((1, 2, 24, 40), 8, 5, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,cout,k,channels_last", WGRAD_SHAPES)
def test_root_wgrad_matches_plain_on_card(x_shape, cout, k, channels_last):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    check = chip_smoke.compare_wgrad(x_shape, cout, k, channels_last)
    assert check["launches"] == 1
    assert check["rel_err"] <= chip_smoke.WGRAD_REL_TOL, check

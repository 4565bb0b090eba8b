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
and the root-conv wgrad must also give the same bits on two launches. The
fused units are also checked at the feature maps evaluation gives them, and
one evaluate on the card is held to the same evaluate on the CPU. The
fused loss is also checked at the Vistas heads (53 / 12 / 5) at full width
and on the logits of the fused adaptation heads in f32 compute. Spatial
partitioning: the fused units on the haloed bands of phase 12's eval, and
the root-conv wgrad with explicit pad rows. The fused units' registered
operators (csrc/torch_ops.cpp), which the wrappers call, are held to the
plain version and, bit for bit, to the ctypes route to the same kernels.
Train-mode BatchNorm (N1/N2, ``bn_impl="fused"``) at ragged channel counts,
unaligned pointers, block4's and the root's widths, in bf16 and f32, at
chip_smoke.py's bounds, on the one-launch path and the two-launch path of a
mesh (bit-equal to each other); two runs on two streams at once and a run
replayed from a CUDA graph give the bits of the runs alone. Eval-mode
BatchNorm (N3, ``fused_bn_eval``) against the plain chain it replaces at the
heads', PSP's and the trunk's widths and maps, with and without a residual
and a ReLU, on a misaligned slice, in f32 and on NCHW memory (copied, the
copy counted), in both forms (the eager operator, the exported program's
folded table): within one ulp of x's type and bit for bit on at least
99.9% of elements; its operators refuse what the kernel does not take and
count their launches; under autograd its gradients are the plain chain's;
a forward of either eval configuration launches it once a batch norm that
no fused unit folds, a train step never; the model exported on the card
holds one ``bn_eval.folded`` node a norm on folded constants alone, and
runs as the eager forward.
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


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,c,m,rate", SHAPES[:3])
def test_op_route_matches_plain_on_card(wrapper, c, m, rate):
    """The registered operator (csrc/torch_ops.cpp), the route of eager
    calls and of exported programs, against the plain version, bit for bit
    against the ctypes route to the same kernels; its C counter goes one up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import ctypes

    import chip_smoke

    lib = ctypes.CDLL(tb.ops_library())
    lib.iv_op_launches.restype = ctypes.c_int64
    assert lib.iv_op_has_cuda() == 1
    rng = np.random.RandomState(2)
    u = chip_smoke.random_unit(rng, c, m, "cuda")
    x = torch.tensor(rng.normal(0, 1, (1, 64, 128, c)), dtype=torch.bfloat16, device="cuda")
    args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
    which = tb.OP_NAMES.index(wrapper)
    before = lib.iv_op_launches(which)
    got = getattr(torch.ops.iv2019, wrapper)(*args, rate, tb.op_plan(x, u["w1"], rate))
    by_ctypes = tb._run(f"iv_{wrapper}", *args, rate)
    want = tb.bottleneck_plain(*args, rate=rate).float()
    torch.cuda.synchronize()
    assert lib.iv_op_launches(which) == before + 1
    assert torch.equal(got, by_ctypes)
    rel = ((got.float() - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel < chip_smoke.KERNEL_REL_TOL


@pytest.mark.gpu
def test_op_route_refuses_what_the_kernels_do_not_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    u = chip_smoke.random_unit(np.random.RandomState(3), 256, 128, "cuda")
    x = torch.zeros(1, 16, 16, 256, dtype=torch.float32, device="cuda")
    args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
    tb.ops_library()
    with pytest.raises(RuntimeError, match="x must be"):
        torch.ops.iv2019.fused_bottleneck(*args, 1, [64, 6, 128, 6, 0, 0])
    with pytest.raises(RuntimeError, match="launch plan"):
        torch.ops.iv2019.fused_bottleneck(x.bfloat16(), *args[1:], 1, [64, 6, 128, 6, 0, 0])


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
               ("cityscapes", 1, 1, (1, 1), (8, 700)),
               # the Vistas heads at full width, the variants' train step
               ("vistas", 4, 12, (64, 128), (512, 1024))]


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


def _wgrad_band_cases():
    """B6's band shapes of chip_smoke (phase 12's haloed band, the general
    kernel, a band at the image's top with pad rows)."""
    import chip_smoke

    return chip_smoke.WGRAD_BAND_SHAPES


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,cout,k,channels_last,pad_rows", _wgrad_band_cases())
def test_root_wgrad_with_pad_rows_matches_plain_on_card(x_shape, cout, k, channels_last,
                                                        pad_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    check = chip_smoke.compare_wgrad(x_shape, cout, k, channels_last, pad_rows=pad_rows)
    assert check["launches"] == 1
    assert check["rel_err"] <= chip_smoke.WGRAD_REL_TOL, check


def _band_unit_cases():
    """(wrapper, unit, n, h, w, C, M, rate) of every trunk unit the rule
    fuses on the haloed bands of phase 12's spatial eval (2 ranks)."""
    import chip_smoke

    return chip_smoke.spatial_band_units()


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,unit,n,h,w,c,m,rate", _band_unit_cases())
def test_kernel_matches_plain_on_card_on_haloed_bands(wrapper, unit, n, h, w, c, m, rate):
    _check_unit(wrapper, n, h, w, c, m, rate)


def _eval_unit_cases():
    """(wrapper, unit, n, h, w, C, M, rate) of every trunk unit the dispatch
    rule fuses at the feature maps evaluation gives the fused units (TTA
    scales 0.75 and 1.25, the 1024x2048 eval size, batch 2)."""
    import chip_smoke

    return [(chip_smoke.fused_wrapper(n, h, w, c, m, rate), unit, n, h, w, c, m, rate)
            for n, h, w in chip_smoke.EVAL_MAPS for unit, c, m, rate, _ in chip_smoke.TRUNK_UNITS
            if chip_smoke.fused_wrapper(n, h, w, c, m, rate) is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,unit,n,h,w,c,m,rate", _eval_unit_cases())
def test_kernel_matches_plain_on_card_at_eval_shapes(wrapper, unit, n, h, w, c, m, rate):
    _check_unit(wrapper, n, h, w, c, m, rate)


@pytest.mark.gpu
def test_evaluate_on_card_matches_the_cpu(tmp_path, monkeypatch):
    """evaluate_cli on a 2-step small-stack run at 64x64 with --fused_block
    (bf16; B5 fuses three units a forward there): on the card it launches
    the kernel and its matrix equals the CPU's (plain version) but for the
    pixels whose decision flipped, each moving two entries. The flip rule
    of the f32 parity tests (0.1%) is for f32; here both sides compute in
    bf16 and round each conv output once, in other orders, on a 2-step
    net whose heads are near-uniform: 0.16% flipped on an H100 80GB HBM3,
    so the bound is 0.5%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iv2019_tpu_torch import evaluate_cli, train_cli
    from iv2019_tpu_torch.models import resnet

    # the small stack of tests/torch_parity.py (which imports JAX)
    monkeypatch.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50",
                        ((2, 128, 128), (2, 256, 128), (2, 256, 128)))
    log = tmp_path / "log"
    train_cli.main([str(log), "cityscapes", "--synthetic_data", "--device", "cpu",
                    "--height_feature_extractor", "64", "--width_feature_extractor", "64",
                    "--feature_dims_decreased", "64", "--Nb_per_pixel", "1",
                    "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
                    "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
                    "--input_seed", "3"])
    problem = "iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json"
    argv = [str(log), "8", problem, "--synthetic_data", "--fused_block", "--Nb", "2",
            "--height_feature_extractor", "64", "--width_feature_extractor", "64"]
    before = tb.fused_bottleneck_ct.launches
    (on_card,) = evaluate_cli.main(argv)
    assert tb.fused_bottleneck_ct.launches - before == 3 * 4
    (on_cpu,) = evaluate_cli.main(argv + ["--device", "cpu"])
    assert on_card["global_step"] == on_cpu["global_step"] == 2
    diff = np.abs(on_card["confusion_matrix"] - on_cpu["confusion_matrix"]).sum()
    assert diff <= 2 * 0.005 * 8 * 64 * 64


@pytest.mark.gpu
def test_fused_loss_at_vistas_full_width_is_deterministic_on_card():
    """Two launches of each kernel at the Vistas heads' plan (a staged
    logit row of 76 padded channels) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    dataset, n_pp, n_weak, in_hw, out_hw = LOSS_SHAPES[-1]
    tax = get_taxonomy(dataset)
    args = chip_smoke.loss_inputs(np.random.RandomState(2), tax, n_pp, n_weak, in_hw, out_hw,
                                  "cuda")
    g3 = torch.tensor([0.5, 0.07, 0.11], device="cuda")
    for fn in (lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw),
               lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dataset", ["cityscapes", "vistas"])
def test_fused_loss_on_fused_head_logits_in_f32_on_card(dataset):
    """The fused adaptation heads' logits are channel slices; in f32 compute
    the model hands B1/B2 contiguous tensors, and the losses and gradients
    match the plain version's on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel, init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tax = get_taxonomy(dataset)
    model = HierarchicalSegmentationModel(tax, resnet_blocks=((1, 64, 16), (1, 128, 32)),
                                          feature_dims_decreased=64, dtype=torch.float32,
                                          fuse_adaptation=True)
    model = init_model(model, torch.Generator().manual_seed(0)).to(
        "cuda", memory_format=torch.channels_last).train()
    n_pp, n_weak, out_hw = 2, 2, (128, 256)
    images = torch.rand(n_pp + n_weak, *out_hw, 3, device="cuda") * 2 - 1
    preds = model(images, upsampling_method="no")
    logits = [preds[f"{h}_logits"] for h in ("l1", "l2_vehicle", "l2_human")]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in logits)
    rest = chip_smoke.loss_inputs(np.random.RandomState(0), tax, n_pp, n_weak, (16, 32), out_hw,
                                  "cuda")[3:]
    args = (*[t.detach() for t in logits], *rest)
    check = chip_smoke.compare_loss(tax, args, out_hw, torch.tensor([0.5, 0.07, 0.11],
                                                                     device="cuda"))
    assert chip_smoke.loss_ok(check), check


# (images, C, h, w, storage offset in elements) of N1/N2: the heads' ragged
# C (14, 7, 3; 2-byte and 4-byte loads), C = 24 with pointers 2 bytes off 16
# (one-element loads), one channel, block4's 2048 at 64x128, the root's 64
BN_SHAPES = [(16, 14, 64, 128, 0), (16, 7, 64, 128, 0), (16, 3, 64, 128, 0),
             (3, 24, 7, 9, 1), (2, 1, 5, 7, 0), (4, 2048, 64, 128, 0), (4, 64, 256, 512, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,c,h,w,offset", BN_SHAPES)
def test_fused_bn_matches_plain_on_card(n, c, h, w, offset, dtype):
    """N1 and N2 (ops/fused_bn.py) against their plain versions: y and dx,
    the statistics and the gradient's sums at chip_smoke.py's bounds, two
    launches bit for bit, one launch of each counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    row = chip_smoke.bn_check(n, c, h, w, getattr(torch, dtype), "cuda", offset=offset)
    assert row["ok"], row


def _bn_run(case, split):
    """N1 then N2 on ``case`` = (x, dy, scale, bias): their eight outputs."""
    import chip_smoke
    from iv2019_tpu_torch.ops import fused_bn as fbn

    x, dy, scale, bias = case
    y, mean, var, rstd, count = fbn.fused_bn_fwd(x, scale, bias, chip_smoke.BN_EPS, _split=split)
    return (y, mean, var, rstd, count,
            *fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count, _split=split))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["one_launch", "two_launches"])
def test_fused_bn_two_streams_at_once_on_card(split):
    """Two runs of N1/N2 on two streams at once give the bits of the same
    runs one after the other: each call's partials and sums live in its own
    workspace, and a cooperative grid waits for room rather than
    sharing the card's blocks with the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    cases = [chip_smoke.bn_inputs(16, 256, 64, 128, torch.bfloat16, "cuda", seed=1),
             chip_smoke.bn_inputs(16, 64, 128, 256, torch.bfloat16, "cuda", seed=2)]
    alone = [_bn_run(case, split) for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    main = torch.cuda.current_stream()
    together = []
    for stream, case in zip(streams, cases):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            together.append(_bn_run(case, split))
    for stream in streams:
        main.wait_stream(stream)
    torch.cuda.synchronize()
    for a, b in zip(alone, together):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["one_launch", "two_launches"])
def test_fused_bn_replays_from_a_cuda_graph_on_card(split):
    """A run captured in a CUDA graph (the cooperative launch a kernel node)
    and replayed gives the bits of the run outside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    case = chip_smoke.bn_inputs(16, 512, 64, 128, torch.bfloat16, "cuda", seed=3)
    want = _bn_run(case, split)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _bn_run(case, split)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(want, got))


# (name, Settings fields): the default train step at 256x512, 1 + 2 + 1
# images, in one microbatch and in two, and with PSP, whose 1x1-6x6 bins
# hand N1/N2 maps of 4-144 rows a channel
DEFAULT_STEP_CASES = [("default", {}), ("accum2", {"grad_accum_steps": 2}),
                      ("psp", {"psp_module": True})]


@pytest.mark.gpu
@pytest.mark.parametrize("name,fields", DEFAULT_STEP_CASES, ids=[c[0] for c in DEFAULT_STEP_CASES])
def test_default_train_step_runs_n1_n2_once_a_norm_on_card(name, fields):
    """One default ``make_train_step`` call launches N1 and N2 once each per
    train-mode batch-norm layer of the model a microbatch (the layers
    counted from its ``Norm`` modules), copies no activation to
    channels_last, and runs no library batch-norm kernel in a profiled
    step; its losses are finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from iv2019_tpu_torch import bench
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_bn as fbn
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    nb, (h, w) = (2, 2, 2) if name == "accum2" else (1, 2, 1), (256, 512)
    settings = Settings(device="cuda", mode="train", height_feature_extractor=h,
                        width_feature_extractor=w, Nb_per_pixel=nb[0], Nb_per_bbox=nb[1],
                        Nb_per_image=nb[2], Nb=nb[0], **fields).finalize()
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    norms = chip_smoke.batch_norm_layers(model)
    assert norms > 0
    opt = FusedSGDM(settings, model)
    state, step = create_fused_train_state(opt), make_train_step(settings, fused_opt=opt)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in bench.train_batch(h, w, *nb).items()}
    state, _ = step(state, batch)  # warm-up: cuDNN's choices, the kernels' build
    torch.cuda.synchronize()
    fbn.fused_bn_fwd.launches = fbn.fused_bn_bwd.launches = fbn.batch_norm_train.layout_copies = 0
    fbn.fused_bn_eval.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    want = norms * settings.grad_accum_steps
    assert (fbn.fused_bn_fwd.launches, fbn.fused_bn_bwd.launches) == (want, want)
    assert fbn.fused_bn_eval.launches == 0
    assert fbn.batch_norm_train.layout_copies == 0
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("bn_fwd_kernel" in k for k in kernels) and any("bn_bwd_kernel" in k
                                                                 for k in kernels), kernels
    library = [k for k in kernels if "batchnorm" in k.lower() or "batch_norm" in k.lower()]
    assert not library, library
    assert all(np.isfinite(float(v)) for k, v in metrics.items() if k != "weight_masks")


@pytest.mark.gpu
def test_mit_b5_step_runs_fused_attention_and_b1_b2_at_x4_on_card():
    """``mit_b5`` in bf16 at 1024x1024: a forward of one image makes its 52
    attention calls on FlashAttention (``.launches`` 52, 52
    ``_scaled_dot_product_flash_attention`` ops, no math-backend op); a
    train step of 1 + 1 + 1 images, its stages replayed from their CUDA
    graphs from the third step on, launches 52 FlashAttention forward and
    52 backward kernels, counts 52 calls, and launches B1 and B2 once each
    on the stride-4 logits; the losses are finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from iv2019_tpu_torch import bench
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops.attention import attention
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step, uses_fused_loss

    settings = Settings(device="cuda", mode="train", name_feature_extractor="mit_b5",
                        stride_feature_extractor=4, height_feature_extractor=1024,
                        width_feature_extractor=1024, Nb_per_pixel=1, Nb_per_bbox=1,
                        Nb_per_image=1, Nb=1).finalize()
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    images = torch.rand(1, 1024, 1024, 3, device="cuda") * 2 - 1
    attention.launches = 0
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = model(images, upsampling_method="no")["l1_logits"]
    assert attention.launches == 52 and attention.backend == "flash"
    assert tuple(logits.shape) == (1, 256, 256, 14)
    ops = {e.key: e.count for e in prof.key_averages()}
    assert ops.get("aten::_scaled_dot_product_flash_attention", 0) == 52, ops
    assert not [k for k in ops if "attention_math" in k], ops
    opt = FusedSGDM(settings, model)
    state, step = create_fused_train_state(opt), make_train_step(settings, fused_opt=opt)
    assert uses_fused_loss(settings, model)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in bench.train_batch(1024, 1024, 1, 1, 1).items()}
    for _ in range(2):  # eager, then the stages' capture; the kernels' build
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    fl.fused_loss_fwd.launches = fl.fused_loss_bwd.launches = attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    assert (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches) == (1, 1)
    assert attention.launches == 52
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    fwd = sum(e.count for e in kernels if "flash_fwd_kernel" in e.key)
    bwd = sum(e.count for e in kernels if "flash_bwd_dq_dk_dv" in e.key)
    assert (fwd, bwd) == (52, 52), [e.key[:80] for e in kernels]
    assert all(np.isfinite(float(v)) for k, v in metrics.items() if k != "weight_masks")


@pytest.mark.gpu
def test_mit_graphed_stages_give_the_eager_results_on_card():
    """A ``mit_b0`` training forward and backward in bf16 on the card, its
    parameters holding gradient buffers as the fused optimizer's do: model
    A eagerly (the first call of a shape), then captured and replayed (the
    second), then replayed (the third); model B, the same weights, eagerly
    once; every call with the same masks. The replays' logits agree bit for
    bit, and with the eager ones within bf16 rounding (2% of the largest).
    FlashAttention's backward adds its query gradients with atomics, so no
    two backward passes agree bit for bit: each replay's gradients lie as
    close to A's eager ones as B's eager ones do, by the worst leaf (its
    gap over the larger of its norm and the median leaf's), within twice
    that and half a percent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import plain_segformer as plain

    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model

    params = plain.draw_params(plain.param_spec(plain.WIDTHS["mit_b0"], (14, 7, 3)), 3)
    images = torch.rand(3, 128, 256, 3, device="cuda") * 2 - 1

    def model_runs(calls):
        model = build_model(Settings(device="cuda", mode="train",
                                     name_feature_extractor="mit_b0",
                                     stride_feature_extractor=4, height_feature_extractor=128,
                                     width_feature_extractor=256))
        with torch.no_grad():
            model.load_state_dict(params, strict=True)
        runs = []
        for _ in range(calls):
            for p in model.parameters():  # gradient buffers, as the fused optimizer keeps
                p.grad = torch.zeros_like(p)
            model.seed_stochastic(11)
            out = model(images, upsampling_method="no")
            logits = torch.cat([out[k].float().flatten() for k in (
                "l1_logits", "l2_vehicle_logits", "l2_human_logits")])
            (logits.square().mean()).backward()
            runs.append((logits.detach(), {k: p.grad.detach().clone()
                                            for k, p in model.named_parameters()}))
            # the last forward's graph freed, as the train step frees it: its
            # parameters' gradient accumulators, made on the default stream,
            # would otherwise be the capture's, which no capture may wait on
            del out, logits
        return model, runs

    model, ((eager, eager_g), (first, first_g), (again, again_g)) = model_runs(3)
    base = model.get_submodule("feature_extractor/base")
    assert len(base._graphs) == 1 and isinstance(next(iter(base._graphs.values())), tuple)
    _, ((other, other_g),) = model_runs(1)
    assert torch.equal(first, again)
    assert float((first - eager).abs().max()) <= 0.02 * float(eager.abs().max())
    norms = {k: float(g.norm()) for k, g in eager_g.items()}
    med = float(np.median(list(norms.values())))

    def worst(grads):
        return max(float((grads[k] - g).norm()) / max(norms[k], med) for k, g in eager_g.items())

    bar = 2 * worst(other_g) + 0.005
    assert worst(first_g) <= bar and worst(again_g) <= bar, (worst(first_g), worst(again_g), bar)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mit_b0_on_card_matches_the_plain_reference(dtype):
    """``mit_b0`` on the card (FlashAttention in bf16, the memory-efficient
    kernel in f32; the masks drawn on the card by both sides) against the
    plain float32 reference with math attention: every head's logits within
    tests/test_torch_mit.py's bounds (f32 1e-3 here: the card's convolutions
    and attention sum in other orders than the CPU's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import plain_segformer as plain

    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.ops.attention import attention

    widths = plain.WIDTHS["mit_b0"]
    params = plain.draw_params(plain.param_spec(widths, (14, 7, 3)), 3)
    s = Settings(device="cuda", mode="train", name_feature_extractor="mit_b0",
                 stride_feature_extractor=4, compute_dtype=dtype, height_feature_extractor=128,
                 width_feature_extractor=256)
    model = build_model(s)
    with torch.no_grad():
        model.load_state_dict(params, strict=True)
    images = torch.rand(3, 128, 256, 3, device="cuda") * 2 - 1
    model.seed_stochastic(9)
    with torch.no_grad(), plain.strict_float32():
        out = model(images, upsampling_method="no")
        masks = plain.draw_masks(9, 3, widths, "cuda")
        ref = plain.forward({k: v.cuda() for k, v in params.items()}, images, widths, True,
                            masks=masks)
    assert attention.backend == ("flash" if dtype == "bfloat16" else "efficient")
    tol = 1e-3 if dtype == "float32" else 6e-2
    for key, want in zip(("l1_logits", "l2_vehicle_logits", "l2_human_logits"), ref):
        got = out[key].permute(0, 3, 1, 2).float()
        gap = float((got - want).abs().max() / want.abs().max())
        assert gap < tol, (key, gap)


# N3's widths: the Cityscapes and Vistas heads (3, 14, 53), the root (64),
# PSP's branches and the extension (256), block4 (2048); its maps: the
# Vistas and Cityscapes eval maps at stride 8, and PSP's 1x1-6x6 bins
BN_EVAL_CS = [3, 14, 53, 64, 256, 2048]
BN_EVAL_MAPS = [(115, 159), (64, 128), (1, 1), (2, 2), (3, 3), (6, 6)]


def _bn_eval_case(n, c, h, w, dtype, offset, seed):
    """x and a residual (NCHW views of NHWC storage ``offset`` elements in),
    the running statistics and f32 parameters of an eval-mode norm."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def nhwc(values):
        buf = torch.empty(offset + values.numel(), dtype=dtype, device="cuda")
        buf[offset:].view(n, h, w, c).copy_(values)
        return buf[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    mean = torch.rand(c, generator=gen, device="cuda") * 2 - 1
    var = torch.rand(c, generator=gen, device="cuda") * 3 + 0.1
    x = nhwc(torch.randn((n, h, w, c), generator=gen, device="cuda") * var.sqrt() + mean)
    residual = nhwc(torch.randn((n, h, w, c), generator=gen, device="cuda"))
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.rand(c, generator=gen, device="cuda") - 0.5
    return x, residual, mean, var, scale, bias


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["bf16", "misaligned", "f32", "nchw"])
@pytest.mark.parametrize("h,w", BN_EVAL_MAPS)
@pytest.mark.parametrize("c", BN_EVAL_CS)
def test_bn_eval_matches_the_plain_chain_on_card(c, h, w, variant):
    """N3 against ``batch_norm_eval_plain`` (the ATen ops it replaces) on
    the same card, with and without a residual and a ReLU, through
    ``fused_bn_eval`` and through the exported program's ``bn_eval.folded``
    on the table export folds: within one ulp of x's type everywhere and
    bit for bit on at least 99.9% of elements, y channels_last, one launch
    counted a call. ``misaligned``: x and the residual start 2 bytes off 16
    (one-element loads); ``nchw``: x in NCHW memory, copied to
    channels_last first and the copy counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    from iv2019_tpu_torch.ops import fused_bn as fbn

    dtype = torch.float32 if variant == "f32" else torch.bfloat16
    x, residual, *params = _bn_eval_case(2, c, h, w, dtype, 1 if variant == "misaligned" else 0,
                                         seed=c + h)
    mean, var, scale, bias = params
    table = torch.stack([mean, torch.rsqrt(var + 1e-5) * scale, bias])
    x_cl = x
    if variant == "nchw":
        x = x.contiguous()
    for res in (None, residual):
        for relu in (False, True):
            before = fbn.fused_bn_eval.launches, fbn.fused_bn_eval.layout_copies
            got = fbn.fused_bn_eval(x, *params, 1e-5, res, relu)
            want = fbn.batch_norm_eval_plain(x, *params, 1e-5, res, relu)
            folded = torch.ops.iv2019.bn_eval.folded(x_cl, table, res, relu)
            torch.cuda.synchronize()
            copied = int(not x.is_contiguous(memory_format=torch.channels_last))
            assert (fbn.fused_bn_eval.launches - before[0],
                    fbn.fused_bn_eval.layout_copies - before[1]) == (1, copied)
            assert got.dtype == dtype and got.shape == x.shape
            assert got.is_contiguous(memory_format=torch.channels_last)
            for form, out in (("operator", got), ("folded", folded)):
                off = chip_smoke.ulps_off(out, want)
                assert float(off.max()) <= 1.0, (form, res is not None, relu, float(off.max()))
                assert float((out != want).float().mean()) <= 1e-3, (form, res is not None, relu)
            if relu:
                assert float(got.float().min()) >= 0.0


@pytest.mark.gpu
def test_bn_eval_op_refuses_what_the_kernel_does_not_take_on_card():
    """The operator counts its launches in the library (``iv_op_launches``
    index 2) and raises on an x that is not channels_last, on f16, on a
    parameter of another type or length, and on a residual of another
    layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import ctypes

    from iv2019_tpu_torch.ops import fused_bn as fbn

    lib = ctypes.CDLL(tb.ops_library())
    lib.iv_op_launches.restype = ctypes.c_int64
    x, residual, mean, var, scale, bias = _bn_eval_case(2, 64, 8, 12, torch.bfloat16, 0, seed=5)
    before = lib.iv_op_launches(2)
    torch.ops.iv2019.bn_eval(x, mean, var, scale, bias, 1e-5, residual, True)
    torch.cuda.synchronize()
    assert lib.iv_op_launches(2) == before + 1
    bad = [((x.contiguous(), mean, var, scale, bias, 1e-5, None, False), "channels_last"),
           ((x.half(), mean, var, scale, bias, 1e-5, None, False), "float32 or bfloat16"),
           ((x, mean.double(), var, scale, bias, 1e-5, None, False), "mean must be"),
           ((x, mean, var[:63], scale, bias, 1e-5, None, False), "var must be"),
           ((x, mean, var, scale, bias, 1e-5, residual.contiguous(), False), "residual must be")]
    for args, message in bad:
        with pytest.raises(RuntimeError, match=message):
            torch.ops.iv2019.bn_eval(*args)
    with pytest.raises(RuntimeError, match="table must be"):
        torch.ops.iv2019.bn_eval.folded(x, torch.stack([mean, scale]), None, False)
    with pytest.raises(RuntimeError, match="residual must be"):
        fbn.fused_bn_eval(x, mean, var, scale, bias, 1e-5, residual.float())
    for bad_x in (x.half(), x[:, :, 0]):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fbn.fused_bn_eval(bad_x, mean, var, scale, bias, 1e-5)
    assert lib.iv_op_launches(2) == before + 1


@pytest.mark.gpu
def test_bn_eval_under_autograd_on_card():
    """An eval-mode Norm on the card called with gradients on (its scale
    and bias want them): N3's forward, one launch counted, and the plain
    chain's gradients of x, the shortcut, scale and bias, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.ops import fused_bn as fbn

    x, residual, mean, var, scale, bias = _bn_eval_case(2, 64, 8, 12, torch.bfloat16, 0, seed=9)
    norm = Norm(64).cuda().eval()
    with torch.no_grad():
        for name, value in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
            getattr(norm, name).copy_(value)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, residual, x, residual)]
    before = fbn.fused_bn_eval.launches
    y = norm(leaves[0], leaves[1], True)
    assert fbn.fused_bn_eval.launches == before + 1
    want = fbn.batch_norm_eval_plain(leaves[2], norm.mean, norm.var, norm.scale, norm.bias,
                                     norm.epsilon, leaves[3], True)
    assert float(chip_smoke.ulps_off(y, want).max()) <= 1.0
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, (*leaves[:2], norm.scale, norm.bias), dy)
    ref = torch.autograd.grad(want, (*leaves[2:], norm.scale, norm.bias), dy)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# (name, Settings fields) of the benchmark's two eval configurations, at
# their images' sizes, batch 1: Vistas (PSP, heads 53 / 12 / 5, no unit
# fuses at 115x159) and Cityscapes with the fused units
EVAL_CONFIGS = [("vistas_psp", dict(per_pixel_dataset_name="vistas", psp_module=True,
                                    height_feature_extractor=918, width_feature_extractor=1266)),
                ("cityscapes_fused", dict(per_pixel_dataset_name="cityscapes", fused_block=True,
                                          height_feature_extractor=512,
                                          width_feature_extractor=1024))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,fields", EVAL_CONFIGS, ids=[c[0] for c in EVAL_CONFIGS])
def test_eval_forward_runs_n3_once_a_norm_no_unit_folds_on_card(name, fields):
    """One eval forward of either configuration launches N3 once for every
    batch norm of the model that no fused unit folds (a fused unit folds
    its three): all of them in Vistas, all but 3 x (B4 + B5 launches) in
    Cityscapes; and its profiled kernels hold N3's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_bn as fbn

    settings = Settings(device="cuda", mode="eval", Nb=1, **fields)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    norms = sum(1 for m in model.modules() if isinstance(m, Norm) and m.norm_type == "batch")
    h, w = fields["height_feature_extractor"], fields["width_feature_extractor"]
    images = torch.rand(1, h, w, 3, device="cuda") * 2 - 1
    with torch.inference_mode():
        model(images)  # the kernels' build, cuDNN's choices
        torch.cuda.synchronize()
        fbn.fused_bn_eval.launches = fbn.fused_bn_eval.layout_copies = 0
        fused = tb.fused_bottleneck.launches + tb.fused_bottleneck_ct.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = model(images)
            torch.cuda.synchronize()
    fused = tb.fused_bottleneck.launches + tb.fused_bottleneck_ct.launches - fused
    assert (fused > 0) == (name == "cityscapes_fused")
    assert fbn.fused_bn_eval.launches == norms - 3 * fused
    assert fbn.fused_bn_eval.layout_copies == 0
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(n for k, n in kernels.items() if "bn_eval_kernel" in k) == norms - 3 * fused
    assert bool(torch.isfinite(out["l1_probabilities"]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fused_block", [False, True], ids=["unfused", "fused"])
def test_card_export_holds_one_bn_eval_node_a_norm(tmp_path, fused_block):
    """The Cityscapes model exported on the card (bf16, 64x128): one
    ``iv2019::bn_eval.folded`` node for each batch norm that no fused unit
    folds, traced through its fake implementation (y laid out as x); every
    constant of the program folded at export (``_folded*``, the norms'
    tables among them), nothing computed from the weights per request, no
    rsqrt in its graph; the program launches N3 once a node and gives the
    eager forward's decisions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import ctypes

    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_bn as fbn
    from iv2019_tpu_torch.tools import export_model as em

    settings = Settings(device="cuda", mode="eval", per_pixel_dataset_name="cityscapes",
                        fused_block=fused_block, height_feature_extractor=64,
                        width_feature_extractor=128, Nb=1)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator("cuda").manual_seed(1)
    norms = [m for m in model.modules() if isinstance(m, Norm) and m.norm_type == "batch"]
    with torch.no_grad():
        for m in norms:
            m.mean.copy_(torch.rand(m.mean.shape, generator=gen, device="cuda") - 0.5)
            m.var.copy_(torch.rand(m.var.shape, generator=gen, device="cuda") + 0.5)
    paths = em.export_program(model, (1, 64, 128, 3), str(tmp_path), package=False)
    program = torch.export.load(paths["program"])
    nodes = em.op_nodes(program)
    fused = nodes["fused_bottleneck"] + nodes["fused_bottleneck_ct"]
    assert (fused > 0) == fused_block
    assert nodes["bn_eval"] == len(norms) - 3 * fused
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and n.target == torch.ops.iv2019.bn_eval.folded]
    assert len(calls) == nodes["bn_eval"]
    for node in calls:
        x, y = node.args[0].meta["val"], node.meta["val"]
        assert (y.shape, y.dtype, y.stride()) == (x.shape, x.dtype, x.stride())
        assert y.is_contiguous(memory_format=torch.channels_last)
    assert em.weight_only_nodes(program) == []
    assert all(k.startswith("_folded") for k in program.state_dict)
    assert "rsqrt" not in open(paths["graph"]).read()
    lib = ctypes.CDLL(tb.ops_library())
    lib.iv_op_launches.restype = ctypes.c_int64
    images = torch.rand(1, 64, 128, 3, generator=gen, device="cuda") * 2 - 1
    with torch.no_grad():
        eager = em.ServedForward(model, None, False)(images)
        before = lib.iv_op_launches(2), fbn.fused_bn_eval.launches
        got = program.module()(images)
        torch.cuda.synchronize()
    assert lib.iv_op_launches(2) - before[0] == nodes["bn_eval"]
    assert fbn.fused_bn_eval.launches == before[1]  # the program calls the operator itself
    assert float((got[0] == eager[0]).float().mean()) >= 0.999
    assert float((got[1] - eager[1]).abs().max()) < 1e-2

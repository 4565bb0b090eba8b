"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. build: compiles the port's CUDA sources (``iv2019_tpu_torch/csrc``).
2. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the flagship predict and train paths give it, with times.
3. predict: the port's predict path at full ResNet-50 width (Cityscapes
   taxonomy, 512x1024 input, 1024x2048 output, bf16, fused blocks) on
   seeded random weights; checks the kernel launch counts, compares with
   the unfused path, and reports latency.
4. cli: the port's predict CLI over synthetic PNGs and an .npz of the same
   weights under the reference's variable names.
5. train: the port's train step at full ResNet-50 width on a constant
   synthetic 512x1024 batch of 4 per-pixel + 8 bbox + 4 image-label
   images (bf16, train-mode BatchNorm, fused loss B1/B2, fused update B3):
   one launch of each kernel per step, finite and falling losses, the EMA
   decay product; step time, images/s, device busy and idle share, peak
   memory.

The next-to-last line is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# max |got - want| / max(1, |want|) of a kernel against its plain version;
# the bound the reference holds its Pallas kernel to
# (tests/test_pallas_block.py:107): both sides round y1 and y2 to bf16, so a
# one-ulp bf16 flip of a mid activation propagates through conv3.
KERNEL_REL_TOL = 2e-2

# Fused loss kernels (B1/B2) against their plain versions. Both upsample in
# f32 with the same weights; the plain version runs dense matrix products
# (cuBLAS, FMA, another summation order) and the kernel 4-tap blends, so
# logits differ in the last bits: sums within 1e-4 relative, decisions
# equal but for near-ties (>= 99.99% of pixels), gradients within 1e-4 of
# the largest |gradient|.
LOSS_SUM_REL_TOL = 1e-4
LOSS_DECISIONS_MIN = 0.9999
LOSS_GRAD_REL_TOL = 1e-4
# The update kernel (B3) rounds every operation as the plain version's
# separate tensor ops do (no FMA contraction), so its vectors are expected
# bit-equal; the bound allows one contraction per element. reg is a sum of
# 26M terms in another order (f64 in the kernel, f32 in the plain version).
UPDATE_REL_TOL = 1e-6
UPDATE_REG_REL_TOL = 1e-5

REQUESTS = 8  # predict requests of the predict phase

# Fused vs unfused predict path, same weights, both bf16. The two paths round
# differently (the fused one folds BN into bf16 weights before the convs, the
# unfused one rounds conv outputs to bf16 before the BN affine), and a deep
# net on random weights amplifies the difference: on the card, mean
# |l1 prob diff| was 0.011-0.014 and only 66-70% of decisions agreed, while
# each bf16 path agreed with an f32 truth on just 26-33% (the random net's
# probabilities are near-uniform: mean max 0.20, mean top-2 gap 0.06). So the
# check that catches a wrong kernel is against the f32 truth: the fused path
# must be as close to it as the unfused bf16 path (the criterion of
# tests/test_pallas_block.py::test_resnet_fused_flag_matches_unfused); the
# fused-vs-unfused mean bound only catches gross breakage.
PREDICT_MEAN_ABS_TOL = 5e-2
PREDICT_TRUTH_RATIO = 1.1
PREDICT_TRUTH_DECISIONS_SLACK = 0.02

# (unit, C, M, rate, launches per request) of the fused units on the
# flagship path, feature map 64x128
UNIT_SHAPES = {
    "fused_bottleneck": [("block2", 512, 128, 1, 3), ("block3", 1024, 256, 2, 5)],
    "fused_bottleneck_ct": [("block4", 2048, 512, 4, 2)],
}
REPLACES = {
    "fused_bottleneck": "iv2019_tpu/ops/pallas_block.py:120",
    "fused_bottleneck_ct": "iv2019_tpu/ops/pallas_block.py:354",
    "fused_loss_fwd": "iv2019_tpu/ops/fused_loss.py:196",
    "fused_loss_bwd": "iv2019_tpu/ops/fused_loss.py:250",
    "fused_update": "iv2019_tpu/ops/pallas_update.py:38",
}

# the flagship train step: per-pixel, bbox and image-label images, input size
TRAIN_NB = (4, 8, 4)
TRAIN_HW = (512, 1024)
TRAIN_STEPS = 8  # timed steps, after one warm-up step
# f32 operations per output pixel of the fused loss, counted from the
# kernels' arithmetic: the 4-tap upsample (9 per logit), max, exp, sum and
# the CE terms (~6 per logit), plus the weak projection and gates (~40);
# the backward adds the gradient (4 per logit) and its two contractions
# (~5 per logit)
LOSS_FWD_OPS_PER_LOGIT, LOSS_BWD_OPS_PER_LOGIT, LOSS_OPS_PER_PIXEL = 15, 24, 40
UPDATE_OPS_PER_PARAM = 14


def log(*args):
    print(*args, flush=True)


def time_ms(fn, runs=20, warmup=3):
    """Median device time of one call, from CUDA events around each run.

    The runs are queued back to back with one synchronize at the end, so
    the host's time to launch a call overlaps the device's work on the one
    before: a start event fires when the previous call ends, not while the
    device waits for the host.
    """
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def random_unit(rng, c, m, device):
    """Folded weights of one identity unit with randomized BN statistics.

    Each running variance is drawn around the variance its conv's output
    has for unit-variance input under the He init (2 for conv1 on x, about
    1 for conv2 and conv3), as in a trained net, where BN keeps activations
    at unit scale. Drawn far from it, the gains compound over the three
    convs, outputs reach |30|, and a one-ulp bf16 flip of a large y2 value
    moves a small output by several of its own ulps: on the card that gave
    max rel errors of 2.3e-2 to 3.9e-2 with the reference test's draws
    (var in [0.3, 1.2]) against 1.2e-2 to 1.6e-2 with these.
    """
    from iv2019_tpu_torch.ops.fused_block import fold_bn

    def bn(k, var0):
        return [torch.tensor(a, dtype=torch.float32, device=device) for a in (
            rng.uniform(0.5, 1.5, k), rng.uniform(-0.5, 0.5, k),
            rng.uniform(-0.2, 0.2, k), var0 * rng.uniform(0.5, 1.5, k))]

    def kern(co, ci, kh):
        std = (2.0 / (kh * kh * ci)) ** 0.5
        return torch.tensor(rng.normal(0, std, (co, ci, kh, kh)), dtype=torch.float32, device=device)

    k1, b1 = fold_bn(kern(m, c, 1), *bn(m, 2.0))
    k2, b2 = fold_bn(kern(m, m, 3), *bn(m, 1.0))
    k3, b3 = fold_bn(kern(c, m, 1), *bn(c, 1.0))
    bf = torch.bfloat16
    return dict(
        w1=k1[:, :, 0, 0].t().contiguous().to(bf), b1=b1,
        w2=k2.permute(2, 3, 1, 0).contiguous().to(bf), b2=b2,
        w3=k3[:, :, 0, 0].t().contiguous().to(bf), b3=b3,
    )


def loss_inputs(rng, tax, n_pp, n_weak, in_hw, out_hw, device):
    """Inputs of the fused loss (B1/B2) as the train step hands them over:
    stride-8 f32 logits, per-pixel labels gathered into the three head
    spaces, and one-hot weak labels of random weak classes (bench.py:83-93)."""
    from iv2019_tpu_torch.ops.segment_ops import gather_cids

    n = n_pp + n_weak
    (h, w), (H, W) = in_hw, out_hw

    def logits(c):
        return torch.tensor(rng.normal(0, 2, (n, h, w, c)), dtype=torch.float32, device=device)

    pp = torch.tensor(rng.randint(0, len(tax.per_pixel_cids2l1_cids), (n_pp, H, W)),
                      dtype=torch.int32, device=device)
    eye = np.eye(len(tax.per_bbox_cids2vehicle_cids), dtype=np.float32)
    weak = torch.tensor(eye[rng.randint(0, len(eye), (n_weak, H, W))], device=device)
    heads = [gather_cids(t, pp).contiguous() for t in (
        tax.per_pixel_cids2l1_cids, tax.per_pixel_cids2vehicle_cids, tax.per_pixel_cids2human_cids)]
    return (logits(tax.num_l1_classes), logits(tax.num_vehicle_classes),
            logits(tax.num_human_classes), *heads, weak)


def compare_loss(tax, args, out_hw, g3):
    """B1 and B2 against their plain versions on the same inputs: sums
    relative and absolute error, decision agreement, gradient error
    relative to the largest |gradient| and absolute."""
    from iv2019_tpu_torch.ops import fused_loss as fl

    sums, dec, l1dec = fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)
    grads = fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)
    want_sums, want_dec, want_l1dec = fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw)
    want_grads = fl.fused_loss_bwd_plain(g3, *args, tax=tax, out_hw=out_hw)
    torch.cuda.synchronize()
    return dict(
        sums_rel_err=float(((sums - want_sums).abs() / want_sums.abs().clamp_min(1.0)).max()),
        sums_max_abs_err=float((sums - want_sums).abs().max()),
        decisions_equal=float((dec == want_dec).float().mean()),
        l1_decisions_equal=float((l1dec == want_l1dec).float().mean()),
        grad_rel_err=max(float((g - gw).abs().max() / gw.abs().max().clamp_min(1e-30))
                         for g, gw in zip(grads, want_grads)),
        grad_max_abs_err=max(float((g - gw).abs().max()) for g, gw in zip(grads, want_grads)))


def loss_ok(check):
    return (check["sums_rel_err"] < LOSS_SUM_REL_TOL
            and min(check["decisions_equal"], check["l1_decisions_equal"]) >= LOSS_DECISIONS_MIN
            and check["grad_rel_err"] < LOSS_GRAD_REL_TOL)


def update_inputs(n, device, seed=0):
    """(w, g, m, s, mask, lr, decay) of the update kernel (B3): flat f32
    vectors at weight, gradient and momentum scales, a 0/1 decay mask."""
    gen = torch.Generator(device).manual_seed(seed)

    def vec(scale):
        return torch.randn(n, generator=gen, device=device) * scale

    mask = (torch.rand(n, generator=gen, device=device) < 0.9).float()
    return (vec(0.05), vec(0.01), vec(0.01), vec(0.05), mask,
            torch.tensor(0.01, device=device), torch.tensor(0.9, device=device))


def compare_update(args, nesterov):
    """B3 against its plain version: the largest vector error relative to
    the largest |value| and absolute, and reg's relative error."""
    from iv2019_tpu_torch.ops.fused_update import fused_update, fused_update_plain

    kw = dict(momentum=0.9, weight_decay=0.00017, nesterov=nesterov)
    got = fused_update(*args, **kw)
    want = fused_update_plain(*args, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(got[:3], want[:3]))
    return dict(
        vec_rel_err=max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs),
        vec_max_abs_err=max(float((a - b).abs().max()) for a, b in pairs),
        reg_rel_err=float((got[3] - want[3]).abs() / want[3].abs()))


def update_ok(check):
    return check["vec_rel_err"] <= UPDATE_REL_TOL and check["reg_rel_err"] <= UPDATE_REG_REL_TOL


def unfused_cudnn(x, u, rate):
    """The same unit as three cuDNN convs + bias + relu (channels_last bf16).

    Returns a function of no arguments; the weights are laid out for cuDNN
    here, outside it, so that timing it times the convs.
    """
    xc = x.permute(0, 3, 1, 2)
    bf = torch.bfloat16
    w1 = u["w1"].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
    w2 = u["w2"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    w3 = u["w3"].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
    b1, b2, b3 = (u[k].to(bf) for k in ("b1", "b2", "b3"))

    def run():
        y = torch.relu(F.conv2d(xc, w1, b1))
        y = torch.relu(F.conv2d(y, w2, b2, padding=rate, dilation=rate))
        return torch.relu(F.conv2d(y, w3, b3) + xc)

    return run


def kernel_phase(device):
    """Each kernel against its plain version at the path's shapes.

    Returns one entry per kernel; its times and bound are per launch,
    averaged over the path's mix of shapes (per_shape has each shape).
    """
    from iv2019_tpu_torch.ops import fused_block as fb

    rng = np.random.RandomState(0)
    h, w = 64, 128
    results = []
    for name, shapes in UNIT_SHAPES.items():
        wrapper = getattr(fb, name)
        rows = []
        for unit, c, m, rate, per_request in shapes:
            u = random_unit(rng, c, m, device)
            x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.bfloat16, device=device)
            args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
            got = wrapper(*args, rate=rate).float()
            want = fb.bottleneck_plain(*args, rate=rate).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            rel = float((diff / want.abs().clamp_min(1.0)).max())
            flops = 2 * h * w * (c * m + 9 * m * m + m * c)
            nbytes = 2 * x.numel() * 2 + sum(t.numel() * t.element_size() for t in args[1:])
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            row = dict(
                unit=unit, C=c, M=m, rate=rate, per_request=per_request,
                max_abs_err=float(diff.max()), max_rel_err=rel,
                ms=time_ms(lambda: wrapper(*args, rate=rate)),
                plain_ms=time_ms(lambda: fb.bottleneck_plain(*args, rate=rate)),
                library_ms=time_ms(unfused_cudnn(x, u, rate)),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
            )
            log(f"kernel {name} {json.dumps(row)}")
            if not rel < KERNEL_REL_TOL:
                raise AssertionError(f"{name} {unit}: max rel err {rel} >= {KERNEL_REL_TOL}")
            rows.append(row)
        weight = sum(r["per_request"] for r in rows)

        def mean(key):
            return sum(r[key] * r["per_request"] for r in rows) / weight

        bound_by = {r["bound_by"] for r in rows}
        results.append(dict(
            name=name, route="cuda", source="iv2019_tpu_torch/csrc/fused_bottleneck.cu",
            replaces=REPLACES[name], launches=None,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            max_rel_err=max(r["max_rel_err"] for r in rows),
            ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=bound_by.pop() if len(bound_by) == 1 else "operations",
            library_ms=mean("library_ms"), per_shape=rows,
        ))
    results.extend(train_kernels(device))
    return results


def bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def train_kernels(device):
    """B1, B2 and B3 against their plain versions at the train step's
    shapes: 16 images at 64x128 -> 512x1024, Cityscapes heads, one-hot weak
    labels; the update over the full model's parameter count. No single
    PyTorch call computes any of them, so library_ms is null."""
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    tax = get_taxonomy("cityscapes")
    n_pp, n_weak = TRAIN_NB[0], TRAIN_NB[1] + TRAIN_NB[2]
    in_hw, out_hw = (TRAIN_HW[0] // 8, TRAIN_HW[1] // 8), TRAIN_HW
    args = loss_inputs(np.random.RandomState(3), tax, n_pp, n_weak, in_hw, out_hw, device)
    # cotangents of the sums at the scale of 1 / (labelled pixels)
    g3 = torch.tensor([1 / 1e6, 0.1 / 1e6, 0.1 / 1e6], device=device)
    check = compare_loss(tax, args, out_hw, g3)
    log(f"kernel fused_loss {json.dumps(check)}")
    if not loss_ok(check):
        raise AssertionError(f"fused loss departs from its plain version: {check}")
    n = args[0].shape[0]
    pixels = n * out_hw[0] * out_hw[1]
    c_tot = tax.num_l1_classes + tax.num_vehicle_classes + tax.num_human_classes
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    logit_bytes = sum(t.numel() * t.element_size() for t in args[:3])
    fwd_bytes, bwd_bytes = in_bytes + 2 * pixels * 4, in_bytes + logit_bytes
    fwd_bound = bound(fwd_bytes, pixels * (LOSS_FWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL),
                      PEAK_F32_FLOPS)
    bwd_bound = bound(bwd_bytes, pixels * (LOSS_BWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL),
                      PEAK_F32_FLOPS)
    common = dict(route="cuda", source="iv2019_tpu_torch/csrc/fused_loss.cu", launches=None,
                  library_ms=None)
    results = [
        dict(name="fused_loss_fwd", replaces=REPLACES["fused_loss_fwd"], **common,
             max_abs_err=check["sums_max_abs_err"],
             ms=time_ms(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)),
             plain_ms=time_ms(lambda: fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw),
                              runs=5),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], mbytes=fwd_bytes / 1e6,
             sums_rel_err=check["sums_rel_err"], decisions_equal=check["decisions_equal"],
             l1_decisions_equal=check["l1_decisions_equal"]),
        dict(name="fused_loss_bwd", replaces=REPLACES["fused_loss_bwd"], **common,
             max_abs_err=check["grad_max_abs_err"],
             ms=time_ms(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)),
             plain_ms=time_ms(lambda: fl.fused_loss_bwd_plain(g3, *args, tax=tax, out_hw=out_hw),
                              runs=5),
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], mbytes=bwd_bytes / 1e6,
             grad_rel_err=check["grad_rel_err"]),
    ]
    del args

    num_params = sum(p.numel() for p in HierarchicalSegmentationModel(tax).parameters())
    uargs = update_inputs(num_params, device)
    kw = dict(momentum=0.9, weight_decay=0.00017)
    check = compare_update(uargs, nesterov=False)
    log(f"kernel fused_update n={num_params} {json.dumps(check)}")
    if not update_ok(check):
        raise AssertionError(f"fused update departs from its plain version: {check}")
    upd_bound = bound(32 * num_params, UPDATE_OPS_PER_PARAM * num_params, PEAK_F32_FLOPS)
    results.append(dict(
        name="fused_update", route="cuda", source="iv2019_tpu_torch/csrc/fused_update.cu",
        replaces=REPLACES["fused_update"], launches=None, max_abs_err=check["vec_max_abs_err"],
        ms=time_ms(lambda: fu.fused_update(*uargs, **kw)),
        plain_ms=time_ms(lambda: fu.fused_update_plain(*uargs, **kw)),
        bound_ms=upd_bound[0], bound_by=upd_bound[1], library_ms=None,
        num_params=num_params, mbytes=32 * num_params / 1e6, vec_rel_err=check["vec_rel_err"],
        reg_rel_err=check["reg_rel_err"]))
    for r in results:
        log(f"kernel {r['name']} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    return results


_BN_INV = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def tf_name(path):
    """The reference's variable name of a flax path (the inverse of the
    port's name mapping, written independently of it)."""
    col, module, *rest = path

    def cnr(prefix, tail):
        if list(tail) == ["conv", "kernel"]:
            return f"{prefix}/weights"
        return f"{prefix}/BatchNorm/{_BN_INV[tail[-1]]}"

    if module == "feature_extractor/base":
        if rest[0] == "conv1":
            return "feature_extractor/resnet_v1_50/conv1/weights"
        if rest[0] == "conv1_norm":
            return "feature_extractor/resnet_v1_50/conv1/BatchNorm/" + _BN_INV[rest[-1]]
        return cnr(f"feature_extractor/resnet_v1_50/{rest[0]}/bottleneck_v1/{rest[1]}", rest[2:])
    if module.startswith("adaptation_module/"):
        return cnr(f"{module}/bottleneck_v1/{rest[0]}", rest[1:])
    return cnr(module, rest)


@torch.no_grad()
def calibrate_bn(model, images, rng):
    """Randomize every BatchNorm around the statistics of its own input on
    ``images`` (one unfused forward), as trained running statistics are:
    activations stay at unit scale through all 50+ layers."""
    from iv2019_tpu_torch.models.layers import Norm

    def draw(lo, hi, like):
        return torch.tensor(rng.uniform(lo, hi, like.shape), dtype=torch.float32, device=like.device)

    def hook(norm, args):
        x = args[0].float()
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        norm.mean.copy_(mean + 0.1 * var.sqrt() * draw(-1, 1, mean))
        norm.var.copy_(var * draw(0.8, 1.25, var))
        norm.scale.copy_(draw(0.8, 1.2, var))
        norm.bias.copy_(draw(-0.2, 0.2, var))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, Norm)]
    model(images)
    for h in handles:
        h.remove()


# device-time groups of the train step's profile, first match wins
STEP_GROUPS = (
    ("port kernels B1-B3", ("fwd_kernel", "bwd_rows_kernel", "bwd_cols_kernel",
                            "update_kernel", "sum_partials")),
    ("batchnorm", ("batchnorm", "batch_norm")),
    ("conv and gemm", ("xmma", "nvjet", "gemm", "conv", "cutlass")),
    ("copies and casts", ("copy", "convert")),
)


def profile_call(fn, label, p50_ms, top=8, groups=()):
    """Device time of one call of ``fn`` by kernel (torch.profiler); the wall
    time under the profiler includes its own overhead, so the device's idle
    share is taken against the unprofiled p50. ``groups``: (name, key
    substrings) to sum device time by; the rest is "other". Returns the
    numbers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows)
    # points where the host waits for the device (blocking copies, syncs)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = dict(wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
               kernels=sum(r[1] for r in rows), idle_share=1 - busy_ms / p50_ms,
               host_waits=len(syncs))
    if groups:
        by_group = {name: 0.0 for name, _ in groups}
        by_group["other"] = 0.0
        port_rows = []
        for key, count, ms in rows:
            name = next((g for g, keys in groups if any(k in key for k in keys)), "other")
            by_group[name] += ms
            if name == groups[0][0]:
                port_rows.append((key[:60], count, ms))
        out["device_ms_by_group"] = by_group
        out["port_kernels"] = port_rows
    log(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms, {out['kernels']} kernels, idle share of the "
        f"p50 {out['idle_share']:.3f}, {len(syncs)} host waits for the device")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return out


def predict_phase(device, requests):
    """The flagship predict path, fused, on seeded weights; returns the
    unfused model's state dict for the CLI phase and the launch counts."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_block as fb
    from iv2019_tpu_torch.train.step import make_predict_step

    h, w, out_hw = 512, 1024, (1024, 2048)
    settings = Settings(device=device.type, height_feature_extractor=h, width_feature_extractor=w)
    rng = np.random.RandomState(1)
    images = [torch.tensor(rng.uniform(-1, 1, (1, h, w, 3)), dtype=torch.float32, device=device)
              for _ in range(requests)]
    unfused = init_model(build_model(settings), torch.Generator().manual_seed(0))
    calibrate_bn(unfused, images[0], rng)
    fused = build_model(settings.replace(fused_block=True))
    fused.load_state_dict(unfused.state_dict())

    predict = make_predict_step(settings.replace(fused_block=True), output_size=out_hw, model=fused)
    predict_unfused = make_predict_step(settings, output_size=out_hw, model=unfused)
    ref = predict_unfused(images[0])  # warm-ups: cuDNN algorithm choice,
    predict(images[0])                # kernel library load
    torch.cuda.synchronize()
    # the two paths take turns, in alternating order, so that a change in
    # the host's load during the run falls on both (the latency is host-bound)
    steps = {"fused": predict, "unfused": predict_unfused}
    lat = {"fused": [], "unfused": []}
    first = None
    fb.fused_bottleneck.launches = 0
    fb.fused_bottleneck_ct.launches = 0
    for i, img in enumerate(images):
        for key in ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused"):
            t0 = time.perf_counter()
            out = steps[key](img)
            torch.cuda.synchronize()
            lat[key].append((time.perf_counter() - t0) * 1e3)
            if key == "fused" and first is None:
                first = out
    launches = {"fused_bottleneck": fb.fused_bottleneck.launches,
                "fused_bottleneck_ct": fb.fused_bottleneck_ct.launches}
    log(f"predict: {requests} requests 1x{h}x{w} -> {out_hw}: launches {launches}")
    want = {"fused_bottleneck": 8 * requests, "fused_bottleneck_ct": 2 * requests}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    tax_widths = {"l1_probabilities": 14, "l2_vehicle_probabilities": 7,
                  "l2_human_probabilities": 3}
    for key, c in tax_widths.items():
        p = first[key]
        if tuple(p.shape) != (1, *out_hw, c) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{key}: shape {tuple(p.shape)} or non-finite values")
        if float((p.sum(-1) - 1).abs().max()) > 1e-3:
            raise AssertionError(f"{key}: probabilities do not sum to 1")
    if tuple(first["decisions"].shape) != (1, *out_hw):
        raise AssertionError(f"decisions shape {tuple(first['decisions'].shape)}")

    # the same weights unfused in bf16, and unfused in f32 (no TF32) as truth
    truth_model = build_model(settings.replace(compute_dtype="float32"))
    truth_model.load_state_dict(unfused.state_dict())
    truth = make_predict_step(settings, output_size=out_hw, model=truth_model)(images[0])

    def compare(a, b):
        d = (a["l1_probabilities"] - b["l1_probabilities"]).abs()
        return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                    decisions_equal=float((a["decisions"] == b["decisions"]).float().mean()))

    stats = {"fused_vs_unfused": compare(first, ref), "fused_vs_f32": compare(first, truth),
             "unfused_vs_f32": compare(ref, truth)}
    for key, values in lat.items():
        ordered = sorted(values)
        stats[f"{key}_p50_ms"] = ordered[len(ordered) // 2]
        stats[f"{key}_p90_ms"] = ordered[min(len(ordered) - 1, int(len(ordered) * 0.9))]
        stats[f"{key}_ms"] = values
    log("predict: " + json.dumps(stats))
    profile_call(lambda: predict(images[0]), "fused", stats["fused_p50_ms"])
    profile_call(lambda: predict_unfused(images[0]), "unfused", stats["unfused_p50_ms"])
    fu, ff, uf = stats["fused_vs_unfused"], stats["fused_vs_f32"], stats["unfused_vs_f32"]
    if not fu["mean_abs"] < PREDICT_MEAN_ABS_TOL:
        raise AssertionError(f"fused path departs from the unfused path: {fu}")
    if not (ff["mean_abs"] <= PREDICT_TRUTH_RATIO * uf["mean_abs"]
            and ff["decisions_equal"] >= uf["decisions_equal"] - PREDICT_TRUTH_DECISIONS_SLACK):
        raise AssertionError(f"fused path is further from f32 than the unfused bf16 path: {stats}")
    return unfused.state_dict(), launches


def cli_phase(state):
    """The port's predict CLI over two synthetic PNGs and an .npz of the
    predict phase's weights under the reference's variable names."""
    import os
    import tempfile

    from PIL import Image

    from iv2019_tpu_torch import predict_cli
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.utils.convert import flax_from_state_dict

    params, batch_stats = flax_from_state_dict(state)
    arrays = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        stack = [((col,), tree)]
        while stack:
            path, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((path + (k,), v))
                else:
                    arrays[tf_name(path + (k,))] = v
    problem = os.path.join(os.path.dirname(os.path.abspath(predict_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    lids = set(load_problem_def(problem).cids2lids)
    rng = np.random.RandomState(2)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "model.npz")
        np.savez(npz, **arrays)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        sizes = {"a": (512, 1024), "b": (600, 800)}
        for stem, hw in sizes.items():
            Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
                os.path.join(img_dir, f"{stem}.png"))
        log_dir = os.path.join(tmp, "log")
        n = predict_cli.main([log_dir, problem, img_dir, "--ckpt_path", npz,
                              "--fused_block", "--export_lids_images"])
        if n != len(sizes):
            raise AssertionError(f"predicted {n} images, expected {len(sizes)}")
        for stem, hw in sizes.items():
            with Image.open(os.path.join(log_dir, "predictions", f"{stem}_result_lids.png")) as im:
                got = np.asarray(im)
            if got.shape != hw or not set(np.unique(got).tolist()) <= lids:
                raise AssertionError(f"{stem}: lids export {got.shape} {np.unique(got)}")
    log(f"cli: {n} images exported at raw size, {len(arrays)} variables in the npz")


def train_batch(rng, device):
    """The constant synthetic batch of bench.py:80-93 at the flagship sizes,
    on the device: uniform images, per-pixel labels in [0, 20), one-hot weak
    labels of random weak classes."""
    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW

    def img(n):
        return rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)

    eye = np.eye(15, dtype=np.float32)
    batch = {
        "proimages_per_pixel": img(npp),
        "proimages_per_bbox": img(npb),
        "proimages_per_image": img(npi),
        "prolabels_per_pixel": rng.randint(0, 20, (npp, h, w)).astype(np.int32),
        "prolabels_per_bbox": eye[rng.randint(0, 15, (npb, h, w))],
        "prolabels_per_image": eye[rng.randint(0, 15, (npi, h, w))],
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_phase(device, steps=TRAIN_STEPS):
    """The flagship train step: full-width ResNet-50, seeded weights, the
    default fused loss and fused optimizer, one warm-up step and ``steps``
    timed steps on one constant batch. Returns the launch counts of the run."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    settings = Settings(device=device.type, mode="train", height_feature_extractor=h,
                        width_feature_extractor=w, Nb_per_pixel=npp, Nb_per_bbox=npb,
                        Nb_per_image=npi).finalize()
    if not (settings.fused_loss and settings.fused_optimizer and settings.pallas_update):
        raise AssertionError("the train phase drives the default fused loss and update")
    torch.cuda.reset_peak_memory_stats()
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    opt = FusedSGDM(settings, model)
    state = create_fused_train_state(opt)
    step = make_train_step(settings, fused_opt=opt)
    batch = train_batch(np.random.RandomState(0), device)
    images = sum(TRAIN_NB)
    log(f"train: {opt.num_params} parameters, batch {TRAIN_NB} x {h}x{w}, "
        f"{settings.compute_dtype}, weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "with the batch")

    fl.fused_loss_fwd.launches = fl.fused_loss_bwd.launches = fu.fused_update.launches = 0
    history, times = [], []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items() if k != "weight_masks"})
    launches = {"fused_loss_fwd": fl.fused_loss_fwd.launches,
                "fused_loss_bwd": fl.fused_loss_bwd.launches,
                "fused_update": fu.fused_update.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(history):
        log(f"train step {i}: {times[i]:.1f} ms " + json.dumps(m))
    if launches != {k: steps + 1 for k in launches}:
        raise AssertionError(f"launches {launches}, expected one of each per step ({steps + 1})")
    if not all(np.isfinite(v) for m in history for v in m.values()):
        raise AssertionError("non-finite loss or metric")
    if not history[-1]["total"] < history[0]["total"]:
        raise AssertionError(f"total did not fall on a constant batch: "
                             f"{history[0]['total']} -> {history[-1]['total']}")
    prod = float(np.prod([min(0.9, (1 + t) / (10 + t)) for t in range(steps + 1)]))
    got = float(state.opt_state.ema_decay_product)
    if abs(got - prod) > 1e-6 * prod:
        raise AssertionError(f"ema_decay_product {got}, expected {prod}")
    timed = sorted(times[1:])
    p50 = timed[len(timed) // 2]
    p90 = timed[min(len(timed) - 1, int(len(timed) * 0.9))]
    stats = dict(steps=steps, p50_ms=p50, p90_ms=p90, images_per_s=images / p50 * 1e3,
                 warmup_ms=times[0], peak_memory_gib=peak_gib, launches=launches,
                 first_total=history[0]["total"], last_total=history[-1]["total"],
                 ema_decay_product=got)
    log("train: " + json.dumps(stats))
    profile = profile_call(lambda: step(state, batch), "train step", p50, top=12,
                           groups=STEP_GROUPS)
    log("train profile: " + json.dumps(profile))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from iv2019_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    for stem, report in _build.build_all().items():
        log(f"built {stem} in {time.time() - t0:.1f}s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  " + line.strip())
    # the plain versions are the references: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    results = kernel_phase(device)
    state, launches = predict_phase(device, REQUESTS)
    cli_phase(state)
    del state
    torch.cuda.empty_cache()
    launches.update(train_phase(device))
    for r in results:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

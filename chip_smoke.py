"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. build: compiles the port's CUDA sources (``iv2019_tpu_torch/csrc``).
2. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the flagship predict and train paths give it, with times;
   for the fused units also the device times of their two kernels apart,
   the achieved TFLOP/s and the share of the bound. The fused-loss kernels
   (B1, B2) are also checked at ragged shapes, at the Vistas head widths
   and with label views that start 1-3 elements off 16 bytes, and B1's
   decisions against an argmax of the 4-tap blend done as separate tensor
   multiplies and adds (equal on every pixel); the root-conv wgrad (B6) on
   its ragged edge and on its general kernel; for B1, B2 and B6 two
   launches on the same inputs must agree bit for bit, and ``device_ms``
   (replays of a CUDA graph of one call) stands beside ``ms``.
3. predict: the port's predict path at full ResNet-50 width (Cityscapes
   taxonomy, 512x1024 input, 1024x2048 output, bf16, fused blocks) on
   seeded random weights; checks the kernel launch counts, compares with
   the unfused path, and reports latency.
4. cli: the port's predict CLI over synthetic PNGs and an .npz of the same
   weights under the reference's variable names.
5. train: the port's train step at full ResNet-50 width on a constant
   synthetic 512x1024 batch of 4 per-pixel + 8 bbox + 4 image-label
   images (bf16, train-mode BatchNorm, fused loss B1/B2, fused update B3),
   with the root conv's weight gradient from cuDNN and from B6
   (``root_wgrad_pallas``) in turns, both from the same initial weights:
   one launch of each kernel per step (B6 only with the flag), B6's dW
   against cuDNN's on the same step, finite and falling losses, the EMA
   decay product; step time, images/s, device busy and idle share, the
   root wgrad's device time, peak memory.
6. train run: the port's training run through its entry points at full
   width with ``root_wgrad_pallas`` (``SemanticSegmentation.train`` to step
   6 on synthetic input, checkpoints every 3 steps, then a rerun on the same
   directory that resumes at 6 and stops at 8), then ``train_cli.main`` at
   256x512 for 2 steps: the run's artifacts, one B6 launch per step; step
   p50/p90, images/s, the host input's time per batch, idle share, peak
   memory. Then ``predict_cli`` on train_cli's checkpoint, with and without
   ``--restore_emas``: the exports, and the predictions against a model
   holding the run's weights (or their unbiased EMA shadows).

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
    "root_conv_wgrad": "iv2019_tpu/ops/pallas_wgrad.py:115",
}

# B2 beside the flagship check: (dataset, n_pp, n_weak, stride-8 size, output
# size) of a ragged shape (no chunk, band or 16-byte label row comes out
# even), the Vistas head widths, and Vistas at a ragged mid size
LOSS_EDGE_SHAPES = [("cityscapes", 0, 3, (5, 9), (37, 67)),
                    ("vistas", 1, 2, (9, 16), (36, 64)),
                    ("vistas", 1, 1, (39, 54), (310, 427))]
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
# The root-conv wgrad kernel (B6) against its plain version (one f32 matrix
# product over the same bf16 operands, cuBLAS without TF32): only the order
# of the f32 sums differs, over up to 2.1M products per output (measured
# 7.6e-6 of the largest |dW| at the flagship shape, 2.3e-7 at 2x36x70).
WGRAD_REL_TOL = 1e-4
# the flagship train step's root conv: x (16, 3, 512, 1024), dy (16, 64, 256, 512)
WGRAD_SHAPE = ((sum(TRAIN_NB), 3) + TRAIN_HW, 64, 7)
# the train run: steps of the first run, of the resumed run, checkpoint cadence
RUN_STEPS, RESUME_STEPS, RUN_SAVE_EVERY = 6, 8, 3


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


def device_ms(fn, runs=20):
    """Median device time of one call of ``fn`` with the host's time taken
    out: the call is captured once in a CUDA graph and the graph replayed,
    with CUDA events around each replay. For calls whose kernels take less
    time than the host needs to launch them (the small fused units),
    ``time_ms`` measures the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, runs=runs)


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
    tap_dec, tap_l1dec = tap_decisions(tax, *args[:3], out_hw)
    torch.cuda.synchronize()
    return dict(
        sums_rel_err=float(((sums - want_sums).abs() / want_sums.abs().clamp_min(1.0)).max()),
        sums_max_abs_err=float((sums - want_sums).abs().max()),
        decisions_equal=float((dec == want_dec).float().mean()),
        l1_decisions_equal=float((l1dec == want_l1dec).float().mean()),
        tap_decisions_equal=min(float((dec == tap_dec).float().mean()),
                                float((l1dec == tap_l1dec).float().mean())),
        grad_rel_err=max(float((g - gw).abs().max() / gw.abs().max().clamp_min(1e-30))
                         for g, gw in zip(grads, want_grads)),
        grad_max_abs_err=max(float((g - gw).abs().max()) for g, gw in zip(grads, want_grads)))


def loss_ok(check):
    return (check["sums_rel_err"] < LOSS_SUM_REL_TOL
            and min(check["decisions_equal"], check["l1_decisions_equal"]) >= LOSS_DECISIONS_MIN
            and check["grad_rel_err"] < LOSS_GRAD_REL_TOL
            and check.get("tap_decisions_equal", 1.0) == 1.0)


def tap_decisions(tax, l1_lr, veh_lr, hum_lr, out_hw):
    """(decisions, l1_decisions) from the 4-tap blend written as separate
    tensor multiplies and adds, rows first (each rounded once, as the
    kernels' blend), and torch's first-max argmax: what B1's decisions must
    equal bit for bit."""
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops.segment_ops import gather_cids

    dev = l1_lr.device
    (H, W), (h, w) = out_hw, l1_lr.shape[1:3]
    rlo, rhi, rw0, rw1, _, _ = (torch.as_tensor(t, device=dev) for t in fl._taps(h, H))
    clo, chi, cw0, cw1, _, _ = (torch.as_tensor(t, device=dev) for t in fl._taps(w, W))

    def argmax(lr):
        rows = rw0[None, :, None, None] * lr[:, rlo.long()] + rw1[None, :, None, None] * lr[:, rhi.long()]
        u = cw0[None, None, :, None] * rows[:, :, clo.long()] + cw1[None, None, :, None] * rows[:, :, chi.long()]
        return u.argmax(-1).int()

    d1, dv, dh = argmax(l1_lr), argmax(veh_lr), argmax(hum_lr)
    dec = torch.where(
        d1 == tax.cid_l1_vehicle, gather_cids(tax.l2_vehicle_cids2common_cids, dv),
        torch.where(d1 == tax.cid_l1_human, gather_cids(tax.l2_human_cids2common_cids, dh),
                    gather_cids(tax.l1_cids2common_cids, d1)))
    return dec, d1


def unaligned_labels(args, offset):
    """The loss inputs with each label tensor replaced by an equal view that
    starts ``offset`` elements (4-byte words) into a fresh buffer."""
    out = list(args)
    for k in range(3, 7):
        t = out[k]
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out[k] = buf[offset:].view(t.shape).copy_(t)
    return out


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
    A fused unit's entry also has the device times of the wrapper's two
    kernels apart (conv1, and conv2 + conv3), its achieved TFLOP/s and its
    share of the bound, from ``ms`` and from ``device_ms``.
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
            y1 = torch.empty((1, h, w, m), dtype=torch.bfloat16, device=device)
            symbol = f"iv_{name}"
            row = dict(
                unit=unit, C=c, M=m, rate=rate, per_request=per_request,
                max_abs_err=float(diff.max()), max_rel_err=rel,
                ms=time_ms(lambda: wrapper(*args, rate=rate)),
                device_ms=device_ms(lambda: wrapper(*args, rate=rate)),
                kernel1_ms=device_ms(lambda: fb._run(symbol, *args, rate, kernels=1, y1=y1)),
                kernel2_ms=device_ms(lambda: fb._run(symbol, *args, rate, kernels=2, y1=y1)),
                plain_ms=time_ms(lambda: fb.bottleneck_plain(*args, rate=rate)),
                library_ms=time_ms(unfused_cudnn(x, u, rate)),
                library_device_ms=device_ms(unfused_cudnn(x, u, rate)),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
            )
            row.update(tflops=flops / row["ms"] / 1e9, bound_share=row["bound_ms"] / row["ms"],
                       device_tflops=flops / row["device_ms"] / 1e9,
                       device_bound_share=row["bound_ms"] / row["device_ms"])
            log(f"kernel {name} {unit}: {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
                f"{row['bound_share']:.3f} of the bound), device {row['device_ms']:.4f} ms "
                f"= conv1 {row['kernel1_ms']:.4f} + conv2/3 {row['kernel2_ms']:.4f} "
                f"({row['device_tflops']:.1f} TFLOP/s, {row['device_bound_share']:.3f}); "
                f"cuDNN unit {row['library_ms']:.4f} ms, device {row['library_device_ms']:.4f}; "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
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
            library_ms=mean("library_ms"), device_ms=mean("device_ms"),
            kernel1_ms=mean("kernel1_ms"), kernel2_ms=mean("kernel2_ms"),
            library_device_ms=mean("library_device_ms"), per_shape=rows,
        ))
    results.extend(train_kernels(device))
    results.append(wgrad_kernel(device))
    return results


def wgrad_inputs(x_shape, cout, k, channels_last, seed=0):
    """x (NCHW view of NHWC bf16 memory, images in [-1, 1)) and dy (bf16,
    NHWC memory or, with ``channels_last`` False, NCHW contiguous)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    n, c, h, w = x_shape
    x = (torch.rand(x_shape, generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn((n, cout, h // 2, w // 2), generator=gen, device="cuda").to(torch.bfloat16)
    if channels_last:
        dy = dy.contiguous(memory_format=torch.channels_last)
    return x, dy


def compare_wgrad(x_shape, cout, k, channels_last, seed=0):
    """B6 against its plain version: the largest error, absolute and
    relative to the largest |dW|, and the launches of the call."""
    from iv2019_tpu_torch.ops import root_wgrad as rw

    x, dy = wgrad_inputs(x_shape, cout, k, channels_last, seed)
    before = rw.root_conv_wgrad.launches
    got = rw.root_conv_wgrad(x, dy, k, 2)
    launches = rw.root_conv_wgrad.launches - before
    want = rw.root_conv_wgrad_reference(x, dy, k, 2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    return dict(shape=list(x_shape), cout=cout, k=k, channels_last_dy=channels_last,
                max_abs_err=err, rel_err=err / float(want.abs().max()), launches=launches)


def wgrad_kernel(device):
    """B6 at the flagship step's shape, on the root kernel's ragged edge (a
    200-pixel row fills no 128-pixel chunk; dy in NCHW memory), and on the
    general kernel (W = 70 is no multiple of 8), dy in NHWC and in NCHW
    memory; two launches bit for bit; times at the flagship shape, against
    cuDNN's wgrad of the same conv (``torch.nn.grad.conv2d_weight``) as the
    library call."""
    from iv2019_tpu_torch.ops import root_wgrad as rw

    x_shape, cout, k = WGRAD_SHAPE
    checks = [compare_wgrad(x_shape, cout, k, True),
              compare_wgrad((2, 3, 20, 400), cout, k, False),
              compare_wgrad((2, 3, 36, 70), cout, k, True),
              compare_wgrad((2, 3, 36, 70), cout, k, False)]
    for check in checks:
        log(f"kernel root_conv_wgrad {json.dumps(check)}")
        if not check["rel_err"] <= WGRAD_REL_TOL:
            raise AssertionError(f"root_conv_wgrad departs from its plain version: {check}")
    x, dy = wgrad_inputs(x_shape, cout, k, True)
    first, second = rw.root_conv_wgrad(x, dy, k, 2), rw.root_conv_wgrad(x, dy, k, 2)
    if not torch.equal(first, second):
        raise AssertionError("root_conv_wgrad: two launches on the same inputs differ")
    del first, second
    n, c, h, w = x_shape
    pixels = n * (h // 2) * (w // 2)
    nbytes = x.numel() * 2 + dy.numel() * 2 + cout * c * k * k * 4
    b = bound(nbytes, 2 * k * k * c * cout * pixels, PEAK_BF16_FLOPS)
    w_shape = (cout, c, k, k)
    row = dict(
        name="root_conv_wgrad", route="cuda", source="iv2019_tpu_torch/csrc/root_wgrad.cu",
        replaces=REPLACES["root_conv_wgrad"], launches=None,
        max_abs_err=checks[0]["max_abs_err"], rel_err=checks[0]["rel_err"],
        ms=time_ms(lambda: rw.root_conv_wgrad(x, dy, k, 2)),
        device_ms=device_ms(lambda: rw.root_conv_wgrad(x, dy, k, 2)), bit_equal=True,
        plain_ms=time_ms(lambda: rw.root_conv_wgrad_reference(x, dy, k, 2), runs=5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(x, w_shape, dy, 2, (k - 1) // 2)),
        mbytes=nbytes / 1e6, gflop=2 * k * k * c * cout * pixels / 1e9,
        per_shape=checks)
    log(f"kernel root_conv_wgrad ms {row['ms']:.4f} device {row['device_ms']:.4f} plain {row['plain_ms']:.4f} cudnn "
        f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']})")
    return row


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
    edge_checks = []
    # the edge shapes, then label views that start 1-3 elements off 16 bytes
    # (B1 and B2 copy label rows from the address rounded down to 16 bytes)
    unaligned = [(shape, offset) for shape in (LOSS_EDGE_SHAPES[0], LOSS_EDGE_SHAPES[2])
                 for offset in (1, 2, 3)]
    for (dataset, e_pp, e_weak, e_in, e_out), offset in [(s, 0) for s in LOSS_EDGE_SHAPES] + unaligned:
        e_tax = get_taxonomy(dataset)
        e_args = loss_inputs(np.random.RandomState(0), e_tax, e_pp, e_weak, e_in, e_out, device)
        if offset:
            e_args = unaligned_labels(e_args, offset)
        e_check = compare_loss(e_tax, e_args, e_out, torch.tensor([0.5, 0.07, 0.11], device=device))
        e_check.update(dataset=dataset, n_pp=e_pp, n_weak=e_weak, in_hw=e_in, out_hw=e_out,
                       label_offset=offset)
        log(f"kernel fused_loss {json.dumps(e_check)}")
        if not loss_ok(e_check):
            raise AssertionError(f"fused loss departs from its plain version: {e_check}")
        edge_checks.append(e_check)
    check_off = compare_loss(tax, unaligned_labels(args, 3), out_hw, g3)
    check_off.update(label_offset=3)
    log(f"kernel fused_loss flagship, labels 3 elements off 16 bytes: {json.dumps(check_off)}")
    if not loss_ok(check_off):
        raise AssertionError(f"fused loss departs from its plain version: {check_off}")
    edge_checks.append(check_off)

    def scratch(fn):
        """Device memory one call takes besides its outputs (the caching
        allocator hands out a cached block whole when less than 1 MiB of it
        would be left over, so up to 1 MiB per output shows here as
        rounding), and whether it gave the bits of the call before it."""
        first = fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        second = fn()
        torch.cuda.synchronize()
        nbytes = (torch.cuda.max_memory_allocated() - before
                  - sum(t.numel() * t.element_size() for t in second))
        return nbytes, all(torch.equal(a, b) for a, b in zip(first, second))

    # B1's per-block partial sums are its only scratch (6 floats a block); the
    # B2 scratch this guards against was N x H x w x C floats, 100 MB here
    fwd_scratch, fwd_equal = scratch(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw))
    scratch_bytes, bwd_equal = scratch(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw))
    if not (fwd_equal and bwd_equal):
        raise AssertionError(f"two launches on the same inputs differ: B1 {not fwd_equal}, "
                             f"B2 {not bwd_equal}")
    if max(scratch_bytes, fwd_scratch) > 8 * 2**20:
        raise AssertionError(f"fused loss scratch: B1 {fwd_scratch}, B2 {scratch_bytes} bytes")
    heads = (tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes)
    plan = fl._bwd_plan(*in_hw, *out_hw, heads)
    fplan = fl._fwd_plan(*in_hw, *out_hw, heads)
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
             device_ms=device_ms(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)),
             bit_equal=True, scratch_bytes=fwd_scratch, smem_bytes=fplan.smem_bytes,
             blocks=fplan.slots(n), threads=fplan.threads, per_shape=edge_checks,
             plain_ms=time_ms(lambda: fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw),
                              runs=5),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], mbytes=fwd_bytes / 1e6,
             sums_rel_err=check["sums_rel_err"], decisions_equal=check["decisions_equal"],
             l1_decisions_equal=check["l1_decisions_equal"],
             tap_decisions_equal=check["tap_decisions_equal"]),
        dict(name="fused_loss_bwd", replaces=REPLACES["fused_loss_bwd"], **common,
             max_abs_err=check["grad_max_abs_err"],
             ms=time_ms(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)),
             device_ms=device_ms(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)),
             bit_equal=True, scratch_bytes=scratch_bytes, smem_bytes=plan.smem_bytes,
             blocks=len(plan.chunks) * len(plan.bands) * n, threads=plan.threads,
             per_shape=edge_checks,
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


# device-time groups of the fused predict request's profile
PREDICT_GROUPS = (
    ("port kernels B4/B5", ("conv1_kernel", "conv23_kernel")),
    ("conv and gemm", ("xmma", "nvjet", "gemm", "conv", "cutlass")),
    ("copies and casts", ("copy", "convert")),
)
# device-time groups of the train step's profile, first match wins
STEP_GROUPS = (
    ("port kernels B1-B3, B6", ("fwd_walk_kernel", "bwd_walk_kernel", "update_kernel", "sum_partials",
                                "wgrad_root_kernel", "wgrad_root_reduce_kernel",
                                "wgrad_general_kernel", "wgrad_general_reduce_kernel")),
    ("batchnorm", ("batchnorm", "batch_norm")),
    ("conv and gemm", ("xmma", "nvjet", "gemm", "conv", "cutlass")),
    ("copies and casts", ("copy", "convert")),
)


def profile_call(fn, label, p50_ms, top=8, groups=(), root_shape=None):
    """Device time of one call of ``fn`` by kernel (torch.profiler); the wall
    time under the profiler includes its own overhead, so the device's idle
    share is taken against the unprofiled p50. ``groups``: (name, key
    substrings) to sum device time by; the rest is "other". ``root_shape``:
    the images' NCHW shape, to report the device time of the root conv's
    weight gradient (B6's kernels, or cuDNN's convolution backward on that
    input). Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=root_shape is not None) as prof:
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
    if root_shape is not None:
        cudnn = [e for e in prof.key_averages(group_by_input_shape=True)
                 if e.key == "aten::convolution_backward"
                 and list(root_shape) in [list(s) for s in e.input_shapes]]
        out["root_wgrad_ms"] = (
            sum(e.device_time_total for e in cudnn) / 1e3
            + sum(ms for key, _, ms in rows if "::wgrad_" in key))
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
    profile = profile_call(lambda: predict(images[0]), "fused", stats["fused_p50_ms"],
                           groups=PREDICT_GROUPS)
    log("predict profile (fused): " + json.dumps(profile))
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


def _counts():
    """The launch counts of the train path's kernels."""
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.ops import root_wgrad as rw

    return {"fused_loss_fwd": fl.fused_loss_fwd.launches,
            "fused_loss_bwd": fl.fused_loss_bwd.launches,
            "fused_update": fu.fused_update.launches,
            "root_conv_wgrad": rw.root_conv_wgrad.launches}


def _reset_counts():
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.ops import root_wgrad as rw

    fl.fused_loss_fwd.launches = fl.fused_loss_bwd.launches = 0
    fu.fused_update.launches = rw.root_conv_wgrad.launches = 0


def _p50_p90(values):
    ordered = sorted(values)
    return ordered[len(ordered) // 2], ordered[min(len(ordered) - 1, int(len(ordered) * 0.9))]


def capture_root_grads(model):
    """Hooks that keep the root conv's bf16 input and the gradient of its
    output from the next backward; returns (dict, remove)."""
    captured = {}
    conv1 = model.get_submodule("feature_extractor/base").conv1

    def hook(module, inputs, output):
        captured["x"] = inputs[0].detach().to(module.dtype)
        output.register_hook(lambda g: captured.__setitem__("dy", g.detach()))

    return captured, conv1.register_forward_hook(hook).remove


def check_step_wgrad(captured):
    """B6's dW of a train step's root conv against cuDNN's for the same x
    and dy: both rounded to bf16 (what each path hands the optimizer), within
    one bf16 ulp of the largest |dW|; and B6's f32 dW against cuDNN's in f32
    (TF32 off) on the same bf16 operands."""
    from iv2019_tpu_torch.ops.root_wgrad import root_conv_wgrad

    x, dy = captured["x"], captured["dy"]
    shape = (dy.shape[1], x.shape[1], 7, 7)
    b6 = root_conv_wgrad(x, dy, 7, 2)
    cudnn = torch.nn.grad.conv2d_weight(x, shape, dy, 2, 3)
    cudnn_f32 = torch.nn.grad.conv2d_weight(x.float(), shape, dy.float(), 2, 3)
    torch.cuda.synchronize()
    top = float(cudnn.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    out = dict(max_abs_dw=top, bf16_ulp=ulp,
               bf16_max_abs_diff=float((b6.to(torch.bfloat16).float() - cudnn.float()).abs().max()),
               f32_rel_err=float((b6 - cudnn_f32).abs().max()) / float(cudnn_f32.abs().max()))
    log("train: root dW, B6 against cuDNN on the same step: " + json.dumps(out))
    if not (out["bf16_max_abs_diff"] <= ulp and out["f32_rel_err"] <= WGRAD_REL_TOL):
        raise AssertionError(f"B6's dW departs from cuDNN's on the train step: {out}")
    return out


def train_phase(device, steps=TRAIN_STEPS):
    """The flagship train step: full-width ResNet-50, the default fused loss
    and fused optimizer, the root conv's wgrad from cuDNN and from B6 in
    turns (two models from the same seeded weights), one warm-up step and
    ``steps`` timed steps each on one constant batch. Returns the device
    busy time of the B6 step."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import root_wgrad as rw
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
    runs = {}
    for flag in (False, True):
        s = settings.replace(root_wgrad_pallas=flag)
        model = init_model(build_model(s), torch.Generator().manual_seed(0))
        opt = FusedSGDM(s, model)
        runs[flag] = dict(opt=opt, state=create_fused_train_state(opt),
                          step=make_train_step(s, fused_opt=opt), history=[], times=[], b6=[])
    batch = train_batch(np.random.RandomState(0), device)
    images = sum(TRAIN_NB)
    log(f"train: {runs[True]['opt'].num_params} parameters, batch {TRAIN_NB} x {h}x{w}, "
        f"{settings.compute_dtype}, two models (root_wgrad_pallas off/on), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with the batch")
    captured, remove_hooks = capture_root_grads(runs[True]["opt"].model)

    _reset_counts()
    for i in range(steps + 1):
        # the two paths take turns, in alternating order
        for flag in (False, True) if i % 2 == 0 else (True, False):
            r = runs[flag]
            before = rw.root_conv_wgrad.launches
            t0 = time.perf_counter()
            r["state"], metrics = r["step"](r["state"], batch)
            torch.cuda.synchronize()
            r["times"].append((time.perf_counter() - t0) * 1e3)
            r["b6"].append(rw.root_conv_wgrad.launches - before)
            r["history"].append({k: float(v) for k, v in metrics.items() if k != "weight_masks"})
            if flag:
                remove_hooks()
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"fused_loss_fwd": 2 * (steps + 1), "fused_loss_bwd": 2 * (steps + 1),
            "fused_update": 2 * (steps + 1), "root_conv_wgrad": steps + 1}
    log(f"train: launches {launches}")
    if launches != want or runs[True]["b6"] != [1] * (steps + 1) or any(runs[False]["b6"]):
        raise AssertionError(f"launches {launches}, expected {want}; B6 per step with the flag "
                             f"{runs[True]['b6']}, without {runs[False]['b6']}")
    wgrad_check = check_step_wgrad(captured)
    del captured
    prod = float(np.prod([min(0.9, (1 + t) / (10 + t)) for t in range(steps + 1)]))
    stats = {}
    for flag, r in runs.items():
        key = "b6" if flag else "cudnn"
        history = r["history"]
        for i, m in enumerate(history):
            log(f"train step {i} ({key}): {r['times'][i]:.1f} ms " + json.dumps(m))
        if not all(np.isfinite(v) for m in history for v in m.values()):
            raise AssertionError(f"{key}: non-finite loss or metric")
        if not history[-1]["total"] < history[0]["total"]:
            raise AssertionError(f"{key}: total did not fall on a constant batch: "
                                 f"{history[0]['total']} -> {history[-1]['total']}")
        got = float(r["state"].opt_state.ema_decay_product)
        if abs(got - prod) > 1e-6 * prod:
            raise AssertionError(f"{key}: ema_decay_product {got}, expected {prod}")
        p50, p90 = _p50_p90(r["times"][1:])
        stats[key] = dict(p50_ms=p50, p90_ms=p90, images_per_s=images / p50 * 1e3,
                          warmup_ms=r["times"][0], first_total=history[0]["total"],
                          last_total=history[-1]["total"], ema_decay_product=got)
    stats.update(steps=steps, peak_memory_gib=peak_gib, launches=launches,
                 root_dw_check=wgrad_check)
    log("train: " + json.dumps(stats))
    busy = {}
    for flag, r in runs.items():
        key = "b6" if flag else "cudnn"
        profile = profile_call(lambda: r["step"](r["state"], batch), f"train step ({key})",
                               stats[key]["p50_ms"], top=12, groups=STEP_GROUPS,
                               root_shape=(images, 3, h, w))
        log(f"train profile ({key}): " + json.dumps(profile))
        busy[key] = profile["device_busy_ms"]
    return busy["b6"]


def _waits_by_file(syncs):
    """Host waits for the device (sync debug warnings) by the port's source
    file that triggered them."""
    import collections
    import os

    out = collections.Counter(os.path.basename(w.filename) for w in syncs)
    return dict(out.most_common())


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_run_phase(device, step_busy_ms):
    """The training run through its entry points (see the module
    docstring). ``step_busy_ms``: the device time of one B6 train step
    (train phase profile), for the run's idle share. Returns the launch
    counts of the two SemanticSegmentation runs."""
    import os
    import tempfile

    from iv2019_tpu_torch import train_cli
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.system import SemanticSegmentation

    problem = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    images = sum(TRAIN_NB)
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "run")
        settings = Settings(
            device=device.type, mode="train", log_dir=log_dir, training_problem_def_path=problem,
            synthetic_data=True, input_seed=0, root_wgrad_pallas=True,
            save_checkpoints_steps=RUN_SAVE_EVERY, save_summaries_steps=RUN_SAVE_EVERY,
            height_feature_extractor=h, width_feature_extractor=w, Nb=npp, Nb_per_pixel=npp,
            Nb_per_bbox=npb, Nb_per_image=npi)
        # the host input alone, one thread, as the loop's prefetcher runs it
        batches = train_input(settings.finalize(), load_problem_def(problem))
        next(batches)
        t0 = time.perf_counter()
        for _ in range(3):
            next(batches)
        input_ms = (time.perf_counter() - t0) / 3 * 1e3
        del batches

        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        SemanticSegmentation({"train": train_input}, settings=settings).train(
            max_steps=RUN_STEPS, log_every=1)
        first_s = time.perf_counter() - t0
        # a rerun on the same directory: the user moves settings.txt aside
        os.rename(os.path.join(log_dir, "settings.txt"), os.path.join(log_dir, "settings.0.txt"))
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            SemanticSegmentation({"train": train_input}, settings=settings).train(
                max_steps=RESUME_STEPS, log_every=1)
            resume_s = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
        launches = _counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        records = _read_jsonl(os.path.join(log_dir, "train_metrics.jsonl"))
        steps = [r["step"] for r in records]
        ckpts = sorted(int(d) for d in os.listdir(os.path.join(log_dir, "checkpoints")))
        tb = os.listdir(os.path.join(log_dir, "tb"))
        traces = sorted(os.listdir(os.path.join(log_dir, "profile")))
        want = {k: RESUME_STEPS for k in launches}
        log(f"train run: steps {steps}, checkpoints {ckpts}, tb {tb}, traces {traces}, "
            f"launches {launches}")
        problems = []
        if steps != list(range(1, RESUME_STEPS + 1)):
            problems.append(f"metrics steps {steps}: the rerun did not resume at {RUN_STEPS}")
        if not all(np.isfinite(v) for r in records for v in r.values()):
            problems.append("non-finite metrics")
        if ckpts != [3, 6, 8]:
            problems.append(f"checkpoints {ckpts}")
        if len(tb) != 2 or not all(t.startswith("events.out.tfevents.") for t in tb):
            problems.append(f"tb event files {tb}")
        if not set(os.listdir(log_dir)) >= {"settings.txt", "all_code.zip", "train_metrics.jsonl"}:
            problems.append(f"log dir holds {sorted(os.listdir(log_dir))}")
        if launches != want:
            problems.append(f"launches {launches}, expected one of each per step {want}")
        if problems:
            raise AssertionError("train run: " + "; ".join(problems))
        # per-step wall time from the loop's own records (it reads the
        # metrics back every step here); left out: the first step of each
        # run (warm-up) and each step the loop traced with torch.profiler
        # (every RUN_SAVE_EVERY steps, the reference's cadence)
        skipped = {1, RUN_STEPS + 1} | set(range(RUN_SAVE_EVERY + 1, RESUME_STEPS + 1,
                                                 RUN_SAVE_EVERY))
        step_ms = [images / r["images_per_sec"] * 1e3 for r in records
                   if r["step"] not in skipped]
        p50, p90 = _p50_p90(step_ms)
        stats = dict(steps=RESUME_STEPS, p50_ms=p50, p90_ms=p90, images_per_s=images / p50 * 1e3,
                     input_ms_per_batch=input_ms, device_busy_ms_per_step=step_busy_ms,
                     idle_share=1 - step_busy_ms / p50, peak_memory_gib=peak_gib,
                     first_run_s=first_s, resumed_run_s=resume_s,
                     host_waits_resumed_run=_waits_by_file(syncs), launches=launches,
                     last_total=records[-1]["total"])
        log("train run: " + json.dumps(stats))

        cli_dir = os.path.join(tmp, "cli")
        _reset_counts()
        cli_state = train_cli.main([cli_dir, "cityscapes", "--synthetic_data", "--height_feature_extractor",
                        "256", "--width_feature_extractor", "512", "--Nb_per_pixel", "1",
                        "--Nb_per_bbox", "2", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
                        "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
                        "--input_seed", "1"])
        cli_launches = _counts()
        cli_records = _read_jsonl(os.path.join(cli_dir, "train_metrics.jsonl"))
        listing = sorted(os.listdir(cli_dir))
        log(f"train cli: {listing}, records {cli_records}, launches {cli_launches}")
        if ([r["step"] for r in cli_records] != [2]
                or not os.path.isfile(os.path.join(cli_dir, "checkpoints", "2", "state.pt"))
                or not {"settings.txt", "all_code.zip", "tb"} <= set(listing)
                or cli_launches != {"fused_loss_fwd": 2, "fused_loss_bwd": 2, "fused_update": 2,
                                    "root_conv_wgrad": 0}):
            raise AssertionError(f"train cli: {listing} {cli_records} {cli_launches}")
        predict_from_run_phase(cli_dir, cli_state, problem)
    return launches


def predict_from_run_phase(log_dir, state, problem, device="cuda"):
    """``predict_cli`` on the checkpoint ``train_cli`` wrote in ``log_dir``
    (256x512, step 2), with and without ``--restore_emas``: the exports, and
    the predictions against those of a model holding the run's final
    weights (or their unbiased EMA shadows, taken from the optimizer state
    and the checkpoint's layout, not through the restore code)."""
    import os

    from PIL import Image

    from iv2019_tpu_torch import predict_cli
    from iv2019_tpu_torch.config import (PREDICT, build_argparser, resolve_dataset_name,
                                         resolve_trained_model, settings_from_args)
    from iv2019_tpu_torch.input.predict_input import predict_input
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.system import SemanticSegmentation

    img_dir = os.path.join(log_dir, "images")
    os.makedirs(img_dir)
    sizes = {"a": (256, 512), "b": (300, 400)}
    rng = np.random.RandomState(4)
    for stem, hw in sizes.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}.png"))
    lids = set(load_problem_def(problem).cids2lids)
    opt = state.opt_state
    raw = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    layout = torch.load(os.path.join(log_dir, "checkpoints", "2", "state.pt"),
                        weights_only=True)["layout"]
    ema = dict(raw)
    flat = opt.ema_biased / (1.0 - opt.ema_decay_product)
    for name, shape, stride, offset in layout:
        ema[name] = torch.as_strided(flat, shape, stride, offset)
    out = {}
    for flags, weights in (((), raw), (("--restore_emas",), ema)):
        results = os.path.join(log_dir, "predictions" + "".join(flags))
        argv = [log_dir, problem, img_dir, "--height_feature_extractor", "256",
                "--width_feature_extractor", "512", "--fused_block", "--export_lids_images",
                "--results_dir", results, "--device", str(device), *flags]
        n = predict_cli.main(argv)
        for stem, hw in sizes.items():
            with Image.open(os.path.join(results, f"{stem}_result_lids.png")) as im:
                got = np.asarray(im)
            if got.shape != hw or not set(np.unique(got).tolist()) <= lids:
                raise AssertionError(f"predict from the run {flags}: {stem} {got.shape}")
        # the same images through SemanticSegmentation.predict (the CLI's
        # path) and through a model that holds the weights
        args = build_argparser(PREDICT).parse_args(argv)
        settings = resolve_trained_model(resolve_dataset_name(
            settings_from_args(args, PREDICT, predict_keys=predict_cli.PREDICT_KEYS), None), argv)
        system = SemanticSegmentation({"predict": lambda s, _pd: predict_input(s)},
                                      model_fn=build_model, settings=settings)
        got = list(system.predict())
        model = build_model(system.settings)
        model.load_state_dict(weights)
        want = list(predict_cli.predict(system.settings, model))
        diff = max(float(np.abs(g[k] - w[k]).max()) for g, w in zip(got, want)
                   for k in ("l1_probabilities", "l2_vehicle_probabilities"))
        same = min(float((g["decisions"] == w["decisions"]).mean()) for g, w in zip(got, want))
        out["restore_emas" if flags else "weights"] = dict(
            images=n, max_abs_prob_diff=diff, decisions_equal=same)
        if n != len(sizes) or len(got) != len(sizes) or diff > 1e-6 or same < 0.9999:
            raise AssertionError(f"predict from the run {flags}: {n} images, "
                                 f"probabilities differ by {diff}, decisions equal {same}")
    log("predict from the train run's checkpoint: " + json.dumps(out))
    return out


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
    step_busy_ms = train_phase(device)
    torch.cuda.empty_cache()
    # the train path's kernels report the launches of this slice's main
    # path, the training run; the train phase's are printed above
    launches.update(train_run_phase(device, step_busy_ms))
    for r in results:
        r["launches"] = launches[r["name"]]
    log(f"chip_smoke: {time.time() - t0:.1f} s from the build to the end")
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

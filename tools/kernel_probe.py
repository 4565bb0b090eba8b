"""Probe of the port's fused-loss kernels (B1, B2), root-conv wgrad (B6),
train-mode BatchNorm (N1, N2) and eval-mode BatchNorm (N3) on one CUDA card.

    python3 tools/kernel_probe.py [--root TREE] [--quick] [--only b1|b2|b6|n1|n2|n3] [--step]
                                  [--jc N] [--ib N] [--xc N] [--yb N]

Imports ``iv2019_tpu_torch`` and ``chip_smoke`` from TREE (default: the
repository this file lies in), so two trees can be measured in turns on one
card, each in its own process. For each kernel it prints one JSON line:

- the check against the plain version at the flagship train-step shape and
  whether two launches on the same inputs are bit-equal;
- ``ms`` (CUDA events around calls queued back to back) and ``device_ms``
  (the same around replays of a CUDA graph of one call);
- the device time of each CUDA kernel of one call (torch.profiler);
- the static SASS instruction count of each of the library's kernels
  (``cuobjdump -sass`` on the built library), and what ``ptxas -v`` said.

Before the flagship shape each kernel is checked at a few small and ragged
ones (B1 also with label tensors that start 1-3 elements off 16 bytes).
``--quick`` stops after the checks (a first run of a new kernel); ``--jc``
and ``--ib`` time B2, ``--xc`` and ``--yb`` B1, with another chunk or band
size than its plan's.

N1 and N2 (``--only n1`` / ``--only n2``; neither runs without ``--only``)
go through the flagship train step's 12 distinct BatchNorm maps in bf16
(``chip_smoke.bn_shapes``): one line a map with the check against the plain
version, two runs bit for bit, ``ms``, ``device_ms``, the host's share,
``F.batch_norm``'s forward (or its backward alone) on the same input, the
device ms of a mesh's two launches on one rank (where the wrapper takes
``_split``), and the bounds of one pass and of two; then the
launch-weighted means over the step's 66 layers. Only the wrapper's call
signature is assumed, so an older tree measures with its own
``chip_smoke`` helpers. With ``--step`` (and
``--only n1``) it also takes step 1 of the flagship train step under
``bn_impl="fused"`` and prints its losses beside those of the f32 flax
step, and the share of N1's y, over the step's 66 norms, that differs from
the y of exactly rounded statistics (f64 mean and variance of the same x,
each rounded once to f32, then N1's f32 arithmetic): how far the kernel's
statistics stand from exact ones.

N3 (``--only n3``; not without it) goes through every eval-mode batch norm
of one forward of the two eval configurations the benchmark runs (Vistas
with PSP, 4 images at 918x1266; Cityscapes with the fused units, 8 at
512x1024), as the model calls it (the maps, the residual and the ReLU
recorded by a hook on each ``Norm``): one line a distinct call with the
check against the plain chain (largest ulps off, share of elements not bit
for bit), ``ms``, ``device_ms``, ``kernel_ms`` (the profiler's duration of
the kernel itself, the mean of 10 calls back to back: what a call costs
inside a step, where no launch gap sits between kernels), the plain
chain's ``plain_ms`` and ``bound_ms`` (x, y and any residual moved once at
the card's memory peak); then each configuration's sums over its forward
and the shares of the bound (of ``device_ms`` and of ``kernel_ms``). The
bounds are TREE's ``chip_smoke.least_ms`` (the card's memory peak from
``benchmark/counts.py``), null on a card that table lacks.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import re
import shutil
import subprocess
import sys


def sass_counts(lib_path):
    """{kernel name: instructions} from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[:200]}
    demangle = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    counts, name = collections.OrderedDict(), None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    try:
        names = subprocess.run([demangle, *counts], capture_output=True, text=True).stdout.split("\n")
        short = [re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((int|bool)\)|\(.*", "", n)
                 for n in names]
        return dict(zip(short, counts.values()))
    except OSError:
        return dict(counts)


def kernel_ms(fn, name, calls=10):
    """Mean device ms a call of the CUDA kernels whose names hold ``name``,
    over ``calls`` calls of ``fn`` queued back to back (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key) / 1e3 / calls


def kernel_times(fn):
    """Device time in ms of each CUDA kernel of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--jc", type=int, help="B2: stride-8 columns per chunk, in place of the plan's")
    ap.add_argument("--ib", type=int, help="B2: stride-8 rows per band, in place of the plan's")
    ap.add_argument("--xc", type=int, help="B1: output columns per chunk, in place of the plan's")
    ap.add_argument("--yb", type=int, help="B1: output rows per band, in place of the plan's")
    ap.add_argument("--step", action="store_true",
                    help="n1: step 1's losses and N1's y against exactly rounded statistics")
    ap.add_argument("--only", choices=["b1", "b2", "b6", "n1", "n2", "n3"],
                    help="one kernel (a fault in one launch ends the process, so a first run "
                    "probes each in its own)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as cs
    from iv2019_tpu_torch.ops import _build
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import root_wgrad as rw
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"tree {root}: {smi}", flush=True)
    for stem, report in _build.build_all().items():
        if stem in ("fused_loss", "root_wgrad", "fused_bn"):
            for line in report.splitlines():
                if any(k in line for k in ("registers", "spill", "entry function")) \
                        or "warning" in line.lower():
                    print(f"  {stem}: {line.strip()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.jc:
        fl._BWD_J_CHUNK = args.jc
    if args.ib:
        fl._BWD_I_BAND = args.ib
    if args.xc:
        fl._FWD_X_CHUNK = args.xc
    if args.yb:
        fl._FWD_Y_BAND = args.yb
    if args.only in (None, "b1"):
        probe_b1(args, cs, fl, _build, get_taxonomy)
    if args.only in (None, "b2"):
        probe_b2(args, cs, fl, _build, get_taxonomy)
    if args.only in (None, "b6"):
        probe_b6(args, cs, rw, _build)
    if args.only in ("n1", "n2"):
        probe_bn(args, cs, _build)
    if args.only == "n1" and args.step:
        probe_bn_step(cs)
    if args.only == "n3":
        probe_bn_eval(args, cs, _build)
    return 0


def probe_b1(args, cs, fl, _build, get_taxonomy):
    import numpy as np
    import torch

    tax = get_taxonomy("cityscapes")
    n_pp, n_weak = cs.TRAIN_NB[0], cs.TRAIN_NB[1] + cs.TRAIN_NB[2]
    in_hw, out_hw = (cs.TRAIN_HW[0] // 8, cs.TRAIN_HW[1] // 8), cs.TRAIN_HW
    largs = cs.loss_inputs(np.random.RandomState(3), tax, n_pp, n_weak, in_hw, out_hw, "cuda")
    g3 = torch.tensor([1 / 1e6, 0.1 / 1e6, 0.1 / 1e6], device="cuda")

    def fwd():
        return fl.fused_loss_fwd(*largs, tax=tax, out_hw=out_hw)

    small = [("cityscapes", 2, 2, (4, 8), (32, 64)), ("cityscapes", 0, 3, (5, 9), (37, 67)),
             ("vistas", 1, 2, (9, 16), (36, 64)), ("cityscapes", 2, 1, (6, 7), (6, 7)),
             ("vistas", 1, 1, (39, 54), (310, 427))]
    for dataset, npp, nweak, ihw, ohw in small:
        t = get_taxonomy(dataset)
        sargs = cs.loss_inputs(np.random.RandomState(0), t, npp, nweak, ihw, ohw, "cuda")
        variants = [("aligned", sargs)]
        if hasattr(cs, "unaligned_labels"):
            variants += [(f"labels {k} off", cs.unaligned_labels(sargs, k)) for k in (1, 2, 3)]
        for label, vargs in variants:
            c = cs.compare_loss(t, vargs, ohw, torch.tensor([0.5, 0.07, 0.11], device="cuda"))
            print(json.dumps(dict(kernel="fused_loss_fwd", shape=[dataset, npp, nweak, ihw, ohw],
                                  labels=label, ok=cs.loss_ok(c), sums_rel_err=c["sums_rel_err"],
                                  tap_decisions_equal=c.get("tap_decisions_equal"))), flush=True)
    check = cs.compare_loss(tax, largs, out_hw, g3)
    first, second = fwd(), fwd()
    torch.cuda.synchronize()
    row = dict(kernel="fused_loss_fwd", check=check, ok=cs.loss_ok(check),
               bit_equal=all(bool(torch.equal(a, b)) for a, b in zip(first, second)))
    del first, second
    if not args.quick:
        row.update(ms=cs.time_ms(fwd), device_ms=cs.device_ms(fwd), kernels_ms=kernel_times(fwd))
    row["sass"] = sass_counts(_build._library_path(_build.CSRC_DIR / "fused_loss.cu"))
    print(json.dumps(row), flush=True)


def probe_b2(args, cs, fl, _build, get_taxonomy):
    import numpy as np
    import torch

    tax = get_taxonomy("cityscapes")
    n_pp, n_weak = cs.TRAIN_NB[0], cs.TRAIN_NB[1] + cs.TRAIN_NB[2]
    in_hw, out_hw = (cs.TRAIN_HW[0] // 8, cs.TRAIN_HW[1] // 8), cs.TRAIN_HW
    largs = cs.loss_inputs(np.random.RandomState(3), tax, n_pp, n_weak, in_hw, out_hw, "cuda")
    g3 = torch.tensor([1 / 1e6, 0.1 / 1e6, 0.1 / 1e6], device="cuda")

    def bwd():
        return fl.fused_loss_bwd(g3, *largs, tax=tax, out_hw=out_hw)

    small = [("cityscapes", 2, 2, (4, 8), (32, 64)), ("cityscapes", 0, 3, (5, 9), (37, 67)),
             ("vistas", 1, 2, (9, 16), (36, 64)), ("cityscapes", 2, 1, (6, 7), (6, 7))]
    for dataset, npp, nweak, ihw, ohw in small:
        t = get_taxonomy(dataset)
        sargs = cs.loss_inputs(np.random.RandomState(0), t, npp, nweak, ihw, ohw, "cuda")
        c = cs.compare_loss(t, sargs, ohw, torch.tensor([0.5, 0.07, 0.11], device="cuda"))
        print(json.dumps(dict(kernel="fused_loss_bwd", shape=[dataset, npp, nweak, ihw, ohw],
                              ok=cs.loss_ok(c), grad_rel_err=c["grad_rel_err"])), flush=True)
    check = cs.compare_loss(tax, largs, out_hw, g3)
    first, second = bwd(), bwd()
    torch.cuda.synchronize()
    row = dict(kernel="fused_loss_bwd", check=check, ok=cs.loss_ok(check),
               bit_equal=all(bool(torch.equal(a, b)) for a, b in zip(first, second)))
    if not args.quick:
        row.update(ms=cs.time_ms(bwd), device_ms=cs.device_ms(bwd), kernels_ms=kernel_times(bwd),
                   fwd_ms=cs.time_ms(lambda: fl.fused_loss_fwd(*largs, tax=tax, out_hw=out_hw)))
    row["sass"] = sass_counts(_build._library_path(_build.CSRC_DIR / "fused_loss.cu"))
    print(json.dumps(row), flush=True)


def probe_b6(args, cs, rw, _build):
    import torch

    x_shape, cout, k = cs.WGRAD_SHAPE
    for shape, co, kk, cl in [((1, 3, 16, 256), 64, 7, True), ((2, 3, 36, 72), 64, 7, True),
                              ((2, 3, 20, 400), 64, 7, False), ((2, 3, 36, 70), 64, 7, True),
                              ((1, 2, 24, 40), 8, 5, False)]:
        print(json.dumps(dict(kernel="root_conv_wgrad", **cs.compare_wgrad(shape, co, kk, cl))),
              flush=True)
    check = cs.compare_wgrad(x_shape, cout, k, True)
    x, dy = cs.wgrad_inputs(x_shape, cout, k, True)

    def wgrad():
        return rw.root_conv_wgrad(x, dy, k, 2)

    first, second = wgrad(), wgrad()
    torch.cuda.synchronize()
    row = dict(kernel="root_conv_wgrad", check=check, ok=check["rel_err"] <= cs.WGRAD_REL_TOL,
               bit_equal=bool(torch.equal(first, second)))
    if not args.quick:
        w_shape = (cout, x_shape[1], k, k)
        row.update(ms=cs.time_ms(wgrad), device_ms=cs.device_ms(wgrad),
                   kernels_ms=kernel_times(wgrad),
                   cudnn_ms=cs.time_ms(lambda: torch.nn.grad.conv2d_weight(x, w_shape, dy, 2, 3)))
    row["sass"] = sass_counts(_build._library_path(_build.CSRC_DIR / "root_wgrad.cu"))
    print(json.dumps(row), flush=True)


def probe_bn(args, cs, _build):
    """N1 (``--only n1``) or N2 at the flagship step's 12 maps, bf16."""
    import torch
    import torch.nn.functional as F

    from iv2019_tpu_torch.ops import fused_bn as fbn

    backward = args.only == "n2"
    # a mesh's two launches on one rank, where the wrapper takes the switch
    # (the first version had only that path)
    two = "_split" in inspect.signature(fbn.fused_bn_fwd).parameters
    rows = []
    for seed, ((n, c, h, w), layers) in enumerate(cs.bn_shapes(torch.device("cuda"))):
        x, dy, scale, bias = cs.bn_inputs(n, c, h, w, torch.bfloat16, "cuda", seed)
        y, mean, var, rstd, count = fbn.fused_bn_fwd(x, scale, bias, cs.BN_EPS)
        if backward:
            def call(**split):
                return fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count, **split)

            xl = x.detach().requires_grad_(True)
            sl, bl = scale.detach().requires_grad_(True), bias.detach().requires_grad_(True)
            yl = F.batch_norm(xl, None, None, sl, bl, True, 0.0, cs.BN_EPS)

            def library():
                return torch.autograd.grad(yl, (xl, sl, bl), dy, retain_graph=True)

            want = fbn.batch_norm_backward_plain(x, dy, mean, rstd, scale, count)[0]
            isz_reads = 2
        else:
            def call(**split):
                return fbn.fused_bn_fwd(x, scale, bias, cs.BN_EPS, **split)

            def library():
                return F.batch_norm(x, None, None, scale, bias, True, 0.0, cs.BN_EPS)

            want = fbn.batch_norm_train_plain(x, scale, bias, cs.BN_EPS)[0]
            isz_reads = 1
        first, second = call(), call()
        torch.cuda.synchronize()
        ratio, err = cs._bn_out_err(first[0], want, torch.bfloat16)
        m = n * h * w
        elems = m * c * x.element_size()
        row = dict(kernel="N2" if backward else "N1", n=n, C=c, h=h, w=w, layers=layers,
                   ok=ratio <= 1, err_over_allowed=ratio, max_abs_err=err,
                   bit_equal=all(bool(torch.equal(a, b)) for a, b in zip(first, second)),
                   bound_ms=cs.least_ms((isz_reads + 1) * elems)[0],
                   two_pass_bound_ms=cs.least_ms((2 * isz_reads + 1) * elems)[0])
        del first, second, want
        if not args.quick:
            runs = 10 if m * c > 2 ** 26 else 20
            row.update(ms=cs.time_ms(call, runs=runs), device_ms=cs.device_ms(call, runs=runs),
                       library_ms=cs.time_ms(library, runs=runs))
            row["host_ms"] = row["ms"] - row["device_ms"]
            if two:
                row["split_device_ms"] = cs.device_ms(lambda: call(_split=True), runs=runs)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, dy, y, mean, var, rstd, count
        torch.cuda.empty_cache()
    weight = sum(r["layers"] for r in rows)
    summary = dict(kernel=rows[0]["kernel"], layers=weight, ok=all(r["ok"] for r in rows),
                   bit_equal=all(r["bit_equal"] for r in rows))
    for key in ("ms", "device_ms", "split_device_ms", "library_ms", "host_ms", "bound_ms",
                "two_pass_bound_ms"):
        if key in rows[0] and rows[0][key] is not None:
            summary[key] = sum(r[key] * r["layers"] for r in rows) / weight
    if "ms" in summary:
        summary["under_library"] = [r["ms"] <= r["library_ms"] for r in rows]
    summary["sass"] = sass_counts(_build._library_path(_build.CSRC_DIR / "fused_bn.cu"))
    print(json.dumps(summary), flush=True)


def probe_bn_step(cs):
    """Step 1 of the flagship train step with ``bn_impl="fused"`` (N1 in
    every norm) and of the f32 flax step, from the same seeded weights
    and batch: their losses, and the share of N1's outputs that differ from
    the bf16 y of exactly rounded statistics."""
    import numpy as np
    import torch

    from iv2019_tpu_torch.ops import fused_bn as fbn

    device = torch.device("cuda")
    settings = cs._train_settings(device, per_pixel_dataset_name="cityscapes", bn_impl="fused")
    batch = cs.train_batch(np.random.RandomState(0), device)
    kernel, shares = fbn.fused_bn_fwd, []

    def fused_bn_fwd(x, scale, bias, epsilon, mesh=None, **kw):
        out = kernel(x, scale, bias, epsilon, mesh, **kw)
        xd = x.double()
        mean = xd.mean((0, 2, 3))
        var = ((xd * xd).mean((0, 2, 3)) - mean * mean).clamp_min(0)
        rstd = torch.rsqrt(var + epsilon).float()
        exact = ((x.float() - mean.float()[:, None, None]) * (rstd * scale)[:, None, None]
                 + bias[:, None, None]).to(x.dtype)
        shares.append(float((out[0] != exact).float().mean()))
        return out

    fused_bn_fwd.launches = 0
    rows = {}
    for name, s in (("fused", settings),
                    ("f32", settings.replace(bn_impl="flax", compute_dtype="float32"))):
        fbn.fused_bn_fwd = fused_bn_fwd if name == "fused" else kernel
        try:
            _, step, holder = cs._fused_train(s)
            _, metrics = step(holder["state"], batch)
        finally:
            fbn.fused_bn_fwd = kernel
        rows[name] = cs._metrics(metrics)
        del step, holder
        torch.cuda.empty_cache()
    print(json.dumps(dict(kernel="N1 step 1", losses=rows, norms=len(shares),
                          y_off_exact_statistics=sum(shares) / len(shares),
                          y_off_exact_statistics_max=max(shares))), flush=True)


def probe_bn_eval(args, cs, _build):
    """N3 at every eval-mode batch norm call of the two eval cells' forwards."""
    import torch

    from iv2019_tpu_torch.ops import fused_bn as fbn

    for cell, fields in cs.N3_EVAL_CELLS:
        rows = []
        for seed, (((n, c, h, w), res, relu), calls) in enumerate(
                sorted(cs.eval_norm_calls(fields)[0].items())):
            gen = torch.Generator("cuda").manual_seed(seed)

            def draw():
                return torch.randn(n, h, w, c, generator=gen, device="cuda").to(
                    torch.bfloat16).permute(0, 3, 1, 2)

            x, r = draw(), draw() if res else None
            mean = torch.rand(c, generator=gen, device="cuda") - 0.5
            var = torch.rand(c, generator=gen, device="cuda") + 0.5
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            bias = torch.rand(c, generator=gen, device="cuda") - 0.5
            params = (mean, var, scale, bias, cs.BN_EPS, r, relu)

            def call():
                return fbn.fused_bn_eval(x, *params)

            def plain():
                return fbn.batch_norm_eval_plain(x, *params)

            got, want = call(), plain()
            torch.cuda.synchronize()
            ulps = cs.ulps_off(got, want)
            tensors = 3 if res else 2
            row = dict(kernel="N3", cell=cell, n=n, C=c, h=h, w=w, residual=res, relu=relu,
                       calls=calls, ulps_max=float(ulps.max()),
                       not_bitwise=float((got != want).float().mean()),
                       bound_ms=cs.least_ms(tensors * x.numel() * x.element_size())[0])
            del got, want
            if not args.quick:
                runs = 10 if x.numel() > 2 ** 26 else 30
                row.update(ms=cs.time_ms(call, runs=runs), device_ms=cs.device_ms(call, runs=runs),
                           kernel_ms=kernel_ms(call, "bn_eval_kernel"),
                           plain_ms=cs.time_ms(plain, runs=runs))
                if row["bound_ms"] is not None:
                    row["bound_share"] = row["bound_ms"] / row["device_ms"]
                    row["kernel_bound_share"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, r
            torch.cuda.empty_cache()
        summary = dict(kernel="N3", cell=cell, calls=sum(r["calls"] for r in rows),
                       ulps_max=max(r["ulps_max"] for r in rows),
                       not_bitwise_max=max(r["not_bitwise"] for r in rows))
        for key in ("ms", "device_ms", "kernel_ms", "plain_ms", "bound_ms"):
            if key in rows[0] and rows[0][key] is not None:
                summary[key + "_forward"] = sum(r[key] * r["calls"] for r in rows)
        if "device_ms_forward" in summary and "bound_ms_forward" in summary:
            summary["bound_share"] = summary["bound_ms_forward"] / summary["device_ms_forward"]
            summary["kernel_bound_share"] = (summary["bound_ms_forward"]
                                             / summary["kernel_ms_forward"])
        summary["sass"] = sass_counts(_build._library_path(_build.CSRC_DIR / "fused_bn.cu"))
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    sys.exit(main())

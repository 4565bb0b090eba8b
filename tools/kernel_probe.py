"""Probe of the port's fused-loss kernels (B1, B2) and root-conv wgrad (B6) on one CUDA card.

    python3 tools/kernel_probe.py [--root TREE] [--quick] [--only b1|b2|b6] [--jc N] [--ib N]
                                  [--xc N] [--yb N]

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
"""

from __future__ import annotations

import argparse
import collections
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
    ap.add_argument("--only", choices=["b1", "b2", "b6"], help="one kernel (a fault in one launch "
                    "ends the process, so a first run probes each in its own)")
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
        if stem in ("fused_loss", "root_wgrad"):
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


if __name__ == "__main__":
    sys.exit(main())

"""The ``infer`` kind: the program's evaluation step, back to back.

Set-up paints the mix's pool of batches from the seed, draws the weights
(running statistics calibrated on two images of the first batch by the
reference's train-mode forward; with the mix's ``steer_heads``, the heads
steered on the first batch so that the vehicle and human heads decide,
``weights.steer``), builds the step as the evaluation command
line does (``make_eval_step``; ``fused_block`` as the mix says) and runs
it once on every batch. The window cycles the pool, adding each step's
confusion matrix on the device, and reads the sum back once, at its end;
the rate is every image of the window's steps over the window.

After the window (and the profiled steps, when tracing), the program is
freed; the reference evaluates each batch of the pool in float32 without
TF32, and the matrix the window produced is held to the reference's
matrices, each counted as many times as the window ran its batch (and,
where the cell's limits name ``decision_gap_vs_bf16``, to the same
reference's with bfloat16 rounding). The numbers compared are those that
the limits file names.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark import compare, program, scenes, trace, weights
from benchmark.harness import Run, device_name, sync, trace_steps
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

RATE_METRIC = "infer_img_per_s"
CALIBRATION_IMAGES = 2


def inputs(ctx):
    """(program settings, weights, pool) of the run's seed."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s = program.settings(cfg, mix, dev, "eval", ctx.problem_path)
    pool = scenes.eval_pool(mix, ctx.problem, cfg["dataset"], ctx.seed, dev)
    with ref_model.strict_float32():
        w = weights.draw(cfg, ctx.seed, dev, calibrate=pool[0][0][:CALIBRATION_IMAGES])
        if "steer_heads" in mix:
            w = weights.steer(w, cfg, pool[0][0], mix["steer_heads"])
    return s, w, pool


def reference_matrices(w: dict, pool: list, cfg: dict, problem: dict, rnd=None) -> list:
    """The reference's confusion matrix of each batch of the pool (CPU)."""
    with ref_model.strict_float32():
        return [ref_steps.confusion(w, images, labels, cfg, problem, rnd=rnd).cpu()
                for images, labels in pool]


def run(ctx) -> Run:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s, w, pool = inputs(ctx)
    model, step = program.eval_step(s, w)
    for images, labels in pool:
        step(images, labels)
    sync(dev)

    ctx.end_setup()
    runs = [0] * len(pool)
    steps, total, t0 = 0, None, time.perf_counter()
    while True:
        i = steps % len(pool)
        cm = step(*pool[i])
        total = cm if total is None else total + cm
        runs[i] += 1
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    total = total.cpu()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    traced = shaped = None
    if ctx.trace and dev.type == "cuda":
        def run_steps(n):
            for j in range(n):
                step(*pool[j % len(pool)])

        traced = trace.capture(run_steps, trace_steps(steps, window_s))
        shaped = trace.capture(run_steps, 1, record_shapes=True)

    del model, step, cm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = sum(n * m for n, m in zip(runs, reference_matrices(w, pool, cfg, ctx.problem)))
    rounded = None
    if "decision_gap_vs_bf16" in ctx.limits:
        rounded = sum(n * m for n, m in zip(runs, reference_matrices(
            w, pool, cfg, ctx.problem, rnd=ref_model.rounding("bfloat16"))))
    print(f"benchmark: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    gaps = compare.confusion_gaps(total, expected, rounded)
    for name, (gap, where) in gaps.items():
        print(f"benchmark: {name} {gap!r}" + (f" (bf16 {where!r})" if where else ""),
              file=sys.stderr)
    return Run(kind="infer", config=cfg, mix=mix, steps=steps, images=steps * mix["images"],
               window_s=window_s, memory_peak_bytes=peak,
               checks=[(k, gaps[k][0], limit) for k, limit in ctx.limits.items()],
               device_name=device_name(dev),
               trace=traced, shape_trace=shaped)

"""The ``train`` kind: the program's training step, back to back.

Set-up draws the weights and paints the mix's pool of batches from the
seed, builds the step as the training command line does (``FusedSGDM``,
``make_train_step``) and drives it through its first two steps, on
batches 0 and 1 of the pool: the first step's loss, the first gradient
(from the optimizer's momentum after one step, less the weight decay's
share) and the parameters' change over the two are read for the
comparison; steps on the pool's other batches leave every batch seen. The same step object then runs
the window, cycling the pool; the rate is every image the window's steps
took over the window, which ends when the device has finished them.

After the window (and the profiled steps, when tracing), the program is
freed and the reference takes the same two steps from the same weights on
the same batches in float32 without TF32. Two steps and not three keep the
reference inside the window's length: three took 12.2-14.3 s on the H100
against a 10 s window.
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

RATE_METRIC = "train_img_per_s"
CHECKED_STEPS = 2


def inputs(ctx):
    """(program settings, weights, pool) of the run's seed."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s = program.settings(cfg, mix, dev, "train", ctx.problem_path)
    w0 = weights.draw(cfg, ctx.seed, dev)
    return s, w0, scenes.train_pool(mix, ctx.problem, cfg["dataset"], ctx.seed, dev)


def _losses(metrics: dict) -> dict:
    return {k: float(metrics[k]) for k in compare.LOSS_KEYS}


def first_steps(built, pool: list, w0: dict, cfg: dict):
    """Drive the program's step through the checked steps; returns its
    state and readings (losses a step, first gradient and change by leaf)."""
    model, opt, state, step = built
    losses = []
    state, metrics = step(state, pool[0])
    losses.append(_losses(metrics))
    grads = {}
    for name, shape, stride, offset in opt.layout:
        m = torch.as_strided(state.opt_state.momentum, shape, stride, offset)
        grads[name] = m - cfg["weight_decay"] * w0[name] if name.endswith(".weight") else m
    grads = compare.leaf_norms(grads)
    for b in range(1, CHECKED_STEPS):
        state, metrics = step(state, pool[b])
        losses.append(_losses(metrics))
    deltas = compare.leaf_norms({n: p - w0[n] for n, p in model.named_parameters()})
    return state, (losses, grads, deltas)


def reference_readings(w0: dict, pool: list, cfg: dict, rnd=None):
    """The reference's (losses a step, first gradient and change by leaf)."""
    with ref_model.strict_float32():
        ref = ref_steps.train_steps(w0, pool[:CHECKED_STEPS], cfg, rnd=rnd)
    return (ref["losses"], compare.leaf_norms(ref["first_grads"]),
            compare.leaf_norms({n: p - w0[n] for n, p in ref["params"].items()}))


def run(ctx) -> Run:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s, w0, pool = inputs(ctx)
    built = program.train_step(s, w0)
    step = built[3]
    state, readings = first_steps(built, pool, w0, cfg)
    for b in range(CHECKED_STEPS, len(pool)):
        state, _ = step(state, pool[b])
    sync(dev)

    ctx.end_setup()
    steps, t0 = 0, time.perf_counter()
    while True:
        state, _ = step(state, pool[steps % len(pool)])
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    traced = None
    if ctx.trace and dev.type == "cuda":
        holder = {"state": state}

        def run_steps(n):
            for i in range(n):
                holder["state"], _ = step(holder["state"], pool[i % len(pool)])

        traced = trace.capture(run_steps, trace_steps(steps, window_s))
        del holder

    del built, state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = compare.train_gaps(*readings, *reference_readings(w0, pool, cfg),
                              cfg["weak_loss_coefficient"])
    print(f"benchmark: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for name, (gap, where) in gaps.items():
        print(f"benchmark: {name} {gap!r} at {where}", file=sys.stderr)
    n_img = mix["per_pixel"] + mix["per_bbox"] + mix["per_image"]
    return Run(kind="train", config=cfg, mix=mix, steps=steps, images=steps * n_img,
               window_s=window_s, memory_peak_bytes=peak,
               checks=[(k, gaps[k][0], ctx.limits[k]) for k in ("loss_gap", "grad_gap",
                                                                "delta_gap")],
               device_name=device_name(dev),
               trace=traced)

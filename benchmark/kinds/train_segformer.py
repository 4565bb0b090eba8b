"""The ``train_segformer`` kind: the program's training step of a
``segformer_*`` configuration, back to back.

As the ``train`` kind (``kinds/train.py``), whose ``first_steps`` it reuses:
set-up draws the weights (``weights_segformer.py``), builds the step as the
training command line does (``FusedSGDM``, ``make_train_step``, through
``program.py``), paints the mix's pool, and drives the step through its
first two steps on batches 0 and 1, reading the first step's loss, the
first gradient and the parameters' change over the two; the same step then
runs the window, cycling the pool. The program's ``random_seed`` is the
run's seed (below 2^31), which seeds the stochastic-depth and dropout masks
of each step (``mask_seed(random_seed, step)``).

The weights are drawn and the step is built before the pool is painted, so
a program that cannot build the configuration stops within seconds.

After the window (and the profiled steps), the program is freed and the
reference (``reference/segformer.py``) takes the same two steps from the
same weights, on the same batches, with the same masks, in float32 without
TF32, math attention image by image and its blocks, decoder and heads
recomputed in the backward.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark import compare, program, scenes, trace, weights_segformer
from benchmark.harness import Run, device_name, sync, trace_steps
from benchmark.kinds import train
from benchmark.reference import model as ref_model
from benchmark.reference import segformer as ref

RATE_METRIC = "train_img_per_s"


def settings(ctx):
    """The program's Settings: the configuration's, with the run's seed."""
    s = program.settings(ctx.config, ctx.mix, ctx.device, "train", ctx.problem_path)
    return s.replace(random_seed=random_seed(ctx.seed))


def random_seed(seed: int) -> int:
    return int(seed) % (1 << 31)


def reference_readings(w0: dict, pool: list, cfg: dict, seed: int, rnd=None):
    """The reference's (losses a step, first gradient and change by leaf)."""
    with ref_model.strict_float32():
        out = ref.train_steps(w0, pool[:train.CHECKED_STEPS], cfg, random_seed(seed), rnd=rnd)
    return (out["losses"], compare.leaf_norms(out["first_grads"]),
            compare.leaf_norms({n: p - w0[n] for n, p in out["params"].items()}))


def run(ctx) -> Run:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s = settings(ctx)
    w0 = weights_segformer.draw(cfg, ctx.seed, dev)
    built = program.train_step(s, w0)
    step = built[3]
    pool = scenes.train_pool(mix, ctx.problem, cfg["dataset"], ctx.seed, dev)
    state, readings = train.first_steps(built, pool, w0, cfg)
    for b in range(train.CHECKED_STEPS, len(pool)):
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
    gaps = compare.train_gaps(*readings, *reference_readings(w0, pool, cfg, ctx.seed),
                              cfg["weak_loss_coefficient"])
    print(f"benchmark: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for name, (gap, where) in gaps.items():
        print(f"benchmark: {name} {gap!r} at {where}", file=sys.stderr)
    n_img = mix["per_pixel"] + mix["per_bbox"] + mix["per_image"]
    return Run(kind="train", config=cfg, mix=mix, steps=steps, images=steps * n_img,
               window_s=window_s, memory_peak_bytes=peak,
               checks=[(k, gaps[k][0], ctx.limits[k]) for k in ("loss_gap", "grad_gap",
                                                                "delta_gap")],
               device_name=device_name(dev), trace=traced)

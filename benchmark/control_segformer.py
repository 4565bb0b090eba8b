"""The readings that the limits of a ``train_segformer`` cell are set from,
over many seeds in one process (``benchmark/control.py`` for this kind).

    python3 -m benchmark.control_segformer --workload train.segformer_b5 \
        --seeds 1,2,... [--control-seeds 7,8] [--out FILE]

For each seed of ``--seeds``: the program's numbers against the float32
reference. For each of ``--control-seeds``: the control, the reference
computed in float8 (e4m3 forward, e5m2 gradients, per-tensor scales) in the
program's place, and the faults planted in the reference in the program's
place: ``half_batch`` (each sub-batch's first half), ``gate_dropped`` (the
weak images' L1 decisions read as vehicle everywhere), ``scale_dropped``
(the attention's scores without their d^-1/2); ``state_unchanged`` reads 1
by the leaf gap's measure and is written without a run.

One JSON line a reading on standard output, and in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from benchmark import compare, harness, program, scenes, weights_segformer
from benchmark.control import _emit, _free, _gaps, _spread
from benchmark.kinds import train, train_segformer
from benchmark.reference import model as ref_model
from benchmark.reference import segformer as ref
from benchmark.reference import steps as ref_steps


def _faults(w0, pool, cfg, seed, want):
    half = [{k: v[:max(1, v.shape[0] // 2)] for k, v in b.items()} for b in pool]
    yield "half_batch", train_segformer.reference_readings(w0, half, cfg, seed)
    losses, vehicle = ref_steps.losses, cfg["hierarchy"]["cid_l1_vehicle"]
    n_pp = pool[0]["prolabels_per_pixel"].shape[0]

    def gate_dropped(up, per_pixel, weak, c):
        l1 = up[0].clone()
        l1[n_pp:, vehicle] += 100.0
        return losses([l1, up[1], up[2]], per_pixel, weak, c)

    ref_steps.losses = gate_dropped
    try:
        yield "gate_dropped", train_segformer.reference_readings(w0, pool, cfg, seed)
    finally:
        ref_steps.losses = losses
    scale = ref.SCORE_SCALE
    ref.SCORE_SCALE = lambda d: 1.0
    try:
        yield "scale_dropped", train_segformer.reference_readings(w0, pool, cfg, seed)
    finally:
        ref.SCORE_SCALE = scale
    yield "state_unchanged", (want[0], want[1], {k: 0.0 for k in want[2]})


def readings(workload: str, seed: int, device, program_side: bool, control_side: bool,
             overrides=None):
    """Yield (side, gaps, detail or None) for one seed."""
    ctx = harness.build_context(workload, seed, 0.0, False, device, overrides=overrides)
    cfg = ctx.config
    coefficient = cfg["weak_loss_coefficient"]
    w0 = weights_segformer.draw(cfg, seed, device)
    pool = scenes.train_pool(ctx.mix, ctx.problem, cfg["dataset"], seed, device)
    if program_side:
        built = program.train_step(train_segformer.settings(ctx), w0)
        _, prog = train.first_steps(built, pool, w0, cfg)
        del built
        _free(device)
    want = train_segformer.reference_readings(w0, pool, cfg, seed)
    if program_side:
        yield "program", compare.train_gaps(*prog, *want, coefficient), \
            _spread(prog, want, coefficient)
    if control_side:
        control = train_segformer.reference_readings(w0, pool, cfg, seed,
                                                     rnd=ref_model.rounding("float8"))
        yield "float8", compare.train_gaps(*control, *want, coefficient), \
            _spread(control, want, coefficient)
        for name, fault in _faults(w0, pool, cfg, seed, want):
            yield name, compare.train_gaps(*fault, *want, coefficient), None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control_segformer")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("benchmark.control_segformer: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = [int(x) for x in args.control_seeds.split(",") if x]
    for seed in dict.fromkeys(seeds + control):
        for side, gaps, detail in readings(args.workload, seed, device, seed in seeds,
                                           seed in control):
            _emit(args.out, {"workload": args.workload, "seed": seed, "side": side,
                             "gaps": _gaps(gaps), "detail": detail})
        _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

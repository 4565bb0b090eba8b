"""The readings the limits of ``correct`` are set from, over many seeds in
one process (the timed window plays no part in them).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out FILE]

For each seed of ``--seeds``: the program's numbers against the float32
reference (the lower readings), and where the seed is a control seed too,
a second run of the program against the first. For each of
``--control-seeds``: the
control, the reference computed in float8 (e4m3 forward, e5m2 gradients,
per-tensor scales) in the program's place, and the faults a cell can have,
planted in the reference in the program's place:

- train: ``half_batch`` (each sub-batch's first half, its mean over those),
  ``gate_dropped`` (the weak images' L1 decisions read as vehicle
  everywhere, so the vehicle head's decision gate never closes);
  ``state_unchanged`` (the parameters never move) reads 1 by the leaf gap's
  measure and is written without a run;
- infer: ``half_batch`` (each batch's first half counted twice),
  ``fusion_skipped`` (the L1 decision's common class where the vehicle or
  human head should decide), ``state_unchanged`` (the window's matrix never
  grows: every count missing). The program's line carries the shares of
  the first batch's stride-8 pixels on which the reference's L1 head picks
  the vehicle and the human metaclass, where their heads decide.

One JSON line a reading on standard output, and in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys

import torch

from benchmark import compare, harness, program
from benchmark.kinds import infer, train
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps


def _emit(out, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _gaps(gaps: dict) -> dict:
    return {k: [v, str(where)] for k, (v, where) in gaps.items()}


def _spread(side, ref, coefficient) -> dict:
    """Each step's loss gap and the quartiles, 90th percentile and worst
    three leaves of both leaf gaps: where a number's noise comes from."""
    out = {"step_loss_gaps": [
        abs(compare.step_loss(p, coefficient) - compare.step_loss(r, coefficient))
        / abs(compare.step_loss(r, coefficient)) for p, r in zip(side[0], ref[0])]}
    keep = compare.kept_leaves(ref[1])
    for name, got, want in (("grad", side[1], ref[1]), ("delta", side[2], ref[2])):
        med = statistics.median(want.values())
        gaps = sorted(((abs(got[k] - want[k]) / max(want[k], med), k) for k in keep),
                      reverse=True)
        values = [g for g, _ in gaps]
        out[name] = {"quartiles": statistics.quantiles(values, n=4),
                     "p90": values[len(values) // 10], "worst": gaps[:3],
                     "leaves": {k: g for g, k in gaps}}
    return out


def _train_faults(w0, pool, cfg, ref):
    n_pp = pool[0]["prolabels_per_pixel"].shape[0]
    half = [{k: v[:max(1, v.shape[0] // 2)] for k, v in b.items()} for b in pool]
    yield "half_batch", train.reference_readings(w0, half, cfg)
    losses = ref_steps.losses
    vehicle = cfg["hierarchy"]["cid_l1_vehicle"]

    def gate_dropped(up, per_pixel, weak, c):
        l1 = up[0].clone()
        l1[n_pp:, vehicle] += 100.0
        return losses([l1, up[1], up[2]], per_pixel, weak, c)

    ref_steps.losses = gate_dropped
    try:
        yield "gate_dropped", train.reference_readings(w0, pool, cfg)
    finally:
        ref_steps.losses = losses
    yield "state_unchanged", (ref[0], ref[1], {k: 0.0 for k in ref[2]})


def _infer_faults(w, pool, cfg, problem):
    half = [(img[:img.shape[0] // 2], lab[:lab.shape[0] // 2]) for img, lab in pool]
    yield "half_batch", [2 * m for m in infer.reference_matrices(w, half, cfg, problem)]
    decisions = ref_steps.decisions

    def fusion_skipped(up, hier):
        l1 = torch.argmax(up[0], 1)
        return torch.as_tensor(hier["l1_cids2common_cids"], device=l1.device)[l1]

    ref_steps.decisions = fusion_skipped
    try:
        yield "fusion_skipped", infer.reference_matrices(w, pool, cfg, problem)
    finally:
        ref_steps.decisions = decisions
    yield "state_unchanged", None


def _metaclass_shares(w: dict, images: torch.Tensor, cfg: dict) -> dict:
    hier = cfg["hierarchy"]
    with torch.no_grad(), ref_model.strict_float32():
        l1 = torch.cat([torch.argmax(ref_model.forward(w, images[i:i + 2], cfg, train=False)[0], 1)
                        for i in range(0, images.shape[0], 2)])
    return {head: float((l1 == hier[f"cid_l1_{head}"]).float().mean())
            for head in ("vehicle", "human")}


def readings(workload: str, seed: int, device, program_side: bool, control_side: bool,
             overrides=None):
    """Yield (side, gaps, detail or None) for one seed."""
    ctx = harness.build_context(workload, seed, 0.0, False, device, overrides=overrides)
    cfg = ctx.config
    if ctx.mix["kind"] == "train":
        s, w0, pool = train.inputs(ctx)
        coefficient = cfg["weak_loss_coefficient"]
        ref = train.reference_readings(w0, pool, cfg)
        if program_side:
            built = program.train_step(s, w0)
            _, prog = train.first_steps(built, pool, w0, cfg)
            del built
            _free(device)
            yield "program", compare.train_gaps(*prog, *ref, coefficient), \
                _spread(prog, ref, coefficient)
            if control_side:
                # the program against itself: a second run on the same inputs
                built = program.train_step(s, w0)
                _, again = train.first_steps(built, pool, w0, cfg)
                del built
                _free(device)
                yield "program_again", compare.train_gaps(*again, *prog, coefficient), \
                    _spread(again, prog, coefficient)
        if control_side:
            control = train.reference_readings(w0, pool, cfg, rnd=ref_model.rounding("float8"))
            yield "float8", compare.train_gaps(*control, *ref, coefficient), \
                _spread(control, ref, coefficient)
            for name, fault in _train_faults(w0, pool, cfg, ref):
                yield name, compare.train_gaps(*fault, *ref, coefficient), None
        return
    s, w, pool = infer.inputs(ctx)
    ref = infer.reference_matrices(w, pool, cfg, ctx.problem)
    expected = sum(ref)
    rounded = sum(infer.reference_matrices(w, pool, cfg, ctx.problem,
                                           rnd=ref_model.rounding("bfloat16")))
    if program_side:
        _, step = program.eval_step(s, w)
        got = sum(step(images, labels).cpu() for images, labels in pool)
        del step
        _free(device)
        yield "program", compare.confusion_gaps(got, expected, rounded), \
            {"metaclass_shares": _metaclass_shares(w, pool[0][0], cfg)}
    if control_side:
        control = infer.reference_matrices(w, pool, cfg, ctx.problem,
                                           rnd=ref_model.rounding("float8"))
        yield "float8", compare.confusion_gaps(sum(control), expected, rounded), None
        for name, fault in _infer_faults(w, pool, cfg, ctx.problem):
            got = torch.zeros_like(expected) if fault is None else sum(fault)
            yield name, compare.confusion_gaps(got, expected, rounded), None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
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

"""Two checks of the data-parallel path on one CUDA card.

    python3 tools/probe_multirank.py

1. The power of ``chip_smoke.py`` phase 11(b)'s f32 gradient bar. Step 1
   of the full-width train cell in f32 (4 + 8 + 4 images at 512x1024, two
   gloo ranks sharing the card, 2 + 4 + 2 each) is held against the
   single-process step on the global batch, under ``BAR_FACTOR`` times what
   reversing the rows of each sub-batch does to that step. The probe runs
   the ranks twice: as they are, and with a planted fault that touches only
   the gradient, BatchNorm's backward taking this rank's (sum dy, sum dy
   xhat) and row count instead of the all-reduced ones (the forward stays
   global, so the losses do not move). Prints each relative distance beside
   the bar, over the whole flat gradient and for each parameter alone (the
   largest ratios to the permutation's distance, under floors of 1e-6,
   1e-5, 1e-4); writes every parameter's distances to
   ``chiprun_out/probe_multirank_tensors.json``.
2. The bootstrapped loss's threshold, the k-th largest valid loss: one
   ``torch.sort`` of the masked losses against ``kth_largest``'s radix
   select (four 256-bin histograms), with no mesh, on random losses of
   4 x 512 x 1024 (the train cell's per-pixel rows) and 16 x 512 x 1024,
   70% of them valid, p = 30. Both must give the same threshold; medians of
   CUDA events over 20 calls after 3 warm-ups.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _plant_local_bn_backward():
    """BatchNorm's backward on this rank's rows alone: the fault."""
    from iv2019_tpu_torch.models import layers

    def backward(ctx, dy, _dmean, _dvar):
        xhat, scale, rstd, _count = ctx.saved_tensors
        dims = (0, 2, 3)
        dbias = dy.sum(dims)
        dscale = (dy * xhat).sum(dims)
        local = dy.numel() // dy.shape[1]
        dx = (dy - (dbias / local)[:, None, None] - xhat * (dscale / local)[:, None, None]) \
            * (scale * rstd)[:, None, None]
        return dx, dscale, dbias, None, None

    layers._GlobalBatchNorm.backward = staticmethod(backward)


def _rank(rank, port, path, fault):
    """One of the two gloo ranks: step 1 in f32 on its rows."""
    import chip_smoke as cs
    from iv2019_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if fault:
        _plant_local_bn_backward()
    settings = cs._train_settings_full(num_processes=cs.RANKS, process_id=rank, num_devices=1,
                                       coordinator_address=f"localhost:{port}")
    mesh = multihost.initialize(settings, backend="gloo")
    try:
        batch = multihost.put_sharded(
            cs.train_batch(np.random.RandomState(0), torch.device("cpu")), mesh)
        opt, state, step = cs._fused_run(settings.replace(compute_dtype="float32"), mesh)
        _, m = step(state, batch)
        if rank == 0:
            torch.save({"grads": opt.grads.detach().cpu(), "metrics": cs._metrics(m),
                        "layout": opt.layout}, path)
    finally:
        multihost.shutdown()


def bar_power(tmp):
    import chip_smoke as cs
    from iv2019_tpu_torch.parallel.multihost import free_port

    settings = cs._train_settings_full().replace(compute_dtype="float32")
    batch = cs.train_batch(np.random.RandomState(0), torch.device("cuda"))
    permuted = {k: torch.flip(v, dims=(0,)) for k, v in batch.items()}
    ref = {}
    for name, b in (("global", batch), ("permuted", permuted)):
        opt, state, step = cs._fused_run(settings)
        _, m = step(state, b)
        ref[name] = (cs._metrics(m), opt.grads.detach().cpu().clone())
        del opt, state, step, m
        torch.cuda.empty_cache()
    del batch, permuted
    torch.cuda.empty_cache()
    want_m, want_g = ref["global"]
    permuted = cs._rel_norm(ref["permuted"][1], want_g)
    out = {"permuted": permuted, "bar_factor": cs.BAR_FACTOR,
           "bar": cs.BAR_FACTOR * max(permuted, 1e-7)}
    tensors = {}
    for fault in (False, True):
        path = os.path.join(tmp, f"probe_rank0_{int(fault)}.pt")
        cs._spawn_ranks(_rank, (free_port(), path, fault), "probe ranks")
        got = torch.load(path, weights_only=False)
        name = "local_batchnorm_backward" if fault else "as_is"
        out[name] = {"grad_rel_norm": cs._rel_norm(got["grads"], want_g),
                     "total": got["metrics"]["total"], "single_total": want_m["total"]}
        # each parameter's gradient alone: its distance against what the
        # permutation does to it
        for pname, shape, _, offset in got["layout"]:
            n = int(np.prod(shape))
            part = slice(offset, offset + n)
            row = tensors.setdefault(pname, {"numel": n, "permuted": cs._rel_norm(
                ref["permuted"][1][part], want_g[part])})
            row[name] = cs._rel_norm(got["grads"][part], want_g[part])
    for name in ("as_is", "local_batchnorm_backward"):
        for floor in (1e-6, 1e-5, 1e-4):
            ratios = {k: v[name] / max(v["permuted"], floor) for k, v in tensors.items()}
            worst = sorted(ratios, key=ratios.get, reverse=True)[:5]
            out[name][f"max_ratio_floor_{floor:g}"] = {k: [ratios[k], tensors[k]]
                                                      for k in worst}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_multirank_tensors.json"), "w") as f:
        json.dump(tensors, f)
    return out


def _median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def select_times():
    from iv2019_tpu_torch.losses.hierarchical import kth_largest

    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for n in (4, 16):
        raw = torch.rand((n, 512, 1024), generator=gen, device="cuda") * 5.0
        valid = torch.rand((n, 512, 1024), generator=gen, device="cuda") < 0.7
        masked = torch.where(valid, raw, torch.finfo(torch.float32).min).reshape(-1)
        k = torch.clamp(valid.sum(dtype=torch.int64) * 30 // 100, min=1)

        def by_sort():
            return torch.sort(masked, descending=True).values[k - 1]

        def by_radix():
            return kth_largest(masked, k)

        equal = bool(by_sort() == by_radix())
        out[f"{n}x512x1024"] = {"sort_ms": _median_ms(by_sort),
                                "kth_largest_ms": _median_ms(by_radix), "equal": equal}
    return out


def main():
    if not torch.cuda.is_available():
        print("probe_multirank: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from iv2019_tpu_torch.ops import _build

    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"select": select_times()}
    with tempfile.TemporaryDirectory() as tmp:
        result["bar"] = bar_power(tmp)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

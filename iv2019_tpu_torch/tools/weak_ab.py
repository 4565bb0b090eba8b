"""Seeded weak-supervision A/B on object-scarce per-pixel data.

Port of tools/weak_ab.py, on the port's CLIs. The paper's mechanism, weak
bbox and image-level supervision boosting a segmentation model, targets the
regime where the per-pixel set undercovers the object classes (OpenImages
adds classes and instances the dense sets lack). This runner creates that
regime and measures it with seeds:

- per-pixel train scenes generated with ``--rate`` (default 0.2: ~80% of
  cars, buses and persons removed, so objects are scarce in the dense
  labels), by ``iv2019_tpu_torch.tools.synthetic_scenes.generate``;
- the weak set (bboxes + image labels) and the val set at the full object
  rate;
- arms: per-pixel only (Nb 4/0/0: the unfused loss, kernel B3) against
  + weak (Nb 4/8/4: kernels B1, B2, B3), same schedule, each trained by
  ``python -m iv2019_tpu_torch.train_cli`` and evaluated by
  ``python -m iv2019_tpu_torch.evaluate_cli`` in a process of its own;
- N seeds per arm (--random_seed = model init, --input_seed = shuffles);
- per-class and mean IoU as mean +/- std across seeds, and the paired
  per-seed deltas.

``_state_key``, ``_cfg_tag``, ``_sanitize``, ``_load_state``, ``run_arm``
and the state file's lines are the JAX tool's, so each tool reads the
other's files; but seeded torch initial weights are not flax's, so the
port's sweep records to a file of its own (``docs/torch_weak_ab_arms.jsonl``)
and refuses the JAX package's ``docs/weak_ab_arms.jsonl``.

Usage: python -m iv2019_tpu_torch.tools.weak_ab WORKDIR [--seeds 3]
           [--rate 0.2] [--n_pp 24] [--n_weak 256] [--n_val 48] [--ne 48]
           [--coeff 0.1] [--state docs/torch_weak_ab_arms.jsonl]
           [--ema_evals] [--device cuda|cpu]
Writes WORKDIR/weak_ab.json and prints a markdown table. Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBLEM = os.path.join(
    REPO, "iv2019_tpu_torch", "problem_definitions", "cityscapes", "problem01.json"
)
SIZE = ["--height_feature_extractor", "128", "--width_feature_extractor", "256"]
# the JAX package's record of its own sweep (flax initial weights)
JAX_STATE = os.path.join(REPO, "docs", "weak_ab_arms.jsonl")


def check_state_path(path, jax_state=JAX_STATE):
    """Refuse to record the port's arms into the JAX package's state file."""
    if path and os.path.realpath(path) == os.path.realpath(jax_state):
        raise SystemExit(f"{path} records the JAX package's arms; give the port's sweep "
                         "its own --state file (docs/torch_weak_ab_arms.jsonl)")


def _run(module, args, timeout=3600):
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"{module} {' '.join(args[:3])} failed\n"
            f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
        )
    return proc


def save_every(n_train, ne, nb=4):
    """The arm's checkpoint cadence: its middle step (and train_cli saves
    the last). train_cli's default, one an epoch, writes ~0.3 GB a
    checkpoint (weights, momentum, EMA) 48 times an arm at the defaults; the
    evals read the last one."""
    return max(1, ne * (n_train // nb) // 2)


def final_step(n_train, ne, nb=4):
    """The step an arm's ``train_cli`` run ends at: ``ne`` epochs of
    ``n_train // nb`` batches (config.py::Settings.finalize; train_cli
    saves it whatever the cadence)."""
    return ne * (n_train // nb)


def arm_trained(log_dir, n_train, ne, nb=4):
    """Whether the arm's training finished: its newest numbered checkpoint
    is the run's final step. ``checkpoints/`` alone says nothing (the
    checkpoint manager makes it before step 1), nor does an earlier step (a
    run that crashed, was killed or filled the disk)."""
    try:
        steps = [int(d) for d in os.listdir(os.path.join(log_dir, "checkpoints")) if d.isdigit()]
    except OSError:
        return False
    return bool(steps) and max(steps) == final_step(n_train, ne, nb)


def _arm_metrics(log_dir):
    """First (raw-weights) eval metrics of a finished arm, or None.

    eval_00 is always the raw eval in this tool's flow; later eval_NN dirs
    may be --restore_emas re-evaluations and must not be harvested as raw."""
    try:
        eval_dirs = sorted(
            d for d in os.listdir(log_dir) if d.startswith("eval_")
        )
        with open(os.path.join(log_dir, eval_dirs[0], "all_metrics.p"),
                  "rb") as f:
            return pickle.load(f)[-1]
    except (OSError, IndexError):
        return None


def _state_key(arm, seed, coeff, cfg):
    return json.dumps(
        {"arm": arm, "seed": seed,
         "coeff": coeff if arm == "weak" else None, **cfg},
        sort_keys=True)


def _cfg_tag(cfg):
    """Short hash of the sweep config, embedded in workdir arm-dir names so a
    rerun with a different --rate/--ne/--n_pp never harvests a stale arm."""
    return hashlib.sha1(
        json.dumps(cfg or {}, sort_keys=True).encode()).hexdigest()[:8]


def _sanitize(v):
    """NaN -> None recursively so the state file is strict JSON (jq-safe)."""
    if isinstance(v, float) and v != v:
        return None
    if isinstance(v, list):
        return [_sanitize(x) for x in v]
    return v


def _load_state(path):
    """Completed-arm metrics persisted across runs (one JSON per line).

    The arm checkpoints live in the (ephemeral) workdir; only the final
    eval metrics are needed to aggregate, so those are appended here as
    each arm finishes. Pointing --state at a file inside the repo makes a
    sweep resumable across runs even when the workdir is lost. Lines
    truncated by a mid-append crash (or hand-edited) are skipped with a
    warning rather than blocking the resume they exist to provide."""
    state = {}
    try:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    state[_state_key(rec["arm"], rec["seed"],
                                     rec.get("coeff"),
                                     rec["config"])] = rec["metrics"]
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    print(f"[state] skipping bad line {lineno} of {path}: {e}",
                          file=sys.stderr)
    except OSError:
        pass
    return state


def run_arm(workdir, paths, arm, seed, ne, coeff=0.1, state=None,
            state_path=None, cfg=None, ema=False, device="cuda"):
    """Train + evaluate one arm. Resumable two ways: a finished arm in the
    workdir (its eval artifact exists) is reused, and an arm recorded in
    the --state file is reused even after the workdir is gone. Non-default
    coefficients get their own weak-arm dirs (weak_c{coeff}_s{seed}), so a
    coefficient sweep in the SAME workdir reuses the coeff-independent
    pp_s* arms and retrains only weak arms.

    ``ema=True`` evaluates the SAME checkpoint with --restore_emas
    (recorded under arm '<arm>_ema'); reuses the trained arm in the
    workdir, retraining it unless its final checkpoint is there
    (``arm_trained``: a run cut short is cleared and trained again).
    ``device``: where the CLIs run."""
    state_arm = f"{arm}_ema" if ema else arm
    key = _state_key(state_arm, seed, coeff, cfg or {})
    if state is not None and key in state:
        print(f"[{state_arm} seed {seed}] reusing persisted metrics", flush=True)
        return state[key]

    def _record(metrics):
        if state_path:
            rec = {"arm": state_arm, "seed": seed,
                   "coeff": coeff if arm == "weak" else None,
                   "config": cfg or {},
                   "metrics": {k: _sanitize(v.tolist()
                                            if hasattr(v, "tolist") else v)
                               for k, v in metrics.items()}}
            with open(state_path, "a") as f:
                f.write(json.dumps(rec, allow_nan=False) + "\n")
        return metrics

    name = arm if arm == "pp" or coeff == 0.1 else f"weak_c{coeff}"
    log_dir = os.path.join(workdir, f"{name}_s{seed}_{_cfg_tag(cfg)}")
    if not ema:
        done = _arm_metrics(log_dir)
        if done is not None:
            print(f"[{arm} seed {seed}] reusing {log_dir}", flush=True)
            return _record(done)
    if not arm_trained(log_dir, paths["n_pp"], ne):
        if os.path.isdir(log_dir):  # train started but never completed
            print(f"[{arm} seed {seed}] clearing partial {log_dir}", flush=True)
            shutil.rmtree(log_dir)
        nb_weak = ("8", "4") if arm == "weak" else ("0", "0")
        _run("iv2019_tpu_torch.train_cli", [
            log_dir, "cityscapes",
            "--tfrecords_path_per_pixel", paths["tfrecords_train"],
            "--openimages_image_dir", paths["openimages_image_dir"],
            "--openimages_bboxes_path", paths["openimages_bboxes_path"],
            "--openimages_image_labels_path", paths["openimages_image_labels_path"],
            *SIZE,
            "--Ntrain", str(paths["n_pp"]), "--Ne", str(ne),
            "--Nb_per_pixel", "4",
            "--Nb_per_bbox", nb_weak[0], "--Nb_per_image", nb_weak[1],
            "--learning_rate_boundaries", str(ne * 2 // 3), str(ne * 5 // 6),
            "--learning_rate_values", "0.01", "0.005", "0.0025",
            "--weak_loss_coefficient", str(coeff),
            "--random_seed", str(seed), "--input_seed", str(seed),
            "--save_checkpoints_steps", str(save_every(paths["n_pp"], ne)),
            "--device", device,
        ])
    _run("iv2019_tpu_torch.evaluate_cli", [
        log_dir, str(paths["n_val"]), PROBLEM,
        "--tfrecords_path", paths["tfrecords_val"],
        *SIZE, "--Nb", "4",
        *(["--restore_emas"] if ema else []),
        "--device", device,
    ])
    eval_dir = sorted(d for d in os.listdir(log_dir) if d.startswith("eval_"))[-1]
    with open(os.path.join(log_dir, eval_dir, "all_metrics.p"), "rb") as f:
        return _record(pickle.load(f)[-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("workdir")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--rate", type=float, default=0.2)
    p.add_argument("--n_pp", type=int, default=24)
    p.add_argument("--n_weak", type=int, default=256)
    p.add_argument("--n_val", type=int, default=48)
    p.add_argument("--ne", type=int, default=48)
    p.add_argument("--coeff", type=float, default=0.1,
                   help="--weak_loss_coefficient for the weak arm")
    p.add_argument("--state", default=None,
                   help="JSONL of completed-arm metrics; arms recorded "
                        "there are never retrained (survives workdir loss)")
    p.add_argument("--ema_evals", action="store_true",
                   help="additionally evaluate every arm with "
                        "--restore_emas (recorded as arm '<arm>_ema'; "
                        "reuses workdir checkpoints, retrains only if gone)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    check_state_path(args.state)

    from iv2019_tpu_torch.tools.synthetic_scenes import generate

    os.makedirs(args.workdir, exist_ok=True)
    data_dir = os.path.join(args.workdir, "data")
    paths = generate(data_dir, n_train=args.n_pp, n_val=args.n_val,
                     n_weak=args.n_weak, h=128, w=256,
                     object_rate_train=args.rate)
    paths["n_pp"], paths["n_val"] = args.n_pp, args.n_val

    with open(PROBLEM) as f:
        labels = json.load(f)["cids2labels"]

    cfg = {"rate": args.rate, "n_pp": args.n_pp, "n_weak": args.n_weak,
           "n_val": args.n_val, "ne": args.ne}
    state = _load_state(args.state) if args.state else None

    results = {"pp": [], "weak": []}
    for seed in range(args.seeds):
        for arm in ("pp", "weak"):
            m = run_arm(args.workdir, paths, arm, seed, args.ne,
                        coeff=args.coeff, state=state,
                        state_path=args.state, cfg=cfg, device=args.device)
            results[arm].append(m)
            print(f"[{arm} seed {seed}] mean IoU {m['mean_iou']:.2f}",
                  flush=True)

    ema_results = {"pp": [], "weak": []}
    if args.ema_evals:
        for seed in range(args.seeds):
            for arm in ("pp", "weak"):
                m = run_arm(args.workdir, paths, arm, seed, args.ne,
                            coeff=args.coeff, state=state,
                            state_path=args.state, cfg=cfg, ema=True,
                            device=args.device)
                ema_results[arm].append(m)
                print(f"[{arm}_ema seed {seed}] mean IoU "
                      f"{m['mean_iou']:.2f}", flush=True)

    def stack(arm, key):
        return np.stack([np.asarray(m[key], float) for m in results[arm]])

    miou = {a: np.array([m["mean_iou"] for m in results[a]]) for a in results}
    ious = {a: stack(a, "ious") for a in results}
    mask = np.all(np.isfinite(np.concatenate(list(ious.values()))), axis=0)

    lines = ["| class | per-pixel only | + weak labels | delta |",
             "|---|---:|---:|---:|"]
    order = np.argsort(-(np.nanmean(ious["weak"], 0) - np.nanmean(ious["pp"], 0)))
    for c in order:
        if not mask[c]:
            continue
        if max(ious["pp"][:, c].max(), ious["weak"][:, c].max()) < 0.05:
            continue  # class absent from the scenes; 0-IoU rows are noise
        pp_m, pp_s = ious["pp"][:, c].mean(), ious["pp"][:, c].std()
        wk_m, wk_s = ious["weak"][:, c].mean(), ious["weak"][:, c].std()
        lines.append(
            f"| {labels[c]} | {pp_m:.1f} ± {pp_s:.1f} | {wk_m:.1f} ± {wk_s:.1f}"
            f" | {wk_m - pp_m:+.1f} |")
    lines.append(
        f"| **mean IoU** | **{miou['pp'].mean():.1f} ± {miou['pp'].std():.1f}**"
        f" | **{miou['weak'].mean():.1f} ± {miou['weak'].std():.1f}**"
        f" | **{miou['weak'].mean() - miou['pp'].mean():+.1f}** |")
    table = "\n".join(lines)
    print(table)

    # Seeds are paired across arms (same --random_seed/--input_seed), so the
    # per-seed delta is the headline statistic: its sign being constant across
    # seeds is what separates a measurement from noise.
    paired = miou["weak"] - miou["pp"]
    paired_line = (
        "paired mean-IoU delta per seed: "
        + ", ".join(f"{d:+.2f}" for d in paired)
        + f" -> {paired.mean():+.2f} ± {paired.std():.2f}"
        + (" (same sign across all seeds)"
           if np.all(paired > 0) or np.all(paired < 0) else "")
    )
    print(paired_line)

    out = {
        "object_rate_train": args.rate, "seeds": args.seeds,
        "weak_loss_coefficient": args.coeff,
        "n_pp": args.n_pp, "n_weak": args.n_weak, "ne": args.ne,
        "mean_iou_pp": [round(float(x), 2) for x in miou["pp"]],
        "mean_iou_weak": [round(float(x), 2) for x in miou["weak"]],
        "delta_mean": round(float(miou["weak"].mean() - miou["pp"].mean()), 2),
        "paired_deltas": [round(float(d), 2) for d in paired],
        "paired": paired_line,
        "table": table,
    }
    if args.ema_evals and ema_results["pp"] and ema_results["weak"]:
        ema_miou = {a: np.array([m["mean_iou"] for m in ema_results[a]])
                    for a in ema_results}
        ema_paired = ema_miou["weak"] - ema_miou["pp"]
        out["mean_iou_pp_ema"] = [round(float(x), 2) for x in ema_miou["pp"]]
        out["mean_iou_weak_ema"] = [round(float(x), 2)
                                    for x in ema_miou["weak"]]
        out["paired_deltas_ema"] = [round(float(d), 2) for d in ema_paired]
        print("EMA-restored paired deltas: "
              + ", ".join(f"{d:+.2f}" for d in ema_paired)
              + f" -> {ema_paired.mean():+.2f} ± {ema_paired.std():.2f}")
    with open(os.path.join(args.workdir, "weak_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "table"}))


if __name__ == "__main__":
    main()

"""Seeded A/Bs of three quality claims: EMA, flip augmentation and
Gaussian window blending.

Port of tools/quality_ab.py, on the port's CLIs (``python -m
iv2019_tpu_torch.train_cli`` / ``evaluate_cli``, each run a process of its
own). It measures the three deltas with N seeds and paired per-seed
deltas, from only 2 training arms per seed:

- scenes are generated at (2h, 2w) native size by
  ``iv2019_tpu_torch.tools.synthetic_scenes.generate``; both arms train at
  (h, w) (the pipeline resizes), per-pixel only (Nb 4/0/0: the unfused
  loss, kernel B3); seeds vary --random_seed/--input_seed;
- arm 'base': no augmentations; arm 'flip': --augmentations flip;
- per checkpoint, up to four evals:
    raw          resize protocol, raw weights
    ema          resize protocol, --restore_emas
    sw_uniform   --eval_size 2h 2w --sliding_window (EMA)
    sw_gauss     ... --window_blend gaussian (EMA)
- claims, paired per seed:
    EMA   = base/ema - base/raw
    flip  = flip/ema - base/ema (and raw-raw)
    blend = base/sw_gauss - base/sw_uniform

``Runner``, its keys and the state file's lines are the JAX tool's: every
finished (arm, seed, eval) mIoU is appended to --state JSONL and never
rerun. Seeded torch initial weights are not flax's, so the port's sweep
records to a file of its own (``docs/torch_quality_ab.jsonl``).

Usage: python -m iv2019_tpu_torch.tools.quality_ab WORKDIR [--seeds 3]
           [--ne 6] [--n_train 256] [--n_val 48]
           [--state docs/torch_quality_ab.jsonl] [--skip_sliding]
           [--device cuda|cpu]
Writes WORKDIR/quality_ab.json. Runs on the card unless ``--device cpu``.
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

from iv2019_tpu_torch.tools.weak_ab import arm_trained, save_every

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBLEM = os.path.join(
    REPO, "iv2019_tpu_torch", "problem_definitions", "cityscapes", "problem01.json"
)


def _run(module, args, timeout=5400):
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


def _cfg_tag(cfg):
    return hashlib.sha1(
        json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:8]


def _sanitize(v):
    if isinstance(v, float) and v != v:
        return None
    if isinstance(v, list):
        return [_sanitize(x) for x in v]
    return v


def _load_state(path):
    state = {}
    try:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    state[rec["key"]] = rec["mean_iou"]
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    print(f"[state] skipping bad line {lineno}: {e}",
                          file=sys.stderr)
    except OSError:
        pass
    return state


class Runner:
    def __init__(self, workdir, paths, cfg, state_path, device="cuda"):
        self.workdir = workdir
        self.device = device
        self.paths = paths
        self.cfg = cfg
        self.tag = _cfg_tag(cfg)
        self.state_path = state_path
        self.state = _load_state(state_path) if state_path else {}

    def _record(self, key, mean_iou):
        self.state[key] = mean_iou
        if self.state_path:
            with open(self.state_path, "a") as f:
                f.write(json.dumps(
                    {"key": key, "mean_iou": _sanitize(mean_iou),
                     "config": self.cfg}, allow_nan=False) + "\n")
        return mean_iou

    def _log_dir(self, arm, seed):
        return os.path.join(self.workdir, f"{arm}_s{seed}_{self.tag}")

    def train(self, arm, seed):
        log_dir = self._log_dir(arm, seed)
        ne = self.cfg["ne"]
        if arm_trained(log_dir, self.cfg["n_train"], ne):
            return log_dir
        if os.path.isdir(log_dir):  # train started but never completed
            shutil.rmtree(log_dir)
        args = [
            log_dir, "cityscapes",
            "--tfrecords_path_per_pixel", self.paths["tfrecords_train"],
            "--height_feature_extractor", str(self.cfg["h"]),
            "--width_feature_extractor", str(self.cfg["w"]),
            "--Ntrain", str(self.cfg["n_train"]), "--Ne", str(ne),
            "--Nb_per_pixel", "4", "--Nb_per_bbox", "0",
            "--Nb_per_image", "0",
            "--learning_rate_boundaries", str(ne * 2 // 3), str(ne * 5 // 6),
            "--learning_rate_values", "0.01", "0.005", "0.0025",
            "--random_seed", str(seed), "--input_seed", str(seed),
            "--save_checkpoints_steps", str(save_every(self.cfg["n_train"], ne)),
            "--device", self.device,
        ]
        if arm == "flip":
            args += ["--augmentations", "flip"]
        _run("iv2019_tpu_torch.train_cli", args)
        return log_dir

    def evaluate(self, arm, seed, mode):
        key = f"{arm}_s{seed}_{mode}_{self.tag}"
        if key in self.state:
            print(f"[{key}] reusing persisted mIoU {self.state[key]:.2f}",
                  flush=True)
            return self.state[key]
        log_dir = self.train(arm, seed)
        args = [
            log_dir, str(self.cfg["n_val"]), PROBLEM,
            "--tfrecords_path", self.paths["tfrecords_val"],
            "--height_feature_extractor", str(self.cfg["h"]),
            "--width_feature_extractor", str(self.cfg["w"]),
            "--Nb", "4", "--device", self.device,
        ]
        if mode != "raw":
            args += ["--restore_emas"]
        if mode.startswith("sw_"):
            args += ["--eval_size", str(self.cfg["h"] * 2),
                     str(self.cfg["w"] * 2), "--sliding_window", "--Nb", "2"]
            if mode == "sw_gauss":
                args += ["--window_blend", "gaussian"]
        _run("iv2019_tpu_torch.evaluate_cli", args)
        eval_dir = sorted(
            d for d in os.listdir(log_dir) if d.startswith("eval_"))[-1]
        with open(os.path.join(log_dir, eval_dir, "all_metrics.p"), "rb") as f:
            miou = float(pickle.load(f)[-1]["mean_iou"])
        print(f"[{key}] mean IoU {miou:.2f}", flush=True)
        return self._record(key, miou)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("workdir")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--ne", type=int, default=6)
    p.add_argument("--n_train", type=int, default=256)
    p.add_argument("--n_val", type=int, default=48)
    p.add_argument("--h", type=int, default=128)
    p.add_argument("--w", type=int, default=256)
    p.add_argument("--state", default=None)
    p.add_argument("--skip_sliding", action="store_true",
                   help="skip the sliding-window (blend) evals")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from iv2019_tpu_torch.tools.synthetic_scenes import generate

    os.makedirs(args.workdir, exist_ok=True)
    # scenes at 2x the training size so sliding-window eval has a native
    # resolution to tile (QUALITY.md section 8 protocol)
    paths = generate(os.path.join(args.workdir, "data"),
                     n_train=args.n_train, n_val=args.n_val, n_weak=4,
                     h=args.h * 2, w=args.w * 2)
    cfg = {"ne": args.ne, "n_train": args.n_train, "n_val": args.n_val,
           "h": args.h, "w": args.w}
    r = Runner(args.workdir, paths, cfg, args.state, args.device)

    res = {}
    for seed in range(args.seeds):
        for arm in ("base", "flip"):
            for mode in ("raw", "ema"):
                res[(arm, seed, mode)] = r.evaluate(arm, seed, mode)
        if not args.skip_sliding:
            for mode in ("sw_uniform", "sw_gauss"):
                res[("base", seed, mode)] = r.evaluate("base", seed, mode)

    def paired(name, a_key, b_key):
        deltas = [res[(a_key[0], s, a_key[1])] - res[(b_key[0], s, b_key[1])]
                  for s in range(args.seeds)
                  if (a_key[0], s, a_key[1]) in res
                  and (b_key[0], s, b_key[1]) in res]
        if not deltas:
            return None
        d = np.asarray(deltas)
        line = (f"{name}: " + ", ".join(f"{x:+.2f}" for x in d)
                + f" -> {d.mean():+.2f} ± {d.std():.2f}"
                + (" (same sign across all seeds)"
                   if np.all(d > 0) or np.all(d < 0) else ""))
        print(line)
        return {"deltas": [round(float(x), 2) for x in d],
                "mean": round(float(d.mean()), 2),
                "std": round(float(d.std()), 2), "line": line}

    out = {
        "config": cfg, "seeds": args.seeds,
        "mious": {f"{a}_s{s}_{m}": round(v, 2)
                  for (a, s, m), v in sorted(res.items())},
        "ema": paired("EMA (base: ema - raw)", ("base", "ema"),
                      ("base", "raw")),
        "flip_ema": paired("flip (ema: flip - base)", ("flip", "ema"),
                           ("base", "ema")),
        "flip_raw": paired("flip (raw: flip - base)", ("flip", "raw"),
                           ("base", "raw")),
    }
    if not args.skip_sliding:
        out["blend"] = paired("gaussian blend (sw_gauss - sw_uniform)",
                              ("base", "sw_gauss"), ("base", "sw_uniform"))
    with open(os.path.join(args.workdir, "quality_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""The benchmark's driver: one cell, one run, one result line.

``main`` reads ``BENCHMARK.json`` at the checkout's root, finds the cell,
loads its configuration (``benchmark/configs/<config>.json``), its traffic
mix (``benchmark/traffic/<traffic>.json``) and its limits
(``benchmark/limits/<cell>.json``), and hands them to the driver of the
mix's ``kind`` (``benchmark/kinds/<kind>.py``). The driver builds the
program's step, warms it up, marks the end of set-up, runs the timed
window, reads the peak memory, profiles a few more steps when tracing,
frees the program and compares what the window produced with the plain
reference. The per-layer readers are ``benchmark/metrics/<metric>.py``,
each a ``read(run)`` that returns a number or None.

Every path is taken from the checkout's root, so a cell, a mix, a limit
file or a reader that a later change adds as a file of its own is found
without an edit here.

A result line carries ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
``device`` and, when tracing, ``breakdown``; its last key, ``checks``,
has every number compared beside its limit, which also end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Optional

__all__ = ["BANNED", "Context", "Run", "banned_modules", "build_context", "device_name",
           "finish", "load_metric", "main", "process_seconds", "result_line", "sync",
           "trace_steps"]

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "iv2019_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is banned."""
    return sorted(name for name in sys.modules if name.split(".")[0] in BANNED)


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's start time."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Context:
    """What a kind's driver gets: the cell and the run's arguments."""

    workload: dict
    config: dict
    mix: dict
    limits: dict
    problem: dict
    problem_path: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_s: Optional[float] = None

    def end_setup(self) -> None:
        """Mark the end of set-up: the timed window starts now."""
        self.setup_s = process_seconds()


@dataclasses.dataclass
class Run:
    """What a driver returns, and what the per-layer readers read."""

    kind: str
    config: dict
    mix: dict
    steps: int
    images: int
    window_s: float
    memory_peak_bytes: int
    checks: list  # [(name, value, limit)]
    device_name: str
    trace: Any = None  # trace.Trace of the profiled steps
    shape_trace: Any = None  # trace.Trace of one step with input shapes


def sync(device) -> None:
    """Wait for the device's queue to drain (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def device_name(device) -> str:
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return device.type


def trace_steps(steps: int, window_s: float, seconds: float = 1.0) -> int:
    """Steps to profile: about ``seconds`` of the window's pace, 3 at least."""
    return max(3, math.ceil(seconds * steps / window_s))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def build_context(workload_name: str, seed: int, seconds: float, trace: bool, device,
                  root: Path = ROOT, overrides: Optional[dict] = None) -> Context:
    """The cell's files read into a Context. ``overrides`` ({'config': {...},
    'mix': {...}, 'limits': {...}}) replace entries, for tests at small
    sizes."""
    spec = _json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in spec["workloads"]}
    if workload_name not in workloads:
        raise SystemExit(f"benchmark: no workload {workload_name!r} in BENCHMARK.json")
    workload = workloads[workload_name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    config = _json(root / configs[workload["config"]]["file"])
    mix = _json(bench / "traffic" / f"{workload['traffic']}.json")
    limits = _json(bench / "limits" / f"{workload_name}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    mix.update(overrides.get("mix", {}))
    limits.update(overrides.get("limits", {}))
    problem_path = str(bench / "configs" / config["problem"])
    return Context(workload=workload, config=config, mix=mix, limits=limits,
                   problem=_json(Path(problem_path)), problem_path=problem_path, seed=seed,
                   seconds=seconds, trace=trace, device=device)


def load_metric(name: str, root: Path = ROOT):
    """The reader module of a per-layer metric, ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cell_metrics(spec: dict, cell: str, key: str, reported: set) -> list:
    """The entries of ``spec[key]`` this cell reports: those that list it,
    and those without a list whose moved metric (per-layer) or whose own
    name (end-to-end) the cell reports."""
    out = []
    for m in spec[key]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def _device_info(ctx: Context, run: Run) -> dict:
    info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
            "kind": run.device_name, "count": 1,
            "memory_peak_bytes": run.memory_peak_bytes}
    if ctx.trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def result_line(spec: dict, ctx: Context, run: Run, rate_metric: str, root: Path = ROOT) -> dict:
    """The result's JSON object; ``checks`` is its last key."""
    cell = ctx.workload["name"]
    e2e = {"setup_s": ctx.setup_s, rate_metric: run.images / run.window_s}
    e2e_entries = _cell_metrics(spec, cell, "end_to_end", set())
    reported = {m["name"] for m in e2e_entries}
    metrics = {}
    if not ctx.trace:
        for m in e2e_entries:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in _cell_metrics(spec, cell, "per_layer", reported):
            value = load_metric(m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in run.checks)
    line = {"correct": correct, "attempted": run.steps, "failed": 0, "metrics": metrics,
            "device": _device_info(ctx, run)}
    if ctx.trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in run.checks}
    return line


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own nvcc and g++ builds go to ``build/`` there already)."""
    cache = root / "build" / "benchmark_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def execute(ctx: Context):
    """Run the cell's driver; returns (run, rate metric name)."""
    kind = importlib.import_module(f"benchmark.kinds.{ctx.mix['kind']}")
    return kind.run(ctx), kind.RATE_METRIC


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    set_cache_dirs()
    import torch

    spec = _json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    ctx = build_context(args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0))
    run, rate_metric = execute(ctx)
    return finish(spec, ctx, run, rate_metric)


def finish(spec: dict, ctx: Context, run: Run, rate_metric: str, root: Path = ROOT) -> int:
    """Build the result line (the per-layer readers load here), then look
    for JAX in ``sys.modules``: with any loaded, exit 4 and print no
    result; else print the checks on standard error and the line."""
    line = result_line(spec, ctx, run, rate_metric, root)
    loaded = banned_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}", file=sys.stderr)
        return 4
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

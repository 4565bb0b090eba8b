"""The harness: its result line, the JAX check, a cell added as files only,
and what it does without a card or without the program.

    python -m pytest benchmark/tests -q          (CPU; ``gpu`` tests skip)
    python -m pytest benchmark/tests -q -m gpu   (on the card)
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_benchmark_reference import SMALL, small_context
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _python(args, cwd, timeout=600, path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(map(str, (cwd, *path))))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _copy_benchmark(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("iv2019_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.banned_modules() == []
    for name in ("iv2019_tpu.models", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.banned_modules() == ["flax.linen", "iv2019_tpu.models", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    out = _python(["-c", "import sys, benchmark.reference.model, benchmark.reference.steps; "
                   "print(sorted({m.split('.')[0] for m in sys.modules}))"], ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & {"iv2019_tpu_torch", "iv2019_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    code = ("import json, torch; from benchmark import harness; "
            f"mix = {SMALL['infer.cityscapes']!r}; "
            "ctx = harness.build_context('infer.cityscapes', 5, 0.2, False, torch.device('cpu'), "
            "overrides={'mix': mix}); harness.execute(ctx); "
            "print(json.dumps(harness.banned_modules()))")
    out = _python(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A per-layer reader loads after the window; the look for JAX comes
    after it, so a reader that imports JAX leaves no result line."""
    root = _copy_benchmark(tmp_path)
    (root / "jax.py").write_text("")
    (root / "benchmark/metrics/loads_jax.train.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "loads_jax.train", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_img_per_s", "workloads": ["train.cityscapes"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys, torch; from benchmark import harness; "
            f"mix = {SMALL['train.cityscapes']!r}; "
            "spec = json.load(open('BENCHMARK.json')); "
            "ctx = harness.build_context('train.cityscapes', 7, 0.2, True, torch.device('cpu'), "
            "overrides={'mix': mix}); run, rate = harness.execute(ctx); "
            "sys.exit(harness.finish(spec, ctx, run, rate))")
    out = _python(["-c", code], root, path=(ROOT,))  # the program from the repo
    assert out.returncode == 4, out.stderr[-2000:]
    assert "'jax'" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _python(["-m", "benchmark.run", "--workload", "train.cityscapes", "--seed",
                   "4294967311", "--seconds", "1", "--trace", "0"], ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_exits_without_a_result(tmp_path):
    root = _copy_benchmark(tmp_path)
    code = ("import torch; from benchmark import harness; "
            "ctx = harness.build_context('train.cityscapes', 5, 0.2, False, torch.device('cpu')); "
            "harness.execute(ctx); print('{}')")
    out = _python(["-c", code], root, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "iv2019_tpu_torch" in out.stderr


def _synthetic_trace(steps=2):
    """Two steps of kernels with a gap between them, and host ops."""
    events = []
    t = 0.0
    for _ in range(steps):
        for name, dur in (("void cudnn::batchnorm_fwtr_nhwc_semiPersist<float>", 40.0),
                          ("void at::native::direct_copy_kernel_cuda", 30.0),
                          ("void (anonymous namespace)::fwd_walk_kernel<14, 7, 3>", 5.0),
                          ("void (anonymous namespace)::bwd_walk_kernel<14, 7, 3>", 5.0)):
            events.append({"cat": "kernel", "name": name, "ts": t, "dur": dur})
            t += dur
        events.append({"cat": "cpu_op", "name": "aten::copy_", "ts": t - 1.0, "dur": 30.0})
        t += 20.0
    return Trace(events, steps)


def test_result_line_shape():
    ctx = small_context("train.cityscapes", dtype="bfloat16")
    ctx.seconds = 0.2
    run, rate = harness.execute(ctx)
    line = harness.result_line(SPEC, ctx, run, rate)
    assert list(line)[-1] == "checks"
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert isinstance(line["correct"], bool) and line["attempted"] == run.steps >= 1
    assert set(line["metrics"]) == {"train_img_per_s", "setup_s"}
    assert all(m["value"] > 0 and m["unit"] for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "delta_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)

    # the traced line: per-layer metrics from the trace, busy and window, breakdown
    ctx.trace = True
    run.trace, run.device_name = _synthetic_trace(), "NVIDIA H100 80GB HBM3"
    line = harness.result_line(SPEC, ctx, run, rate)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"mfu.train", "norm_ms.train", "copy_ms.train",
                                    "fused_loss_roofline", "idle_share.train"}
    assert line["metrics"]["norm_ms.train"]["value"] == pytest.approx(0.04)
    assert line["metrics"]["copy_ms.train"]["value"] == pytest.approx(0.03)
    assert line["metrics"]["idle_share.train"]["value"] == pytest.approx(100 * 20 / 180)
    assert line["device"]["busy_s"] == pytest.approx(160e-6)
    assert line["device"]["window_s"] == pytest.approx(180e-6)
    assert line["breakdown"]["idle_gaps"] == [["aten::copy_", pytest.approx(20e-6)]]
    assert len(line["breakdown"]["device_ops"]) == 4


def test_a_cell_added_as_files_only(tmp_path):
    root = _copy_benchmark(tmp_path)
    before = _digests(root)
    mix = dict(json.loads((root / "benchmark/traffic/train_cityscapes.json").read_text()),
               **SMALL["train.cityscapes"])
    (root / "benchmark/traffic/train_cityscapes_tiny.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/train.tiny.json").write_text(
        (root / "benchmark/limits/train.cityscapes.json").read_text())
    (root / "benchmark/metrics/steps_traced.tiny.py").write_text(
        "def read(run):\n    return float(run.trace.steps) if run.trace else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "train.tiny", "config": "r50os8_cityscapes",
                              "traffic": "train_cityscapes_tiny", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("train.tiny")
    spec["per_layer"].append({"name": "steps_traced.tiny", "unit": "1", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_img_per_s", "workloads": ["train.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

    ctx = harness.build_context("train.tiny", 3, 0.2, False, torch.device("cpu"), root=root)
    run, rate = harness.execute(ctx)
    line = harness.result_line(spec, ctx, run, rate, root=root)
    assert set(line["metrics"]) == {"train_img_per_s", "setup_s"}
    ctx.trace, run.trace = True, _synthetic_trace(3)
    line = harness.result_line(spec, ctx, run, rate, root=root)
    assert line["metrics"]["steps_traced.tiny"]["value"] == 3.0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _python(["-m", "benchmark.run", "--workload", workload, "--seed", "4294967311",
                   "--seconds", "2", "--trace", "1"], ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0

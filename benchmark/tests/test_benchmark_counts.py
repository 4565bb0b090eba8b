"""The benchmark's operation and byte counts.

- The model's convolutions, as ``benchmark/counts.py`` counts them from a
  configuration, equal what ``torch.utils.flop_counter.FlopCounterMode``
  counts in the convolutions of the program's default path (a training
  step, and an evaluation forward) at a small size.
- The B1/B2/B4/B5 least times reproduce the ``bound ms`` of PERF.md's
  kernel table at the table's shapes.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, program
from benchmark.kinds import train
from benchmark.tests.test_benchmark_reference import small_context

ROOT = Path(__file__).resolve().parents[2]
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
CONV_OPS = ("convolution", "convolution_backward")


def _conv_flops(counter: FlopCounterMode) -> int:
    return sum(v for op, v in counter.get_flop_counts()["Global"].items()
               if str(op).split(".")[1] in CONV_OPS)


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("workload", ["train.cityscapes", "train.vistas_psp"])
def test_training_count_is_the_programs_convolutions(workload):
    ctx = small_context(workload, dtype="bfloat16")
    s, w0, pool = train.inputs(ctx)
    _, _, state, step = program.train_step(s, w0)
    counter = FlopCounterMode(display=False)
    with counter:
        step(state, pool[0])
    mix = ctx.mix
    images = mix["per_pixel"] + mix["per_bbox"] + mix["per_image"]
    assert _conv_flops(counter) == images * counts.model_flops(
        ctx.config, mix["height"], mix["width"], train=True)


@pytest.mark.parametrize("workload", ["infer.cityscapes", "infer.vistas_psp"])
def test_forward_count_is_the_programs_convolutions(workload):
    from iv2019_tpu_torch.models.model import build_model

    ctx = small_context(workload, dtype="bfloat16")
    s = program.settings(ctx.config, ctx.mix, ctx.device, "eval", ctx.problem_path)
    model = build_model(s.replace(fused_block=False))
    images = torch.zeros(ctx.mix["images"], ctx.mix["height"], ctx.mix["width"], 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(images)
    assert _conv_flops(counter) == ctx.mix["images"] * counts.model_flops(
        ctx.config, ctx.mix["height"], ctx.mix["width"], train=False)


def test_flagship_step_count():
    # 21.0211 TFLOP a step of 16 images by FlopCounterMode and the kernels'
    # own counts (PERF.md, the bench's train line); the convolutions alone
    assert 16 * counts.model_flops(_config("r50os8_cityscapes"), 512, 1024, True) \
        == pytest.approx(21.012e12, rel=1e-4)


def _bound_ms(nbytes, ops, peak):
    return 1e3 * counts.bound_s(nbytes, ops, peak, H100["bytes"])


@pytest.mark.parametrize("n_pp, n_weak, heads, fwd_ms, bwd_ms", [
    (2, 6, (14, 7, 3), 0.0720, 0.0639),    # one real-format microbatch
    (4, 12, (14, 7, 3), 0.1440, 0.1277),   # the flagship step
    (4, 12, (53, 12, 5), 0.1512, 0.2153),  # Vistas widths, 16 images
])
def test_loss_bounds_reproduce_the_kernel_table(n_pp, n_weak, heads, fwd_ms, bwd_ms):
    c = counts.loss_counts(n_pp, n_weak, (64, 128), (512, 1024), heads)
    assert _bound_ms(*c["fwd"], H100["f32"]) == pytest.approx(fwd_ms, abs=5e-5)
    assert _bound_ms(*c["bwd"], H100["f32"]) == pytest.approx(bwd_ms, abs=5e-5)


def test_unit_bounds_reproduce_the_kernel_table():
    # B4: block2 (512, 128) x 3 and block3 (1024, 256) x 5 units a request at
    # 64x128, their launch-weighted mean; B5: block4 (2048, 512)
    b4 = [_bound_ms(*counts.unit_counts(1, 64, 128, c, m), H100["bf16"])
          for c, m, n in ((512, 128, 3), (1024, 256, 5)) for _ in range(n)]
    assert sum(b4) / len(b4) == pytest.approx(0.0135, abs=5e-5)
    b5 = _bound_ms(*counts.unit_counts(1, 64, 128, 2048, 512), H100["bf16"])
    assert b5 == pytest.approx(0.0738, abs=5e-5)

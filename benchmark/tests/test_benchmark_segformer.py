"""The ``train.segformer_b5`` cell on the CPU, at ``mit_b0`` widths.

- The reference, the weights and the counts import nothing of the program;
  the reference's names and shapes are the program's, at ``mit_b5``'s
  widths and at ``mit_b0``'s.
- The ``train_segformer`` kind end to end through ``build_context``
  overrides (``mit_b0``, 64x128, 1 + 2 + 1 images, a pool of 2), the
  program in float32 and in bfloat16: ``correct`` under the cell's limits.
- ``counts_segformer.py`` against a count by hand of one block of each
  stage of MiT-B5 at 1024x1024, and against ``FlopCounterMode`` over the
  program's ``mit_b0`` forward (linears, convs and attention).
- The planted faults fail the cell's limits: a step that leaves the state
  unchanged, half of each sub-batch left out, the vehicle gate left open
  on the weak images (their L1 decisions read as vehicle), the attention's
  softmax scale dropped; the control, the reference in float8 in the
  program's place, reads at least 4x the bf16 program's leaf gaps.

    python -m pytest benchmark/tests/test_benchmark_segformer.py -q
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import compare, counts_segformer, harness, program, scenes, weights_segformer
from benchmark.kinds import train, train_segformer
from benchmark.reference import model as ref_model
from benchmark.reference import segformer as ref
from benchmark.reference import steps as ref_steps

ROOT = Path(__file__).resolve().parents[2]
CELL = "train.segformer_b5"
CONFIG = json.loads((ROOT / "benchmark/configs/segformer_b5_cityscapes.json").read_text())
B0 = {"feature_extractor": "mit_b0", "embed_dims": [32, 64, 160, 256], "num_heads": [1, 2, 5, 8],
      "depths": [2, 2, 2, 2], "decoder_embed_dim": 256}
SMALL = dict(height=64, width=128, per_pixel=1, per_bbox=2, per_image=1, pool=2)
SEED = 2147483711


def small_context(seed=SEED, dtype="float32"):
    return harness.build_context(CELL, seed, 0.0, False, torch.device("cpu"), overrides={
        "config": dict(B0, compute_dtype=dtype), "mix": SMALL})


def _gaps(ctx, prog=None, ref_side=None):
    s = train_segformer.settings(ctx)
    w0 = weights_segformer.draw(ctx.config, ctx.seed, ctx.device)
    pool = scenes.train_pool(ctx.mix, ctx.problem, ctx.config["dataset"], ctx.seed, ctx.device)
    if prog is None:
        _, prog = train.first_steps(program.train_step(s, w0), pool, w0, ctx.config)
    want = train_segformer.reference_readings(w0, pool, ctx.config, ctx.seed)
    if ref_side is not None:
        prog = ref_side(w0, pool)
    gaps = compare.train_gaps(*prog, *want, ctx.config["weak_loss_coefficient"])
    return {k: v for k, (v, _) in gaps.items()}


def _fails(gaps: dict, limits: dict) -> bool:
    return any(gaps[k] > limits[k] for k in limits)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.segformer, benchmark.weights_segformer, "
            "benchmark.counts_segformer; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & {"iv2019_tpu_torch", "iv2019_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("widths", ["mit_b5", "mit_b0"])
def test_reference_names_and_shapes_are_the_programs(widths):
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model

    cfg = dict(CONFIG, **(B0 if widths == "mit_b0" else {}))
    model = build_model(Settings(device="cpu", name_feature_extractor=cfg["feature_extractor"],
                                 stride_feature_extractor=4))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(
        ref.param_spec(cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kind_is_correct_end_to_end(dtype):
    ctx = small_context(dtype=dtype)
    ctx.seconds = 0.2
    run, rate = harness.execute(ctx)
    assert rate == "train_img_per_s" and run.kind == "train" and run.steps >= 1
    assert run.images == run.steps * 4
    checks = {name: (v, limit) for name, v, limit in run.checks}
    assert set(checks) == {"loss_gap", "grad_gap", "delta_gap"}
    assert all(v <= limit for v, limit in checks.values()), checks
    if dtype == "float32":  # one function in another order
        assert all(v < 1e-3 for v, _ in checks.values()), checks
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    line = harness.result_line(spec, ctx, run, rate)
    assert line["correct"] and set(line["metrics"]) == {"train_img_per_s", "setup_s"}


def test_counts_are_a_hand_count_of_one_block_a_stage():
    """MiT-B5 at 1024x1024: per image, 2 x multiply-adds."""
    layers = counts_segformer.layer_flops(CONFIG, 1024, 1024)
    fwd, bwd = counts_segformer.attention_flops(CONFIG, 1024, 1024)
    # (tokens, keys, C, heads, R) of each stage
    stages = [(256 * 256, 32 * 32, 64, 1, 8), (128 * 128, 32 * 32, 128, 2, 4),
              (64 * 64, 32 * 32, 320, 5, 2), (32 * 32, 32 * 32, 512, 8, 1)]
    attention = 0
    for s, (n, nr, c, heads, r) in enumerate(stages):
        depth = CONFIG["depths"][s]
        hand = {"q": 2 * n * c * c, "kv": 2 * nr * c * 2 * c, "proj": 2 * n * c * c,
                "fc1": 2 * n * c * 4 * c, "dwconv": 2 * n * 4 * c * 9, "fc2": 2 * n * 4 * c * c}
        if r > 1:
            hand["sr"] = 2 * nr * c * c * r * r
        for name, ops in hand.items():
            assert layers[f"block{s + 1}.{name}"] == depth * ops, (s, name)
        assert f"block{s + 1}.sr" in layers or r == 1
        attention += depth * heads * (2 * n * nr * 64 + 2 * n * nr * 64)
    assert fwd == attention and bwd == attention * 10 // 4
    assert layers["patch_embed1"] == 2 * 256 * 256 * 7 * 7 * 3 * 64
    assert layers["decode.linear_fuse"] == 2 * 256 * 256 * 3072 * 768
    assert layers["adaptation"] == 3 * 2 * 256 * 256 * 256 * 256 * 11
    # the whole step: 8 images, about 35.6 TFLOP
    assert 35.5e12 < 8 * counts_segformer.train_flops(CONFIG, 1024, 1024) < 35.7e12


def test_counts_are_what_the_programs_forward_counts():
    """``FlopCounterMode`` over the program's ``mit_b0`` forward (f32, CPU,
    eval mode, attention on PyTorch's math backend, whose products the
    counter sees): its matrix products, convolutions and attention equal
    ``layer_flops`` plus the forward attention."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ctx = small_context()
    s = train_segformer.settings(ctx).replace(mode="eval")
    cfg = ctx.config
    w0 = weights_segformer.draw(cfg, ctx.seed, ctx.device)
    model, _ = program.eval_step(s, w0)
    images = torch.rand(2, 64, 128, 3) * 2 - 1
    with FlopCounterMode(display=False) as counter, torch.no_grad(), \
            sdpa_kernel([SDPBackend.MATH]):
        model(images, upsampling_method="no")
    counted = sum(counter.get_flop_counts()["Global"].values())
    want = sum(counts_segformer.layer_flops(cfg, 64, 128).values()) \
        + counts_segformer.attention_flops(cfg, 64, 128)[0]
    assert counted == 2 * want


def test_reference_forward_matches_the_program():
    """The benchmark's reference and the program (f32) on the same weights
    and masks: every head's stride-4 logits within 1e-4 of the largest."""
    ctx = small_context()
    cfg = ctx.config
    w0 = weights_segformer.draw(cfg, ctx.seed, ctx.device)
    s = train_segformer.settings(ctx)
    model = program.train_step(s, w0)[0]
    images = torch.rand(3, 64, 128, 3) * 2 - 1
    model.seed_stochastic(ref.mask_seed(s.random_seed, 0))
    with torch.no_grad():
        out = model(images, upsampling_method="no")
        want = ref.forward(w0, images, cfg, masks=ref.draw_masks(
            cfg, ref.mask_seed(s.random_seed, 0), 3, ctx.device))
    for key, w in zip(("l1_logits", "l2_vehicle_logits", "l2_human_logits"), want):
        got = out[key].permute(0, 3, 1, 2)
        assert float((got - w).abs().max() / w.abs().max()) < 1e-4, key


def _limits():
    return json.loads((ROOT / "benchmark/limits/train.segformer_b5.json").read_text())


def test_state_unchanged_fails_the_limits():
    ctx = small_context()
    gaps = _gaps(ctx, ref_side=lambda w0, pool: (lambda r: (r[0], r[1], {k: 0.0 for k in r[2]}))(
        train_segformer.reference_readings(w0, pool, ctx.config, ctx.seed)))
    assert gaps["delta_gap"] >= 0.99 and _fails(gaps, _limits())


def test_half_batch_fails_the_limits():
    ctx = small_context()

    def half(w0, pool):
        cut = [{k: v[:max(1, v.shape[0] // 2)] for k, v in b.items()} for b in pool]
        return train_segformer.reference_readings(w0, cut, ctx.config, ctx.seed)

    assert _fails(_gaps(ctx, ref_side=half), _limits())


def test_gate_dropped_fails_the_limits(monkeypatch):
    ctx = small_context()
    losses, vehicle = ref_steps.losses, ctx.config["hierarchy"]["cid_l1_vehicle"]
    n_pp = ctx.mix["per_pixel"]

    def gate_dropped(up, per_pixel, weak, cfg):
        l1 = up[0].clone()
        l1[n_pp:, vehicle] += 100.0
        return losses([l1, up[1], up[2]], per_pixel, weak, cfg)

    def faulty(w0, pool):
        monkeypatch.setattr(ref_steps, "losses", gate_dropped)
        try:
            return train_segformer.reference_readings(w0, pool, ctx.config, ctx.seed)
        finally:
            monkeypatch.setattr(ref_steps, "losses", losses)

    assert _fails(_gaps(ctx, ref_side=faulty), _limits())


def test_softmax_scale_dropped_in_the_program_fails_the_limits(monkeypatch):
    """The program's attention without its d^-1/2: scores 8x (head width
    64) too large."""
    from iv2019_tpu_torch.models import mit

    attention = mit.attention
    monkeypatch.setattr(mit, "attention", lambda q, k, v, scale: attention(q, k, v, 1.0))
    assert _fails(_gaps(small_context()), _limits())


def test_softmax_scale_dropped_in_the_reference_fails_the_limits(monkeypatch):
    ctx = small_context()

    def faulty(w0, pool):
        monkeypatch.setattr(ref, "SCORE_SCALE", lambda d: 1.0)
        try:
            return train_segformer.reference_readings(w0, pool, ctx.config, ctx.seed)
        finally:
            monkeypatch.undo()

    assert _fails(_gaps(ctx, ref_side=faulty), _limits())


def test_the_float8_control_is_far_from_the_bf16_program():
    """At this size the float8 control reads near the cell's limits (0.22-0.29
    by the leaf gaps, set from the full-size readings on the card, PERF.md
    §2), so it is held to the sound bf16 program instead: at least 4x its
    first gradient's and change's worst leaf."""
    ctx = small_context(dtype="bfloat16")

    def control(w0, pool):
        return train_segformer.reference_readings(w0, pool, ctx.config, ctx.seed,
                                                  rnd=ref_model.rounding("float8"))

    sound, f8 = _gaps(ctx), _gaps(ctx, ref_side=control)
    assert not _fails(sound, _limits()), sound
    for k in ("grad_gap", "delta_gap"):
        assert f8[k] > 4 * sound[k], (k, f8[k], sound[k])

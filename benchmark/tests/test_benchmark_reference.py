"""The plain reference against the program at a small size, on the CPU.

With the program's compute type set to float32 both sides compute the same
function, so they agree to float32 rounding: the model's forward (train and
eval mode), the hierarchical losses, one training step (update included)
and the evaluation step's confusion matrix, for each configuration. The
seeded weights load into the program under the reference's names.

    python -m pytest benchmark/tests -q
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import compare, harness, program
from benchmark.kinds import infer, train
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "train.cityscapes": dict(height=64, width=128, per_pixel=2, per_bbox=2, per_image=2),
    "train.vistas_psp": dict(height=73, width=99, per_pixel=2, per_bbox=2, per_image=2),
    "infer.cityscapes": dict(height=64, width=128, images=2, label_height=128, label_width=256),
    "infer.vistas_psp": dict(height=73, width=99, images=2, label_height=73, label_width=99),
}


def small_context(workload, seed=11, dtype="float32"):
    """A cell's context at a small size on the CPU. ``train.vistas_psp`` is
    no cell of BENCHMARK.json (PERF.md says why); its training path runs as
    the Cityscapes training cell under the Vistas configuration."""
    config, mix = {"compute_dtype": dtype}, SMALL[workload]
    if workload == "train.vistas_psp":
        workload = "train.cityscapes"
        config = dict(json.loads(
            (ROOT / "benchmark/configs/r50os8_vistas_psp.json").read_text()), **config)
    ctx = harness.build_context(workload, seed, 0.0, False, torch.device("cpu"),
                                overrides={"mix": mix, "config": config})
    return ctx


@pytest.mark.parametrize("config", ["r50os8_cityscapes", "r50os8_vistas_psp"])
def test_reference_names_and_shapes_are_the_programs(config):
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    model = build_model(Settings(device="cpu", per_pixel_dataset_name=cfg["dataset"],
                                 psp_module=cfg["psp_module"]))
    spec = dict(ref_model.param_spec(cfg))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec


@pytest.mark.parametrize("workload", ["train.cityscapes", "train.vistas_psp"])
def test_forward_and_losses_match_the_program(workload):
    from iv2019_tpu_torch.losses.hierarchical import define_losses
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    ctx = small_context(workload)
    s, w0, pool = train.inputs(ctx)
    model = program.train_step(s, w0)[0]
    batch = pool[0]
    images = torch.cat([batch[k] for k in ("proimages_per_pixel", "proimages_per_bbox",
                                           "proimages_per_image")])
    with torch.no_grad():
        preds = model(images)
        logits = ref_model.forward(w0, images, ctx.config, train=True)
        up = [ref_model.upsample(t, images.shape[1:3]) for t in logits]
        for head, u in zip(ref_model.HEADS, up):
            got = preds[f"{head}_logits"].permute(0, 3, 1, 2)
            assert torch.allclose(got, u, rtol=1e-4, atol=1e-4 * float(u.abs().max())), head
        labels = {k: batch[k] for k in ("prolabels_per_pixel", "prolabels_per_bbox",
                                        "prolabels_per_image")}
        theirs = define_losses(preds, labels, get_taxonomy(ctx.config["dataset"]))
        ours = ref_steps.losses(up, batch["prolabels_per_pixel"],
                                torch.cat([batch["prolabels_per_bbox"],
                                           batch["prolabels_per_image"]]), ctx.config)
    for k in compare.LOSS_KEYS + ("total",):
        assert float(ours[k]) == pytest.approx(float(theirs[k]), rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("workload", ["train.cityscapes", "train.vistas_psp"])
def test_one_training_step_matches_the_program(workload):
    ctx = small_context(workload)
    s, w0, pool = train.inputs(ctx)
    model, opt, state, step = program.train_step(s, w0)
    state, metrics = step(state, pool[0])
    ref = ref_steps.train_steps(w0, pool[:1], ctx.config)
    for k in compare.LOSS_KEYS:
        assert float(metrics[k]) == pytest.approx(ref["losses"][0][k], rel=1e-4, abs=1e-6), k
    params = dict(model.named_parameters())
    deltas = compare.leaf_norms({n: params[n] - w0[n] for n in params})
    ref_deltas = compare.leaf_norms({n: p - w0[n] for n, p in ref["params"].items()})
    gap, leaf = compare.leaf_gap(deltas, ref_deltas, compare.kept_leaves(
        compare.leaf_norms(ref["first_grads"])))
    assert gap < 1e-3, (gap, leaf)


@pytest.mark.parametrize("workload", ["infer.cityscapes", "infer.vistas_psp"])
def test_evaluation_matrix_matches_the_program(workload):
    ctx = small_context(workload)
    s, w, pool = infer.inputs(ctx)
    _, step = program.eval_step(s, w)
    got = sum(step(images, labels) for images, labels in pool)
    want = sum(infer.reference_matrices(w, pool, ctx.config, ctx.problem))
    gaps = compare.confusion_gaps(got, want)
    assert gaps["label_gap"][0] == 0
    assert gaps["decision_gap"][0] < 1e-3

"""``correct`` comes out false when the timed path is broken, and when the
control stands in for the program; true when the program is sound.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size (the program computing in float32 there, where
its sound readings are those of rounding alone) with the cell's own
limits, with the program broken underneath by one of the faults a cell can
have:

- a step that returns its state unchanged;
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced (train: the vehicle loss counted
  twice in the fused loss's result; infer: every decision moved to the next
  class before the confusion matrix, or the hierarchical fusion skipped: the
  L1 decision's common class where the vehicle or human head decides).

One chip holds a cell, so no exchange between chips can be left out. The
control, the reference computed in float8 in the program's place, is held
to the same limits.
"""

import pytest
import torch

from benchmark import compare, harness
from benchmark.kinds import infer, train
from benchmark.reference import model as ref_model
from benchmark.tests.test_benchmark_reference import small_context

SEED = 2147483659


def _correct(workload) -> bool:
    ctx = small_context(workload, seed=SEED)
    ctx.seconds = 0.2
    run, _ = harness.execute(ctx)
    return all(v <= limit for _, v, limit in run.checks)


def _half(batch):
    return {k: v[:v.shape[0] // 2] if hasattr(v, "shape") else v for k, v in batch.items()}


def _train_fault(monkeypatch, fault):
    import iv2019_tpu_torch.train.step as step_module
    from iv2019_tpu_torch.train.fused_update import FusedSGDM

    if fault == "state_unchanged":
        monkeypatch.setattr(FusedSGDM, "update", lambda self, opt_state, step: (
            opt_state, torch.zeros((), device=opt_state.momentum.device)))
    elif fault == "half_batch":
        make = step_module.make_train_step

        def make_half(settings, *args, **kw):
            half = settings.replace(**{k: getattr(settings, k) // 2 for k in (
                "Nb_per_pixel", "Nb_per_bbox", "Nb_per_image")})
            inner = make(half, *args, **kw)
            return lambda state, batch: inner(state, _half(batch))

        monkeypatch.setattr(step_module, "make_train_step", make_half)
    else:
        fused = step_module.define_losses_fused

        def altered(*args, **kw):
            out = fused(*args, **kw)
            out["l2_vehicle_segmentation"] = 2.0 * out["l2_vehicle_segmentation"]
            out["total"] = out["l1_segmentation"] + 0.1 * (
                out["l2_vehicle_segmentation"] + out["l2_human_segmentation"])
            return out

        monkeypatch.setattr(step_module, "define_losses_fused", altered)


def _infer_fault(monkeypatch, fault):
    import iv2019_tpu_torch.train.step as step_module

    make = step_module.make_eval_step
    if fault == "state_unchanged":
        def make_idle(*args, **kw):
            inner = make(*args, **kw)
            return lambda images, labels: torch.zeros_like(inner(images, labels))

        monkeypatch.setattr(step_module, "make_eval_step", make_idle)
    elif fault == "half_batch":
        def make_half(*args, **kw):
            inner = make(*args, **kw)
            return lambda images, labels: 2 * inner(images[:images.shape[0] // 2],
                                                    labels[:labels.shape[0] // 2])

        monkeypatch.setattr(step_module, "make_eval_step", make_half)
    elif fault == "fusion_skipped":
        from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

        def make_skipped(settings, model=None, **kw):
            table = torch.as_tensor(get_taxonomy(settings.per_pixel_dataset_name)
                                    .l1_cids2common_cids)
            forward = model.forward

            def skipped(*args, **kwargs):
                preds = forward(*args, **kwargs)
                l1 = preds["l1_decisions"].long()
                preds["decisions"] = table.to(l1.device)[l1].to(preds["decisions"].dtype)
                return preds

            model.forward = skipped
            return make(settings, model=model, **kw)

        monkeypatch.setattr(step_module, "make_eval_step", make_skipped)
    else:
        matrix = step_module.confusion_matrix
        monkeypatch.setattr(step_module, "confusion_matrix", lambda labels, dec, k: matrix(
            labels, (dec + 1) % k, k))


@pytest.mark.parametrize("workload", ["train.cityscapes", "infer.cityscapes",
                                      "infer.vistas_psp"])
def test_sound_program_is_correct(workload):
    assert _correct(workload)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    assert not _correct("train.cityscapes")


@pytest.mark.parametrize("workload", ["infer.cityscapes", "infer.vistas_psp"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "fusion_skipped"])
def test_infer_fault_is_not_correct(monkeypatch, workload, fault):
    _infer_fault(monkeypatch, fault)
    assert not _correct(workload)


def test_train_control_is_not_correct():
    ctx = small_context("train.cityscapes", seed=SEED)
    _, w0, pool = train.inputs(ctx)
    ref = train.reference_readings(w0, pool, ctx.config)
    control = train.reference_readings(w0, pool, ctx.config, rnd=ref_model.rounding("float8"))
    gaps = compare.train_gaps(*control, *ref, ctx.config["weak_loss_coefficient"])
    assert any(gaps[k][0] > ctx.limits[k] for k in ctx.limits), gaps


@pytest.mark.parametrize("workload", ["infer.cityscapes", "infer.vistas_psp"])
def test_infer_control_is_not_correct(workload):
    ctx = small_context(workload, seed=SEED)
    _, w, pool = infer.inputs(ctx)
    ref = sum(infer.reference_matrices(w, pool, ctx.config, ctx.problem))
    control = sum(infer.reference_matrices(w, pool, ctx.config, ctx.problem,
                                           rnd=ref_model.rounding("float8")))
    rounded = sum(infer.reference_matrices(w, pool, ctx.config, ctx.problem,
                                           rnd=ref_model.rounding("bfloat16")))
    gaps = compare.confusion_gaps(control, ref, rounded)
    assert any(gaps[k][0] > ctx.limits[k] for k in ctx.limits), gaps

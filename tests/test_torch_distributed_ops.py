"""Global-batch BatchNorm, the all-reduced losses and the distributed
bootstrap threshold of the port, on 2 gloo ranks on the CPU; and the
training loop's preemption, decided by both ranks.

Each rank (tests/torch_dist_worker.py, scenario ``ops``) takes its rows of
each sub-batch of a global batch made from a numpy seed; the test holds
what the ranks compute against the port's single-process functions on the
global batch and against the JAX package's (flax ``BatchNorm``,
``define_losses_fused`` with its Pallas kernel in interpret mode,
``define_losses``, ``bootstrap_weights``).

Tolerances (f32; the ranks add their partial sums in another order):
- BatchNorm output and input gradient: 2e-5 of the largest |value|
  against the single-process port (torch's two-pass variance against the
  ranks' E[x^2] - E[x]^2) and against flax (E[x^2] - E[x]^2 as well);
  the scale and bias gradients (the ranks' parts summed) 2e-5 relative;
  the running statistics 1e-6 of the largest |value|, and equal on both
  ranks;
- losses 1e-5 relative, gradients w.r.t. the logits 1e-5 of the largest
  |gradient|, as tests/test_torch_losses.py and test_torch_fused_loss.py;
- decisions: each rank's equal to the single-process decisions of its rows
  (the same plain B1 on the same rows);
- loss weight masks and the bootstrapped weights: equal, bit for bit, to
  JAX's (one sort over the global batch), ties and -0.0 included, at 1 and
  at 2 ranks.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as worker
from iv2019_tpu.losses import hierarchical as jl
from iv2019_tpu.ops import fused_loss as jfl
from iv2019_tpu.ops.resize import resize_bilinear_mxu
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from torch_parity import loss_inputs_np, run_ranks, threads

BN_TOL = 2e-5
BN_STATS_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
FUSED_CASES = [("cityscapes", 4, 2, 2), ("vistas", 2, 2, 2)]
LOSS_CASES = [("cityscapes", 2, 2, 2, -1), ("cityscapes", 4, 2, 2, 30)]
LOGIT_KEYS = worker.LOGIT_KEYS
LOSS_KEYS = worker.LOSS_KEYS
MASK_KEYS = ("l1_weights", "l2_vehicle_weights", "l2_human_weights")


def _bn_inputs(rng):
    n, c, h, w = 4, 16, 6, 5
    return {"x": (rng.randn(n, c, h, w) * 2.0 + 0.5).astype(np.float32),
            "dy": rng.randn(n, c, h, w).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.uniform(-0.3, 0.3, c).astype(np.float32),
            "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "var": rng.uniform(0.8, 1.2, c).astype(np.float32), "decay": 0.9}


def _full_res_logits(lr, out_hw):
    return {k: np.array(resize_bilinear_mxu(jnp.asarray(v), out_hw, align_corners=True))
            for k, v in lr.items()}


def _bootstrap_inputs(rng):
    cases = []
    ties = np.array([0.5, 1.0, 1.0, 2.0, 0.0, -0.0, 3.0, 2.0], np.float32)
    for p in (1, 30, 100):
        raw = rng.choice(ties, (4, 6, 7)).astype(np.float32)
        w = (rng.rand(4, 6, 7) < 0.7).astype(np.float32)
        cases.append((raw, w, p))
    raw = rng.randn(4, 9, 5).astype(np.float32)
    cases.append((raw, (rng.rand(4, 9, 5) < 0.5).astype(np.float32), 25))
    cases.append((raw, np.zeros_like(raw), 25))  # no valid pixel
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads()
    rng = np.random.RandomState(0)
    inp = {"bn": _bn_inputs(rng), "fused_loss": [], "losses": [],
           "bootstrap": _bootstrap_inputs(rng)}
    for i, (dataset, n_pp, n_pb, n_pi) in enumerate(FUSED_CASES):
        lr, labels, out_hw = loss_inputs_np(jax_taxonomy(dataset), 10 + i, n_pp, n_pb, n_pi)
        inp["fused_loss"].append({"dataset": dataset, "lr": lr, "labels": labels,
                                  "out_hw": out_hw})
    for i, (dataset, n_pp, n_pb, n_pi, boot) in enumerate(LOSS_CASES):
        lr, labels, out_hw = loss_inputs_np(jax_taxonomy(dataset), 20 + i, n_pp, n_pb, n_pi)
        inp["losses"].append({"dataset": dataset, "logits": _full_res_logits(lr, out_hw),
                              "labels": labels, "boot": boot})
    tmp = tmp_path_factory.mktemp("dist_ops")
    return {"inp": inp, "ranks": run_ranks("ops", inp, tmp), "one": run_ranks("ops", inp, tmp,
                                                                                world=1),
            "single": worker.run_ops(inp, None)}


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= tol * scale, what


# ------------------------------------------------------------- BatchNorm


def _flax_bn(inp):
    """flax BatchNorm in train mode on the global batch: y, dx, dscale,
    dbias and the new running statistics (NCHW)."""
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1))
    dy = jnp.asarray(inp["dy"].transpose(0, 2, 3, 1))
    bn = nn.BatchNorm(use_running_average=False, momentum=inp["decay"], epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])},
                 "batch_stats": {"mean": jnp.asarray(inp["mean"]),
                                 "var": jnp.asarray(inp["var"])}}

    def f(x, params):
        y, mutated = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
        return y, mutated["batch_stats"]

    y, vjp, stats = jax.vjp(f, x, variables["params"], has_aux=True)
    dx, dparams = vjp(dy)
    return {"y": np.asarray(y).transpose(0, 3, 1, 2), "dx": np.asarray(dx).transpose(0, 3, 1, 2),
            "dscale": np.asarray(dparams["scale"]), "dbias": np.asarray(dparams["bias"]),
            "mean": np.asarray(stats["mean"]), "var": np.asarray(stats["var"])}


@pytest.mark.parametrize("key", ["y", "dx"])
def test_global_batch_norm_matches_one_process_and_flax(runs, key):
    got = _cat([r["bn"] for r in runs["ranks"]], key)
    _close(got, runs["single"]["bn"][key], BN_TOL, f"{key} vs single process")
    _close(got, _flax_bn(runs["inp"]["bn"])[key], BN_TOL, f"{key} vs flax")


@pytest.mark.parametrize("key", ["dscale", "dbias"])
def test_global_batch_norm_parameter_gradients(runs, key):
    got = sum(r["bn"][key] for r in runs["ranks"])
    np.testing.assert_allclose(got, runs["single"]["bn"][key], rtol=BN_TOL, atol=0)
    np.testing.assert_allclose(got, _flax_bn(runs["inp"]["bn"])[key], rtol=BN_TOL, atol=0)


@pytest.mark.parametrize("key", ["mean", "var"])
def test_global_batch_norm_running_statistics(runs, key):
    a, b = (r["bn"][key] for r in runs["ranks"])
    np.testing.assert_array_equal(a, b)
    _close(a, runs["single"]["bn"][key], BN_STATS_TOL, "vs single process")
    _close(a, _flax_bn(runs["inp"]["bn"])[key], BN_STATS_TOL, "vs flax")


# ------------------------------------------------------------ fused loss


def _jax_fused(case):
    jtax = jax_taxonomy(case["dataset"])

    def total(l1, veh, hum):
        out = jfl.define_losses_fused(
            {"l1_logits": l1, "l2_vehicle_logits": veh, "l2_human_logits": hum},
            {k: jnp.asarray(v) for k, v in case["labels"].items()}, jtax, case["out_hw"],
            interpret=True)
        return out["total"], out

    (_, out), grads = jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(case["lr"][k]) for k in LOGIT_KEYS))
    return out, [np.asarray(g) for g in grads]


def _sizes(case):
    return [len(case["labels"][k]) for k in ("prolabels_per_pixel", "prolabels_per_bbox",
                                              "prolabels_per_image")]


def _rank_order(outs, key, sizes):
    """The ranks' rows of a [pp | pb | pi] array (sub-batches of ``sizes``)
    back in global order."""
    world = len(outs)
    local = [s // world for s in sizes]
    parts = []
    for t in range(3):
        a = sum(local[:t])
        parts += [o[key][a:a + local[t]] for o in outs]
    return np.concatenate(parts)


@pytest.mark.parametrize("i", range(len(FUSED_CASES)))
def test_fused_loss_sums_are_global(runs, i):
    single = runs["single"]["fused_loss"][i]
    want, _ = _jax_fused(runs["inp"]["fused_loss"][i])
    for r in runs["ranks"]:
        got = r["fused_loss"][i]
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got[k], single[k], rtol=LOSS_RTOL, err_msg=k)
            np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("i", range(len(FUSED_CASES)))
def test_fused_loss_gradients_are_those_of_the_global_loss(runs, i):
    case = runs["inp"]["fused_loss"][i]
    _, jgrads = _jax_fused(case)
    outs = [r["fused_loss"][i] for r in runs["ranks"]]
    for k, jg in zip(LOGIT_KEYS, jgrads):
        got = _rank_order(outs, f"grad_{k}", _sizes(case))
        _close(got, runs["single"]["fused_loss"][i][f"grad_{k}"], GRAD_TOL, k)
        _close(got, jg, GRAD_TOL, k)


@pytest.mark.parametrize("i", range(len(FUSED_CASES)))
def test_fused_loss_decisions_stay_local(runs, i):
    case = runs["inp"]["fused_loss"][i]
    outs = [r["fused_loss"][i] for r in runs["ranks"]]
    for k in ("decisions", "l1_decisions"):
        np.testing.assert_array_equal(_rank_order(outs, k, _sizes(case)),
                                      runs["single"]["fused_loss"][i][k])


# -------------------------------------------------- unfused, bootstrapped


def _jax_losses(case):
    jtax = jax_taxonomy(case["dataset"])

    def total(l1, veh, hum):
        preds = {"l1_logits": l1, "l2_vehicle_logits": veh, "l2_human_logits": hum,
                 "l1_decisions": jnp.argmax(l1, -1).astype(jnp.int32)}
        out = jl.define_losses(preds, {k: jnp.asarray(v) for k, v in case["labels"].items()},
                               jtax, bootstrapping_percentage=case["boot"])
        return out["total"], out

    (_, out), grads = jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(case["logits"][k]) for k in LOGIT_KEYS))
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(LOSS_CASES)))
def test_unfused_losses_are_global(runs, i):
    case = runs["inp"]["losses"][i]
    want, jgrads = _jax_losses(case)
    outs = [r["losses"][i] for r in runs["ranks"]]
    for r in outs:
        for k in LOSS_KEYS:
            np.testing.assert_allclose(r[k], runs["single"]["losses"][i][k], rtol=LOSS_RTOL)
            np.testing.assert_allclose(r[k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    sizes = _sizes(case)
    for k in MASK_KEYS:
        mask_sizes = (sizes[0], 0, 0) if k == "l1_weights" else sizes
        np.testing.assert_array_equal(_rank_order(outs, k, mask_sizes), np.asarray(want[k]))
    for k, jg in zip(LOGIT_KEYS, jgrads):
        _close(_rank_order(outs, f"grad_{k}", sizes), jg, GRAD_TOL, k)


@pytest.mark.parametrize("world", ["one", "ranks"])
@pytest.mark.parametrize("i", range(5))
def test_bootstrap_threshold_is_jax_sort_bit_for_bit(runs, world, i):
    raw, w, p = runs["inp"]["bootstrap"][i]
    want = np.asarray(jl.bootstrap_weights(jnp.asarray(raw), jnp.asarray(w), p))
    got = np.concatenate([r["bootstrap"][i] for r in runs[world]])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(runs["single"]["bootstrap"][i].view(np.int32),
                                  want.view(np.int32))


def test_sigterm_on_one_rank_stops_both_at_one_step(tmp_path):
    """SIGTERM reaches rank 1 alone: both ranks stop after the same step,
    rank 0 saves that step's checkpoint, and neither waits for ever in a
    collective (train/loop.py; the run's own timeout would fail the test)."""
    from helpers import TINY_BLOCKS, synthetic_batch, tiny_model
    from torch_parity import torch_tiny_model, torch_tiny_settings

    threads()
    nb4 = dict(Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4)
    jax_settings, settings = torch_tiny_settings(**nb4)
    variables = jax.tree_util.tree_map(np.asarray, tiny_model(jax_settings).init(
        jax.random.PRNGKey(0), np.zeros((2, 32, 64, 3), np.float32)))
    settings = settings.replace(log_dir=str(tmp_path / "log"), save_checkpoints_steps=100)
    inp = {"settings": settings, "blocks": TINY_BLOCKS, "max_steps": 8, "signal_at": 3,
           "state_dict": torch_tiny_model(settings, variables).state_dict(),
           "batch": synthetic_batch(jax_settings, seed=1)}
    outs = run_ranks("preempt", inp, tmp_path)
    steps = [o["step"] for o in outs]
    # the step it lands on depends on how far the prefetcher ran ahead
    assert steps[0] == steps[1] and 0 <= steps[0] < inp["max_steps"], steps
    assert outs[0]["checkpoints"] == [str(steps[0])]
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])

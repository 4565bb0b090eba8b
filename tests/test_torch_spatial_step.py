"""The port's train step under spatial partitioning, on gloo ranks on the
CPU: spatial 2 x data 1 (2 ranks) and spatial 2 x data 2 (4 ranks), each
spatial group of 2 splitting the height of its batch shard's images,
against the port's single-process step on the global batch and against the
JAX package's step on ``create_mesh(2, spatial_partitions=2)`` over the
virtual CPU devices of tests/conftest.py (XLA's halo exchanges).

Every run starts from the same flax-initialized weights of the tiny f32
model (tests/helpers.py) and takes 2 steps on helpers.synthetic_batch at
4 + 4 + 4 images of 32x64 (each rank: its batch shard's images, whose 16
rows of 32 it holds). Variants: the optax path and the fused optimizer,
both with ``fused_loss=False`` as tests/test_spatial.py runs JAX; the fused
optimizer with ``fused_loss`` left on (the spatial step turns the fused loss
off, as JAX's does: the same bits as ``fused_loss=False``); and the blur,
flip and scale augmentations with ``grad_accum_steps=2`` (the draws of a
batch shard, applied to whole images before the band is taken: the median
filter and the rescale read rows of other bands). Color is left out of that
variant: with all four at 2 + 2 + 2 images a microbatch, the single-process
step's own step-1 gradient moves by 0.57% in relative norm between one CPU
thread and eight (PyTorch's CPU kernels round by their chunking, and a
random net's train-mode BatchNorm gradient at a few images amplifies it;
each augmentation alone, and color with blur or with scale, stay within
1.1e-5), so no gradient bar could tell the ranks from the reference there.

Tolerances: tests/test_spatial.py's between meshes, loss rtol 1e-5 and
parameters after step 1 atol 1e-5 / rtol 1e-4, against the single-process
port and (optax path) against JAX; the batch mIoU 2e-3
(test_torch_train_step.py); the all-reduced step-1 gradient within 1e-4 in
relative norm of the single-process port's
(test_torch_distributed_step.py); the state after 2 steps bit-equal on
every rank.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from helpers import TINY_BLOCKS, synthetic_batch, tiny_model
from iv2019_tpu.parallel.mesh import create_mesh as jax_create_mesh
from iv2019_tpu.parallel.mesh import replicate as jax_replicate
from iv2019_tpu.parallel.mesh import shard_batch as jax_shard_batch
from iv2019_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from iv2019_tpu.train.state import create_train_state as jax_create_state
from iv2019_tpu.train.step import make_train_step as jax_make_train_step
from iv2019_tpu_torch.utils.convert import flax_from_state_dict
from test_torch_distributed_step import GRAD_REL_NORM, assert_state_equal, grad_rel_norm
from test_torch_train_step import MIOU_ATOL
from torch_parity import numpy_tree, run_ranks, threads, torch_tiny_model, torch_tiny_settings

STEPS = 2
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
NB4 = dict(Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4)
VARIANTS = {
    "optax": dict(fused_loss=False, fused_optimizer=False),
    "fused": dict(fused_loss=False),
    "fused_loss_flag": {},
    "augment_accum2": dict(fused_loss=False, grad_accum_steps=2,
                           augmentations=("blur", "flip", "scale")),
}
LAYOUTS = {"spatial2_data1": 2, "spatial2_data2": 4}
LOSS_METRICS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
                "regularization")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads()
    settings, jax_settings = {}, {}
    for name, kw in VARIANTS.items():
        jax_settings[name], settings[name] = torch_tiny_settings(**NB4, **kw)
    js = jax_settings["optax"]
    jmodel = tiny_model(js, train=True)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(42), np.zeros((2, 32, 64, 3), np.float32)))
    batch = synthetic_batch(js, seed=42)
    state_dict = {k: v.clone() for k, v in
                  torch_tiny_model(settings["optax"], variables).state_dict().items()}
    inp = {"variants": settings, "state_dict": state_dict, "blocks": TINY_BLOCKS,
           "batch": batch, "steps": STEPS}
    tmp = tmp_path_factory.mktemp("spatial_step")
    out = {"variables": variables, "single": worker.run_steps(inp, None)}
    for layout, world in LAYOUTS.items():
        out[layout] = run_ranks("step", inp, tmp, world=world, spatial=2, timeout=180)
    # JAX: the optax path on the spatial mesh (tests/test_spatial.py)
    mesh = jax_create_mesh(2, spatial_partitions=2)
    tx, _ = jax_make_optimizer(js)
    state = jax_replicate(jax_create_state(variables, tx, js.ema_decay), mesh)
    step = jax_make_train_step(js, model=tiny_model(js, train=True), tx=tx, mesh=mesh)
    history, params = [], []
    for _ in range(STEPS):
        state, m = step(state, jax_shard_batch(dict(batch), mesh))
        history.append({k: float(v) for k, v in m.items() if k != "weight_masks"})
        params.append(numpy_tree(state.params))
    out["jax"] = {"history": history, "params": params}
    return out


def _params(result, key="model1"):
    return flax_from_state_dict({k: torch.from_numpy(v) for k, v in result[key].items()})[0]


def _assert_params_close(got, want, what):
    flat_got, flat_want = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (got, want))
    assert flat_got.keys() == flat_want.keys()
    for path, a in flat_got.items():
        np.testing.assert_allclose(a, flat_want[path], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_metrics_close(got, want, what):
    for k in LOSS_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=f"{what} {k}")
    assert abs(got["miou"] - want["miou"]) <= MIOU_ATOL, what


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_metrics_match_one_process(runs, layout, name):
    for rank in runs[layout]:
        for step in range(STEPS):
            _assert_metrics_close(rank[name]["metrics"][step],
                                  runs["single"][name]["metrics"][step], f"step {step + 1}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_metrics_match_jax_spatial_mesh(runs, layout):
    for rank in runs[layout]:
        for step in range(STEPS):
            _assert_metrics_close(rank["optax"]["metrics"][step], runs["jax"]["history"][step],
                                  f"step {step + 1}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_step1_gradient_and_params_match_one_process(runs, layout, name):
    single = runs["single"][name]
    for rank in runs[layout]:
        assert grad_rel_norm(rank[name]["grads"], single["grads"]) <= GRAD_REL_NORM
        _assert_params_close(_params(rank[name]), _params(single), "ranks vs single")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_params_after_one_step_match_jax_spatial_mesh(runs, layout):
    want = runs["jax"]["params"][0]
    _assert_params_close(_params(runs["single"]["optax"]), want, "single vs jax")
    for rank in runs[layout]:
        _assert_params_close(_params(rank["optax"]), want, "ranks vs jax")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_is_replicated_bit_for_bit(runs, layout, name):
    first, *others = runs[layout]
    for other in others:
        assert_state_equal(first[name], other[name])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_step_runs_the_unfused_loss(runs, layout):
    """With ``fused_loss`` on, the spatial step computes what it computes
    with it off, bit for bit: the gate turns the fused loss off."""
    for rank in runs[layout]:
        assert_state_equal(rank["fused_loss_flag"], rank["fused"])
        assert rank["fused_loss_flag"]["metrics"] == rank["fused"]["metrics"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_halo_exchanges_per_step(runs, layout):
    """Each step exchanges halos forward and backward; the counts agree on
    every rank (a collective every rank must join)."""
    for name in VARIANTS:
        counts = [[c["halo"] for c in rank[name]["collectives"]] for rank in runs[layout]]
        assert all(c == counts[0] for c in counts) and min(counts[0]) > 0, (name, counts)

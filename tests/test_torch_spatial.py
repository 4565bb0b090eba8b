"""Spatial partitioning in the port: the mesh's bookkeeping, the refusals,
the input stream, the eval step and the image-summary forward.

- Mesh layouts as tests/test_spatial.py pins JAX's (``test_mesh_layouts``,
  ``test_shard_batch_splits_height``, ``test_box_tensors_never_shard_spatially``):
  (replica?, data, spatial) with spatial the fastest axis, the batch split
  over the batch shards only, ``shard_height`` a rank's band, box tensors
  whole on their dim 1; a height that does not divide by 8 x
  ``spatial_partitions`` raises ``ValueError`` (JAX's ``shard_batch``
  replicates such arrays silently instead).
- The refusals of the JAX package: TTA and sliding windows
  (``Settings.validate``) and multi-process eval
  (``SemanticSegmentation.evaluate``).
- The stream: the ranks of a spatial group read the same images; batch
  shards read their own.
- The eval step: ``SemanticSegmentation.evaluate`` of the small f32 model
  (tests/torch_parity.py ``SMALL_BLOCKS``: block3 at rate 2) on the ranks
  of one process's devices, spatial 2 x data 1 and 2 x data 2, against the
  sweep in this process: the confusion matrices equal integer for integer
  (as tests/test_spatial.py::test_eval_step_parity_data_vs_spatial holds
  JAX's).
- The image-summary forward of the training loop runs on rank 0 alone
  (the other rank waits at a host barrier; a halo exchange there would
  hang, and the run's timeout would fail the test) and gives the
  single-process decisions.
"""

import os

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from helpers import TINY_BLOCKS, synthetic_batch
from helpers import tiny_model as jax_tiny_model
from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.input.heterogeneous import train_input
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from iv2019_tpu_torch.system import SemanticSegmentation
from torch_parity import (SMALL_BLOCKS, SMALL_FDIMS, run_ranks, small_variables, threads,
                          torch_tiny_model, torch_tiny_settings, write_trained_npz)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")


def test_mesh_layouts():
    m = pmesh.create_mesh(8, 5, spatial_partitions=2)
    assert (m.spatial, m.batch_shards, m.data_index, m.spatial_index) == (2, 4, 2, 1)
    assert pmesh.local_batch_size(8, m) == 2  # the batch divides over 4 data shards
    m3 = pmesh.create_mesh(8, 6, num_slices=2, spatial_partitions=2)
    assert (m3.batch_shards, m3.data_index, m3.spatial_index) == (4, 3, 0)
    assert pmesh.local_batch_size(8, m3) == 2
    assert pmesh.spatial_groups(8, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        pmesh.create_mesh(8, 0, spatial_partitions=3)
    with pytest.raises(ValueError):
        pmesh.local_batch_size(6, m)


def test_shard_height_splits_height():
    images = np.arange(4 * 32 * 64 * 3, dtype=np.float32).reshape(4, 32, 64, 3)
    labels = torch.arange(4 * 32 * 64).reshape(4, 32, 64)
    for rank in range(2):
        m = pmesh.create_mesh(2, rank, spatial_partitions=2)
        band = pmesh.shard_height(images, m)
        assert band.shape == (4, 16, 64, 3)
        np.testing.assert_array_equal(band, images[:, 16 * rank:16 * (rank + 1)])
        assert torch.equal(pmesh.shard_height(labels, m), labels[:, 16 * rank:16 * (rank + 1)])
    assert pmesh.shard_height(images, pmesh.create_mesh(2, 1)) is images


def test_height_must_divide_by_8_x_partitions():
    m = pmesh.create_mesh(2, 0, spatial_partitions=2)
    with pytest.raises(ValueError, match="8 x spatial_partitions"):
        pmesh.shard_height(np.zeros((1, 24, 8, 3), np.float32), m)
    with pytest.raises(ValueError, match="8 x spatial_partitions"):
        Settings(height_feature_extractor=520, spatial_partitions=2).finalize()
    Settings(height_feature_extractor=512, spatial_partitions=4).finalize()


def test_box_tensors_never_shard_spatially():
    """bbox_coords (N, 516, 4) and bbox_cids (N, 516): batch rows by the
    batch shard, dim 1 whole; images keep their height too (the step takes
    the band after the augmentations)."""
    batch = {"bbox_coords": np.zeros((4, 516, 4), np.float32),
             "bbox_cids": np.zeros((4, 516), np.int32),
             "proimages_per_pixel": np.zeros((4, 32, 64, 3), np.float32)}
    for rank in range(8):
        mesh = pmesh.create_mesh(8, rank, spatial_partitions=2)
        out = multihost.put_sharded(batch, mesh)
        assert out["bbox_coords"].shape == (1, 516, 4)
        assert out["bbox_cids"].shape == (1, 516)
        assert out["proimages_per_pixel"].shape == (1, 32, 64, 3)


@pytest.mark.parametrize("kw,error", [
    (dict(eval_flip=True), "TTA"),
    (dict(eval_scales=(0.75, 1.0)), "TTA"),
    (dict(sliding_window=True, eval_size=(64, 128)), "sliding_window"),
], ids=["flip", "scales", "windows"])
def test_tta_and_windows_refuse_spatial(kw, error):
    with pytest.raises(ValueError, match=error):
        Settings(height_feature_extractor=64, width_feature_extractor=128, spatial_partitions=2,
                 **kw).finalize()


def test_multi_process_eval_refuses_spatial(tmp_path):
    settings = Settings(device="cpu", mode="eval", log_dir=str(tmp_path), spatial_partitions=2,
                        num_processes=2, process_id=0, coordinator_address="localhost:1",
                        Nb=2, Nb_per_pixel=2, Nb_per_bbox=2, Nb_per_image=2,
                        training_problem_def_path=PROBLEM)
    system = SemanticSegmentation({}, settings=settings)
    with pytest.raises(NotImplementedError, match="multi-process eval"):
        system.evaluate()


def _first_batch(world, rank, spatial):
    settings = Settings(device="cpu", synthetic_data=True, input_seed=5,
                        height_feature_extractor=32, width_feature_extractor=64,
                        Nb_per_pixel=4, Nb_per_bbox=4, Nb_per_image=4, Nb=4).finalize()
    pmesh.set_active(pmesh.create_mesh(world, rank, spatial_partitions=spatial))
    try:
        return next(train_input(settings, load_problem_def(PROBLEM)))
    finally:
        pmesh.set_active(None)


def test_spatial_group_reads_one_stream():
    """4 ranks as 2 data x 2 spatial: ranks 0, 1 (data 0) get the same
    images, ranks 2, 3 (data 1) the same as each other and others than
    data 0's: 2 of the 4 per-pixel images each (the global batch over the
    batch shards), seeded by the batch shard."""
    batches = [_first_batch(4, rank, 2) for rank in range(4)]
    for a, b in ((0, 1), (2, 3)):
        for k in ("proimages_per_pixel", "prolabels_per_pixel", "proimages_per_bbox"):
            np.testing.assert_array_equal(batches[a][k], batches[b][k])
    assert batches[0]["proimages_per_pixel"].shape == (2, 32, 64, 3)
    assert not np.array_equal(batches[0]["proimages_per_pixel"],
                              batches[2]["proimages_per_pixel"])
    # without spatial partitioning each rank is a batch shard: rank r of 2
    # reads what the spatial group of data index r reads
    for rank in range(2):
        data = _first_batch(2, rank, 1)
        np.testing.assert_array_equal(data["proimages_per_pixel"],
                                      batches[2 * rank]["proimages_per_pixel"])


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_trained_npz(tmp_path_factory.mktemp("spatial_eval") / "model.npz",
                             small_variables(seed=2), with_ema=False, own_values=True)


@pytest.mark.parametrize("world", [2, 4], ids=["spatial2_data1", "spatial2_data2"])
def test_spatial_eval_equals_one_process(npz, tmp_path, world):
    threads()
    settings = dict(mode="eval", device="cpu", log_dir=str(tmp_path / "log"), ckpt_path=npz,
                    Nb=4, Neval=8, height_feature_extractor=64, width_feature_extractor=64,
                    compute_dtype="float32", synthetic_data=True,
                    feature_dims_decreased=SMALL_FDIMS, training_problem_def_path=PROBLEM)
    want = worker.run_eval({"settings": settings, "blocks": SMALL_BLOCKS}, None)
    inp = {"settings": dict(settings, spatial_partitions=2), "blocks": SMALL_BLOCKS}
    got = run_ranks("eval", inp, tmp_path, world=world, devices=True, spatial=2, timeout=180)
    (step, cm), = want
    assert 0 < cm.sum() <= 8 * 64 * 64
    for rank in got:
        (got_step, got_cm), = rank
        assert got_step == step
        assert got_cm.dtype == np.int64
        np.testing.assert_array_equal(got_cm, cm)


def test_image_summary_forward_runs_on_rank_0_alone(tmp_path):
    threads()
    import jax

    js, settings = torch_tiny_settings()
    variables = jax.tree_util.tree_map(np.asarray, jax_tiny_model(js).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32)))
    state_dict = torch_tiny_model(settings, variables).state_dict()
    inp = {"settings": settings, "state_dict": state_dict, "blocks": TINY_BLOCKS,
           "batch": synthetic_batch(js, seed=1)}
    want = worker.run_summary(inp, None)
    got = run_ranks("summary", inp, tmp_path, world=2, spatial=2, timeout=120)
    assert want["decisions"].shape == (32, 64, 3)
    np.testing.assert_array_equal(got[0]["decisions"], want["decisions"])


def test_device_rasterizer_band_is_the_whole_rows():
    """A band of the device rasterizer (boxes above, across and below it,
    padding and invalid ids) is the same bits as those rows of the whole."""
    from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes

    rng = np.random.RandomState(3)
    cids = torch.from_numpy(rng.randint(-1, 17, (3, 12)).astype(np.int32))
    lo = rng.uniform(-0.1, 0.9, (3, 12, 2))
    boxes = np.stack([lo[..., 0], lo[..., 0] + rng.uniform(0, 0.5, (3, 12)),
                      lo[..., 1], lo[..., 1] + rng.uniform(0, 0.5, (3, 12))], -1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    whole = rasterize_bboxes(cids, boxes, 32, 24)
    for a, b in ((0, 16), (16, 32), (8, 16)):
        assert torch.equal(rasterize_bboxes(cids, boxes, 32, 24, rows=(a, b)), whole[:, a:b])


def test_root_kernel_index_math_with_pad_rows():
    """B6's root kernel on a band that carries its halo (no pad rows): the
    slab origin of every chunk (``_plan(..., pad_rows=(0, 0))``) and the
    kernel's im2row formula, emulated in numpy, give the plain version's dW
    with those pad rows (tests/test_torch_root_wgrad.py emulates the
    conv2d_same case)."""
    from iv2019_tpu_torch.ops import root_wgrad as trw
    from test_torch_root_wgrad import SMS, _emulate_root_kernel

    rng = np.random.RandomState(4)
    n, h, w = 2, 13, 256  # a band of 8 rows with 3 above and 2 below
    x = torch.tensor(rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)).bfloat16().float()
    dy = torch.tensor(rng.uniform(-1, 1, (n, 4, w // 2, 64)).astype(np.float32)).bfloat16()
    plan = trw._plan((n, 3, h, w), 64, 7, SMS, pad_rows=(0, 0))
    assert plan.root and plan.pad_top == 0
    assert trw.wgrad_supported((n, 3, h, w), (n, 64, 4, w // 2), 7, 2, (0, 0))
    got = _emulate_root_kernel(x.numpy(), dy.float().numpy(), plan)
    want = trw.root_conv_wgrad_reference(x.permute(0, 3, 1, 2), dy.float().permute(0, 3, 1, 2),
                                         pad_rows=(0, 0)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

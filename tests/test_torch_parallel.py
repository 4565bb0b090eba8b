"""The port's mesh and multi-process helpers against the JAX package's, in
one process (the runs across ranks are in tests/test_torch_distributed_*.py).

- ``create_mesh``'s layout errors and ``local_batch_size`` with JAX's
  messages; ``shard_rows`` gives each rank the rows JAX's sharding puts on
  its device (the batch sharded on ``data``; at accumulation the restacked
  microbatches sharded on their second axis, iv2019_tpu/train/step.py);
- ``local_share`` / ``shard_records`` with explicit index and count, and
  ``Settings.validate`` as tests/test_multihost.py::test_settings_validation
  holds JAX's, message for message; spatial partitions stay refused;
- ``initialize`` refuses what it cannot start (torchrun's environment
  missing, several processes without a coordinator, more CUDA devices than
  are visible) and starts nothing for one process of one device;
- BatchNorm takes the single-device path at one rank and under
  ``unsynced_norms``, group norm and eval-mode BatchNorm take no collective;
- a checkpoint manager that is not rank 0's writes nothing;
- ``kth_largest`` gives JAX's sort threshold bit for bit (ties, -0.0).
"""

import re

import numpy as np
import pytest
import torch

from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu.losses import hierarchical as jl
from iv2019_tpu.parallel import mesh as jmesh
from iv2019_tpu.parallel import multihost as jmultihost
from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.losses.hierarchical import kth_largest
from iv2019_tpu_torch.models.layers import Norm
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.parallel import multihost
from iv2019_tpu_torch.utils.checkpoint import CheckpointManager
from torch_parity import threads


def _jax_error(fn):
    with pytest.raises(Exception) as err:
        fn()
    return err


@pytest.mark.parametrize("n,slices,spatial", [(3, 2, 1), (1, 2, 1), (6, 4, 1), (2, 4, 1),
                                              (3, 1, 2)])
def test_create_mesh_errors_match_jax(n, slices, spatial):
    err = _jax_error(lambda: jmesh.create_mesh(n, num_slices=slices, spatial_partitions=spatial))
    with pytest.raises(type(err.value), match=re.escape(str(err.value))):
        pmesh.create_mesh(n, num_slices=slices, spatial_partitions=spatial)


def test_create_mesh_layouts():
    # two slices: a layout check, then the same flat mesh
    m = pmesh.create_mesh(4, 3, num_slices=2)
    assert (m.world, m.rank) == (4, 3)
    assert jmesh.create_mesh(4, num_slices=2).shape == {"replica": 2, "data": 2}
    m = pmesh.create_mesh(4, 3, local_rank=1, local_size=2)
    assert (m.host, m.num_hosts, m.local_rank) == (1, 2, 1)
    # spatial partitions: JAX's (data, spatial) layout, spatial the fastest axis
    m = pmesh.create_mesh(4, 1, spatial_partitions=2)
    assert jmesh.create_mesh(4, spatial_partitions=2).shape == {"data": 2, "spatial": 2}
    assert (m.spatial, m.batch_shards, m.data_index, m.spatial_index) == (2, 2, 0, 1)


@pytest.mark.parametrize("nb,n", [(8, 2), (16, 4), (4, 4), (6, 4), (3, 2)])
def test_local_batch_size_matches_jax(nb, n):
    jax_mesh = jmesh.create_mesh(n)
    mesh = pmesh.create_mesh(n)
    if nb % n:
        err = _jax_error(lambda: jmesh.local_batch_size(nb, jax_mesh))
        with pytest.raises(ValueError, match=re.escape(str(err.value))):
            pmesh.local_batch_size(nb, mesh)
    else:
        assert pmesh.local_batch_size(nb, mesh) == jmesh.local_batch_size(nb, jax_mesh)


@pytest.mark.parametrize("world,accum", [(2, 1), (4, 1), (2, 2), (2, 4), (4, 2)])
def test_shard_rows_are_the_rows_jax_puts_on_each_device(world, accum):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n = 16
    x = np.arange(n, dtype=np.int32)
    mesh = jmesh.create_mesh(world)
    if accum == 1:
        arr = jax.device_put(x, jmesh.batch_sharding(mesh))
    else:
        arr = jax.device_put(x.reshape(accum, n // accum), NamedSharding(mesh, P(None, "data")))
    devices = list(mesh.devices.flat)
    for shard in arr.addressable_shards:
        rank = devices.index(shard.device)
        # (accum, share): its share of each microbatch, microbatch by microbatch
        want = np.asarray(shard.data).reshape(-1)
        np.testing.assert_array_equal(pmesh.shard_rows(x, rank, world, accum), want)
        np.testing.assert_array_equal(pmesh.shard_rows(torch.from_numpy(x), rank, world, accum),
                                      want)
        assert pmesh.shard_rows(list(x), rank, world, accum) == list(want)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_rows(np.arange(6), 0, 4)


def test_local_share_and_shard_records_match_jax():
    assert multihost.local_share(8) == jmultihost.local_share(8) == 8
    for index, count in ((0, 3), (1, 3), (2, 3), (0, 1), (1, 2)):
        assert list(multihost.shard_records(range(7), index=index, count=count)) == list(
            jmultihost.shard_records(range(7), index=index, count=count))
    assert list(multihost.shard_records(range(5))) == [0, 1, 2, 3, 4]
    assert (multihost.process_index(), multihost.process_count(), multihost.is_primary()) == (
        0, 1, True)


VALIDATION_CASES = [
    dict(num_processes=2),
    dict(num_processes=2, coordinator_address="h:1", process_id=5),
    dict(num_processes=3, coordinator_address="h:1", Nb_per_pixel=4, Nb_per_bbox=4,
         Nb_per_image=4),
    dict(num_processes=-1),
]


@pytest.mark.parametrize("kw", VALIDATION_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_settings_validation_matches_jax(kw):
    err = _jax_error(lambda: JaxSettings(**kw).finalize().validate())
    with pytest.raises(type(err.value), match=re.escape(str(err.value))):
        Settings(**kw).finalize()


def test_multi_device_settings_are_accepted():
    # 0 = the cluster from the runtime (torchrun here), as JAX's TPU-pod auto
    for kw in (dict(num_processes=0), dict(num_devices=2), dict(num_slices=2),
               dict(num_processes=2, coordinator_address="h:1", process_id=1)):
        JaxSettings(**kw).finalize().validate()
        Settings(**kw).finalize()
    # spatial partitions too, on a height that divides by 8 x partitions
    JaxSettings(spatial_partitions=2).finalize().validate()
    Settings(spatial_partitions=2).finalize()
    with pytest.raises(ValueError, match="8 x spatial_partitions"):
        Settings(spatial_partitions=2, height_feature_extractor=520).finalize()


def test_initialize_refuses_what_it_cannot_start(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.initialize(Settings(device="cpu", num_processes=0))
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(Settings(device="cpu", num_processes=2))
    with pytest.raises(ValueError, match="started by multihost.launch"):
        multihost.initialize(Settings(device="cpu", num_devices=2))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            multihost.local_devices(Settings(device="cuda", num_devices=2))
    assert multihost.local_devices(Settings(device="cpu")) == 1
    assert multihost.local_devices(Settings(device="cpu", num_devices=3)) == 3
    # one process of one device: no process group
    assert multihost.initialize(Settings(device="cpu")) is None
    assert pmesh.active() is None and not torch.distributed.is_initialized()


def test_default_devices_are_one_outside_launch(monkeypatch):
    # a host with two cards: launch starts a rank on each, a caller that
    # starts its rank itself (the API entry points called directly) has one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert multihost.local_devices(Settings(device="cuda")) == 2
    assert multihost.initialize(Settings(device="cuda")) is None
    assert pmesh.active() is None and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="started by multihost.launch"):
        multihost.initialize(Settings(device="cuda", num_devices=2))


def test_launch_starts_a_rank_per_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    started = {}

    def start_processes(fn, args, nprocs, **kw):
        started.update(nprocs=nprocs, settings=args[1])

    monkeypatch.setattr(torch.multiprocessing, "start_processes", start_processes)
    assert multihost.launch(print, Settings(device="cuda")) is None
    # the ranks get the count: initialize reads it, not None
    assert started["nprocs"] == 2 and started["settings"].num_devices == 2
    # one device: the function runs in this process
    assert multihost.launch(lambda s: s.num_devices, Settings(device="cuda", num_devices=1)) == 1


def test_put_sharded_takes_the_ranks_rows():
    batch = {"a": np.arange(8).reshape(4, 2), "empty": np.zeros((0, 3)), "paths": list("wxyz"),
             "scalar": np.float32(2.0), "name": "x"}
    mesh = pmesh.create_mesh(2, 1)
    got = multihost.put_sharded(batch, mesh)
    np.testing.assert_array_equal(got["a"].numpy(), [[4, 5], [6, 7]])
    assert got["empty"].shape == (0, 3) and got["paths"] == ["y", "z"]
    assert float(got["scalar"]) == 2.0 and got["name"] == "x"
    got = multihost.put_sharded(batch, mesh, accum=2)
    np.testing.assert_array_equal(got["a"].numpy(), [[2, 3], [6, 7]])


def _norm_outputs(norm, x):
    x = x.clone().requires_grad_(True)
    y = norm(x)
    y.square().sum().backward()
    return y.detach(), x.grad, [b.clone() for b in norm.buffers()]


@pytest.fixture
def two_rank_mesh():
    """An active mesh of 2 ranks with no process group behind it: a
    collective would raise."""
    pmesh.set_active(pmesh.create_mesh(2, 0))
    yield
    pmesh.set_active(None)


def test_norms_that_need_no_collective(two_rank_mesh):
    threads()
    x = torch.randn(2, 64, 4, 5)
    group = Norm(64, norm_type="group").train()
    assert torch.equal(group(x), Norm(64, norm_type="group").train()(x))
    bn = Norm(64).eval()
    assert torch.equal(bn(x), Norm(64).eval()(x))
    # a forward one rank runs alone (train/loop.py's image summaries)
    with pmesh.unsynced_norms():
        got = _norm_outputs(Norm(64).train(), x)
    pmesh.set_active(None)
    want = _norm_outputs(Norm(64).train(), x)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(g, w)


def test_batch_norm_at_one_rank_is_the_single_device_path():
    threads()
    x = torch.randn(3, 16, 5, 4)
    want = _norm_outputs(Norm(16).train(), x)
    pmesh.set_active(pmesh.create_mesh(1, 0))
    try:
        assert pmesh.norm_mesh() is None
        got = _norm_outputs(Norm(16).train(), x)
    finally:
        pmesh.set_active(None)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(g, w)


def test_a_manager_of_another_rank_writes_nothing(tmp_path):
    from iv2019_tpu_torch.train.state import TrainState

    model = torch.nn.Linear(2, 2)
    state = TrainState(step=torch.tensor(3), model=model, opt_state=None)
    manager = CheckpointManager(str(tmp_path), primary=False)
    manager.save(3, state, None)
    manager.close()
    assert manager.all_steps() == [] and sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoints"]
    assert not list((tmp_path / "checkpoints").iterdir())


@pytest.mark.parametrize("seed", range(4))
def test_kth_largest_is_the_jax_sort_threshold(seed):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    values = rng.choice(np.array([0.0, -0.0, 1.0, 1.0, 2.5, -1.0, 7.0], np.float32), 300)
    if seed % 2:
        values = np.concatenate([values, rng.randn(100).astype(np.float32),
                                 np.full(5, np.finfo(np.float32).min, np.float32)])
    masked = jnp.asarray(values)
    for k in (1, 2, 17, 150, len(values)):
        want = np.asarray(jnp.sort(masked)[::-1][k - 1])
        got = kth_largest(torch.from_numpy(values), torch.tensor(k)).numpy()
        assert got.view(np.int32) == want.view(np.int32), k
    # and the kept set of JAX's bootstrap_weights at that threshold
    w = (rng.rand(len(values)) < 0.6).astype(np.float32)
    jw = np.asarray(jl.bootstrap_weights(masked, jnp.asarray(w), 30))
    valid = w != 0
    masked_np = np.where(valid, values, np.finfo(np.float32).min).astype(np.float32)
    k = max(int(valid.sum()) * 30 // 100, 1)
    thr = kth_largest(torch.from_numpy(masked_np), torch.tensor(k)).numpy()
    np.testing.assert_array_equal(w * ((values >= thr) & valid), jw)

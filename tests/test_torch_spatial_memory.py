"""The port's spatial memory table (iv2019_tpu_torch/tools/spatial_memory_table.py)
on the CPU.

- The row plan equals the JAX tool's (tools/spatial_memory_table.py) for
  six flag sets: the JAX tool's ``main`` runs in a subprocess with its
  ``analyze`` replaced by a stub, so no JAX model compiles and the tool is
  not edited.
- ``row_settings`` equals the Settings of the JAX tool's ``analyze`` on
  every field the two packages share.
- The JAX test's claim (tests/test_spatial_memory.py) on the port, with
  ``LiveBytes`` as the CPU's measure: at 256x512 and ndev 8, factor 4 (four
  gloo ranks, nb 2) cuts a rank's temp memory below 0.75 x factor 1's (one
  process, nb 8), at the same load per data shard.
- One spatial group equals its whole mesh: the largest per-rank peak of the
  2-rank group at ndev 4, factor 2, within 2% of the 4-rank mesh's.
- ``LiveBytes`` against a hand-counted sequence of allocations and frees.
- The CLI's markdown row and JSON line at the smallest CPU row, and its
  refusal without a card.

The multi-rank rows cut the trunk to helpers.TINY_BLOCKS (full ResNet-50
ranks would take minutes here); each row's ranks run under its own
timeout, as torch_parity.run_ranks does.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import TINY_BLOCKS
from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu_torch.tools import spatial_memory_table as smt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TIMEOUT_S = 240
TEMP_RATIO = 0.75  # tests/test_spatial_memory.py:40-42
GROUP_REL_TOL = 0.02
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
JAX_ROW_KEYS = {"h", "w", "spatial", "remat", "accum", "ndev", "nb", "temp_gb", "args_gb",
                "output_gb", "total_gb"}
FLAG_SETS = {
    "quick": ["--quick"],
    "default": [],
    "sizes_factors": ["--sizes", "920x1268,1240x1712", "--factors", "2,8"],
    "accum3": ["--accum", "3"],
    "remat": ["--remat"],
    "levers": ["--ndev", "1", "--nb", "4", "--accum", "4"],
}

_JAX_PLAN = r"""
import contextlib, io, json, sys
sys.path.insert(0, "tools")
import spatial_memory_table as tool

def stub(h, w, spatial, nb=2, remat=False, accum=1, ndev=8):
    return {"temp_gb": 0.0, "args_gb": 0.0, "output_gb": 0.0, "total_gb": 0.0}

tool.analyze = stub
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    sys.argv = ["spatial_memory_table.py"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.main()
    out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])["detail"]["rows"]
print(json.dumps(out))
"""


def row(h, w, spatial, nb, ndev, accum=1, remat=False):
    return dict(h=h, w=w, spatial=spatial, remat=remat, accum=accum, ndev=ndev, nb=nb)


def tiny_row(r, **kw):
    return smt.run_row(r, "cpu", blocks=TINY_BLOCKS, timeout=ROW_TIMEOUT_S, **kw)


@pytest.fixture(scope="module")
def jax_plans():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_PLAN, json.dumps(FLAG_SETS)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_row_plan_is_the_jax_tools(jax_plans, name):
    want = [{k: r[k] for k in smt.ROW_KEYS} for r in jax_plans[name]]
    assert smt.row_plan(smt.parse_args(FLAG_SETS[name])) == want


@pytest.mark.parametrize("h,w,spatial,nb,remat,accum,ndev", [
    (512, 1024, 1, 8, False, 1, 8), (1024, 1140, 4, 2, True, 2, 8), (512, 1024, 1, 4, False, 4, 1)])
def test_row_settings_are_analyzes(h, w, spatial, nb, remat, accum, ndev):
    """Every field the two Settings share is the JAX tool's (:55-67) but
    ``bn_impl``, each package's default (the port's N1/N2, JAX's flax); the
    port's alone is ``device``."""
    import dataclasses

    want = JaxSettings(
        per_pixel_dataset_name="vistas", Nb_per_pixel=nb, Nb_per_bbox=nb, Nb_per_image=nb, Nb=nb,
        height_feature_extractor=h, width_feature_extractor=w, Ntrain=256, Ne=3,
        learning_rate_boundaries=(1, 2), learning_rate_values=(0.01, 0.005, 0.0025),
        compute_dtype="bfloat16", spatial_partitions=spatial, remat=remat,
        grad_accum_steps=accum, num_devices=ndev).finalize()
    got = smt.row_settings(h, w, spatial, nb, remat, accum, ndev, device="cpu")
    names = {f.name for f in dataclasses.fields(got)}
    shared = names & {f.name for f in dataclasses.fields(want)}
    assert names - shared == {"device"}
    shared.discard("bn_impl")
    assert {n: getattr(got, n) for n in shared} == {n: getattr(want, n) for n in shared}
    assert (got.bn_impl, want.bn_impl) == ("fused", "flax")
    assert not got.root_wgrad_pallas and got.fused_loss and got.fused_optimizer


def test_row_batch_is_analyzes():
    """The draws of the JAX tool's batch (:82-92), bit for bit."""
    nb, h, w = 2, 16, 24
    eye = np.eye(15, dtype=np.float32)
    rng = np.random.RandomState(0)
    want = {
        "proimages_per_pixel": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "proimages_per_bbox": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "proimages_per_image": rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
        "prolabels_per_pixel": rng.randint(0, 60, (nb, h, w)).astype(np.int32),
        "prolabels_per_bbox": eye[rng.randint(0, 15, (nb, h, w))],
        "prolabels_per_image": eye[rng.randint(0, 15, (nb, h, w))],
    }
    got = smt.row_batch(h, w, nb)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("r,message", [
    (row(512, 1024, 1, 6, 8, accum=3), "not divisible by 3 microbatches x 8 data shards"),
    (row(512, 1024, 2, 1, 1), "1 devices not divisible into 2 spatial partitions"),
    (row(512, 1024, 1, 3, 2), "not divisible by 1 microbatches x 2 data shards")])
def test_a_batch_the_mesh_cannot_shard_is_an_error_row(r, message):
    """As JAX's shard_batch refuses it: the row records the error, no rank starts."""
    out = smt.run_row(r, "cpu", timeout=5)
    assert message in out["error"] and not out["oom"]
    assert {k: out[k] for k in smt.ROW_KEYS} == r


def test_a_failed_rank_is_an_error_row():
    """A rank that raises ends the row's other ranks; the row carries its error."""
    out = smt.run_row(row(64, 128, 2, 2, 4), "cpu", blocks=((2, 32),), timeout=ROW_TIMEOUT_S)
    assert "error" in out and "per_rank" not in out and out["wall_s"] < ROW_TIMEOUT_S


@pytest.fixture(scope="module")
def claim_rows():
    """The JAX test's two configurations at 256x512 on an 8-device mesh: 8
    images over 8 data shards, and 2 each split over 4 ranks."""
    return {1: tiny_row(row(256, 512, 1, 8, 8)), 4: tiny_row(row(256, 512, 4, 2, 8))}


def test_spatial_factor_4_cuts_temp(claim_rows):
    base, spat = claim_rows[1], claim_rows[4]
    for r in (base, spat):
        assert "error" not in r, r
        assert r["temp_gb"] > 0 and r["args_gb"] > 0 and r["finite"]
        assert r["shard_nb"] == 1
    assert (base["ranks"], spat["ranks"]) == (1, 4)
    assert spat["temp_gb"] < TEMP_RATIO * base["temp_gb"], (base, spat)


def test_rows_count_their_bytes_and_halos(claim_rows):
    """total = args + temp per rank; halo exchanges only when height splits;
    on the CPU the wrappers run their plain versions, so no kernel counts a
    launch, and there is no card to fit on."""
    for f, r in claim_rows.items():
        for rank in r["per_rank"]:
            assert rank["total_bytes"] == rank["args_bytes"] + rank["temp_bytes"]
            assert 0 <= rank["output_bytes"] < rank["temp_bytes"]
            assert (rank["halo"] > 0) == (f > 1)
            assert (rank["halo_buffer_bytes"] > 0) == (f > 1)
            assert rank["halo_buffer_bytes"] <= rank["halo_bytes"]
            assert rank["reserved_bytes"] is None and rank["device_bytes"] is None
        assert r["launches"] == {k: [0] * r["ranks"] for k in smt.KERNELS}
        assert r["fits"] is None and r["reserved_gb"] is None
        assert 0 <= r["halo_buffer_share"] < 1


def test_one_group_equals_its_mesh():
    """The 2-rank group the tool runs for ndev 4, factor 2, against all 4
    ranks of that mesh: the largest per-rank peak within 2%."""
    r = row(256, 512, 2, 2, 4)
    group, mesh = tiny_row(r), tiny_row(r, full_mesh=True)
    for out, ranks in ((group, 2), (mesh, 4)):
        assert "error" not in out, out
        assert out["ranks"] == ranks and out["finite"]
    peak = {k: max(p["total_bytes"] for p in out["per_rank"])
            for k, out in (("group", group), ("mesh", mesh))}
    assert abs(peak["group"] - peak["mesh"]) <= GROUP_REL_TOL * peak["mesh"], peak


def test_live_bytes_by_hand():
    """Storages counted once when an operation makes them, uncounted when
    freed; views and in-place results add nothing; tensors made before the
    mode count only when tracked; a storage resized in place counts at its
    new size."""
    before = torch.ones(5)  # 20 bytes, made outside the mode
    with smt.LiveBytes() as live:
        a = torch.empty(1000, dtype=torch.float32)
        assert (live.live, live.peak) == (4000, 4000)
        b = a.view(10, 100)
        c = a.add_(1)
        assert live.live == 4000
        d = torch.empty(250, dtype=torch.float64)
        assert (live.live, live.peak) == (6000, 6000)
        del a, c
        assert live.live == 6000  # b holds the storage
        del b
        assert (live.live, live.peak) == (2000, 6000)
        e = torch.zeros(3, dtype=torch.int32)
        live.reset_peak()
        assert (live.live, live.peak) == (2012, 2012)
        del d, e
        assert (live.live, live.peak) == (0, 2012)
        v = before.view(5)
        assert live.live == 0
        m = before.mul(2)
        assert live.live == 20
        live.track([before, v])
        assert live.live == 40
        f = torch.empty(10)
        f.resize_(100)
        assert (live.live, live.peak) == (440, 2012)
        del v, m, f
        assert live.live == 20  # ``before`` is still held
    del before
    assert live.live == 0


def test_cli_on_the_cpu():
    """The smallest CPU row through the CLI (full ResNet-50, 64x128, one
    process): the markdown row, then one JSON line with the JAX tool's keys."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "iv2019_tpu_torch.tools.spatial_memory_table", "--device", "cpu",
         "--sizes", "64x128", "--factors", "1", "--ndev", "1", "--nb", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4
    assert lines[0].startswith("| size | factor | temp GB")
    assert re.fullmatch(r"\| 64x128 \| x1 \| \d+\.\d\d \| \d+\.\d\d \| \d+\.\d\d \| n/a \|",
                        lines[2]), lines[2]
    line = json.loads(lines[3])
    assert set(line) == LINE_KEYS
    assert (line["metric"], line["value"], line["unit"], line["vs_baseline"]) == (
        "spatial_memory_table", 1, "configs", None)
    (r,) = line["detail"]["rows"]
    assert JAX_ROW_KEYS <= set(r)
    assert {k: r[k] for k in smt.ROW_KEYS} == row(64, 128, 1, 1, 1)
    assert r["total_gb"] > r["args_gb"] > 0 and r["finite"]
    assert line["detail"]["measured_by"] == "live bytes"


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "iv2019_tpu_torch.tools.spatial_memory_table",
                           "--quick"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr

"""The port's evaluation sweep on the ranks of one process's devices, on the
CPU with gloo: each rank takes its rows of each eval batch.

``SemanticSegmentation.evaluate`` of the small model (tests/torch_parity.py
``SMALL_BLOCKS``) from a converted checkpoint, over synthetic 64x64 eval
batches, runs on W ranks started as one process's devices
(tests/torch_dist_worker.py, scenario ``eval``, ``--devices``) and in this
process alone. Batch sizes whose groups do not split evenly over the ranks
are the cases: Nb 1 with an odd eval count (the last group padded), Nb 3 at
2 ranks and Nb 4 at 3 ranks (each batch padded up to a multiple of the
ranks). The summed confusion matrices must equal the single-process
sweep's, integer for integer, on every rank (no tolerance: they count
pixels).
"""

import os

import numpy as np
import pytest

import torch_dist_worker as worker
from torch_parity import (SMALL_BLOCKS, SMALL_FDIMS, run_ranks, small_variables, threads,
                          write_trained_npz)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_trained_npz(tmp_path_factory.mktemp("eval_ranks") / "model.npz",
                             small_variables(seed=2), with_ema=False, own_values=True)


@pytest.mark.parametrize("nb,neval,world", [(1, 3, 2), (3, 6, 2), (4, 4, 3)],
                         ids=["nb1-odd-count", "nb3-2ranks", "nb4-3ranks"])
def test_sweep_over_device_ranks_equals_one_process(npz, tmp_path, nb, neval, world):
    threads()
    settings = dict(mode="eval", device="cpu", log_dir=str(tmp_path / "log"), ckpt_path=npz,
                    Nb=nb, Neval=neval, height_feature_extractor=64,
                    width_feature_extractor=64, compute_dtype="float32", synthetic_data=True,
                    feature_dims_decreased=SMALL_FDIMS, training_problem_def_path=PROBLEM)
    inp = {"settings": settings, "blocks": SMALL_BLOCKS}
    want = worker.run_eval(inp, None)
    got = run_ranks("eval", inp, tmp_path, world=world, devices=True)
    (step, cm), = want
    # every labeled pixel of the Neval images (void is not counted)
    assert 0 < cm.sum() <= neval * 64 * 64
    for rank in got:
        (got_step, got_cm), = rank
        assert got_step == step
        assert got_cm.dtype == cm.dtype == np.int64
        np.testing.assert_array_equal(got_cm, cm)

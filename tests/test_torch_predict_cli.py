"""The port's predict CLI on the CPU, and its input pipeline against JAX's.

The CLI runs over two small PNGs of different raw sizes with a small-stack
.npz under the reference's names; exports must exist at the raw size and
the label-id PNGs hold raw Cityscapes ids. The preprocessed images agree
with the JAX pipeline's to 1e-6 (uint8 scaling by 1/255 vs the reference's
native decode, same TF1 resize tables).
"""

import numpy as np
import pytest
from PIL import Image

from iv2019_tpu_torch import predict_cli
from iv2019_tpu_torch.models import resnet
from iv2019_tpu_torch.problem.problem_def import load_problem_def
from torch_parity import SMALL_BLOCKS, SMALL_FDIMS, small_variables, threads, write_trained_npz

PROBLEM = "iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json"
SIZES = {"street_a": (40, 60), "street_b": (48, 64)}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    threads()
    root = tmp_path_factory.mktemp("predict")
    img_dir = root / "images" / "nested"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for stem, hw in SIZES.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(img_dir / f"{stem}.png")
    npz = write_trained_npz(root / "model.npz", small_variables(seed=3), with_ema=False)
    return root, npz


@pytest.fixture
def small_trunk(monkeypatch):
    monkeypatch.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)


def _argv(root, npz, *flags):
    return [str(root / "log"), PROBLEM, str(root / "images"), "--ckpt_path", npz,
            "--device", "cpu", "--height_feature_extractor", "128",
            "--width_feature_extractor", "128", "--feature_dims_decreased", str(SMALL_FDIMS),
            "--compute_dtype", "float32", *flags]


def test_cli_exports_at_raw_size(workdir, small_trunk):
    root, npz = workdir
    n = predict_cli.main(_argv(root, npz, "--export_lids_images", "--export_color_decisions",
                               "--export_overlapped_color_decisions", "--fused_block"))
    assert n == len(SIZES)
    lids = set(load_problem_def(PROBLEM).cids2lids)
    out = root / "log" / "predictions"
    for stem, hw in SIZES.items():
        got = np.asarray(Image.open(out / f"{stem}_result_lids.png"))
        assert got.shape == hw
        assert set(np.unique(got).tolist()) <= lids
        assert np.asarray(Image.open(out / f"{stem}_result_color.png")).shape == (*hw, 3)
        assert np.asarray(Image.open(out / f"{stem}_result_overlapped_color.png")).shape == (*hw, 3)


def test_cli_system_size_and_default_export(workdir, small_trunk, tmp_path):
    root, npz = workdir
    n = predict_cli.main(_argv(root, npz, "--height_system", "32", "--width_system", "24",
                               "--results_dir", str(tmp_path)))
    assert n == len(SIZES)
    for stem in SIZES:  # no export flag: colorized decisions at the system size
        assert np.asarray(Image.open(tmp_path / f"{stem}_result_color.png")).shape == (32, 24, 3)


def test_cli_requires_npz(workdir, small_trunk):
    root, _ = workdir
    with pytest.raises(SystemExit, match="model.npz"):
        predict_cli.main(_argv(root, "checkpoints/8"))


@pytest.mark.parametrize("preserve", [False, True])
def test_preprocess_matches_jax_pipeline(workdir, preserve):
    from iv2019_tpu.config import Settings as JaxSettings
    from iv2019_tpu.input.dataset_agnostic import predict_input as jax_input
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.predict_input import predict_input

    root, _ = workdir
    kw = dict(predict_dir=str(root / "images"), height_feature_extractor=32,
              width_feature_extractor=56, preserve_aspect_ratio=preserve)
    want = list(jax_input(JaxSettings(**kw)))
    got = list(predict_input(Settings(**kw)))
    assert [g["rawimagespaths"] for g in got] == [w["rawimagespaths"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["rawimages"], w["rawimages"])
        assert g["proimages"].shape == w["proimages"].shape == (1, 32, 56, 3)
        if not preserve:  # the aspect-preserving crop offset is random
            np.testing.assert_allclose(g["proimages"], w["proimages"], atol=1e-6, rtol=0)

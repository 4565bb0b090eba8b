"""The model variants through the port's command lines, on the CPU.

``train_cli --psp_module --upsampling_method hybrid`` for 2 steps, then
``evaluate_cli`` and ``predict_cli`` on its log dir with no model flags:
both rebuild the PSP + hybrid model from the run's settings.txt
(``resolve_trained_model``) and restore its checkpoint. A group-norm run
shows the JAX package's ``_MODEL_SHAPE_FIELDS`` as it is: norm_layer is not
read back, so evaluating it needs ``--norm_layer group`` again (the
checkpoint of a group-norm model does not load into a batch-norm one).
The trunk is the short stack of tests/torch_parity.py, at 64x64.
"""

import os

import numpy as np
import pytest
from PIL import Image

from iv2019_tpu_torch import config as tconfig
from iv2019_tpu_torch import evaluate_cli, predict_cli, train_cli
from iv2019_tpu_torch.models import resnet
from torch_parity import SMALL_BLOCKS, SMALL_FDIMS, threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = os.path.join(ROOT, "iv2019_tpu_torch", "problem_definitions", "cityscapes",
                       "problem01.json")
SIZE = ["--height_feature_extractor", "64", "--width_feature_extractor", "64"]
TRAIN_ARGS = ["cityscapes", "--synthetic_data", "--device", "cpu", "--compute_dtype", "float32",
              *SIZE, "--feature_dims_decreased", str(SMALL_FDIMS), "--Nb_per_pixel", "1",
              "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
              "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
              "--input_seed", "3", "--save_checkpoints_steps", "2"]


@pytest.fixture
def small_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)
        yield


def _train(log, *flags):
    threads()
    train_cli.main([str(log), *TRAIN_ARGS, *flags])
    assert (log / "checkpoints" / "2" / "state.pt").is_file()


def _eval_argv(log, *flags):
    return [str(log), "2", PROBLEM, "--synthetic_data", "--device", "cpu", "--compute_dtype",
            "float32", *SIZE, "--Nb", "1", *flags]


def test_psp_hybrid_run_evaluates_and_predicts_from_its_settings(tmp_path, small_trunk):
    log = tmp_path / "log"
    _train(log, "--psp_module", "--upsampling_method", "hybrid")
    argv = _eval_argv(log)
    s = tconfig.settings_from_args(tconfig.build_argparser(tconfig.EVAL).parse_args(argv),
                                   tconfig.EVAL)
    s = tconfig.resolve_trained_model(s, argv)
    assert (s.psp_module, s.upsampling_method) == (True, "hybrid")
    (metrics,) = evaluate_cli.main(argv)
    assert metrics["global_step"] == 2
    assert 0 < metrics["confusion_matrix"].sum() <= 2 * 64 * 64  # void trimmed
    assert os.path.isfile(os.path.join(log, "eval_00", "all_metrics.txt"))

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    for stem, hw in (("a", (64, 64)), ("b", (48, 80))):
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(images / f"{stem}.png")
    n = predict_cli.main([str(log), PROBLEM, str(images), "--device", "cpu", "--compute_dtype",
                          "float32", *SIZE, "--export_lids_images", "--restore_emas"])
    assert n == 2
    with Image.open(log / "predictions" / "b_result_lids.png") as im:
        assert np.asarray(im).shape == (48, 80)


def test_group_norm_run_needs_its_norm_layer_again(tmp_path, small_trunk):
    """The reference's table lacks norm_layer: without the flag the eval
    builds a batch-norm model, which the group-norm checkpoint does not fit."""
    log = tmp_path / "log"
    _train(log, "--norm_layer", "group")
    assert "norm_layer" not in tconfig._MODEL_SHAPE_FIELDS
    with pytest.raises(RuntimeError, match="state_dict"):
        evaluate_cli.main(_eval_argv(log))
    (metrics,) = evaluate_cli.main(_eval_argv(log, "--norm_layer", "group"))
    assert metrics["global_step"] == 2

"""The port's quality tools against the JAX package's (no TensorFlow needed).

- ``iv2019_tpu_torch/tools/weak_ab.py``: the seven state-file cases of
  tests/test_weak_ab_state.py, run against the port's tool; a line written
  by either tool is reused by the other; ``_state_key`` and ``_cfg_tag``
  agree; ``main`` on planted arms writes the JAX tool's ``weak_ab.json``.
- ``iv2019_tpu_torch/tools/quality_ab.py``: keys, log dirs, state reuse and
  the paired deltas on planted mIoUs, against the JAX tool's ``main``.
- both tools' arms in the workdir (``_run`` replaced, no training): an arm
  whose ``checkpoints/`` holds no step or only an early one is cleared and
  trained again, one that holds the run's final step is reused.
- ``iv2019_tpu_torch/tools/real_data_runbook.sh``: ``bash -n``, every
  ``python -m`` module exists in the port, the stage-2 imports resolve, and
  the ``train_cli`` / ``evaluate_cli`` lines take the JAX runbook's flags,
  which the port's parsers accept; ``quality_sweeps.sh``: ``bash -n`` and
  the two tools it runs; ``eval_protocols.sh``: ``bash -n`` and its CLI
  lines.
- ``iv2019_tpu_torch/tools/overfit_probe.py`` at the small stack
  (tests/torch_parity.py::SMALL_BLOCKS) in f32 on the CPU, with JAX's
  initial weights carried across by utils/convert.py, against
  tools/overfit_probe.py running JAX's step on its own batch (its
  ``build_model`` swapped for the small stack): the same batch bit for bit,
  the JSON's keys, and two steps. The first step's loss is held to
  tests/test_torch_train_step.py's 1e-4 relative (plus the JSON's rounding
  to 4 decimals; measured equal to the 4 decimals) and both steps' mIoU to
  its 2e-3. The rest cannot take that test's bars at this stack: its tiny
  model's gradients are well conditioned, but those of a random net of
  this width through train-mode BatchNorm on six images are not
  (tests/test_torch_model_variants.py measured the port 1-11% from JAX and
  JAX 1-7% from itself under a 1e-6 change of the images; here one update
  leaf differs by 10% of its largest value and the second step's loss by
  2.4e-4 relative, while the losses' own gradients agree to 2e-7 and the
  step's gates pixel for pixel). So the second step's loss is held to 1e-3
  relative, each parameter leaf after the two steps, in norm, to 0.25 of
  its update's norm (tests/test_torch_model_variants.py's
  ``TRAIN_BN_GRAD_RTOL``: a missing or wrong gradient term moves a leaf by
  its own size), and so is each running-statistics leaf's change (its
  second update is taken on the first step's weights).
"""

import importlib.util
import json
import os
import pickle
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

from iv2019_tpu_torch.tools import overfit_probe, quality_ab, weak_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOK = os.path.join(REPO, "iv2019_tpu_torch", "tools", "real_data_runbook.sh")
SWEEPS = os.path.join(REPO, "iv2019_tpu_torch", "tools", "quality_sweeps.sh")
PROTOCOLS = os.path.join(REPO, "iv2019_tpu_torch", "tools", "eval_protocols.sh")
JAX_RUNBOOK = os.path.join(REPO, "tools", "real_data_runbook.sh")
CFG = {"rate": 0.2, "n_pp": 24, "n_weak": 256, "n_val": 48, "ne": 48}

LOSS_RTOL = (1e-4, 1e-3)  # the first step's loss, the second's
ROUNDING = 1e-4  # two values each rounded to 4 decimals
MIOU_ATOL = 2e-3
TRAIN_BN_UPDATE_RTOL = 0.25
PROBE_HW = (64, 64)
PROBE_STEPS = 2


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_weak_ab = _jax_tool("weak_ab")
jax_quality_ab = _jax_tool("quality_ab")


def _record(path, arm, seed, coeff, cfg, metrics):
    rec = {"arm": arm, "seed": seed, "coeff": coeff if arm == "weak" else None,
           "config": cfg, "metrics": metrics}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _finished_arm(tmp_path, tool, metrics, arm="pp", seed=0, cfg=CFG):
    """An arm's eval artifact in the workdir, as evaluate_cli leaves it."""
    eval_dir = tmp_path / f"{arm}_s{seed}_{tool._cfg_tag(cfg)}" / "eval_00"
    eval_dir.mkdir(parents=True)
    with open(eval_dir / "all_metrics.p", "wb") as f:
        pickle.dump([metrics], f)


# -- weak_ab: the state contract of tests/test_weak_ab_state.py ------------------------

def _state_hit_short_circuits_training(tmp_path):
    sp = str(tmp_path / "arms.jsonl")
    _record(sp, "pp", 0, None, CFG, {"mean_iou": 61.0, "ious": np.arange(20.0).tolist()})
    state = weak_ab._load_state(sp)
    # paths={} would crash run_arm anywhere past the state lookup
    out = weak_ab.run_arm(str(tmp_path), {}, "pp", 0, CFG["ne"], coeff=0.1, state=state,
                          state_path=sp, cfg=CFG)
    assert out["mean_iou"] == 61.0


def _state_misses_on_any_config_change(tmp_path):
    sp = str(tmp_path / "arms.jsonl")
    _record(sp, "pp", 0, None, CFG, {"mean_iou": 61.0})
    state = weak_ab._load_state(sp)
    for delta in ({"rate": 0.5}, {"ne": 24}, {"n_pp": 48}):
        assert weak_ab._state_key("pp", 0, None, {**CFG, **delta}) not in state
    assert weak_ab._state_key("weak", 0, 0.1, CFG) not in state
    assert weak_ab._state_key("pp", 1, None, CFG) not in state


def _weak_arms_key_on_coefficient_pp_does_not(tmp_path):
    k_pp = weak_ab._state_key("pp", 0, None, CFG)
    assert weak_ab._state_key("pp", 0, None, CFG) == k_pp
    assert weak_ab._state_key("weak", 0, 0.1, CFG) != weak_ab._state_key("weak", 0, 0.5, CFG)


def _workdir_completion_is_recorded_to_state(tmp_path):
    _finished_arm(tmp_path, weak_ab, {"mean_iou": 59.5, "ious": [1.0, 2.0]})
    sp = str(tmp_path / "arms.jsonl")
    out = weak_ab.run_arm(str(tmp_path), {}, "pp", 0, CFG["ne"], coeff=0.1, state={},
                          state_path=sp, cfg=CFG)
    assert out["mean_iou"] == 59.5
    assert weak_ab._state_key("pp", 0, None, CFG) in weak_ab._load_state(sp)


def _missing_state_file_is_empty(tmp_path):
    assert weak_ab._load_state(str(tmp_path / "nope.jsonl")) == {}


def _corrupt_state_lines_are_skipped(tmp_path):
    sp = str(tmp_path / "arms.jsonl")
    _record(sp, "pp", 0, None, CFG, {"mean_iou": 61.0})
    with open(sp, "a") as f:
        f.write('{"arm": "pp", "seed": 1, "conf\n')   # truncated
        f.write("\n")                                  # blank
        f.write('{"no": "keys"}\n')                    # wrong schema
    state = weak_ab._load_state(sp)
    assert weak_ab._state_key("pp", 0, None, CFG) in state
    assert len(state) == 1


def _state_is_strict_json(tmp_path):
    sp = str(tmp_path / "arms.jsonl")
    _finished_arm(tmp_path, weak_ab, {"mean_iou": 59.5, "accuracies": [1.0, float("nan")]})
    weak_ab.run_arm(str(tmp_path), {}, "pp", 0, CFG["ne"], coeff=0.1, state={}, state_path=sp,
                    cfg=CFG)
    raw = open(sp).read()
    assert "NaN" not in raw
    rec = json.loads(raw)
    assert rec["metrics"]["accuracies"][1] is None
    assert rec["metrics"]["mean_iou"] == 59.5


STATE_CASES = {f.__name__[1:]: f for f in (
    _state_hit_short_circuits_training, _state_misses_on_any_config_change,
    _weak_arms_key_on_coefficient_pp_does_not, _workdir_completion_is_recorded_to_state,
    _missing_state_file_is_empty, _corrupt_state_lines_are_skipped, _state_is_strict_json)}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_weak_ab_state_contract(tmp_path, case):
    STATE_CASES[case](tmp_path)


# -- weak_ab: the two tools read each other's files ------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jax_weak_ab, weak_ab), (weak_ab, jax_weak_ab)],
                         ids=["jax_to_port", "port_to_jax"])
def test_weak_ab_state_lines_cross_read(tmp_path, writer, reader):
    sp = str(tmp_path / "arms.jsonl")
    _finished_arm(tmp_path / "w", writer, {"mean_iou": 57.25, "ious": [0.5, float("nan")]},
                  arm="weak", seed=2)
    writer.run_arm(str(tmp_path / "w"), {}, "weak", 2, CFG["ne"], coeff=0.1, state={},
                   state_path=sp, cfg=CFG)
    state = reader._load_state(sp)
    # the reader's run_arm takes the writer's line and trains nothing
    out = reader.run_arm(str(tmp_path / "r"), {}, "weak", 2, CFG["ne"], coeff=0.1,
                         state=state, state_path=sp, cfg=CFG)
    assert out == {"mean_iou": 57.25, "ious": [0.5, None]}


@pytest.mark.parametrize("arm,seed,coeff,cfg", [
    ("pp", 0, None, CFG), ("weak", 1, 0.1, CFG), ("weak_ema", 2, 0.5, CFG),
    ("pp_ema", 0, None, {**CFG, "rate": 0.5}), ("pp", 0, None, {})])
def test_state_key_and_cfg_tag_equal_across_tools(arm, seed, coeff, cfg):
    assert weak_ab._state_key(arm, seed, coeff, cfg) == jax_weak_ab._state_key(arm, seed,
                                                                                coeff, cfg)
    assert weak_ab._cfg_tag(cfg) == jax_weak_ab._cfg_tag(cfg)
    assert quality_ab._cfg_tag(cfg) == jax_quality_ab._cfg_tag(cfg)


def test_port_sweep_refuses_the_jax_record(tmp_path):
    with pytest.raises(SystemExit, match="JAX package's arms"):
        weak_ab.check_state_path(os.path.join(REPO, "docs", "weak_ab_arms.jsonl"))
    weak_ab.check_state_path(str(tmp_path / "torch_weak_ab_arms.jsonl"))
    weak_ab.check_state_path(None)


def _run_main(tool, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [tool.__file__, *argv])
    tool.main()
    return capsys.readouterr().out


def test_weak_ab_main_on_planted_arms_matches_jax(tmp_path, monkeypatch, capsys):
    """Both tools aggregate the same planted arms (no training) into the same
    weak_ab.json: per-class table, paired deltas, EMA deltas."""
    cfg = {"rate": 0.2, "n_pp": 2, "n_weak": 2, "n_val": 2, "ne": 3}
    sp = str(tmp_path / "arms.jsonl")
    rng = np.random.RandomState(0)
    for seed in range(2):
        for arm in ("pp", "weak", "pp_ema", "weak_ema"):
            ious = rng.uniform(0, 90, 19)
            ious[5] = np.nan
            _record(sp, arm, seed, 0.1, cfg,
                    {"mean_iou": float(np.nanmean(ious)), "ious": [None if np.isnan(x) else x
                                                                   for x in ious.tolist()]})
    argv = ["--seeds", "2", "--n_pp", "2", "--n_weak", "2", "--n_val", "2", "--ne", "3",
            "--state", sp, "--ema_evals"]
    outs = {}
    for tag, tool in (("jax", jax_weak_ab), ("port", weak_ab)):
        _run_main(tool, [str(tmp_path / tag), *argv], monkeypatch, capsys)
        with open(tmp_path / tag / "weak_ab.json") as f:
            outs[tag] = json.load(f)
    assert outs["port"] == outs["jax"]
    want = [round(w - p, 2) for w, p in zip(outs["port"]["mean_iou_weak"],
                                            outs["port"]["mean_iou_pp"])]
    assert outs["port"]["paired_deltas"] == pytest.approx(want, abs=0.011)
    assert "paired_deltas_ema" in outs["port"]


# -- quality_ab -----------------------------------------------------------------------------

QCFG = {"ne": 1, "n_train": 2, "n_val": 2, "h": 16, "w": 32}


def test_quality_keys_and_log_dirs(tmp_path):
    port = quality_ab.Runner(str(tmp_path), {}, QCFG, None, device="cpu")
    jax = jax_quality_ab.Runner(str(tmp_path), {}, QCFG, None)
    assert port.tag == jax.tag == quality_ab._cfg_tag(QCFG)
    assert port._log_dir("flip", 2) == jax._log_dir("flip", 2) == str(
        tmp_path / f"flip_s2_{port.tag}")


def test_quality_state_reuse(tmp_path, capsys):
    sp = str(tmp_path / "q.jsonl")
    writer = jax_quality_ab.Runner(str(tmp_path), {}, QCFG, sp)
    key = f"base_s0_sw_gauss_{writer.tag}"
    writer._record(key, 41.5)
    with open(sp, "a") as f:
        f.write('{"key": "truncated\n')
    port = quality_ab.Runner(str(tmp_path), {}, QCFG, sp)
    # paths={} would crash the training this must skip
    assert port.evaluate("base", 0, "sw_gauss") == 41.5
    assert "reusing persisted mIoU 41.50" in capsys.readouterr().out
    port._record(f"flip_s1_raw_{port.tag}", float("nan"))
    assert json.loads(open(sp).read().splitlines()[-1])["mean_iou"] is None


def test_quality_paired_deltas_on_planted_mious(tmp_path, monkeypatch, capsys):
    sp = str(tmp_path / "q.jsonl")
    tag = quality_ab._cfg_tag(QCFG)
    rng = np.random.RandomState(1)
    planted = {}
    with open(sp, "w") as f:
        for seed in range(3):
            for arm, mode in (("base", "raw"), ("base", "ema"), ("flip", "raw"),
                              ("flip", "ema"), ("base", "sw_uniform"), ("base", "sw_gauss")):
                planted[(arm, seed, mode)] = round(float(rng.uniform(30, 60)), 3)
                f.write(json.dumps({"key": f"{arm}_s{seed}_{mode}_{tag}",
                                    "mean_iou": planted[(arm, seed, mode)],
                                    "config": QCFG}) + "\n")
    argv = ["--seeds", "3", "--ne", "1", "--n_train", "2", "--n_val", "2", "--h", "16",
            "--w", "32", "--state", sp]
    outs = {}
    for name, tool in (("jax", jax_quality_ab), ("port", quality_ab)):
        _run_main(tool, [str(tmp_path / name), *argv], monkeypatch, capsys)
        with open(tmp_path / name / "quality_ab.json") as f:
            outs[name] = json.load(f)
    assert outs["port"] == outs["jax"]
    assert set(outs["port"]) == {"config", "seeds", "mious", "ema", "flip_ema", "flip_raw",
                                 "blend"}
    for name, (a, b) in {"ema": (("base", "ema"), ("base", "raw")),
                         "flip_ema": (("flip", "ema"), ("base", "ema")),
                         "blend": (("base", "sw_gauss"), ("base", "sw_uniform"))}.items():
        want = [planted[(a[0], s, a[1])] - planted[(b[0], s, b[1])] for s in range(3)]
        assert outs["port"][name]["deltas"] == pytest.approx(want, abs=0.006)


# -- both tools: an arm is trained only when its final checkpoint is there -----------------------

# n_train 8 at Nb 4 for 2 epochs: the run ends at step 4
ARM_CFG = {"ne": 2, "n_train": 8, "n_val": 2, "h": 16, "w": 32}
ARM_PATHS = {"tfrecords_train": "train.tfrecords", "tfrecords_val": "val.tfrecords",
             "openimages_image_dir": "weak", "openimages_bboxes_path": "bboxes.pkl",
             "openimages_image_labels_path": "labels.pkl", "n_pp": 8, "n_val": 2}
# the checkpoint steps a planted arm holds before the tool runs
ARM_STATES = {"no_step": [], "early_step": [2], "final_step": [2, 4]}


def _fake_run(calls):
    """A ``_run`` that trains and evaluates nothing: train_cli leaves its
    final checkpoint, evaluate_cli an eval_NN with one mIoU."""
    def run(module, args, timeout=None):
        log_dir = args[0]
        calls.append(module.rsplit(".", 1)[-1])
        if module.endswith("train_cli"):
            assert not os.path.exists(log_dir), "trained into a directory that was not cleared"
            os.makedirs(os.path.join(log_dir, "checkpoints", "4"))
        else:
            n = sum(d.startswith("eval_") for d in os.listdir(log_dir))
            os.makedirs(os.path.join(log_dir, f"eval_{n:02d}"))
            with open(os.path.join(log_dir, f"eval_{n:02d}", "all_metrics.p"), "wb") as f:
                pickle.dump([{"mean_iou": 50.0}], f)
    return run


def _plant_arm(log_dir, steps):
    os.makedirs(os.path.join(log_dir, "checkpoints"))
    for step in steps:
        os.makedirs(os.path.join(log_dir, "checkpoints", str(step)))
    open(os.path.join(log_dir, "marker"), "w").close()


@pytest.mark.parametrize("state", sorted(ARM_STATES))
@pytest.mark.parametrize("tool", ["weak_ab", "quality_ab"])
def test_sweep_retrains_an_unfinished_arm(tmp_path, monkeypatch, tool, state):
    """A ``checkpoints/`` with no step, or with a step short of the run's
    last (a run that crashed or was killed), is cleared and trained again;
    one that holds the last step is reused and only evaluated."""
    calls = []
    module = weak_ab if tool == "weak_ab" else quality_ab
    monkeypatch.setattr(module, "_run", _fake_run(calls))
    assert weak_ab.final_step(ARM_CFG["n_train"], ARM_CFG["ne"]) == 4
    if tool == "weak_ab":
        cfg = {"rate": 0.2, "n_pp": 8, "n_weak": 2, "n_val": 2, "ne": ARM_CFG["ne"]}
        log_dir = str(tmp_path / f"pp_s0_{weak_ab._cfg_tag(cfg)}")
        _plant_arm(log_dir, ARM_STATES[state])
        out = weak_ab.run_arm(str(tmp_path), ARM_PATHS, "pp", 0, ARM_CFG["ne"], cfg=cfg,
                              device="cpu")
        assert out == {"mean_iou": 50.0}
    else:
        runner = quality_ab.Runner(str(tmp_path), ARM_PATHS, ARM_CFG, None, device="cpu")
        log_dir = runner._log_dir("base", 0)
        _plant_arm(log_dir, ARM_STATES[state])
        assert runner.evaluate("base", 0, "raw") == 50.0
    reused = state == "final_step"
    assert calls == (["evaluate_cli"] if reused else ["train_cli", "evaluate_cli"])
    assert os.path.exists(os.path.join(log_dir, "marker")) == reused
    assert weak_ab.arm_trained(log_dir, ARM_CFG["n_train"], ARM_CFG["ne"])


# -- the runbook ------------------------------------------------------------------------------

def _commands(path):
    """The runbook's shell commands, continuation lines joined, comments off."""
    text = open(path).read().replace("\\\n", " ")
    return [line.strip() for line in text.splitlines()
            if line.strip() and not line.strip().startswith("#")]


def _cli_argv(path, module):
    """Each ``python -m <module>`` line's arguments, up to a redirection,
    variables replaced by ``<NAME>``."""
    out = []
    for line in _commands(path):
        m = re.search(rf"python3? -m {re.escape(module)} (.*)", line)
        if m:
            args = shlex.split(m.group(1).split(" > ")[0])
            out.append([re.sub(r"\$\{?(\w+)\}?", r"<\1>", a) for a in args])
    return out


@pytest.mark.parametrize("script", [RUNBOOK, SWEEPS, PROTOCOLS],
                         ids=["runbook", "sweeps", "protocols"])
def test_scripts_parse_with_bash(script):
    subprocess.run(["bash", "-n", script], check=True, timeout=30)
    assert os.access(script, os.X_OK)


def test_protocol_lines_parse():
    """eval_protocols.sh: its train_cli line and the evaluate_cli line of its
    run() helper, with each protocol's flags, are the port's CLIs' flags."""
    from iv2019_tpu_torch.config import EVAL, TRAIN, build_argparser

    (train,) = _cli_argv(PROTOCOLS, "iv2019_tpu_torch.train_cli")
    build_argparser(TRAIN).parse_args([a.replace("<DEVICE>", "cuda") for a in train])
    (evaluate,) = _cli_argv(PROTOCOLS, "iv2019_tpu_torch.evaluate_cli")
    evaluate = [{"<PROBLEM>": "problem01.json", "<DEVICE>": "cuda"}.get(a, a) for a in evaluate]
    runs = [shlex.split(line)[2:] for line in _commands(PROTOCOLS) if line.startswith('run "')]
    assert len(runs) == 4 and "$@" in evaluate
    for flags in runs:
        at = evaluate.index("$@")
        args = build_argparser(EVAL).parse_args(evaluate[:at] + flags + evaluate[at + 1:])
        assert args.restore_emas


def test_sweeps_run_the_port_tools_at_their_defaults():
    text = open(SWEEPS).read()
    assert set(re.findall(r"python3 -m ([\w.]+)", text)) == {
        "iv2019_tpu_torch.tools.weak_ab", "iv2019_tpu_torch.tools.quality_ab"}
    assert "--seeds 3 --rate 0.2" in text and "--ema_evals" in text


def test_runbook_modules_exist_in_port():
    text = open(RUNBOOK).read()
    modules = set(re.findall(r"python -m ([\w.]+)", text))
    assert modules == {"iv2019_tpu_torch.tools.make_tfrecords", "iv2019_tpu_torch.train_cli",
                       "iv2019_tpu_torch.evaluate_cli"}
    for m in modules:
        assert importlib.util.find_spec(m) is not None, m
    imports = re.findall(r"from ([\w.]+) import (\w+)", text)
    assert imports == [("iv2019_tpu_torch.utils.checkpoint", "convert_tf_checkpoint_to_npz")] * 2
    for module, name in imports:
        assert callable(getattr(importlib.import_module(module), name))
    # stage 2 runs the port's converter, the full mode for the released model
    assert "full=True" in text and "iv2019_tpu." not in text


@pytest.mark.parametrize("cli", ["train_cli", "evaluate_cli"])
def test_runbook_cli_flags_are_the_jax_runbooks_and_parse(cli):
    from iv2019_tpu_torch.config import EVAL, TRAIN, build_argparser

    port = _cli_argv(RUNBOOK, f"iv2019_tpu_torch.{cli}")
    jax = _cli_argv(JAX_RUNBOOK, f"iv2019_tpu.{cli}")
    assert len(port) == len(jax) == (1 if cli == "train_cli" else 2)
    parser = build_argparser(TRAIN if cli == "train_cli" else EVAL)
    for p_args, j_args in zip(port, jax):
        assert [a for a in p_args if a.startswith("--")] == [a for a in j_args
                                                               if a.startswith("--")]
        args = [a.replace("<PROBLEM>", "problem01.json") for a in p_args]
        parser.parse_args(args)


# -- the overfit probe ------------------------------------------------------------------------

def _probe_runs(steps):
    """The JAX tool's run (build_model swapped for the small f32 stack; its
    batch, initial variables, states and metrics captured) and the port's
    probe on the same weights and batch."""
    import jax.numpy as jnp
    import torch

    import iv2019_tpu.models.model as jax_models
    import iv2019_tpu.train.state as jax_state
    import iv2019_tpu.train.step as jax_step
    from iv2019_tpu.models.model import HierarchicalSegmentationModel as JaxModel
    from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel as TorchModel
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.utils.convert import flax_from_state_dict, load_flax_variables
    from torch_parity import SMALL_BLOCKS, SMALL_FDIMS, numpy_tree, threads

    threads()
    mp = pytest.MonkeyPatch()
    seen = {"states": []}

    def small_model(settings):
        return JaxModel(taxonomy=jax_taxonomy("cityscapes"), resnet_blocks=SMALL_BLOCKS,
                        feature_dims_decreased=SMALL_FDIMS, dtype=jnp.float32,
                        batch_norm_decay=settings.batch_norm_decay,
                        accumulate_norm_statistics=True, bn_impl="flax")

    make_step, create_state = jax_step.make_train_step, jax_state.create_fused_train_state

    def capture_step(*a, **kw):
        step = make_step(*a, **kw)

        def wrapped(state, batch):
            seen["batch"] = batch
            state, metrics = step(state, batch)
            # host copies: the next step donates the state's buffers
            seen["states"].append((numpy_tree(state.params), numpy_tree(state.batch_stats)))
            return state, metrics
        return wrapped

    def capture_state(variables, opt):
        seen["variables"] = {k: numpy_tree(v) for k, v in variables.items()}
        return create_state(variables, opt)

    try:
        mp.setattr(jax_models, "build_model", small_model)
        mp.setattr(jax_step, "make_train_step", capture_step)
        mp.setattr(jax_state, "create_fused_train_state", capture_state)
        want = _jax_tool("overfit_probe").main(steps, *PROBE_HW)
    finally:
        mp.undo()

    settings = overfit_probe.probe_settings(*PROBE_HW, device="cpu")
    variables = seen["variables"]
    model = TorchModel(taxonomy=get_taxonomy("cityscapes"), resnet_blocks=SMALL_BLOCKS,
                       feature_dims_decreased=SMALL_FDIMS, dtype=torch.float32,
                       batch_norm_decay=settings.batch_norm_decay, bn_impl="flax",
                       ).to(memory_format=torch.channels_last).train(True)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    got = overfit_probe.run(settings, model, steps)
    params, stats = flax_from_state_dict(model.state_dict())
    jparams, jstats = seen["states"][-1]
    return dict(want=want, got=got, seen=seen, params=params, stats=stats, jparams=jparams,
                jstats=jstats, initial_params=variables["params"],
                initial_stats=variables["batch_stats"])


@pytest.fixture(scope="module")
def probe_runs():
    return _probe_runs(PROBE_STEPS)


def test_probe_batch_is_jax_tools_batch(probe_runs):
    jax_batch = probe_runs["seen"]["batch"]
    batch = overfit_probe.probe_batch(*PROBE_HW)
    assert sorted(batch) == sorted(jax_batch)
    for k, v in batch.items():
        w = np.asarray(jax_batch[k])
        assert v.shape == w.shape and v.dtype == w.dtype, k
        assert v.tobytes() == w.tobytes(), k


def test_probe_json_keys_equal_jax(probe_runs):
    got, want = probe_runs["got"], probe_runs["want"]
    assert list(got) == list(want)
    assert got["metric"] == "overfit_probe" and got["steps"] == want["steps"] == [0, 1]
    assert isinstance(got["learned"], bool)


@pytest.mark.parametrize("i", range(PROBE_STEPS))
def test_probe_steps_match_jax(probe_runs, i):
    got, want = probe_runs["got"], probe_runs["want"]
    assert abs(got["loss"][i] - want["loss"][i]) <= LOSS_RTOL[i] * abs(want["loss"][i]) + ROUNDING
    assert abs(got["train_miou"][i] - want["train_miou"][i]) <= MIOU_ATOL + ROUNDING


@pytest.mark.parametrize("col", ["params", "stats"])
def test_probe_state_matches_jax_after_two_steps(probe_runs, col):
    import jax

    def leaves(tree):
        return dict(jax.tree_util.tree_flatten_with_path(tree)[0])

    got, want, init = (leaves(probe_runs[k]) for k in (col, "j" + col, "initial_" + col))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w, w0 = np.asarray(want[path], np.float64), np.asarray(init[path], np.float64)
        # 4 ulps a value for the leaves whose change is as small as that
        floor = 4 * float(np.spacing(np.float32(np.abs(w).max()))) * np.sqrt(w.size)
        bound = TRAIN_BN_UPDATE_RTOL * float(np.linalg.norm(w - w0)) + floor
        assert float(np.linalg.norm(np.asarray(g, np.float64) - w)) <= bound, path


def test_probe_main_on_cpu(monkeypatch, capsys):
    """The CLI on the CPU, the trunk cut to helpers.TINY_BLOCKS: one JSON line
    with the JAX tool's keys."""
    from helpers import TINY_BLOCKS

    import iv2019_tpu_torch.models.model as models

    monkeypatch.setitem(models.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", TINY_BLOCKS)
    result = overfit_probe.main(["3", "--size", "32x64", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert line["steps"] == [0, 1, 2] and len(line["loss"]) == 3
    assert all(np.isfinite(line["loss"]))

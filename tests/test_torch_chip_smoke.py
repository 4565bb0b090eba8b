"""What ``chip_smoke.py`` must keep while its phases are cut to its time
limit: the bench runs of phase 14 (every mode, every kernel knob, exact
launches asked of each), phase 9's step-1 bar from a measured spread, the
kernel line's names, and its kernels' bounds from the benchmark's peaks.
The smoke itself runs only on a CUDA card; these are its tables and its
arithmetic on plain numbers."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmark import counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH_MODES = ("train", "predict", "eval", "input", "e2e")
# each knob that turns on a kernel, and the kernels it turns on
KNOB_KERNELS = {
    ("IV_FUSED_BLOCK", "1"): ("fused_bottleneck", "fused_bottleneck_ct"),
    ("IV_ROOT_WGRAD_PALLAS", "1"): ("root_conv_wgrad",),
}
# each knob that turns off kernels of the default train step, and those kernels
KNOB_OFF = {("IV_BN_IMPL", "flax"): ("fused_bn_fwd", "fused_bn_bwd")}
TRAIN_KERNELS = ("fused_loss_fwd", "fused_loss_bwd", "fused_update", "fused_bn_fwd",
                 "fused_bn_bwd")


@pytest.mark.parametrize("mode", BENCH_MODES)
def test_bench_runs_drive_every_mode(mode):
    assert any(argv[0] == mode for _, argv, _ in cs.BENCH_RUNS)
    assert mode in cs.BENCH_METRICS


@pytest.mark.parametrize("knob", sorted({**KNOB_KERNELS, **KNOB_OFF}), ids=lambda k: "=".join(k))
def test_bench_runs_turn_on_every_kernel_knob(knob):
    name, value = knob
    assert any(knobs.get(name) == value for _, _, knobs in cs.BENCH_RUNS)


@pytest.mark.parametrize("run", cs.BENCH_RUNS, ids=[label for label, _, _ in cs.BENCH_RUNS])
def test_bench_want_asks_for_every_kernel_a_run_turns_on(run):
    """A run's timed part must launch each kernel its mode and knobs turn
    on (N1/N2 on the default train path, unless ``IV_BN_IMPL=flax``), a
    known number of times, and no other."""
    _, argv, knobs = run
    want = cs._bench_want(argv, knobs)
    assert set(want) == set(cs.REPLACES)
    on = set()
    if argv[0] in ("train", "e2e"):
        on.update(TRAIN_KERNELS)
    for (name, value), kernels in KNOB_KERNELS.items():
        if knobs.get(name) == value:
            on.update(kernels)
    for (name, value), kernels in KNOB_OFF.items():
        if knobs.get(name) == value:
            on.difference_update(kernels)
    steps = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 0
    for kernel, count in want.items():
        assert (count > 0) == (kernel in on), (kernel, count)
    if "fused_bn_fwd" in on:
        assert want["fused_bn_fwd"] == want["fused_bn_bwd"] == steps * cs.FLAGSHIP_BATCH_NORMS
    if "root_conv_wgrad" in on:
        assert want["root_conv_wgrad"] == steps


def test_bench_runs_have_unique_labels():
    labels = [label for label, _, _ in cs.BENCH_RUNS]
    assert len(labels) == len(set(labels))


def _metrics(**values):
    return {k: values.get(k, 1.0) for k in cs.BN_TRUTH_KEYS}


# (f32, default, fused) step-1 values of one key on the constant batch and
# its permutations, and the largest distance among them (the noise)
SPREAD_CASES = {
    # one sample: the old bar, 4 x the default's distance to f32
    "one_sample": (([2.0], [2.001], [2.0005]), 0.001),
    # a default step's distance on a permutation is the largest
    "default_permuted": (([2.0, 2.0, 2.0], [2.001, 2.003, 2.0], [2.0005, 2.0006, 2.0004]),
                         0.003),
    # the fused step's own permutation moves it the most
    "fused_permuted": (([2.0, 2.0], [2.001, 2.001], [2.0005, 2.0035]), 0.003),
    # every distance under the floor (1e-6 relative): the floor
    "floor": (([2.0, 2.0], [2.0, 2.0], [2.0, 2.0]), 0.0),
}


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_step1_bar_takes_the_largest_distance(case):
    (f32, default, fused), noise = SPREAD_CASES[case]
    key = "l2_human_segmentation"
    rows, problems = cs.step1_rows(*([_metrics(**{key: v}) for v in values]
                                     for values in (f32, default, fused)))
    row = rows[key]
    assert row["noise"] == pytest.approx(noise, rel=1e-9, abs=1e-12)
    assert row["bar"] == pytest.approx(cs.BAR_FACTOR * max(noise, 1e-6 * f32[0]), rel=1e-9)
    assert row["ratio"] == pytest.approx(abs(fused[0] - f32[0]) / row["bar"])
    assert not problems


def test_step1_bar_of_one_sample_is_the_old_bar():
    """With no permutation the bar is what phase 9 took before: BAR_FACTOR
    times the default step's distance to f32, floored."""
    f32, default = _metrics(total=8.137791), _metrics(total=8.139055)
    fused = _metrics(total=8.138178)
    rows, _ = cs.step1_rows([f32], [default], [fused])
    assert rows["total"]["bar"] == cs.BAR_FACTOR * max(abs(8.139055 - 8.137791), 1e-6 * 8.137791)
    assert rows["miou"]["bar"] == cs.BAR_FACTOR * 1e-3


def test_step1_order_check_reports_statistics_that_follow_the_row_order():
    """A fused step that a permutation moves far more than the default one
    (statistics taken from some of the rows) widens its own bar, but fails
    the order check."""
    key = "l2_human_segmentation"
    rows, problems = cs.step1_rows([_metrics(**{key: 1.0})] * 4,
                                   [_metrics(**{key: 1.0004})] * 4,
                                   [_metrics(**{key: v}) for v in (1.0002, 1.01, 0.99, 1.0002)])
    row = rows[key]
    assert row["ratio"] < 1 < row["order_ratio"]
    assert row["order_bar"] == pytest.approx(cs.BAR_FACTOR * 0.0004)
    assert len(problems) == 1 and "permutation" in problems[0]


@pytest.mark.parametrize("over", [False, True])
def test_step1_bar_reports_a_distance_over_it(over):
    key = "l2_human_segmentation"
    noise = 0.0004
    fused0 = 1.0 + cs.BAR_FACTOR * noise * (1.5 if over else 0.5)
    rows, problems = cs.step1_rows([_metrics(**{key: 1.0})] * 4,
                                   [_metrics(**{key: 1.0 + noise})] * 4,
                                   [_metrics(**{key: fused0})] * 4)
    assert (rows[key]["ratio"] > 1) == over
    assert len(problems) == int(over)
    if over:
        assert key in problems[0]


# (default f32, fused f32) step-1 values of one key on the constant batch and
# its permutations, the noise, and whether each check fails (distance, order)
F32_CASES = {
    # the default step's own permutation moves it the most
    "default_moves": (([2.0, 2.00002, 2.0, 2.00001], [2.00003, 2.00003, 2.00004, 2.00003]),
                      2e-5, (False, False)),
    # a permutation moves the fused step farther, within what the default shows
    "fused_moves": (([2.0, 2.00001, 2.0, 2.0], [2.00001, 2.00003, 2.00001, 2.00001]),
                    2e-5, (False, False)),
    # every distance under the floor (1e-6 relative): the floor
    "floor": (([2.0] * 4, [2.0] * 4), 0.0, (False, False)),
    # statistics of half the rows: off by bf16's size, the same on every order
    "off_everywhere": (([2.0, 2.000001, 2.0, 2.0], [2.004] * 4), 1e-6, (True, False)),
    # statistics that follow the row order: they widen their own bar, but a
    # permutation moves them far beyond what it moves the default step
    "follows_the_order": (([2.0, 2.000001, 2.0, 2.0], [2.001, 2.004, 1.998, 2.001]),
                          0.003, (False, True)),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_step1_bar_holds_the_fused_step_to_f32_reordering(case):
    (flax, fused), noise, (far, ordered) = F32_CASES[case]
    key = "l2_human_segmentation"
    rows, problems = cs.f32_step1_rows([_metrics(**{key: v}) for v in flax],
                                       [_metrics(**{key: v}) for v in fused])
    row = rows[key]
    assert row["noise"] == pytest.approx(noise, rel=1e-6, abs=1e-12)
    assert row["bar"] == pytest.approx(cs.BAR_FACTOR * max(noise, 1e-6 * flax[0]), rel=1e-6)
    assert (row["ratio"] > 1) == far and (row["order_ratio"] > 1) == ordered
    assert len(problems) == int(far) + int(ordered)
    assert all(key in p for p in problems)


def test_spread_bar_floors_and_scales():
    assert cs.spread_bar([0.0, 0.0], 1e-7) == cs.BAR_FACTOR * 1e-7
    assert cs.spread_bar([1e-3, 3e-3, 2e-3], 1e-7) == cs.BAR_FACTOR * 3e-3


@pytest.mark.parametrize("how", cs.BN_PERMUTATIONS, ids=str)
def test_permuted_reorders_the_rows_of_every_sub_batch(how):
    assert len(cs.BN_PERMUTATIONS) >= 3
    rng = np.random.RandomState(0)
    batch = {"proimages_per_pixel": torch.tensor(rng.rand(4, 2, 3, 3)),
             "prolabels_per_pixel": torch.tensor(rng.randint(0, 20, (4, 2, 3))),
             "proimages_per_bbox": torch.tensor(rng.rand(8, 2, 3, 3))}
    out = cs.permuted(batch, how)
    assert set(out) == set(batch)
    for k, v in batch.items():
        assert out[k].shape == v.shape and not torch.equal(out[k], v)
        rows = sorted(map(tuple, v.reshape(len(v), -1).tolist()))
        assert sorted(map(tuple, out[k].reshape(len(v), -1).tolist())) == rows
    # images and labels of a sub-batch move together
    order = [next(i for i in range(4) if torch.equal(batch["proimages_per_pixel"][i], r))
             for r in out["proimages_per_pixel"]]
    assert torch.equal(out["prolabels_per_pixel"], batch["prolabels_per_pixel"][order])


def test_kernel_line_names_cover_replaces_and_the_n_kernels():
    """Every kernel the counters of the main paths read is a row of the
    kernel line (its name a key of REPLACES), N1 and N2 among them."""
    counted = {**cs._counts(), **cs._bn_counts(), **cs._fb_counts()}
    assert set(counted) == set(cs.REPLACES)
    assert {"fused_bn_fwd", "fused_bn_bwd"} <= set(cs.REPLACES)
    assert len(cs.REPLACES) == 8


def test_n3_replaces_names_the_jax_eval_batch_norm():
    """N3's row stands for flax's BatchNorm in the JAX Norm, which runs it
    on the running statistics in eval mode."""
    path, line = cs.N3_REPLACES.split(":")
    with open(os.path.join(ROOT, path)) as f:
        lines = f.read().splitlines()
    assert lines[int(line) - 1].strip() == "y = nn.BatchNorm("
    assert "use_running_average=self.use_running_average" in lines[int(line)]


@pytest.mark.parametrize("name", sorted(cs.REPLACES))
def test_replaces_names_a_line_of_the_jax_package(name):
    path, line = cs.REPLACES[name].split(":")
    with open(os.path.join(ROOT, path)) as f:
        lines = f.read().splitlines()
    assert 1 <= int(line) <= len(lines)
    if not name.startswith("fused_bn"):  # a Pallas kernel's body
        assert lines[int(line) - 1].lstrip().startswith("def ")


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_bounds_are_the_benchmark_arithmetic_on_a_known_card(monkeypatch, name):
    """A kernel's least time is ``benchmark/counts.py``'s ``bound_s`` at that
    table's peaks for the card the smoke runs on, and null on a card the
    table lacks (no other card's peaks stand in)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *device: name)
    # 6.7 GB (2 ms at 3.35 TB/s) with 9.89e12 bf16 operations (10 ms) and
    # with 6.7e10 f32 ones (1 ms)
    got = [cs.least_ms(6.7e9, 9.89e12), cs.least_ms(6.7e9, 6.7e10, "f32")]
    card = counts.peaks(name)
    if card is None:
        assert got == [(None, None), (None, None)]
        return
    assert got == [(counts.bound_s(6.7e9, 9.89e12, card["bf16"], card["bytes"]) * 1e3,
                    "operations"),
                   (counts.bound_s(6.7e9, 6.7e10, card["f32"], card["bytes"]) * 1e3, "bytes")]
    assert [ms for ms, _ in got] == [pytest.approx(10.0), pytest.approx(2.0)]

"""The readers of the program's spans (``benchmark/spans.py``,
``metrics/syncs.*``, ``sync_idle_ms.*``, ``enqueue_idle_ms.*``) on
synthetic traces.

Each step of the trace below (microseconds from the step's start, 1000 a
step) runs on thread 1 in its step span [0, 500), with a forward phase
[1, 200) and a backward phase [200, 400) on thread 1, and:

- a kernel [10, 60), an ``iv.sync.gather_cids`` span [55, 75) holding the
  host's ``aten::copy_`` and the copy [60, 70), then idle [70, 100): a gap
  that begins inside the sync span (30);
- a kernel [100, 150), idle [150, 180): in the step, in no sync span (30);
- a kernel [180, 250) and a copy [250, 255), idle [255, 270): begins inside
  an ``iv.sync.segment_sum_channels`` span [240, 260) on thread 2, the
  autograd engine's, while thread 1 is in the backward phase (15);
- a kernel [270, 510), then idle until the next step's first kernel at
  1010: a gap that begins after the step span ends (500 a step but the
  last).

Each copy ends 5 before its span. Moving the device events against the
host's takes the copies out of their spans, as a drifting device clock
does in a real capture.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark import spans as bspans
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
STEPS = 3
NAMES = {"train": ("syncs.train", "sync_idle_ms.train", "enqueue_idle_ms.train"),
         "infer": ("syncs.infer", "sync_idle_ms.infer", "enqueue_idle_ms.infer")}


def _events(kind: str, steps: int = STEPS, spans: bool = True) -> list:
    events = []
    for k in range(steps):
        t0 = 1000.0 * k

        def add(cat, name, a, b, tid=1):
            events.append({"cat": cat, "name": name, "ts": t0 + a, "dur": b - a, "tid": tid})

        for a, b in ((10, 60), (100, 150), (180, 250), (270, 510)):
            add("kernel", "void at::native::vectorized_elementwise_kernel", a, b)
        add("gpu_memcpy", bspans.HTOD, 60, 70)
        add("gpu_memcpy", bspans.HTOD, 250, 255)
        add("cpu_op", "aten::copy_", 56, 74)
        if spans:
            phase = "iv.train" if kind == "train" else "iv.eval"
            add("user_annotation", bspans.STEP[kind], 0, 500)
            add("user_annotation", f"{phase}.forward", 1, 200)
            add("user_annotation", f"{phase}.backward", 200, 400)
            add("user_annotation", "iv.sync.gather_cids", 55, 75)
            add("user_annotation", "iv.sync.segment_sum_channels", 240, 260, tid=2)
    return events


def _run(kind: str, trace) -> harness.Run:
    return harness.Run(kind=kind, config={}, mix={}, steps=10, images=10, window_s=1.0,
                       memory_peak_bytes=0, checks=[], device_name="NVIDIA H100 80GB HBM3",
                       trace=trace)


def _read(name: str, run):
    return harness.load_metric(name).read(run)


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_readers_of_each_kind(kind):
    run = _run(kind, Trace(_events(kind), STEPS))
    syncs, sync_idle, enqueue_idle = NAMES[kind]
    assert _read(syncs, run) == 2.0
    # 30 + 15 us a step, the second gap's sync span on another thread
    assert _read(sync_idle, run) == pytest.approx(0.045)
    assert _read(enqueue_idle, run) == pytest.approx(0.03)
    # the other kind's readers find nothing in this kind's run
    other = "infer" if kind == "train" else "train"
    assert [_read(name, run) for name in NAMES[other]] == [None] * 3


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_idle_adds_up_to_the_traced_idle_time(kind):
    trace = Trace(_events(kind), STEPS)
    idle = bspans.idle_ms(_run(kind, trace), kind)
    assert idle["outside"] == pytest.approx(0.5 * (STEPS - 1) / STEPS)
    total_ms = (trace.window_s - trace.busy_s) * 1e3 / STEPS
    assert sum(idle.values()) == pytest.approx(total_ms)


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_no_program_span_reads_none(kind):
    run = _run(kind, Trace(_events(kind, spans=False), STEPS))
    assert [_read(name, run) for name in NAMES[kind]] == [None] * 3
    assert [_read(name, _run(kind, None)) for name in NAMES[kind]] == [None] * 3


def test_a_step_without_crossings_reads_zero():
    # no sync span and no copy: the gaps [60, 100), [150, 180), [250, 270)
    events = [e for e in _events("train")
              if not e["name"].startswith(bspans.SYNC) and e["name"] != bspans.HTOD]
    run = _run("train", Trace(events, STEPS))
    assert _read("syncs.train", run) == 0.0
    assert _read("sync_idle_ms.train", run) == 0.0
    assert _read("enqueue_idle_ms.train", run) == pytest.approx(0.09)


def _moved(events: list, move) -> list:
    """The events with each device time ``t`` at ``move(t)``, the host's as
    they were."""
    out = []
    for e in events:
        if e["cat"] in ("kernel", "gpu_memcpy"):
            a, b = move(e["ts"]), move(e["ts"] + e["dur"])
            e = dict(e, ts=a, dur=b - a)
        out.append(e)
    return out


CLOCKS = {
    "late": lambda t: t + 10.0,
    "early": lambda t: t - 10.0,
    # as seen on the card: the device clock's offset moving at a steady rate
    "drifting": lambda t: t - 12.0 + 0.01 * t,
}


@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("clock", sorted(CLOCKS))
def test_a_moved_device_clock_is_brought_back(kind, clock):
    """Copies outside their spans on a device clock that is late, early or
    drifting at a steady rate: the line that ends each copy in its span puts
    the events back (each copy at its span's end, every gap 5 later than it
    was, where it began), so the readers read as on the host's clock."""
    events = _moved(_events(kind), CLOCKS[clock])
    trace = Trace(events, STEPS)
    _, offset, rate = bspans.clock_line(trace, [(ts, ts + dur) for name, ts, dur, _ in trace.host
                                                if name.startswith(bspans.SYNC)])
    assert (offset, rate) != (0.0, 0.0)
    run = _run(kind, trace)
    syncs, sync_idle, enqueue_idle = NAMES[kind]
    assert _read(syncs, run) == 2.0
    assert _read(sync_idle, run) == pytest.approx(0.045)
    assert _read(enqueue_idle, run) == pytest.approx(0.03)


@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("case", ["copy_without_span", "clock_jump"])
def test_copies_no_clock_line_fits_read_no_idle(kind, case):
    """A copy without its sync span (the copies and spans differ in number),
    or a device clock that jumps in the last step (no line ends every copy
    in its span), leaves the idle split unread; the count of sync spans,
    host times alone, still reads."""
    events = _events(kind)
    if case == "copy_without_span":
        events = [e for e in events if e["name"] != "iv.sync.gather_cids"]
    else:
        events = _moved(events, lambda t: t + 100.0 if t >= 1000.0 * (STEPS - 1) else t)
    run = _run(kind, Trace(events, STEPS))
    syncs, sync_idle, enqueue_idle = NAMES[kind]
    assert _read(syncs, run) == (1.0 if case == "copy_without_span" else 2.0)
    assert bspans.idle_ms(run, kind) is None
    assert [_read(sync_idle, run), _read(enqueue_idle, run)] == [None, None]


def test_result_line_carries_the_span_metrics():
    """A traced train line with the synthetic spans reports the three train
    readers beside the accepted ones; the breakdown names each idle gap by
    the innermost host op or span at its start, a phase where it named no
    host op before."""
    ctx = harness.build_context("train.cityscapes", 1, 1.0, True, torch.device("cpu"))
    run = _run("train", Trace(_events("train"), STEPS))
    run.config, run.mix = ctx.config, ctx.mix
    line = harness.result_line(SPEC, ctx, run, "train_img_per_s")
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["syncs.train"] == 2.0
    assert metrics["sync_idle_ms.train"] == pytest.approx(0.045)
    assert metrics["enqueue_idle_ms.train"] == pytest.approx(0.03)
    assert not set(NAMES["infer"]) & set(metrics)
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps == {"aten::copy_": pytest.approx(30e-6 * STEPS),
                    "iv.train.forward": pytest.approx(30e-6 * STEPS),
                    "iv.sync.segment_sum_channels": pytest.approx(15e-6 * STEPS),
                    "(no host op)": pytest.approx(500e-6 * (STEPS - 1))}

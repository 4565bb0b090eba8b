"""The port's spans (utils/spans.py) on the CPU.

With no profiler ``span`` is one shared no-op and makes no
``record_function``. Under a CPU ``torch.profiler`` capture a train and an
eval step at a tiny size (the trunk cut to two blocks, 32x64 images; an
eval step with PSP at 48x96) emit their step span with each phase inside
it; the predict step has no step span of its own. The ``iv.sync.<site>``
spans a step are pinned by site, train, eval and predict, so that a
crossing added without its span, or one taken away, changes the count. The
predict step's ``torch.export`` graph holds no profiler node.

The pinned counts are the CPU's: here the fused loss runs its plain version,
which gathers and sums labels itself, once in its forward and once more in
its backward (``ops/fused_loss.py::_plain_terms``: 6 of the train step's
``gather_cids`` and 4 of its ``segment_sum_channels``); on the card B1/B2
read the cached ``_device_tables`` instead, uploaded on the first call only.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models import model as port_model
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.train.step import make_eval_step, make_predict_step, make_train_step
from iv2019_tpu_torch.utils import spans

PROBLEM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "iv2019_tpu_torch", "problem_definitions", "cityscapes", "problem01.json")
TINY_BLOCKS = ((2, 32, 8), (2, 64, 16))
H, W = 32, 64
LABEL_HW = (64, 128)
PSP_HW = (48, 96)  # stride-8 maps of 6x12, which the pyramid's 6x6 bins divide
NB = 2
TRAIN_PHASES = ("iv.train.assemble", "iv.train.forward", "iv.train.backward",
                "iv.train.update", "iv.train.metrics")
EVAL_PHASES = ("iv.eval.forward", "iv.eval.decide", "iv.eval.resize", "iv.eval.confusion")
# iv.sync.<site> spans of one step at this size, the inputs on the step's device
SYNCS = {
    # the model's decision fusion 3, the fused loss's head labels 3, the
    # summary masks' 1 and 2; the plain B1/B2's 3 + 3 and 2 + 2
    "train": {"iv.sync.gather_cids": 13, "iv.sync.segment_sum_channels": 6},
    # the fusion 3 and the eval remap 1; the x8 upsampler's two matrices for
    # each of the three heads; the nearest resize's row and column indices
    "eval": {"iv.sync.gather_cids": 4, "iv.sync.resize_matrix": 6,
             "iv.sync.resize_index": 2},
    # with PSP (Vistas' eval) at 48x96, labels at the image size: the
    # pyramid's four bins resized back each by two index pairs and two weight
    # rows, one index table for the nearest resize at the same size
    "eval_psp": {"iv.sync.gather_cids": 4, "iv.sync.resize_matrix": 6,
                 "iv.sync.resize_index": 1 + 16, "iv.sync.resize_weights": 8},
    # the fusion 3, the upsampler 6
    "predict": {"iv.sync.gather_cids": 3, "iv.sync.resize_matrix": 6},
}
# host arrays in place of the tensors add one upload each: the train batch's
# six parts, the eval images and labels, the predict images
HOST_SYNCS = {"train": {"iv.sync.batch": 6}, "eval": {"iv.sync.images": 1, "iv.sync.labels": 1},
              "eval_psp": {"iv.sync.images": 1, "iv.sync.labels": 1},
              "predict": {"iv.sync.images": 1}}


def _settings(mode: str, **kw) -> Settings:
    kw = dict(dict(height_feature_extractor=H, width_feature_extractor=W), **kw)
    s = Settings(per_pixel_dataset_name="cityscapes", device="cpu", mode=mode, Nb_per_pixel=NB,
                 Nb_per_bbox=NB, Nb_per_image=NB, Nb=NB, Ntrain=16, Ne=3,
                 learning_rate_boundaries=(1, 2), learning_rate_values=(0.01, 0.005, 0.0025),
                 feature_dims_decreased=16, compute_dtype="float32", ema_decay=0.9,
                 training_problem_def_path=PROBLEM, **kw)
    return s.finalize() if mode == "train" else s


def _model(s: Settings):
    return init_model(build_model(s), torch.Generator().manual_seed(0))


def _train_batch(rng) -> dict:
    def images():
        return torch.as_tensor(rng.uniform(-1, 1, (NB, H, W, 3)).astype(np.float32))

    def weak():
        return torch.as_tensor(rng.dirichlet(np.ones(15), (NB, H, W)).astype(np.float32))

    return {"proimages_per_pixel": images(), "proimages_per_bbox": images(),
            "proimages_per_image": images(),
            "prolabels_per_pixel": torch.as_tensor(rng.randint(0, 20, (NB, H, W), np.int32)),
            "prolabels_per_bbox": weak(), "prolabels_per_image": weak()}


def _host(value):
    return {k: v.numpy() for k, v in value.items()} if isinstance(value, dict) else value.numpy()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{kind: (run the step once on its inputs, host inputs too)}, each
    step warmed up once."""
    torch.set_num_threads(1)
    blocks = port_model.FEATURE_EXTRACTOR_BLOCKS["resnet_v1_50"]
    port_model.FEATURE_EXTRACTOR_BLOCKS["resnet_v1_50"] = TINY_BLOCKS
    try:
        rng = np.random.RandomState(0)
        s = _settings("train")
        opt = FusedSGDM(s, _model(s))
        holder = {"state": create_fused_train_state(opt)}
        train = make_train_step(s, fused_opt=opt)
        batch = _train_batch(rng)

        def train_once(b):
            holder["state"], metrics = train(holder["state"], b)
            return metrics["total"]

        s = _settings("eval")
        model = _model(s)
        evaluate = make_eval_step(s, model=model)
        predict = make_predict_step(_settings("predict"), model=model)
        images = torch.as_tensor(rng.uniform(-1, 1, (NB, H, W, 3)).astype(np.float32))
        labels = torch.as_tensor(rng.randint(0, 19, (NB, *LABEL_HW), np.int32))
        s = _settings("eval", height_feature_extractor=PSP_HW[0],
                      width_feature_extractor=PSP_HW[1], psp_module=True)
        evaluate_psp = make_eval_step(s, model=_model(s))
        psp_inputs = (torch.as_tensor(rng.uniform(-1, 1, (NB, *PSP_HW, 3)).astype(np.float32)),
                      torch.as_tensor(rng.randint(0, 19, (NB, *PSP_HW), np.int32)))

        def evaluate_on(step, inputs, host):
            return step(*map(_host, inputs)) if host else step(*inputs)

        runs = {"train": (lambda host: train_once(_host(batch) if host else batch)),
                "eval": (lambda host: evaluate_on(evaluate, (images, labels), host)),
                "eval_psp": (lambda host: evaluate_on(evaluate_psp, psp_inputs, host)),
                "predict": (lambda host: predict(_host(images) if host else images))}
        for run in runs.values():
            run(False)
        yield runs, model, predict, images
    finally:
        port_model.FEATURE_EXTRACTOR_BLOCKS["resnet_v1_50"] = blocks


def _annotations(run, tmp_path) -> list:
    """The user_annotation events of one profiled call of ``run``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_span_off_is_one_shared_noop_without_record_function(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", made.append)
    assert spans.span("iv.a") is spans.OFF and spans.span("iv.b") is spans.OFF
    with spans.span("iv.a"), spans.span("iv.b"):
        pass
    assert spans.copy_span("iv.c", np.zeros(2), torch.device("cpu")) is spans.OFF
    assert made == []


def test_span_on_is_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = spans.span("iv.a")
        tensor = spans.copy_span("iv.c", torch.zeros(2), torch.device("cpu"))
        host = spans.copy_span("iv.c", np.zeros(2), torch.device("cpu"))
    assert isinstance(on, torch.profiler.record_function)
    assert isinstance(host, torch.profiler.record_function)
    # a tensor on the device crosses nothing
    assert tensor is spans.OFF
    assert spans.span("iv.a") is spans.OFF


@pytest.mark.parametrize("kind, step_name, phases", [
    ("train", "iv.train_step", TRAIN_PHASES),
    ("eval", "iv.eval_step", EVAL_PHASES),
])
def test_step_span_holds_its_phases(steps, tmp_path, kind, step_name, phases):
    runs = steps[0]
    events = _annotations(lambda: runs[kind](False), tmp_path)
    (step,) = [e for e in events if e["name"] == step_name]
    begin, end = step["ts"], step["ts"] + step["dur"]
    names = collections.Counter(e["name"] for e in events)
    assert {n for n in names if n.startswith(("iv.train.", "iv.eval."))} == set(phases)
    for e in events:
        if e is not step:
            assert begin <= e["ts"] and e["ts"] + e["dur"] <= end, e["name"]
            assert e["tid"] == step["tid"], e["name"]


def test_predict_step_has_no_step_span(steps, tmp_path):
    # no capture reads one: the step's crossings are its only spans
    events = _annotations(lambda: steps[0]["predict"](False), tmp_path)
    assert {e["name"] for e in events} == set(SYNCS["predict"])


@pytest.mark.parametrize("kind", ["train", "eval", "eval_psp", "predict"])
@pytest.mark.parametrize("host", [False, True], ids=["device_inputs", "host_inputs"])
def test_sync_spans_a_step_by_site(steps, tmp_path, kind, host):
    runs = steps[0]
    events = _annotations(lambda: runs[kind](host), tmp_path)
    counted = collections.Counter(e["name"] for e in events if e["name"].startswith("iv.sync."))
    assert counted == collections.Counter(SYNCS[kind]) + collections.Counter(
        HOST_SYNCS[kind] if host else {})


def test_exported_predict_step_holds_no_profiler_node(steps):
    _, model, predict, images = steps
    with torch.no_grad():
        program = torch.export.export(_Forward(model, predict.__wrapped__), (images,),
                                      strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


class _Forward(torch.nn.Module):
    """The predict step's decisions, its model's weights as parameters."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, images):
        return self.fn(images)["decisions"]

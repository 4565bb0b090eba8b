"""Benchmark entry point of the PyTorch port, one JSON line per run.

    python -m iv2019_tpu_torch.bench [MODE] [STEPS] [--device cpu]

The port's counterpart of the repository's ``bench.py``: the same modes,
metric names, JSON line and environment knobs, built on the port's entry
functions. MODE is ``train`` (the default; ``python -m
iv2019_tpu_torch.bench 10`` takes 10 train steps), ``predict``, ``eval``,
``input`` (host only) or ``e2e``. STEPS defaults as in ``bench.py``: 20
train steps, 30 predict requests, 12 eval steps, 12 input batches, 20 e2e
steps. Every run takes the card (``cuda``) unless ``--device cpu`` is
given; with no card it raises. A kernel that fails to build or launch
raises too.

Metrics (``metric`` of the line):

- ``train_images_per_sec_per_chip``: the flagship train step (4 + 8 + 4
  images at 512x1024, bf16, the settings of bench.py:61-75) on the constant
  batch of ``train_batch``. An untimed first step must launch each
  hand-written kernel on the step's path as often as ``step_launches``
  says (on the card). The timed steps are bracketed by ``synchronize()``;
  ``detail`` has the p50 and p90 of per-step CUDA-event times beside the
  wall time.
- ``predict_p50_latency_ms``: one image at (h, w) to (2h, 2w), p50 and p90
  of the requests after 3 warm-ups, each ended by the host readback of one
  decision; ``IV_FUSED_BLOCK=1`` runs the fused units (B4, B5).
- ``eval_images_per_sec_per_chip``: the eval step at ``IV_NB`` (8) images
  of ``IV_SHAPE`` against labels at twice the size; ``IV_FUSED_BLOCK=1``.
- ``input_pipeline_images_per_sec``: the host pipeline
  (``input/heterogeneous.py::train_input``) on on-disk data in the real
  formats (``build_synthetic_input_data``), no device.
- ``e2e_train_images_per_sec_per_chip``: host input -> ``device_prefetch``
  -> the train step, with boxes rasterized and image labels broadcast on the
  device (``IV_DENSE_LABELS=1``: dense labels from the host).

``vs_baseline`` is null in every mode: the step's operations, the card's
peaks and the model FLOP utilization are the benchmark's
(``benchmark/counts.py``, ``mfu.*``), not this entry point's.

Knobs: ``IV_SHAPE`` ("512,1024" or "512x1024"; the two formats of
``bench.py``'s train and eval modes, accepted by every mode), ``IV_NB``
("4,8,4" for train, input and e2e; one count, default 8, for eval),
``IV_FUSED_BLOCK``, ``IV_DENSE_LABELS``, ``IV_ROOT_WGRAD_PALLAS`` and
``IV_BN_IMPL`` (``Settings``' default ``fused``: train-mode BatchNorm as
kernels N1/N2, one launch each a batch-norm layer a step; ``flax``: f32
``F.batch_norm``).
``bench.py`` reads ``IV_SHAPE`` and ``IV_NB`` in train and eval only; here
predict, input and e2e read them too (predict's output is twice the input,
the input data's native size twice it as well), so that every mode runs at
a small size on the CPU; at their defaults every mode runs ``bench.py``'s
sizes.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["build_synthetic_input_data", "e2e_throughput", "eval_throughput",
           "input_pipeline_throughput", "main", "make_train", "predict_latency",
           "step_launches", "train", "train_batch", "train_settings"]

MODES = ("train", "predict", "eval", "input", "e2e")
DEFAULT_STEPS = {"train": 20, "predict": 30, "eval": 12, "input": 12, "e2e": 20}
_PROBLEM01 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "problem_definitions",
                          "cityscapes", "problem01.json")


# -- devices, knobs, counters -----------------------------------------------

def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass --device cpu to run on the CPU")
    return device


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shape(default: str) -> tuple[int, int]:
    h, w = os.environ.get("IV_SHAPE", default).replace("x", ",").split(",")
    return int(h), int(w)


def _nb3() -> tuple[int, int, int]:
    npp, npb, npi = (int(x) for x in os.environ.get("IV_NB", "4,8,4").split(","))
    return npp, npb, npi


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def _counters() -> dict:
    """The wrapper of each hand-written kernel, by the name chip_smoke.py
    reports it under; each counts its launches in ``.launches``."""
    from iv2019_tpu_torch.ops import fused_block, fused_bn, fused_loss, fused_update, root_wgrad

    return {"fused_loss_fwd": fused_loss.fused_loss_fwd,
            "fused_loss_bwd": fused_loss.fused_loss_bwd,
            "fused_update": fused_update.fused_update,
            "fused_bottleneck": fused_block.fused_bottleneck,
            "fused_bottleneck_ct": fused_block.fused_bottleneck_ct,
            "root_conv_wgrad": root_wgrad.root_conv_wgrad,
            "fused_bn_fwd": fused_bn.fused_bn_fwd,
            "fused_bn_bwd": fused_bn.fused_bn_bwd}


def train_norm_launches(model) -> int:
    """N1 and N2 launches each of a train step of ``model`` (in train
    mode): one each a batch-norm layer under ``bn_impl="fused"``, else 0."""
    from iv2019_tpu_torch.models.layers import Norm

    return sum(1 for m in model.modules()
               if isinstance(m, Norm) and m.norm_type == "batch" and m.bn_impl == "fused"
               and m.training)


def _reset_launches() -> None:
    for wrapper in _counters().values():
        wrapper.launches = 0


def _launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _counters().items()}


def _p50_p90(values):
    ordered = sorted(values)
    return ordered[len(ordered) // 2], ordered[min(len(ordered) - 1, int(len(ordered) * 0.9))]


def _emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


# -- train ------------------------------------------------------------------

def train_settings(h: int, w: int, npp: int, npb: int, npi: int, device: str = "cuda"):
    """The Settings of bench.py:61-75, with the knobs' overrides."""
    from iv2019_tpu_torch.config import Settings

    return Settings(
        per_pixel_dataset_name="cityscapes", device=device, mode="train",
        Nb_per_pixel=npp, Nb_per_bbox=npb, Nb_per_image=npi, Nb=npp,
        height_feature_extractor=h, width_feature_extractor=w,
        Ntrain=2975, Ne=17,
        learning_rate_boundaries=(8, 15, 17),
        learning_rate_values=(0.01, 0.005, 0.0025),
        compute_dtype="bfloat16",
        bn_impl=os.environ.get("IV_BN_IMPL", Settings.bn_impl),
        root_wgrad_pallas=_flag("IV_ROOT_WGRAD_PALLAS"),
    ).finalize()


def train_batch(h: int, w: int, npp: int, npb: int, npi: int, seed: int = 0) -> dict:
    """The constant batch of bench.py:78-93 as numpy arrays: the same draws
    from ``np.random.RandomState(seed)`` in the same order."""
    rng = np.random.RandomState(seed)

    def img(n):
        return rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)

    eye = np.eye(15, dtype=np.float32)  # NUM_WEAK_CLASSES
    return {
        "proimages_per_pixel": img(npp),
        "proimages_per_bbox": img(npb),
        "proimages_per_image": img(npi),
        "prolabels_per_pixel": rng.randint(0, 20, (npp, h, w)).astype(np.int32),
        "prolabels_per_bbox": eye[rng.randint(0, 15, (npb, h, w))],
        "prolabels_per_image": eye[rng.randint(0, 15, (npi, h, w))],
    }


def make_train(settings, model):
    """(state, step_fn) as bench.py builds them: the fused optimizer
    (``FusedSGDM``, kernel B3 on the card) or the optax path."""
    from iv2019_tpu_torch.train.step import make_train_step

    if settings.fused_optimizer:
        from iv2019_tpu_torch.train.fused_update import FusedSGDM
        from iv2019_tpu_torch.train.state import create_fused_train_state

        opt = FusedSGDM(settings, model)
        return create_fused_train_state(opt), make_train_step(settings, fused_opt=opt)
    from iv2019_tpu_torch.train.optimizer import make_optimizer
    from iv2019_tpu_torch.train.state import create_train_state

    tx, _ = make_optimizer(settings, model)
    return create_train_state(model, tx, settings.ema_decay), make_train_step(settings,
                                                                               model=model)


def step_launches(settings, model) -> dict:
    """Launches of each hand-written kernel in one train step of
    ``settings`` on the card, by the name ``_counters`` gives it: B1/B2 when
    the fused loss runs (``train/step.py::uses_fused_loss``), B3 under the
    fused optimizer, B6 when the root conv sends its weight gradient there
    (``_RootConv.runs_wgrad_kernel``), once a step each; N1/N2 once each a
    batch-norm layer under ``bn_impl="fused"``."""
    from iv2019_tpu_torch.train.step import uses_fused_loss

    h, w = settings.height_feature_extractor, settings.width_feature_extractor
    n = settings.Nb_per_pixel + settings.Nb_per_bbox + settings.Nb_per_image
    want = {}
    if uses_fused_loss(settings, model):
        want.update(fused_loss_fwd=1, fused_loss_bwd=1)
    if settings.fused_optimizer and settings.pallas_update:
        want["fused_update"] = 1
    if model.get_submodule("feature_extractor/base").conv1.runs_wgrad_kernel((n, 3, h, w)):
        want["root_conv_wgrad"] = 1
    norms = train_norm_launches(model)
    if norms:
        want.update(fused_bn_fwd=norms, fused_bn_bwd=norms)
    return want


def train(steps: int = 20, warmup: int = 3, device: str = "cuda") -> dict:
    """Train-step throughput at the flagship configuration (bench.py:44-192)."""
    from iv2019_tpu_torch.models.model import build_model, init_model

    device = _device(device)
    h, w = _shape("512,1024")
    npp, npb, npi = _nb3()
    settings = train_settings(h, w, npp, npb, npi, device.type)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    state, step_fn = make_train(settings, model)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in train_batch(h, w, npp, npb, npi).items()}
    imgs = npp + npb + npi

    # one untimed step: the kernels on the step's path, each launched as often as it should be
    _reset_launches()
    state, _ = step_fn(state, batch)
    _sync(device)
    launched = {k: v for k, v in _launches().items() if v}
    want = step_launches(settings, model)
    if device.type == "cuda" and launched != want:
        raise RuntimeError(f"bench train: kernel launches {launched} in one step, expected {want}")

    for _ in range(warmup):
        state, metrics = step_fn(state, batch)
    _sync(device)
    _reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    if device.type == "cuda":
        events = []
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch)
            end.record()
            events.append((start, end))
        _sync(device)
        step_ms = [a.elapsed_time(b) for a, b in events]
    else:
        for _ in range(steps):
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            step_ms.append((time.perf_counter() - t1) * 1e3)
    dt = time.perf_counter() - t0
    launches = _launches()

    p50, p90 = _p50_p90(step_ms)
    return _emit({
        "metric": "train_images_per_sec_per_chip",
        "value": round(steps * imgs / dt, 3),
        "unit": "img/s",
        "vs_baseline": None,
        "detail": {
            "step_time_ms": round(dt / steps * 1e3, 2),
            "step_p50_ms": round(p50, 3), "step_p90_ms": round(p90, 3),
            "step_timer": "cuda events" if device.type == "cuda" else "host clock",
            "steps": steps, "images_per_step": imgs, "input_hw": [h, w],
            "Nb": [npp, npb, npi],
            "loss": float(metrics["total"]),
            "root_wgrad_pallas": settings.root_wgrad_pallas,
            "bn_impl": settings.bn_impl,
            "launches": launches,
            "device": _device_name(device),
        },
    })


# -- predict and eval -------------------------------------------------------

def predict_latency(samples: int = 30, warmup: int = 3, device: str = "cuda") -> dict:
    """Single-image predict latency (bench.py:195-240)."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.step import make_predict_step

    device = _device(device)
    h, w = _shape("512,1024")
    out_hw = (2 * h, 2 * w)
    fused = _flag("IV_FUSED_BLOCK")
    settings = Settings(per_pixel_dataset_name="cityscapes", mode="predict", device=device.type,
                        height_feature_extractor=h, width_feature_extractor=w,
                        fused_block=fused)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    predict_fn = make_predict_step(settings, output_size=out_hw, model=model)
    rng = np.random.RandomState(0)
    image = torch.as_tensor(rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32), device=device)

    lat = []
    for i in range(warmup + samples):
        if i == warmup:
            _reset_launches()
        t0 = time.perf_counter()
        out = predict_fn(image)
        int(out["decisions"][0, 0, 0])  # host readback: the request's end
        if i >= warmup:
            lat.append(time.perf_counter() - t0)
    p50, p90 = _p50_p90([x * 1e3 for x in lat])
    return _emit({
        "metric": "predict_p50_latency_ms",
        "value": round(p50, 2),
        "unit": "ms",
        "vs_baseline": None,
        "detail": {"p90_ms": round(p90, 2), "n": samples, "input_hw": [h, w],
                   "output_hw": list(out_hw), "fused_block": fused, "launches": _launches(),
                   "device": _device_name(device)},
    })


def eval_throughput(steps: int = 12, warmup: int = 3, nb: int = 8, device: str = "cuda") -> dict:
    """Eval-step throughput (bench.py:243-295)."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.step import make_eval_step

    device = _device(device)
    h, w = _shape("512x1024")
    nb = int(os.environ.get("IV_NB", nb))
    fused = _flag("IV_FUSED_BLOCK")
    settings = Settings(per_pixel_dataset_name="cityscapes", mode="eval", device=device.type,
                        Nb=nb, height_feature_extractor=h, width_feature_extractor=w,
                        fused_block=fused, training_problem_def_path=_PROBLEM01)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    eval_fn = make_eval_step(settings, model=model)
    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.uniform(-1, 1, (nb, h, w, 3)).astype(np.float32),
                             device=device)
    labels = torch.as_tensor(rng.randint(0, 20, (nb, 2 * h, 2 * w)).astype(np.int32),
                             device=device)

    for _ in range(warmup):
        cm = eval_fn(images, labels)
    int(cm[0, 0])
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        cm = eval_fn(images, labels)
    int(cm[0, 0])  # one queue: the last step done, all done
    dt = time.perf_counter() - t0
    return _emit({
        "metric": "eval_images_per_sec_per_chip",
        "value": round(steps * nb / dt, 3),
        "unit": "img/s",
        "vs_baseline": None,
        "detail": {"step_time_ms": round(dt / steps * 1e3, 2), "Nb": nb, "steps": steps,
                   "fused_block": fused, "input_hw": [h, w], "launches": _launches(),
                   "device": _device_name(device)},
    })


# -- host input -------------------------------------------------------------

def build_synthetic_input_data(tmp: str, rng, hw=(512, 1024)) -> dict:
    """On-disk synthetic data in the real formats (bench.py:298-368):
    8 PNG-encoded Cityscapes-like TFRecords at twice ``hw`` (1024x2048 at the
    flagship, Cityscapes' native size), 8 OpenImages-style JPEGs at (1.5 h,
    w), and the box and image-label mappings as JSON; the same draws from
    ``rng`` in the same order."""
    from PIL import Image

    from iv2019_tpu_torch.input.tfrecord_writer import TFRecordWriter, encode_example
    from iv2019_tpu_torch.problem.taxonomy import OPEN_IMAGES_MID2CID

    h_raw, w_raw = 2 * hw[0], 2 * hw[1]

    def _structured(h, w, c=3):
        """Smooth gradients and 64-pixel blocks: a street scene's
        compressibility (noise makes pathological multi-MB PNGs)."""
        yy, xx = np.meshgrid(np.linspace(0, 255, h, dtype=np.float32),
                             np.linspace(0, 255, w, dtype=np.float32), indexing="ij")
        base = np.stack([yy, xx, (yy + xx) / 2][:c], -1).astype(np.uint8)
        blocks = rng.randint(0, 255, (h // 64 + 1, w // 64 + 1, c), np.uint8)
        blocks = np.kron(blocks, np.ones((64, 64, 1), np.uint8))[:h, :w]
        return ((base.astype(np.uint16) + blocks) // 2).astype(np.uint8)

    tfr = os.path.join(tmp, "train.tfrecords")
    with TFRecordWriter(tfr) as writer:
        for i in range(8):
            img = _structured(h_raw, w_raw)
            lab = np.kron(rng.randint(0, 34, (h_raw // 32, w_raw // 32), np.uint8),
                          np.ones((32, 32), np.uint8))[:h_raw, :w_raw]
            ib, lb = io.BytesIO(), io.BytesIO()
            Image.fromarray(img).save(ib, format="PNG")
            Image.fromarray(lab).save(lb, format="PNG")
            writer.write(encode_example({
                "image/encoded": ib.getvalue(), "label/encoded": lb.getvalue(),
                "image/path": f"im{i}.png", "label/path": f"la{i}.png",
            }))

    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    id2boxes, id2mids = {}, {}
    mids = list(OPEN_IMAGES_MID2CID)
    for i in range(8):
        iid = f"oi{i}"
        Image.fromarray(_structured(3 * hw[0] // 2, hw[1])).save(
            os.path.join(img_dir, iid + ".jpg"), quality=90)
        boxes = []
        for _ in range(rng.randint(1, 20)):
            x0, x1 = sorted(rng.rand(2))
            y0, y1 = sorted(rng.rand(2))
            boxes.append((mids[rng.randint(0, 14)], (float(x0), float(x1), float(y0), float(y1))))
        id2boxes[iid] = boxes
        id2mids[iid] = [m for m, _ in boxes[:3]]
    with open(os.path.join(tmp, "boxes.json"), "w") as f:
        json.dump(id2boxes, f)
    with open(os.path.join(tmp, "imagelabels.json"), "w") as f:
        json.dump(id2mids, f)
    return {
        "tfrecords_path_per_pixel": tfr,
        "openimages_image_dir": img_dir,
        "openimages_bboxes_path": os.path.join(tmp, "boxes.json"),
        "openimages_image_labels_path": os.path.join(tmp, "imagelabels.json"),
        "native_hw": (h_raw, w_raw),
    }


def input_pipeline_throughput(num_batches: int = 12, device: str = "cuda") -> dict:
    """Host input-pipeline throughput on real formats (bench.py:371-418):
    TFRecord read, PNG/JPEG decode, lids2cids, box rasterizing, resize and
    crop, batching."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.problem.problem_def import load_problem_def

    _device(device)  # a run on the card's host, or one asked for on the CPU
    hw = _shape("512,1024")
    npp, npb, npi = _nb3()
    tmp = tempfile.mkdtemp(prefix="bench_input_")
    try:
        data = build_synthetic_input_data(tmp, np.random.RandomState(0), hw)
        native = data.pop("native_hw")
        settings = Settings(per_pixel_dataset_name="cityscapes", mode="train",
                            height_feature_extractor=hw[0], width_feature_extractor=hw[1],
                            Nb_per_pixel=npp, Nb_per_bbox=npb, Nb_per_image=npi, Nb=npp,
                            learning_rate_values=(0.01, 0.005, 0.0025), **data).finalize()
        it = train_input(settings, load_problem_def(_PROBLEM01), seed=0)
        try:
            next(it)  # warm the pools
            t0 = time.perf_counter()
            for _ in range(num_batches):
                next(it)
            dt = time.perf_counter() - t0
        finally:
            it.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    imgs = npp + npb + npi
    return _emit({
        "metric": "input_pipeline_images_per_sec",
        "value": round(num_batches * imgs / dt, 2),
        "unit": "img/s",
        "vs_baseline": None,
        "detail": {"batches": num_batches, "images_per_batch": imgs, "input_hw": list(hw),
                   "per_pixel_native": list(native), "host_cores": os.cpu_count(),
                   "note": "host-only: decode+rasterize+resize+batch, no device"},
    })


# -- end to end -------------------------------------------------------------

def e2e_throughput(steps: int = 20, warmup: int = 3, device: str = "cuda") -> dict:
    """Host pipeline -> ``device_prefetch`` (a side stream) -> the train step
    (bench.py:483-588), the path ``train_cli`` runs."""
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.input.prefetch import device_prefetch
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.problem.problem_def import load_problem_def

    device = _device(device)
    h, w = _shape("512,1024")
    npp, npb, npi = _nb3()
    dense = _flag("IV_DENSE_LABELS")
    tmp = tempfile.mkdtemp(prefix="bench_e2e_")
    try:
        data = build_synthetic_input_data(tmp, np.random.RandomState(0), (h, w))
        data.pop("native_hw")
        settings = train_settings(h, w, npp, npb, npi, device.type).replace(
            rasterize_on_device=not dense, compact_image_labels=not dense, **data)
        model = init_model(build_model(settings), torch.Generator().manual_seed(0))
        state, step_fn = make_train(settings, model)
        batches = device_prefetch(train_input(settings, load_problem_def(_PROBLEM01), seed=0),
                                  device)
        try:
            for i, batch in enumerate(batches):
                batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
                state, metrics = step_fn(state, batch)
                if i == warmup - 1:
                    _sync(device)
                    _reset_launches()
                    t0 = time.perf_counter()
                if i == warmup + steps - 1:
                    _sync(device)
                    break
            dt = time.perf_counter() - t0
        finally:
            batches.close()  # stops the prefetch thread and its side stream
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    imgs = npp + npb + npi
    return _emit({
        "metric": "e2e_train_images_per_sec_per_chip",
        "value": round(steps * imgs / dt, 3),
        "unit": "img/s",
        "vs_baseline": None,
        "detail": {"step_time_ms": round(dt / steps * 1e3, 2), "steps": steps,
                   "images_per_step": imgs, "input_hw": [h, w], "host_cores": os.cpu_count(),
                   "loss": float(metrics["total"]), "launches": _launches(),
                   "device": _device_name(device),
                   "weak_label_transfer": "dense" if dense else "compact",
                   "note": "host pipeline + device_prefetch + train step "
                           "(train_cli path) on real on-disk formats"},
    })


# -- command line -----------------------------------------------------------

def parse_args(argv) -> dict:
    """``[MODE] [STEPS] [--device D]`` -> {mode, steps, device}; a first
    argument that is a number is train's step count, as in ``python
    bench.py 10``."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("bench: --device needs a value")
        device = argv[i + 1]
        del argv[i:i + 2]
    mode = argv.pop(0) if argv and argv[0] in MODES else "train"
    if len(argv) > 1 or (argv and not argv[0].isdigit()):
        raise SystemExit(f"bench: unexpected arguments {argv}; usage: "
                         "[train|predict|eval|input|e2e] [STEPS] [--device cpu]")
    steps = int(argv[0]) if argv else DEFAULT_STEPS[mode]
    return {"mode": mode, "steps": steps, "device": device}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    mode, steps, device = args["mode"], args["steps"], args["device"]
    if mode == "input":
        return input_pipeline_throughput(steps, device=device)
    if mode == "predict":
        return predict_latency(steps, device=device)
    if mode == "eval":
        return eval_throughput(steps, device=device)
    if mode == "e2e":
        return e2e_throughput(steps, device=device)
    return train(steps, device=device)


if __name__ == "__main__":
    main()

"""Benchmark entry point of the PyTorch port, one JSON line per run.

    python -m iv2019_tpu_torch.bench [MODE] [STEPS] [--device cpu]
    python -m iv2019_tpu_torch.bench input --workers 1,2,4,8,16 [--stage_ms 100]

The port's counterpart of the repository's ``bench.py``: the same modes,
metric names, JSON line and environment knobs, built on the port's entry
functions. MODE is ``train`` (the default; ``python -m
iv2019_tpu_torch.bench 10`` takes 10 train steps), ``predict``, ``eval``,
``input`` (host only; with ``--workers`` the worker-scaling curve) or
``e2e``. STEPS defaults as in ``bench.py``: 20 train steps, 30 predict
requests, 12 eval steps, 12 input batches, 20 e2e steps. Every run takes
the card (``cuda``) unless ``--device cpu`` is given; with no card it
raises. A kernel that fails to build or launch raises too.

Metrics (``metric`` of the line):

- ``train_images_per_sec_per_chip``: the flagship train step (4 + 8 + 4
  images at 512x1024, bf16, the settings of bench.py:61-75) on the constant
  batch of ``train_batch``; ``vs_baseline`` = value / (0.9 x roofline),
  the roofline being the card's peak bf16 rate (``peak_flops``) over the
  step's operations per image. The operations are those
  ``torch.utils.flop_counter.FlopCounterMode`` counts over one untimed step,
  plus the operations of the hand-written kernels the counter cannot see
  (``ctypes`` calls: B1, B2, B3 and, with ``IV_ROOT_WGRAD_PALLAS=1``, B6),
  counted from their shapes (``kernel_flops``, reported apart). On the CPU
  the kernels' plain versions run in their place and the counter sees
  their matrix products, so only kernels that launched are added. The
  timed steps are bracketed by ``synchronize()``; ``detail`` has the p50
  and p90 of per-step CUDA-event times beside the wall time.
- ``predict_p50_latency_ms``: one image at (h, w) to (2h, 2w), p50 and p90
  of the requests after 3 warm-ups, each ended by the host readback of one
  decision; ``IV_FUSED_BLOCK=1`` runs the fused units (B4, B5).
- ``eval_images_per_sec_per_chip``: the eval step at ``IV_NB`` (8) images
  of ``IV_SHAPE`` against labels at twice the size; ``IV_FUSED_BLOCK=1``.
- ``input_pipeline_images_per_sec``: the host pipeline
  (``input/heterogeneous.py::train_input``) on on-disk data in the real
  formats (``build_synthetic_input_data``), no device.
- ``input_pipeline_worker_scaling``: ``input/core.py::parallel_map`` and
  ``batched`` over a decode stage that sleeps ``--stage_ms`` (releasing the
  GIL as the real decoders do), per worker count.
- ``e2e_train_images_per_sec_per_chip``: host input -> ``device_prefetch``
  -> the train step, with boxes rasterized and image labels broadcast on the
  device (``IV_DENSE_LABELS=1``: dense labels from the host).

Knobs: ``IV_SHAPE`` ("512,1024" or "512x1024"; the two formats of
``bench.py``'s train and eval modes, accepted by every mode), ``IV_NB``
("4,8,4" for train, input and e2e; one count, default 8, for eval),
``IV_FUSED_BLOCK``, ``IV_DENSE_LABELS``, ``IV_ROOT_WGRAD_PALLAS``,
``IV_BN_IMPL`` (``Settings``' default ``fused``: train-mode BatchNorm as
kernels N1/N2, one launch each a batch-norm layer a step; ``flax``: f32
``F.batch_norm``), and the TPU layout switches
``IV_CONV_IMPL``, ``IV_DILATION_MODE``, ``IV_ROOT_S2D``, which the port
accepts and runs its one path for (config.py).
``bench.py`` reads ``IV_SHAPE`` and ``IV_NB`` in train and eval only; here
predict, input and e2e read them too (predict's output is twice the input,
the input data's native size twice it as well), so that every mode runs at
a small size on the CPU; at their defaults every mode runs ``bench.py``'s
sizes.

``docs/floor.json`` is a TPU's measurement, so the achievable-floor fields
are null; no peak is guessed for a device not in ``PEAK_FLOPS``
(``vs_baseline`` null, the name printed to stderr).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["PEAK_FLOPS", "build_synthetic_input_data", "count_flops", "e2e_throughput",
           "eval_throughput", "input_pipeline_throughput", "input_worker_scaling",
           "kernel_flops", "main", "make_train", "peak_flops", "predict_latency", "train",
           "train_batch", "train_settings"]

# dense bf16 tensor-core peak by torch.cuda.get_device_name(): the H100 SXM5
# (NVIDIA H100 Tensor Core GPU datasheet, bf16 without sparsity)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}

# operations per output pixel of the fused loss and per parameter of the
# update, counted from the kernels' arithmetic (chip_smoke.py bounds the
# kernels by them too): the 4-tap upsample (9 per logit), max, exp, sum and
# the CE terms (~6 per logit), plus the weak projection and gates (~40); the
# backward adds the gradient (4 per logit) and its two contractions (~5)
LOSS_FWD_OPS_PER_LOGIT, LOSS_BWD_OPS_PER_LOGIT, LOSS_OPS_PER_PIXEL = 15, 24, 40
UPDATE_OPS_PER_PARAM = 14

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


def peak_flops(name: str) -> Optional[float]:
    """The card's peak bf16 FLOP/s, or None (and the name on stderr) for a
    device this table does not know."""
    peak = PEAK_FLOPS.get(name)
    if peak is None:
        print(f"bench: no peak known for {name!r}; vs_baseline is null", file=sys.stderr)
    return peak


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
        conv_impl=os.environ.get("IV_CONV_IMPL", "conv"),
        bn_impl=os.environ.get("IV_BN_IMPL", Settings.bn_impl),
        dilation_mode=os.environ.get("IV_DILATION_MODE", "dilated"),
        root_conv_s2d=_flag("IV_ROOT_S2D"),
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


def count_flops(fn: Callable[[], object]) -> int:
    """Operations of the aten calls ``fn`` makes (forward and backward), as
    ``FlopCounterMode`` counts them: convolutions and matrix products."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def kernel_flops(settings, model) -> dict:
    """Operations a train step of ``settings`` does in each hand-written
    kernel on its path, by the kernel's name: B1/B2 when the fused loss runs
    (``train/step.py::uses_fused_loss``), B3 under the fused optimizer, B6
    when the root conv sends its weight gradient there
    (``_RootConv.runs_wgrad_kernel``); once a step each."""
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.train.step import uses_fused_loss

    tax = get_taxonomy(settings.per_pixel_dataset_name)
    h, w = settings.height_feature_extractor, settings.width_feature_extractor
    n = settings.Nb_per_pixel + settings.Nb_per_bbox + settings.Nb_per_image
    out = {}
    if uses_fused_loss(settings, model):
        c_tot = tax.num_l1_classes + tax.num_vehicle_classes + tax.num_human_classes
        pixels = n * h * w
        out["fused_loss_fwd"] = pixels * (LOSS_FWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL)
        out["fused_loss_bwd"] = pixels * (LOSS_BWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL)
    if settings.fused_optimizer and settings.pallas_update:
        out["fused_update"] = UPDATE_OPS_PER_PARAM * sum(p.numel() for p in model.parameters())
    root = model.get_submodule("feature_extractor/base").conv1
    if root.runs_wgrad_kernel((n, 3, h, w)):
        cout, cin, k, _ = root.conv.weight.shape
        out["root_conv_wgrad"] = 2 * k * k * cin * cout * n * (h // 2) * (w // 2)
    return out


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
    name = _device_name(device)

    # the operations of one step, on a step of its own (untimed)
    expected = kernel_flops(settings, model)
    _reset_launches()
    holder = {}

    def one_step():
        holder["state"], _ = step_fn(state, batch)

    counted = count_flops(one_step)
    state = holder.pop("state")
    _sync(device)
    launched = {k: v for k, v in _launches().items() if v}
    want = dict.fromkeys(expected, 1)
    norms = train_norm_launches(model)
    if norms:
        want.update(fused_bn_fwd=norms, fused_bn_bwd=norms)
    if device.type == "cuda" and launched != want:
        raise RuntimeError(f"bench train: kernel launches {launched} in one step, expected {want}")
    flops_per_step = counted + sum(v for k, v in expected.items() if k in launched)

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

    ips = steps * imgs / dt
    peak = peak_flops(name)
    roofline = peak / (flops_per_step / imgs) if peak and flops_per_step else None
    p50, p90 = _p50_p90(step_ms)
    return _emit({
        "metric": "train_images_per_sec_per_chip",
        "value": round(ips, 3),
        "unit": "img/s",
        "vs_baseline": round(ips / (0.9 * roofline), 4) if roofline else None,
        "detail": {
            "step_time_ms": round(dt / steps * 1e3, 2),
            "step_p50_ms": round(p50, 3), "step_p90_ms": round(p90, 3),
            "step_timer": "cuda events" if device.type == "cuda" else "host clock",
            "steps": steps, "images_per_step": imgs, "input_hw": [h, w],
            "Nb": [npp, npb, npi],
            "flops_per_step": flops_per_step, "flops_counted": counted,
            "kernel_flops": expected,
            "peak_flops": peak,
            "roofline_img_per_s_per_chip": round(roofline, 2) if roofline else None,
            "achievable_floor_img_per_s_per_chip": None,
            "vs_achievable_floor": None,
            "loss": float(metrics["total"]),
            "root_wgrad_pallas": settings.root_wgrad_pallas,
            "layout": {k: getattr(settings, k) for k in (
                "conv_impl", "bn_impl", "dilation_mode", "root_conv_s2d")},
            "launches": launches,
            "device": name,
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


def input_worker_scaling(workers=(1, 2, 4, 8, 16), stage_ms: float = 100.0,
                         items_per_point: int = 64, device: str = "cuda") -> dict:
    """The worker-scaling curve of the host pipeline's harness
    (bench.py:420-480): ``parallel_map`` -> ``batched`` over a decode stage
    of fixed service time that releases the GIL; ideal = workers / stage."""
    from iv2019_tpu_torch.input.core import batched, parallel_map

    _device(device)
    stage_s = stage_ms / 1e3

    def synthetic_decode(i):
        time.sleep(stage_s)  # releases the GIL like the real decoders
        return {"image": np.full((8, 8, 3), i % 255, np.uint8), "index": i}

    curve = []
    for w in workers:
        it = batched(parallel_map(synthetic_decode, iter(range(10 * items_per_point)),
                                  num_workers=w), batch_size=4)
        try:
            next(it)  # warm the pool
            n_batches = max(items_per_point // 4, 1)
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(it)
            dt = time.perf_counter() - t0
        finally:
            it.close()
        ips, ideal = n_batches * 4 / dt, w / stage_s
        curve.append({"workers": w, "img_per_s": round(ips, 2),
                      "ideal_img_per_s": round(ideal, 2), "efficiency": round(ips / ideal, 3)})
    return _emit({
        "metric": "input_pipeline_worker_scaling",
        "value": curve[-1]["img_per_s"],
        "unit": "img/s",
        "vs_baseline": None,
        "detail": {"stage_ms_per_image": stage_ms, "curve": curve, "host_cores": os.cpu_count(),
                   "note": "synthetic GIL-releasing decode through the real "
                           "parallel_map+batched harness; ideal = workers/stage_time"},
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
    """``[MODE] [STEPS] [--device D] [--workers 1,2,...] [--stage_ms MS]`` ->
    {mode, steps, device, workers, stage_ms}; a first argument that is a
    number is train's step count, as in ``python bench.py 10``."""
    argv = list(argv)
    opts = {"device": "cuda", "workers": None, "stage_ms": 100.0}
    for flag, cast in (("--device", str), ("--workers", str), ("--stage_ms", float)):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"bench: {flag} needs a value")
            opts[flag[2:]] = cast(argv[i + 1])
            del argv[i:i + 2]
    mode = argv.pop(0) if argv and argv[0] in MODES else "train"
    if len(argv) > 1 or (argv and not argv[0].isdigit()):
        raise SystemExit(f"bench: unexpected arguments {argv}; usage: "
                         "[train|predict|eval|input|e2e] [STEPS] [--device cpu]")
    steps = int(argv[0]) if argv else DEFAULT_STEPS[mode]
    workers = opts["workers"]
    if workers is not None:
        if mode != "input":
            raise SystemExit("bench: --workers belongs to the input mode")
        workers = tuple(int(x) for x in workers.split(","))
    return {"mode": mode, "steps": steps, "device": opts["device"], "workers": workers,
            "stage_ms": opts["stage_ms"]}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    mode, steps, device = args["mode"], args["steps"], args["device"]
    if mode == "input" and args["workers"]:
        return input_worker_scaling(args["workers"], stage_ms=args["stage_ms"], device=device)
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

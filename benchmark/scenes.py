"""Street scenes and the batches the benchmark's traffic mixes draw from them.

``make_scene`` is a frozen copy of ``iv2019_tpu_torch/tools/synthetic_scenes.py
::make_scene`` (the same seed gives the same scene): sky, building,
vegetation, sidewalk and road bands with cars and buses on the road and
people on the sidewalk, colours correlated with classes. From it:

- a per-pixel image: the scene in [-1, 1] and its label ids mapped to
  training class ids by the problem definition (void to the trailing id);
- a box image: the scene and its boxes rasterized into 15-class weak-label
  distributions (each pixel: its boxes' counts over their sum, one-hot void
  where none covers it; a box covers rows int(ymin H) to int(ymax H) and
  columns int(xmin W) to int(xmax W), both ends included);
- an image-label image: the scene and the uniform distribution over the
  weak classes present, on every pixel (one-hot void if none).

Scenes are painted on the host (threads, numpy); images and labels are
made from them on the device. Weak labels are dense (N, H, W, 15) float32
tensors, the form the training command line's defaults hand the train
step. Every image has its own seed, drawn from the run's seed, the batch,
the kind and the index, so a pool is the same whatever order or threads
paint it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# host threads that paint a pool's scenes
THREADS = 8

# cityscapes raw label ids (problem01 lids2cids maps them to train cids)
LID_ROAD, LID_SIDEWALK, LID_BUILDING = 7, 8, 11
LID_VEGETATION, LID_SKY, LID_PERSON = 21, 23, 24
LID_CAR, LID_BUS = 26, 28

# vistas label ids (vistas problem01 lids2cids is the identity)
VISTAS_LIDS = {
    LID_ROAD: 13, LID_SIDEWALK: 15, LID_BUILDING: 17, LID_VEGETATION: 30,
    LID_SKY: 27, LID_PERSON: 19, LID_CAR: 55, LID_BUS: 54,
}

MID_CAR = "/m/0k4j"
MID_BUS = "/m/01bjv"
MID_PERSON = "/m/01g317"


def _noise(rng, shape, scale=12):
    return rng.randint(-scale, scale + 1, shape).astype(np.int16)


def make_scene(seed: int, h: int, w: int, object_rate: float = 1.0):
    """One scene -> (image uint8 RGB, label uint8 lids, objects).

    objects: list of (mid, (xmin, xmax, ymin, ymax)) in normalized coords.
    Colors correlate with classes (that's what makes it learnable): blue
    sky, textured gray building, green vegetation, dark road, light
    sidewalk, saturated cars, red-topped persons.

    ``object_rate`` < 1 thins cars/buses/persons by keeping each drawn
    object with that probability — used to synthesize per-pixel sets in
    which the object classes are scarce, the regime the paper's weak
    supervision targets (weak sets stay at rate 1.0). At the default 1.0
    no extra RNG draws happen, so existing seeds reproduce exactly.
    """
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.int16)
    lbl = np.full((h, w), LID_BUILDING, np.uint8)

    h_sky = int(h * rng.uniform(0.2, 0.35))
    h_road = int(h * rng.uniform(0.55, 0.7))
    h_walk = h_road - max(3, h // 20)

    img[:h_sky] = np.array([135, 170, 220]) + _noise(rng, (h_sky, w, 3), 8)
    lbl[:h_sky] = LID_SKY

    base = np.array([120, 105, 100]) + rng.randint(-25, 25, 3)
    img[h_sky:h_walk] = base + _noise(rng, (h_walk - h_sky, w, 3))
    # window texture on buildings
    for _ in range(rng.randint(4, 10)):
        wy = rng.randint(h_sky, max(h_sky + 1, h_walk - 4))
        wx = rng.randint(0, w - 4)
        img[wy : wy + 3, wx : wx + 3] = np.array([40, 45, 60])

    img[h_walk:h_road] = np.array([165, 160, 160]) + _noise(rng, (h_road - h_walk, w, 3), 6)
    lbl[h_walk:h_road] = LID_SIDEWALK

    img[h_road:] = np.array([70, 70, 75]) + _noise(rng, (h - h_road, w, 3), 6)
    lbl[h_road:] = LID_ROAD

    # vegetation blobs in the building band
    for _ in range(rng.randint(0, 3)):
        vw = rng.randint(w // 16, w // 6)
        vh = rng.randint((h_walk - h_sky) // 4, max((h_walk - h_sky) // 2, 2))
        vx = rng.randint(0, w - vw)
        vy = rng.randint(h_sky, h_walk - vh)
        img[vy : vy + vh, vx : vx + vw] = np.array([60, 130, 55]) + _noise(
            rng, (vh, vw, 3), 15
        )
        lbl[vy : vy + vh, vx : vx + vw] = LID_VEGETATION

    objects = []

    def box(y0, y1, x0, x1):
        return (x0 / w, x1 / w, y0 / h, y1 / h)

    # cars / buses on the road
    for _ in range(rng.randint(1, 4)):
        if object_rate < 1.0 and rng.uniform() >= object_rate:
            continue
        is_bus = rng.uniform() < 0.25
        cw = rng.randint(w // 8, w // 4) if not is_bus else rng.randint(w // 5, w // 3)
        ch = max(4, int(cw * (0.45 if not is_bus else 0.6)))
        cx = rng.randint(0, w - cw)
        cy = rng.randint(h_road - ch // 3, h - ch)
        if is_bus:
            color = np.array([210, 180, 40]) + rng.randint(-20, 20, 3)
            lid, mid = LID_BUS, MID_BUS
        else:
            hue = rng.randint(3)
            color = np.roll(np.array([200, 40, 40]), hue) + rng.randint(-30, 30, 3)
            lid, mid = LID_CAR, MID_CAR
        img[cy : cy + ch, cx : cx + cw] = color + _noise(rng, (ch, cw, 3), 8)
        # darker lower third (wheels/shadow), same class
        img[cy + 2 * ch // 3 : cy + ch, cx : cx + cw] //= 2
        lbl[cy : cy + ch, cx : cx + cw] = lid
        objects.append((mid, box(cy, cy + ch, cx, cx + cw)))

    # persons on the sidewalk (large enough to survive the stride-8
    # feature grid at small image sizes — sub-8px objects are invisible
    # to the L1 decision gate)
    for _ in range(rng.randint(0, 3)):
        if object_rate < 1.0 and rng.uniform() >= object_rate:
            continue
        ph = rng.randint(max(12, h // 5), max(14, h // 3))
        pw = max(4, ph // 3)
        px = rng.randint(0, w - pw)
        py = rng.randint(h_walk - ph + max(1, ph // 4), h_road - ph + ph // 2)
        py = max(h_sky, py)
        img[py : py + ph // 3, px : px + pw] = np.array([225, 190, 160]) + _noise(
            rng, (ph // 3, pw, 3), 8
        )
        img[py + ph // 3 : py + ph, px : px + pw] = np.array([150, 40, 90]) + _noise(
            rng, (ph - ph // 3, pw, 3), 10
        )
        lbl[py : py + ph, px : px + pw] = LID_PERSON
        objects.append((MID_PERSON, box(py, py + ph, px, px + pw)))

    return np.clip(img, 0, 255).astype(np.uint8), lbl, objects


# the weak classes of the objects painted (OpenImages v4 MIDs; 15 classes,
# 14 = void)
WEAK_CIDS = {MID_BUS: 1, MID_CAR: 2, MID_PERSON: 6}
NUM_WEAK_CLASSES = 15
_KINDS = {"per_pixel": 0, "per_bbox": 1, "per_image": 2, "eval": 3}


def image_seed(seed: int, batch: int, kind: str, index: int) -> int:
    """The 32-bit scene seed of one image of a run's pool."""
    sequence = np.random.SeedSequence(int(seed) % (1 << 64),
                                      spawn_key=(batch, _KINDS[kind], index))
    return int(sequence.generate_state(1, dtype=np.uint32)[0])


def class_table(problem: dict) -> np.ndarray:
    """label id -> training class id of a problem definition, void (-1) to
    the trailing id."""
    lids2cids = np.asarray(problem["lids2cids"], np.int64)
    return np.where(lids2cids == -1, lids2cids.max() + 1, lids2cids).astype(np.int32)


def _label_ids(lbl: np.ndarray, dataset: str) -> np.ndarray:
    if dataset == "cityscapes":
        return lbl
    out = np.zeros_like(lbl)
    for src, dst in VISTAS_LIDS.items():
        out[lbl == src] = dst
    return out


def box_edges(objects, h: int, w: int):
    """[(weak class, y0, y1, x0, x1)] of one image's boxes, both ends
    included and clamped at 0."""
    out = []
    for mid, (xmin, xmax, ymin, ymax) in objects:
        x0, x1 = int(np.float32(xmin) * w), int(np.float32(xmax) * w)
        y0, y1 = int(np.float32(ymin) * h), int(np.float32(ymax) * h)
        out.append((WEAK_CIDS[mid], max(y0, 0), max(y1, -1), max(x0, 0), max(x1, -1)))
    return out


def image_labels(objects) -> np.ndarray:
    """(15,) float32 uniform over the weak classes present, else void."""
    vec = np.zeros(NUM_WEAK_CLASSES, np.float32)
    present = sorted({WEAK_CIDS[mid] for mid, _ in objects})
    if present:
        vec[present] = 1.0 / len(present)
    else:
        vec[-1] = 1.0
    return vec


def _paint(job):
    seed, batch, kind, index, h, w, dataset, table = job
    img, lbl, objects = make_scene(image_seed(seed, batch, kind, index), h, w)
    return img, (table[_label_ids(lbl, dataset)] if table is not None else None), objects


def _paint_all(jobs):
    with ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(_paint, jobs))


def _images(parts, device) -> torch.Tensor:
    x = torch.as_tensor(np.stack([p[0] for p in parts])).to(device)
    return (x.float() * (1.0 / 255.0)) * 2.0 - 1.0


def _boxes(parts, h: int, w: int, device) -> torch.Tensor:
    counts = torch.zeros((len(parts), h, w, NUM_WEAK_CLASSES), dtype=torch.float32,
                         device=device)
    for i, part in enumerate(parts):
        for cid, y0, y1, x0, x1 in box_edges(part[2], h, w):
            counts[i, y0:y1 + 1, x0:x1 + 1, cid] += 1.0
    total = counts.sum(dim=3, keepdim=True)
    covered = total > 0.5
    counts /= torch.where(covered, total, torch.ones_like(total))
    counts[..., -1:] += (~covered).float()
    return counts


def _image_labels(parts, h: int, w: int, device) -> torch.Tensor:
    vecs = torch.as_tensor(np.stack([image_labels(p[2]) for p in parts]), device=device)
    return vecs[:, None, None, :].expand(len(parts), h, w, NUM_WEAK_CLASSES).contiguous()


def train_pool(mix: dict, problem: dict, dataset: str, seed: int, device) -> list:
    """``mix['pool']`` batches of [per-pixel | box | image-label] images at
    (height, width) on ``device``, as dicts keyed as the train step takes
    them."""
    h, w = mix["height"], mix["width"]
    table = class_table(problem)
    jobs = [(seed, b, kind, i, h, w, dataset, table if kind == "per_pixel" else None)
            for b in range(mix["pool"]) for kind in ("per_pixel", "per_bbox", "per_image")
            for i in range(mix[kind])]
    painted = iter(_paint_all(jobs))
    pool = []
    for _ in range(mix["pool"]):
        parts = {kind: [next(painted) for _ in range(mix[kind])]
                 for kind in ("per_pixel", "per_bbox", "per_image")}
        batch = {f"proimages_{kind}": _images(p, device) for kind, p in parts.items()}
        batch["prolabels_per_pixel"] = torch.as_tensor(
            np.stack([p[1] for p in parts["per_pixel"]])).to(device)
        batch["prolabels_per_bbox"] = _boxes(parts["per_bbox"], h, w, device)
        batch["prolabels_per_image"] = _image_labels(parts["per_image"], h, w, device)
        pool.append(batch)
    return pool


def eval_pool(mix: dict, problem: dict, dataset: str, seed: int, device) -> list:
    """``mix['pool']`` (images (N, H, W, 3), labels (N, LH, LW) training
    class ids) batches on ``device``; the labels at (label_height,
    label_width), the scene's label resized by nearest neighbour."""
    h, w = mix["height"], mix["width"]
    lh, lw = mix["label_height"], mix["label_width"]
    rows, cols = np.arange(lh) * h // lh, np.arange(lw) * w // lw
    table = class_table(problem)
    jobs = [(seed, b, "eval", i, h, w, dataset, table)
            for b in range(mix["pool"]) for i in range(mix["images"])]
    painted = iter(_paint_all(jobs))
    pool = []
    for _ in range(mix["pool"]):
        parts = [next(painted) for _ in range(mix["images"])]
        labels = np.stack([p[1][rows][:, cols] for p in parts])
        pool.append((_images(parts, device), torch.as_tensor(labels).to(device)))
    return pool

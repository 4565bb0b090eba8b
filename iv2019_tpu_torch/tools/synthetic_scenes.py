"""Procedural street-scene dataset in the real input formats.

The port's copy of tools/synthetic_scenes.py, writing its TFRecords through
the port's tools/make_tfrecords.py; the same seeds give the same scenes,
files and pickles. Real Cityscapes/OpenImages are not in the repository, so
this builds the closest checkable stand-in: procedurally generated
street scenes with *learnable* image->label structure (sky / building /
vegetation / road / sidewalk bands, colored car/bus boxes on the road,
person boxes on the sidewalk), written in the exact formats the real
pipelines consume:

- per-pixel: Cityscapes-layout PNGs (raw labelIds) -> KEYS2FEATURES_v5
  TFRecords via iv2019_tpu_torch.tools.make_tfrecords (same path real data takes)
- weak bboxes: {imageid: [(mid, (xmin, xmax, ymin, ymax))]} pickle +
  JPEG dir (input_subset_bboxes_v2 contract, normalized coords)
- weak image labels: {imageid: [mids]} pickle (input_subset_image_labels)

Train/val use disjoint seeds, so held-out mIoU from the real
train_cli -> evaluate_cli journey measures *generalization* of the full
system (TFRecord ingestion, mixed supervision, hierarchical losses,
checkpointing, EMA eval) — not just optimization.

Usage:
  python -m iv2019_tpu_torch.tools.synthetic_scenes OUT_DIR [--n_train 256]
      [--n_val 48] [--n_weak 256] [--height 128] [--width 256]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from PIL import Image

from iv2019_tpu_torch.tools.make_tfrecords import cityscapes_pairs, vistas_pairs, write_pairs

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


def generate(
    out_dir: str,
    n_train: int = 256,
    n_val: int = 48,
    n_weak: int = 256,
    h: int = 128,
    w: int = 256,
    fmt: str = "cityscapes",
    object_rate_train: float = 1.0,
) -> dict:
    """Write the full dataset; returns the paths dict for the CLIs.

    ``fmt='vistas'`` writes the Vistas on-disk layout instead: JPEG images
    + vistas-label-id PNGs under {split}/{images,labels}/, with per-image
    size jitter (Vistas images vary in size; the pipeline must resize
    before batching — reference input_vistas.py:196-198).
    """
    paths = {}
    # --- per-pixel: dataset layout -> v5 TFRecords ---
    for split, n, seed0 in (("train", n_train, 0), ("val", n_val, 10_000_000)):
        if fmt == "cityscapes":
            im_dir = os.path.join(out_dir, "cityscapes", "leftImg8bit", split, "synth")
            la_dir = os.path.join(out_dir, "cityscapes", "gtFine", split, "synth")
        else:
            im_dir = os.path.join(out_dir, "vistas", split, "images")
            la_dir = os.path.join(out_dir, "vistas", split, "labels")
        os.makedirs(im_dir, exist_ok=True)
        os.makedirs(la_dir, exist_ok=True)
        rate = object_rate_train if split == "train" else 1.0
        for i in range(n):
            if fmt == "cityscapes":
                img, lbl, _ = make_scene(seed0 + i, h, w, object_rate=rate)
                Image.fromarray(img).save(
                    os.path.join(im_dir, f"s{i:05d}_leftImg8bit.png")
                )
                Image.fromarray(lbl).save(
                    os.path.join(la_dir, f"s{i:05d}_gtFine_labelIds.png")
                )
            else:
                # vistas: size jitter + jpeg images + vistas label ids
                jrng = np.random.RandomState(seed0 + i + 1)
                jh = h + 8 * jrng.randint(-2, 5)
                jw = w + 8 * jrng.randint(-2, 5)
                img, lbl, _ = make_scene(seed0 + i, jh, jw)
                vlbl = np.zeros_like(lbl)
                for src, dst in VISTAS_LIDS.items():
                    vlbl[lbl == src] = dst
                Image.fromarray(img).save(
                    os.path.join(im_dir, f"s{i:05d}.jpg"), quality=92
                )
                Image.fromarray(vlbl).save(os.path.join(la_dir, f"s{i:05d}.png"))
        tfr = os.path.join(out_dir, f"{split}.tfrecords")
        pairs = (
            cityscapes_pairs(os.path.join(out_dir, "cityscapes"), split)
            if fmt == "cityscapes"
            else vistas_pairs(os.path.join(out_dir, "vistas"), split)
        )
        count = write_pairs(pairs, tfr)
        assert count == n, (count, n)
        paths[f"tfrecords_{split}"] = tfr
    # --- weak sets: jpgs + bbox/image-label pickles ---
    weak_dir = os.path.join(out_dir, "weak")
    os.makedirs(weak_dir, exist_ok=True)
    imageid2bboxes, imageid2mids = {}, {}
    for i in range(n_weak):
        img, _, objects = make_scene(20_000_000 + i, h, w)
        imageid = f"w{i:05d}"
        Image.fromarray(img).save(os.path.join(weak_dir, imageid + ".jpg"))
        if objects:
            imageid2bboxes[imageid] = objects
            imageid2mids[imageid] = sorted({mid for mid, _ in objects})
    paths["openimages_image_dir"] = weak_dir
    paths["openimages_bboxes_path"] = os.path.join(out_dir, "bboxes.pkl")
    paths["openimages_image_labels_path"] = os.path.join(out_dir, "image_labels.pkl")
    with open(paths["openimages_bboxes_path"], "wb") as f:
        pickle.dump(imageid2bboxes, f)
    with open(paths["openimages_image_labels_path"], "wb") as f:
        pickle.dump(imageid2mids, f)
    return paths


def main():
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--n_train", type=int, default=256)
    p.add_argument("--n_val", type=int, default=48)
    p.add_argument("--n_weak", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--format", default="cityscapes", choices=["cityscapes", "vistas"])
    p.add_argument("--object_rate_train", type=float, default=1.0,
                   help="keep-probability for cars/buses/persons in the "
                        "per-pixel TRAIN scenes only (weak/val stay 1.0); "
                        "<1 synthesizes the object-scarce regime weak "
                        "supervision targets")
    args = p.parse_args()
    paths = generate(
        args.out_dir, args.n_train, args.n_val, args.n_weak,
        args.height, args.width, fmt=args.format,
        object_rate_train=args.object_rate_train,
    )
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

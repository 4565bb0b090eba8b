"""Create KEYS2FEATURES_v5 TFRecords from a Cityscapes/Vistas directory.

A copy of iv2019_tpu/tools/make_tfrecords.py over the port's writer
(input/tfrecord_writer.py). The reference trains only from TFRecords with
the v5 schema (input_cityscapes.py:25-36) but ships no creation tool. This
one is dependency-free (the port's TFRecord writer + PNG/JPEG bytes
passthrough) and the output is readable by TensorFlow too (correct CRC32C
framing).

Usage:
  # Cityscapes layout: leftImg8bit/{split}/{city}/*_leftImg8bit.png
  #                    gtFine/{split}/{city}/*_gtFine_labelIds.png
  python -m iv2019_tpu_torch.tools.make_tfrecords cityscapes DATASET_DIR SPLIT OUT.tfrecords

  # Vistas layout: {split}/images/*.jpg, {split}/labels/*.png
  python -m iv2019_tpu_torch.tools.make_tfrecords vistas DATASET_DIR SPLIT OUT.tfrecords
"""

from __future__ import annotations

import glob
import os
import sys

from PIL import Image

from iv2019_tpu_torch.input.tfrecord_writer import TFRecordWriter, encode_example

__all__ = ["write_pairs", "cityscapes_pairs", "vistas_pairs", "main"]


def cityscapes_pairs(root: str, split: str):
    images = sorted(
        glob.glob(os.path.join(root, "leftImg8bit", split, "*", "*_leftImg8bit.png"))
    )
    for im_path in images:
        # canonical mapping: X_leftImg8bit.png -> X_gtFine_labelIds.png
        la_path = im_path.replace(
            os.path.join(root, "leftImg8bit"), os.path.join(root, "gtFine")
        ).replace("_leftImg8bit.png", "_gtFine_labelIds.png")
        if os.path.exists(la_path):
            yield im_path, la_path


def vistas_pairs(root: str, split: str):
    images = sorted(glob.glob(os.path.join(root, split, "images", "*")))
    for im_path in images:
        stem = os.path.splitext(os.path.basename(im_path))[0]
        la_path = os.path.join(root, split, "labels", stem + ".png")
        if os.path.exists(la_path):
            yield im_path, la_path


def write_pairs(pairs, out_path: str) -> int:
    count = 0
    with TFRecordWriter(out_path) as w:
        for im_path, la_path in pairs:
            with open(im_path, "rb") as f:
                im_bytes = f.read()
            with open(la_path, "rb") as f:
                la_bytes = f.read()
            with Image.open(im_path) as im:
                iw, ih = im.size
                im_format = (im.format or "png").lower()
            with Image.open(la_path) as la:
                lw, lh = la.size
            record = encode_example({
                "image/encoded": im_bytes,
                "image/format": im_format,
                "image/dtype": "uint8",
                "image/shape": [ih, iw, 3],
                "image/path": im_path,
                "label/encoded": la_bytes,
                "label/format": "png",
                "label/dtype": "uint8",
                "label/shape": [lh, lw, 1],
                "label/path": la_path,
            })
            w.write(record)
            count += 1
    return count


def main(argv):
    if len(argv) != 4:
        print(__doc__)
        return 1
    dataset, root, split, out_path = argv
    pairs = (
        cityscapes_pairs(root, split)
        if dataset == "cityscapes"
        else vistas_pairs(root, split)
    )
    n = write_pairs(pairs, out_path)
    print(f"wrote {n} examples -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Host-side input-pipeline core: shuffle/repeat, parallel map, batching and
the preprocessing transforms shared by the dataset pipelines.

Port of iv2019_tpu/input/core.py in numpy, with a thread pool in place of
the reference's tf.data threading. The JAX package routes decode, resize and
the label lookup through its native C++ helpers (``iv2019_tpu/native``,
not ported: ROADMAP.md queue A); their numpy counterparts here compute the
same values, each rounding as the native code does (``x * (1/255)`` in f32,
TF1 bilinear and nearest tables in f32, the lookup clamped to the table).

- ``convert_image_dtype``: uint8 -> f32 in [0, 1)
- ``map_lids_to_cids``: lids2cids gather with voids replaced
- ``resize_images_and_labels``: plain resize, or aspect-preserving 'max'
  mode (ceil) + a shared random crop (reference input_pipelines/utils.py:181-247)
- ``from_0_1_to_m1_1``: [0, 1) -> [-1, 1)
"""

from __future__ import annotations

import itertools
import math
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from iv2019_tpu_torch.ops.resize import _resize_nearest_axes, resize_bilinear

__all__ = [
    "NUM_PARALLEL_CALLS",
    "SHUFFLE_BUFFER",
    "aspect_preserving_size",
    "batched",
    "convert_image_dtype",
    "from_0_1_to_m1_1",
    "map_lids_to_cids",
    "parallel_map",
    "per_item_rng_factory",
    "resize_images_and_labels",
    "shuffle_repeat",
]

SHUFFLE_BUFFER = 2000  # reference input_cityscapes.py:21
# reference input_cityscapes.py:22; IV_INPUT_WORKERS overrides it
NUM_PARALLEL_CALLS = int(os.environ.get("IV_INPUT_WORKERS", "15"))

_INV_255 = np.float32(1.0) / np.float32(255.0)


def shuffle_repeat(items_factory: Callable[[], Iterable], buffer_size: int = SHUFFLE_BUFFER,
                   seed: Optional[int] = None, repeat: bool = True) -> Iterator:
    """Streaming shuffle buffer + infinite repeat (tf.data shuffle_and_repeat)."""
    rng = random.Random(seed)
    while True:
        buf: list = []
        for item in items_factory():
            if len(buf) < buffer_size:
                buf.append(item)
                continue
            idx = rng.randrange(len(buf))
            buf[idx], item = item, buf[idx]
            yield item
        rng.shuffle(buf)
        yield from buf
        if not repeat:
            return


def per_item_rng_factory(seed: Optional[int]) -> Callable[[int], np.random.RandomState]:
    """A RandomState per item index, derived from ``(seed, index)``: the
    same crops for the same seed whatever the worker count or scheduling.
    ``seed=None`` draws the base entropy from the OS once."""
    base = np.random.SeedSequence(seed)

    def make(index: int) -> np.random.RandomState:
        child = np.random.SeedSequence(entropy=base.entropy, spawn_key=(index,))
        return np.random.RandomState(np.random.MT19937(child))

    return make


def parallel_map(fn: Callable, it: Iterator, num_workers: int = NUM_PARALLEL_CALLS,
                 depth: int = 32) -> Iterator:
    """Ordered parallel map over an iterator with bounded read-ahead."""
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = []
        try:
            for item in itertools.islice(it, depth):
                futures.append(pool.submit(fn, item))
            for item in it:
                out = futures.pop(0).result()
                futures.append(pool.submit(fn, item))
                yield out
            for f in futures:
                yield f.result()
        finally:
            for f in futures:
                f.cancel()


def batched(it: Iterator[dict], batch_size: int) -> Iterator[dict]:
    """Stack dicts of numpy arrays along a new leading axis; other values
    become lists."""
    while True:
        items = list(itertools.islice(it, batch_size))
        if len(items) < batch_size:
            return
        out = {}
        for k, v0 in items[0].items():
            if isinstance(v0, np.ndarray):
                out[k] = np.stack([d[k] for d in items])
            else:
                out[k] = [d[k] for d in items]
        yield out


def convert_image_dtype(image: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1) as ``x * (1/255)`` in f32."""
    if image.dtype == np.uint8:
        return image.astype(np.float32) * _INV_255
    return image.astype(np.float32)


def from_0_1_to_m1_1(images: np.ndarray) -> np.ndarray:
    return (images - 0.5) / 0.5


def map_lids_to_cids(label: np.ndarray, lids2cids_voids_replaced: np.ndarray) -> np.ndarray:
    """int32 class ids of a label-id image; ids past the table take its last entry."""
    table = np.asarray(lids2cids_voids_replaced, np.int32)
    return table[np.minimum(label.astype(np.int64), len(table) - 1)]


def aspect_preserving_size(in_hw: Sequence[int], target_hw: Sequence[int],
                           mode: str = "max") -> tuple[int, int]:
    """Tight cover ('max') or fit ('min') size with ceil (reference utils/utils.py:569-589)."""
    fh, fw = in_hw
    th, tw = target_hw
    sh, sw = th / fh, tw / fw
    scale = max(sh, sw) if mode == "max" else min(sh, sw)
    return (int(math.ceil(scale * fh)), int(math.ceil(scale * fw)))


def resize_images_and_labels(image: np.ndarray, label: Optional[np.ndarray], target_hw,
                             preserve_aspect_ratio: bool = False,
                             rng: Optional[np.random.RandomState] = None):
    """Resize one (H, W, C) image and an optional label to ``target_hw``.

    Labels may be (H, W) int (sparse) or (H, W, C) float (multinomial);
    both take the nearest resize. With ``preserve_aspect_ratio`` the pair
    is resized 'max'-tight, then cropped at one random offset.
    """
    th, tw = int(target_hw[0]), int(target_hw[1])
    if preserve_aspect_ratio:
        rh, rw = aspect_preserving_size(image.shape[:2], (th, tw), "max")
    else:
        rh, rw = th, tw
    image = resize_bilinear(image, (rh, rw))
    if label is not None:
        label = _resize_nearest_axes(label, (rh, rw), False, 0)
    if preserve_aspect_ratio and (rh, rw) != (th, tw):
        rng = rng or np.random
        oy = rng.randint(0, rh - th + 1)
        ox = rng.randint(0, rw - tw + 1)
        image = image[oy:oy + th, ox:ox + tw]
        if label is not None:
            label = label[oy:oy + th, ox:ox + tw]
    return image, label

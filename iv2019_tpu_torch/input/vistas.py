"""Mapillary Vistas per-pixel input (port of iv2019_tpu/input/vistas.py).

The reference keeps a separate module (input_vistas.py) whose only
differences from Cityscapes are data-level: JPEG-encoded images and
variable image sizes, which the shared pipeline of cityscapes.py handles
(PIL detects the format; every element is resized before batching). This
module re-exports it under the reference's per-dataset entry-point names.
"""

from iv2019_tpu_torch.input.cityscapes import (  # noqa: F401
    evaluate_input,
    synthetic_train_batches,
    train_input,
)

__all__ = ["evaluate_input", "synthetic_train_batches", "train_input"]

"""Learning-rate schedules of the train step, on the device.

Port of iv2019_tpu/train/optimizer.py::make_learning_rate_fn (reference
define_optimizer.py:3-26):

- piecewise constant over *step* boundaries (``Settings.finalize`` converts
  the epoch boundaries): value i applies while boundaries[i-1] < step <=
  boundaries[i], i.e. ``idx = sum(step > boundaries)``;
- polynomial decay: (lr0 - end) * (1 - step / N)^power + end, step clamped.

``lr_fn(step)`` takes the step as a 0-d integer tensor and returns a 0-d f32
tensor on the same device, without waiting on the host. The optax path of
the JAX package (``make_optimizer``) is not ported: the port trains with
the fused update only (train/fused_update.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from iv2019_tpu_torch.config import Settings

__all__ = ["make_learning_rate_fn"]


def make_learning_rate_fn(settings: Settings) -> Callable[[torch.Tensor], torch.Tensor]:
    if settings.learning_rate_schedule == "piecewise_constant":
        tables: dict = {}

        def lr_fn(step: torch.Tensor) -> torch.Tensor:
            if step.device not in tables:
                tables[step.device] = (
                    torch.tensor(settings.learning_rate_boundaries_steps, dtype=torch.int64,
                                 device=step.device),
                    torch.tensor(settings.learning_rate_values_resolved, dtype=torch.float32,
                                 device=step.device))
            boundaries, values = tables[step.device]
            # step == boundary keeps the left value
            idx = torch.sum(step > boundaries).reshape(1)
            return values.index_select(0, idx).reshape(())

        return lr_fn

    if settings.learning_rate_schedule == "polynomial_decay":
        lr0, end = settings.learning_rate_initial, settings.learning_rate_final
        power, n = settings.learning_rate_power, max(settings.num_training_steps, 1)

        def lr_fn(step: torch.Tensor) -> torch.Tensor:
            frac = torch.clamp(step.float() / n, 0.0, 1.0)
            return (lr0 - end) * (1.0 - frac) ** power + end

        return lr_fn

    raise ValueError(f"unknown learning_rate_schedule {settings.learning_rate_schedule}")

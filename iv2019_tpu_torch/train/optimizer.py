"""Learning-rate schedules of the train step, on the device.

Port of iv2019_tpu/train/optimizer.py::make_learning_rate_fn (reference
define_optimizer.py:3-26):

- piecewise constant over *step* boundaries (``Settings.finalize`` converts
  the epoch boundaries): value i applies while boundaries[i-1] < step <=
  boundaries[i], i.e. ``idx = sum(step > boundaries)``;
- polynomial decay: (lr0 - end) * (1 - step / N)^power + end, step clamped.

``lr_fn(step)`` takes the step as a 0-d integer tensor and returns a 0-d f32
tensor on the same device, without waiting on the host.

``make_optimizer`` is the optax path's SGD (``fused_optimizer=False``):
optax ``sgd`` with ``momentum`` and ``nesterov`` for SGDM, plain for SGD.
``torch.optim.SGD`` with dampening 0 keeps optax's trace (the first step's
buffer is the gradient; Nesterov steps along g + momentum * buffer); the
train step sets its learning rate before each update from the schedule at
the pre-update step, which is optax's schedule count. The L2
regularization enters through the loss, not as decoupled weight decay.
"""

from __future__ import annotations

from typing import Callable

import torch

from iv2019_tpu_torch.config import Settings

__all__ = ["make_learning_rate_fn", "make_optimizer"]


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


def make_optimizer(settings: Settings, model: torch.nn.Module
                   ) -> tuple[torch.optim.SGD, Callable[[torch.Tensor], torch.Tensor]]:
    """(SGD over the model's parameters, lr_fn) of the optax path
    (iv2019_tpu/train/optimizer.py:50-62)."""
    lr_fn = make_learning_rate_fn(settings)
    if settings.optimizer == "SGDM":
        tx = torch.optim.SGD(model.parameters(), lr=0.0, momentum=settings.momentum,
                             dampening=0.0, nesterov=settings.use_nesterov)
    elif settings.optimizer == "SGD":
        tx = torch.optim.SGD(model.parameters(), lr=0.0)
    else:
        raise ValueError(f"unknown optimizer {settings.optimizer}")
    return tx, lr_fn

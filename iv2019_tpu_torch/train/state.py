"""Train state of the port: step, model (parameters and BatchNorm statistics)
and the fused optimizer's state.

Port of iv2019_tpu/train/state.py::TrainState and create_fused_train_state.
The EMA shadow of the parameters lives in the fused optimizer state
(TF ``ExponentialMovingAverage(decay, num_updates=global_step,
zero_debias=True)``; BatchNorm moving statistics have none). The optax
state and ``EmaState`` of the JAX package's non-fused path are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from iv2019_tpu_torch.train.fused_update import FusedOptState, FusedSGDM

__all__ = ["TrainState", "create_fused_train_state"]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # 0-d int64 on the model's device
    model: torch.nn.Module
    opt_state: FusedOptState

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def create_fused_train_state(fused_opt: FusedSGDM) -> TrainState:
    """TrainState at step 0 for the fused optimizer's model."""
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=fused_opt.params.device),
                      model=fused_opt.model, opt_state=fused_opt.init())

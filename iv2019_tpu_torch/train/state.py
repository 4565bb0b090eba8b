"""Train state of the port: step, model (parameters and BatchNorm
statistics), the optimizer's state and, on the optax path, the EMA.

Port of iv2019_tpu/train/state.py. The EMA reproduces TF's
``ExponentialMovingAverage(decay, num_updates=global_step,
zero_debias=True)`` over the parameters (BatchNorm moving statistics have
none):

- effective decay_t = min(decay, (1 + t) / (10 + t)), t the pre-increment step
- biased shadow:  s <- s - (1 - decay_t) * (s - v),  s_0 = 0
- zero-debias:    v_ema = s / (1 - prod_t decay_t)

With the fused optimizer (``create_fused_train_state``) the shadow lives in
its flat state (train/fused_update.py) and ``ema`` is None. On the optax
path (``create_train_state``) ``opt_state`` is the ``torch.optim.SGD`` of
train/optimizer.py (its momentum buffers are optax's trace; the schedule
count is ``step``) and ``ema`` an ``EmaState`` keyed by parameter name,
None when ``ema_decay`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from iv2019_tpu_torch.train.fused_update import FusedSGDM

__all__ = ["EmaState", "TrainState", "create_fused_train_state", "create_train_state",
           "ema_decay_at", "momentum_buffers", "set_momentum_buffers"]


def ema_decay_at(step: int, base_decay: float) -> float:
    """decay_t = min(decay, (1 + t) / (10 + t)), rounded as JAX's f32 does."""
    t = np.float32(step)
    return float(np.minimum(np.float32(base_decay), (np.float32(1) + t) / (np.float32(10) + t)))


@dataclasses.dataclass
class EmaState:
    biased: dict  # {parameter name: f32 tensor}, zero-initialized
    decay_product: torch.Tensor  # 0-d f32, prod_t decay_t

    @classmethod
    def create(cls, model: torch.nn.Module) -> "EmaState":
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        return cls(biased={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                   decay_product=torch.ones((), dtype=torch.float32, device=device))

    @torch.no_grad()
    def update(self, model: torch.nn.Module, step: int, base_decay: float) -> None:
        """One update in place from the model's (updated) parameters with the
        pre-increment ``step``, as TF applies the EMA op."""
        decay = ema_decay_at(step, base_decay)
        names = list(self.biased)
        params = dict(model.named_parameters())
        shadows = [self.biased[k] for k in names]
        diff = torch._foreach_sub(shadows, [params[k].float() for k in names])
        # (1 - decay) rounded to f32 first, as JAX computes it
        torch._foreach_mul_(diff, float(np.float32(1.0) - np.float32(decay)))
        torch._foreach_sub_(shadows, diff)
        self.decay_product.mul_(decay)

    def debiased(self, fallback: Optional[dict] = None) -> dict:
        """Zero-debiased EMA parameters {name: tensor}; with ``fallback``
        ({name: tensor}) those while the denominator is 0 (before the
        first update)."""
        denom = 1.0 - self.decay_product
        out = {k: s / denom.clamp_min(1e-12) for k, s in self.biased.items()}
        if fallback is not None:
            out = {k: torch.where(denom > 0, v, fallback[k].float()) for k, v in out.items()}
        return out


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # 0-d int64 on the model's device
    model: torch.nn.Module
    opt_state: Any  # FusedOptState, or the optax path's torch.optim.SGD
    ema: Optional[EmaState] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def create_fused_train_state(fused_opt: FusedSGDM) -> TrainState:
    """TrainState at step 0 for the fused optimizer's model."""
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=fused_opt.params.device),
                      model=fused_opt.model, opt_state=fused_opt.init())


def create_train_state(model: torch.nn.Module, tx: torch.optim.SGD, ema_decay: float
                       ) -> TrainState:
    """TrainState at step 0 of the optax path (``tx`` from
    train/optimizer.py::make_optimizer over ``model``)."""
    device = next(model.parameters()).device
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=device), model=model,
                      opt_state=tx, ema=EmaState.create(model) if ema_decay > 0 else None)


def momentum_buffers(state: TrainState) -> Optional[dict]:
    """{parameter name: momentum trace} of the optax path's SGD (zeros
    before the first step), None for plain SGD."""
    tx = state.opt_state
    if not tx.param_groups[0]["momentum"]:
        return None
    out = {}
    for name, p in state.model.named_parameters():
        buf = tx.state.get(p, {}).get("momentum_buffer")
        out[name] = buf if buf is not None else torch.zeros_like(p)
    return out


@torch.no_grad()
def set_momentum_buffers(state: TrainState, values: dict) -> None:
    """Set the SGD's momentum traces from {parameter name: tensor}."""
    for name, p in state.model.named_parameters():
        state.opt_state.state[p]["momentum_buffer"] = values[name].to(
            p.device, torch.float32).clone()

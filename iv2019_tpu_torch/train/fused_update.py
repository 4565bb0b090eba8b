"""Flat-vector SGD(M) + weight decay + EMA: the port's optimizer.

Port of iv2019_tpu/train/fused_update.py::FusedSGDM. All parameters live in
one flat f32 vector, and each step is one pass over it (kernel B3,
ops/fused_update.py)::

    g' = g + wd * mask * w        (the L2 regularization's gradient)
    m  = g' + mu * m              (momentum; Nesterov optional)
    w  = w - lr * m
    s  = s - (1 - d_t) * (s - w)  (EMA shadow, d_t = min(decay, (1+t)/(10+t)))

with ``reg = 0.5 * wd * sum(mask * w^2)`` over the pre-update weights. The
0/1 mask is 1 on conv kernels only (the port's ``<module>.conv.weight``,
flax ``kernel``): slim regularizes ``weights``, not BatchNorm's scale and
bias.

Layout, and what differs from the JAX package: JAX is functional, so its
FusedSGDM ravels the parameter and gradient trees into new flat vectors on
every step. Here the model's parameters *are* views into one flat buffer,
and their ``.grad`` views into a second one, so backward accumulates the
gradients straight into the flat vector and the kernel updates the
parameters, momentum and EMA in place: no step concatenates or splits the
26M floats. Each view keeps its parameter's strides (channels_last conv
kernels), so the flat order is the parameters' memory order, and starts at
a multiple of ``ALIGN`` elements (512 bytes, the CUDA caching allocator's
alignment), because PyTorch's vectorized and cuDNN kernels assume aligned
operands; the gaps are zero in every vector and in the decay mask, so they
stay zero and add nothing to ``reg``. ``layout`` records (name, shape,
stride, offset) of each parameter, which utils/convert.py uses to move
optimizer state to and from the JAX package's raveled, tile-padded vectors.
Do not move the model (``.to``) or set its gradients to None after building
the optimizer: either would break the views.
"""

from __future__ import annotations

import dataclasses

import torch

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.ops.fused_update import fused_update, fused_update_plain
from iv2019_tpu_torch.train.optimizer import make_learning_rate_fn

__all__ = ["ALIGN", "FusedOptState", "FusedSGDM", "is_decayed"]

ALIGN = 128  # f32 elements: each parameter's view starts at a 512-byte boundary


def is_decayed(name: str) -> bool:
    """Whether weight decay applies to a parameter: kernels only (``.weight``:
    convs and conv transposes; no bias, no norm ``scale``/``bias``)."""
    return name.endswith(".weight")


@dataclasses.dataclass
class FusedOptState:
    momentum: torch.Tensor  # flat f32
    ema_biased: torch.Tensor  # flat f32 (zeros when the EMA is off)
    ema_decay_product: torch.Tensor  # 0-d f32


class FusedSGDM:
    """Flat-vector SGD(M) + weight decay + TF-semantics EMA over ``model``.

    With ``settings.pallas_update`` (the default) CUDA vectors go to kernel
    B3; otherwise, and always for CPU vectors, the plain version runs.
    """

    def __init__(self, settings: Settings, model: torch.nn.Module):
        self.lr_fn = make_learning_rate_fn(settings)
        self.momentum = settings.momentum if settings.optimizer == "SGDM" else 0.0
        self.nesterov = settings.use_nesterov
        self.weight_decay = settings.regularization_weight
        self.ema_decay = settings.ema_decay
        self.use_kernel = settings.pallas_update
        self.model = model
        named = list(model.named_parameters())
        device = named[0][1].device
        self.num_params = sum(p.numel() for _, p in named)
        num_flat = sum(-(-p.numel() // ALIGN) * ALIGN for _, p in named)
        self.params = torch.zeros(num_flat, dtype=torch.float32, device=device)
        self.grads = torch.zeros(num_flat, dtype=torch.float32, device=device)
        self.wd_mask = torch.zeros(num_flat, dtype=torch.float32, device=device)
        self.layout = []
        offset = 0
        with torch.no_grad():
            for name, p in named:
                if p.dtype != torch.float32:
                    raise ValueError(f"{name}: parameters must be float32, got {p.dtype}")
                shape, stride = tuple(p.shape), tuple(p.stride())
                view = torch.as_strided(self.params, shape, stride, offset)
                view.copy_(p)
                p.data = view
                p.grad = torch.as_strided(self.grads, shape, stride, offset)
                if is_decayed(name):
                    self.wd_mask[offset:offset + p.numel()] = 1.0
                self.layout.append((name, shape, stride, offset))
                offset += -(-p.numel() // ALIGN) * ALIGN

    def init(self) -> FusedOptState:
        z = torch.zeros_like(self.params)
        return FusedOptState(momentum=z, ema_biased=torch.zeros_like(z),
                             ema_decay_product=torch.ones((), dtype=torch.float32,
                                                          device=z.device))

    def zero_grad(self) -> None:
        self.grads.zero_()

    def update(self, opt_state: FusedOptState, step: torch.Tensor):
        """One update in place from the accumulated gradients; ``step`` is the
        pre-increment step (0-d tensor). Returns (opt_state, reg)."""
        lr = self.lr_fn(step)
        t = step.float()
        d = torch.clamp_max((1.0 + t) / (10.0 + t), self.ema_decay)
        update = fused_update if self.use_kernel else fused_update_plain
        ema_on = self.ema_decay > 0
        s_out = opt_state.ema_biased if ema_on else torch.empty_like(opt_state.ema_biased)
        _, _, _, reg_raw = update(
            self.params, self.grads, opt_state.momentum, opt_state.ema_biased, self.wd_mask,
            lr, d, momentum=self.momentum, weight_decay=self.weight_decay,
            nesterov=self.nesterov, out=(self.params, opt_state.momentum, s_out))
        prod = opt_state.ema_decay_product * d if ema_on else opt_state.ema_decay_product
        new_state = FusedOptState(momentum=opt_state.momentum, ema_biased=opt_state.ema_biased,
                                  ema_decay_product=prod)
        return new_state, 0.5 * self.weight_decay * reg_raw

    def ema_params(self, opt_state: FusedOptState) -> dict:
        """Zero-debiased EMA parameters, {name: tensor} (for --restore_emas);
        the raw parameters before the first update."""
        denom = 1.0 - opt_state.ema_decay_product
        flat = torch.where(denom > 0, opt_state.ema_biased / denom.clamp_min(1e-12), self.params)
        return {name: torch.as_strided(flat, shape, stride, offset).clone()
                for name, shape, stride, offset in self.layout}

"""Layer primitives of the trunk, in PyTorch.

Port of iv2019_tpu/models/layers.py. Tensors inside the network are NCHW
in ``torch.channels_last`` memory, so a ``permute(0, 2, 3, 1)`` hands the
fused-block kernels NHWC without a copy.

Modules are registered under the flax module names of the JAX package, so
a state-dict key is the flax path joined with dots, with ``conv/kernel``
as ``conv.weight`` (OIHW) and ``norm/BatchNorm/<leaf>`` as ``norm.<leaf>``
(utils/convert.py).

- ``conv2d_same`` padding: symmetric ``keff - 1`` split low/high.
- Norm: flax BatchNorm in f32, epsilon 1e-5, cast back to the compute
  dtype. In eval mode (``module.eval()``) on the running statistics,
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias``; in train mode on the
  batch's statistics over (N, H, W), with the running statistics moved by
  ``decay * ra + (1 - decay) * batch`` with the *biased* variance, as flax.
- ``BottleneckV1``: slim resnet_v1.bottleneck. With ``fused_block`` an
  eligible identity unit runs as one kernel (ops/fused_block.py) under the
  JAX package's dispatch rule, in eval mode only (the kernels fold the
  running statistics into the convs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from iv2019_tpu_torch.ops import fused_block as fb

__all__ = ["BottleneckV1", "Conv", "ConvNormRelu", "Norm"]


def same_padding(kernel_size: int, rate: int) -> int:
    """conv2d_same padding per side (symmetric for the odd kernels used)."""
    keff = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = keff - 1
    if pad_total % 2:
        raise ValueError(f"even effective kernel {keff} pads asymmetrically")
    return pad_total // 2


class Conv(nn.Module):
    """A conv kernel, OIHW f32 (the flax ``conv/kernel`` leaf)."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))


class Norm(nn.Module):
    """BatchNorm in f32 (the flax ``BatchNorm`` variables); the mode follows
    ``module.train()`` / ``module.eval()``."""

    def __init__(self, channels: int, epsilon: float = 1e-5, decay: float = 0.9):
        super().__init__()
        self.epsilon, self.decay = epsilon, decay
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train(x)
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        y = (x.float() - self.mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        # Autograd differentiates through the batch statistics, as flax's
        # autodiff does. F.batch_norm moves its running buffers with the
        # *unbiased* variance and momentum = 1 - decay, so it is handed fresh
        # buffers with momentum 1 (they come back holding the batch mean and
        # unbiased variance, with no second pass over x) and the flax update
        # with the biased variance is done here.
        xf = x.float()
        batch_mean, batch_var = torch.zeros_like(self.mean), torch.zeros_like(self.var)
        y = F.batch_norm(xf, batch_mean, batch_var, self.scale, self.bias, training=True,
                         momentum=1.0, eps=self.epsilon)
        count = xf.numel() // xf.shape[1]
        with torch.no_grad():
            self.mean.mul_(self.decay).add_(batch_mean, alpha=1.0 - self.decay)
            self.var.mul_(self.decay).add_(batch_var * ((count - 1) / count),
                                           alpha=1.0 - self.decay)
        return y.to(x.dtype)


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, rate: int = 1) -> torch.Tensor:
    """conv2d_same in the dtype of x, no bias."""
    pad = same_padding(weight.shape[-1], rate)
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=pad, dilation=rate)


class ConvNormRelu(nn.Module):
    """slim.conv2d: conv (no bias) -> norm -> optional relu.

    ``activation=False`` still applies the norm, as the reference's logit
    heads do.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, rate: int = 1,
                 activation: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.rate, self.activation, self.dtype = stride, rate, activation, dtype
        self.conv = Conv(cin, cout, kernel_size)
        self.norm = Norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(conv_same(x.to(self.dtype), self.conv.weight, self.stride, self.rate))
        return torch.relu(y) if self.activation else y

    def folded(self):
        """(kernel, bias) with the norm folded in, both f32 (kernel OIHW)."""
        n = self.norm
        return fb.fold_bn(self.conv.weight, n.scale, n.bias, n.mean, n.var, n.epsilon)


class BottleneckV1(nn.Module):
    """slim resnet_v1.bottleneck: 1x1 / 3x3(stride, rate) / 1x1 + shortcut.

    Identity shortcut (subsampled by the stride) when depth_in == depth,
    else a 1x1 projection conv + norm; relu after the residual add.
    """

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int, stride: int = 1,
                 rate: int = 1, fused_block: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth_in, self.depth, self.depth_bottleneck = depth_in, depth, depth_bottleneck
        self.stride, self.rate, self.fused_block, self.dtype = stride, rate, fused_block, dtype
        if depth_in != depth:
            self.shortcut = ConvNormRelu(depth_in, depth, 1, stride, activation=False, dtype=dtype)
        self.conv1 = ConvNormRelu(depth_in, depth_bottleneck, 1, dtype=dtype)
        self.conv2 = ConvNormRelu(depth_bottleneck, depth_bottleneck, 3, stride, rate, dtype=dtype)
        self.conv3 = ConvNormRelu(depth_bottleneck, depth, 1, activation=False, dtype=dtype)

    def fused_kernel(self, n: int, h: int, w: int):
        """The kernel wrapper the JAX rule picks for this unit, or None.

        Eligible: eval mode (BatchNorm on running statistics), identity
        shortcut, stride 1, bf16. Then the full-window kernel if its rule
        admits the shape, else the channel-tiled one (layers.py:488-531).
        """
        if not (self.fused_block and not self.training and self.stride == 1
                and self.depth_in == self.depth and self.dtype == torch.bfloat16):
            return None
        shape = (n, h, w, self.depth_in, self.depth_bottleneck, self.rate)
        if fb.fused_bottleneck_supported(*shape):
            return fb.fused_bottleneck
        if fb.pick_ct_config(*shape) is not None:
            return fb.fused_bottleneck_ct
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        kernel = self.fused_kernel(n, h, w)
        if kernel is not None:
            return self._fused(kernel, x)
        if self.depth_in == self.depth:
            shortcut = x if self.stride == 1 else x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut(x)
        residual = self.conv3(self.conv2(self.conv1(x)))
        return torch.relu(shortcut + residual)

    def _fused(self, kernel, x: torch.Tensor) -> torch.Tensor:
        bf = torch.bfloat16
        k1, b1 = self.conv1.folded()
        k2, b2 = self.conv2.folded()
        k3, b3 = self.conv3.folded()
        # NCHW channels_last -> NHWC: a view, contiguous unless the caller
        # handed over another memory format
        xh = x.to(bf).permute(0, 2, 3, 1).contiguous()
        out = kernel(
            xh,
            k1[:, :, 0, 0].t().contiguous().to(bf), b1,
            k2.permute(2, 3, 1, 0).contiguous().to(bf), b2,
            k3[:, :, 0, 0].t().contiguous().to(bf), b3,
            rate=self.rate,
        )
        return out.permute(0, 3, 1, 2).to(x.dtype)

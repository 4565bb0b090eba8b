"""Dilated ResNet-v1 trunk (slim ``resnet_v1_50``, output stride 8).

Port of iv2019_tpu/models/resnet.py: root conv2d_same 7x7/2 + norm + relu,
TF 'SAME' 3x3/2 max pool, then the bottleneck units of ``_unit_plan``. Once
the cumulative stride reaches the output stride, later unit strides become
dilation rates (rate 2 in block3 and 4 in block4 for stride 8).

With ``root_wgrad_pallas`` the root conv's weight gradient on images of even
height and width is kernel B6 (ops/root_wgrad.py) instead of the library's
(``RootConvPallasWgrad``, resnet.py:206-257); the parameter stays
``conv1.conv.weight``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iv2019_tpu_torch.models.layers import BottleneckV1, Conv, Norm, conv_same, same_padding
from iv2019_tpu_torch.ops.root_wgrad import root_conv_wgrad, wgrad_supported

__all__ = [
    "FEATURE_EXTRACTOR_BLOCKS",
    "RESNET50_BLOCKS",
    "ResNetV1",
    "unit_plan",
]

# (num_units, depth, depth_bottleneck); stride 2 on the last unit of blocks 1-3
RESNET50_BLOCKS: tuple[tuple[int, int, int], ...] = (
    (3, 256, 64),
    (4, 512, 128),
    (6, 1024, 256),
    (3, 2048, 512),
)
RESNET101_BLOCKS = ((3, 256, 64), (4, 512, 128), (23, 1024, 256), (3, 2048, 512))
RESNET152_BLOCKS = ((3, 256, 64), (8, 512, 128), (36, 1024, 256), (3, 2048, 512))

FEATURE_EXTRACTOR_BLOCKS = {
    "resnet_v1_50": RESNET50_BLOCKS,
    "resnet_v1_101": RESNET101_BLOCKS,
    "resnet_v1_152": RESNET152_BLOCKS,
}


def unit_plan(blocks: Sequence[tuple[int, int, int]], output_stride: int):
    """slim stack_blocks_dense bookkeeping (resnet.py:70-92).

    Returns [[(depth, depth_bottleneck, stride, rate), ...] per block].
    """
    current_stride = 4  # after root conv + pool
    rate = 1
    plan = []
    for bi, (num_units, depth, depth_bottleneck) in enumerate(blocks):
        units = []
        last_block = bi == len(blocks) - 1
        for ui in range(num_units):
            unit_stride = 2 if (ui == num_units - 1 and not last_block) else 1
            if current_stride == output_stride:
                units.append((depth, depth_bottleneck, 1, rate))
                rate *= unit_stride
            else:
                units.append((depth, depth_bottleneck, unit_stride, 1))
                current_stride *= unit_stride
        plan.append(units)
    if current_stride > output_stride:
        raise ValueError(f"output_stride {output_stride} too small for network.")
    return plan


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """TF 'SAME' max pooling: for even sizes only bottom and right pad."""
    h, w = x.shape[2], x.shape[3]
    pad_h = max((-(-h // stride) - 1) * stride + window - h, 0)
    pad_w = max((-(-w // stride) - 1) * stride + window - w, 0)
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2),
              value=float("-inf"))
    return F.max_pool2d(x, window, stride).contiguous(memory_format=torch.channels_last)


class _RootConvWgrad(torch.autograd.Function):
    """conv2d_same whose weight gradient is kernel B6 where it applies
    (``_root_conv_pallas_wgrad``, resnet.py:206-234).

    Takes x and the kernel in the compute dtype, as the JAX custom VJP does
    (the cast of the f32 parameter stays outside, so its backward carries
    dW to the parameter's f32 gradient). Forward and dx are the library's
    conv; dx only where autograd asks for it (the images never need it).
    dW is B6 for bf16 operands inside ``wgrad_supported``, rounded to bf16
    as ``dw.astype(k.dtype)`` is in JAX; else the library's exact wgrad.
    """

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        return conv_same(x, weight, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        k, stride = weight.shape[-1], ctx.stride
        pad = same_padding(k, 1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, stride=stride, padding=pad)
        if ctx.needs_input_grad[1]:
            if x.dtype == torch.bfloat16 and wgrad_supported(x.shape, dy.shape, k, stride):
                dw = root_conv_wgrad(x, dy, kernel_size=k, stride=stride).to(weight.dtype)
            else:
                dw = torch.nn.grad.conv2d_weight(x, weight.shape, dy, stride=stride, padding=pad)
        return dx, dw, None


class _RootConv(nn.Module):
    """The 7x7/2 root conv (flax ``conv1/conv/kernel``); ``wgrad_kernel``
    sends its weight gradient to B6 on images of even height and width."""

    def __init__(self, dtype: torch.dtype, wgrad_kernel: bool = False):
        super().__init__()
        self.dtype, self.wgrad_kernel = dtype, wgrad_kernel
        self.conv = Conv(3, 64, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.wgrad_kernel and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            return _RootConvWgrad.apply(x, self.conv.weight.to(self.dtype), 2)
        return conv_same(x, self.conv.weight, stride=2)


class ResNetV1(nn.Module):
    """Fully convolutional dilated ResNet-v1; returns the last block's map."""

    def __init__(self, blocks=RESNET50_BLOCKS, output_stride: int = 8,
                 fused_block: bool = False, dtype: torch.dtype = torch.bfloat16,
                 root_wgrad_pallas: bool = False):
        super().__init__()
        self.conv1 = _RootConv(dtype, wgrad_kernel=root_wgrad_pallas)
        self.conv1_norm = Norm(64)
        self.unit_names = []
        depth_in = 64
        for bi, units in enumerate(unit_plan(blocks, output_stride)):
            for ui, (depth, depth_bottleneck, stride, rate) in enumerate(units):
                name = f"block{bi + 1}/unit_{ui + 1}"
                self.add_module(name, BottleneckV1(
                    depth_in, depth, depth_bottleneck, stride, rate,
                    fused_block=fused_block, dtype=dtype))
                self.unit_names.append(name)
                depth_in = depth
        self.depth_out = depth_in

    def units(self):
        return [self.get_submodule(n) for n in self.unit_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(torch.relu(self.conv1_norm(self.conv1(x))), 3, 2)
        for unit in self.units():
            x = unit(x)
        return x

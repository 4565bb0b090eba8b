"""Dilated ResNet-v1 trunk (slim ``resnet_v1_50``, output stride 8).

Port of iv2019_tpu/models/resnet.py: root conv2d_same 7x7/2 + norm + relu,
TF 'SAME' 3x3/2 max pool, then the bottleneck units of ``_unit_plan``. Once
the cumulative stride reaches the output stride, later unit strides become
dilation rates (rate 2 in block3 and 4 in block4 for stride 8).

With ``root_wgrad_pallas`` the root conv's weight gradient on images of even
height and width is kernel B6 (ops/root_wgrad.py) instead of the library's
(``RootConvPallasWgrad``, resnet.py:206-257); the parameter stays
``conv1.conv.weight``.

On a band of image rows (spatial partitioning, parallel/mesh.py) the root
conv takes 3 rows from above and 2 from below through a halo exchange (the
image's edges give zeros) and runs with no padding along H; B6 then gets
the haloed band with no pad rows. The max pool takes one row from below
(-inf past the image's bottom: TF 'SAME' pads only there for even H).

With ``remat`` each bottleneck unit runs under
``torch.utils.checkpoint`` when autograd records it (``nn.remat``,
resnet.py:330-339): the backward recomputes the unit's activations from
its input. The recompute leaves the BatchNorm running statistics alone,
so they move once a forward, as without remat.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from iv2019_tpu_torch.models.layers import BottleneckV1, Conv, Norm, conv_same, same_padding
from iv2019_tpu_torch.ops.root_wgrad import root_conv_wgrad, wgrad_supported
from iv2019_tpu_torch.parallel import mesh as pmesh

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
    """TF 'SAME' max pooling: for even sizes only bottom and right pad. On a
    band of rows the padding is that of the global height, and the rows the
    band's outputs read past it come from the group (the pad rows, -inf,
    belong to the image's edges)."""
    h, w = x.shape[2], x.shape[3]
    mesh = pmesh.spatial_mesh()
    pad_w = max((-(-w // stride) - 1) * stride + window - w, 0)
    if mesh is not None:
        gh = h * mesh.spatial
        top = max((-(-gh // stride) - 1) * stride + window - gh, 0) // 2
        x = pmesh.halo(x, top, window - stride - top, mesh, fill=float("-inf"))
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2), value=float("-inf"))
    else:
        pad_h = max((-(-h // stride) - 1) * stride + window - h, 0)
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2),
                  value=float("-inf"))
    return F.max_pool2d(x, window, stride).contiguous(memory_format=torch.channels_last)


class _RootConvWgrad(torch.autograd.Function):
    """conv2d_same whose weight gradient is kernel B6 where it applies
    (``_root_conv_pallas_wgrad``, resnet.py:206-234).

    ``pad_rows``: zero rows above and below x, default conv2d_same's (0 on
    a band that carries its halo).

    Takes x and the kernel in the compute dtype, as the JAX custom VJP does
    (the cast of the f32 parameter stays outside, so its backward carries
    dW to the parameter's f32 gradient). Forward and dx are the library's
    conv; dx only where autograd asks for it (the images never need it).
    dW is B6 for bf16 operands inside ``wgrad_supported``, rounded to bf16
    as ``dw.astype(k.dtype)`` is in JAX; else the library's exact wgrad.
    """

    @staticmethod
    def forward(ctx, x, weight, stride, pad_rows=None):
        pad, _ = same_padding(weight.shape[-1], 1)
        pad_rows = pad if pad_rows is None else pad_rows
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pad_rows = stride, pad_rows
        return F.conv2d(x, weight, stride=stride, padding=(pad_rows, pad))

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        k, stride, rows = weight.shape[-1], ctx.stride, ctx.pad_rows
        pad, _ = same_padding(k, 1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, stride=stride,
                                            padding=(rows, pad))
        if ctx.needs_input_grad[1]:
            if x.dtype == torch.bfloat16 and wgrad_supported(x.shape, dy.shape, k, stride,
                                                             (rows, rows)):
                dw = root_conv_wgrad(x, dy, kernel_size=k, stride=stride,
                                     pad_rows=(rows, rows)).to(weight.dtype)
            else:
                dw = torch.nn.grad.conv2d_weight(x, weight.shape, dy, stride=stride,
                                                 padding=(rows, pad))
        return dx, dw, None, None


class _RootConv(nn.Module):
    """The 7x7/2 root conv (flax ``conv1/conv/kernel``); ``wgrad_kernel``
    sends its weight gradient to B6 on images of even height and width."""

    def __init__(self, dtype: torch.dtype, wgrad_kernel: bool = False):
        super().__init__()
        self.dtype, self.wgrad_kernel = dtype, wgrad_kernel
        self.conv = Conv(3, 64, 7)

    def runs_wgrad_kernel(self, x_shape) -> bool:
        """Whether a train step on whole images of ``x_shape`` (N, C, H, W)
        takes this conv's weight gradient from B6: the flag, bf16 compute,
        even H and W, and a shape the kernel takes (``_RootConvWgrad``)."""
        n, c, h, w = x_shape
        cout, _, k, _ = self.conv.weight.shape
        pad, _ = same_padding(k, 1)
        return (self.wgrad_kernel and self.dtype == torch.bfloat16 and h % 2 == 0
                and w % 2 == 0
                and wgrad_supported(x_shape, (n, cout, h // 2, w // 2), k, 2, (pad, pad)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not (self.wgrad_kernel and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
            return conv_same(x, self.conv.weight, stride=2)
        mesh = pmesh.spatial_mesh()
        pad, _ = same_padding(self.conv.weight.shape[-1], 1)
        if mesh is None:
            return _RootConvWgrad.apply(x, self.conv.weight.to(self.dtype), 2, pad)
        # the band's halo (zeros past the image's edges) and no pad rows
        x = pmesh.halo(x, pad, self.conv.weight.shape[-1] - 2 - pad, mesh)
        return _RootConvWgrad.apply(x, self.conv.weight.to(self.dtype), 2, 0)


def _remat(unit: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``unit(x)`` whose activations the backward recomputes; the recompute
    (every call after the first) keeps the running statistics still."""
    calls = []

    def run(inp):
        calls.append(None)
        if len(calls) == 1:
            return unit(inp)
        norms = [m for m in unit.modules() if isinstance(m, Norm)]
        for m in norms:
            m.update_stats = False
        try:
            return unit(inp)
        finally:
            for m in norms:
                m.update_stats = True

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class ResNetV1(nn.Module):
    """Fully convolutional dilated ResNet-v1; returns the last block's map."""

    def __init__(self, blocks=RESNET50_BLOCKS, output_stride: int = 8,
                 fused_block: bool = False, dtype: torch.dtype = torch.bfloat16,
                 root_wgrad_pallas: bool = False, norm_type: str = "batch",
                 remat: bool = False, bn_impl: str = "flax"):
        super().__init__()
        self.remat = remat
        self.conv1 = _RootConv(dtype, wgrad_kernel=root_wgrad_pallas)
        self.conv1_norm = Norm(64, norm_type=norm_type, bn_impl=bn_impl)
        self.unit_names = []
        depth_in = 64
        for bi, units in enumerate(unit_plan(blocks, output_stride)):
            for ui, (depth, depth_bottleneck, stride, rate) in enumerate(units):
                name = f"block{bi + 1}/unit_{ui + 1}"
                self.add_module(name, BottleneckV1(
                    depth_in, depth, depth_bottleneck, stride, rate,
                    fused_block=fused_block, dtype=dtype, norm_type=norm_type,
                    bn_impl=bn_impl))
                self.unit_names.append(name)
                depth_in = depth
        self.depth_out = depth_in

    def units(self):
        return [self.get_submodule(n) for n in self.unit_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.conv1_norm(self.conv1(x), relu=True), 3, 2)
        remat = self.remat and torch.is_grad_enabled()
        for unit in self.units():
            x = _remat(unit, x) if remat else unit(x)
        return x

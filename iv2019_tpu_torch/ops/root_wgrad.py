"""Weight gradient of the stride-2 root convolution: kernel B6.

The counterpart of iv2019_tpu/ops/pallas_wgrad.py::root_conv_wgrad::

    dW[o, c, kh, kw] = sum_{n, oh, ow} x[n, c, 2 oh + kh - p, 2 ow + kw - p] * dy[n, o, oh, ow]

for the conv2d_same 7x7/2 root conv (p = (k - 1) / 2, zero padding), with x
and dy rounded to bf16 and f32 accumulation.

The port's tensors are NCHW (in ``channels_last`` memory) and its kernels
OIHW, so ``root_conv_wgrad`` takes x (N, C, H, W) and dy (N, Cout, H/2, W/2)
and returns dW (Cout, C, k, k) f32. For CUDA tensors it launches
``csrc/root_wgrad.cu::iv_root_wgrad`` (which reads both as NHWC: each is
made ``channels_last`` contiguous first, a view for x and, in the common
case, for dy); for CPU tensors it runs ``root_conv_wgrad_reference``, the
plain version (im2row with ``F.unfold``, one f32 matrix product). Each
kernel launch adds one to ``root_conv_wgrad.launches``.

``wgrad_supported`` is the gate the model applies (models/resnet.py): stride
2, an odd kernel, even H and W with dy at half of them. The TPU kernel's
further conditions (an output-row tile dividing OH, 128-lane-aligned OW)
come from Mosaic's layout rules and do not apply here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.ops import _build

__all__ = ["root_conv_wgrad", "root_conv_wgrad_reference", "wgrad_supported"]

_BLOCKS_PER_SM = 2  # resident 320-thread blocks of csrc/root_wgrad.cu per SM
_ERRORS = {
    -1: "more than 160 taps (K*K*C) or 64 outputs: over the kernel's tile",
    -2: "the K input rows of a 64-pixel chunk exceed the kernel's staging buffer, or the "
        "chunks of 64 output pixels number 2^31 or more",
}


def wgrad_supported(x_shape, dy_shape, kernel_size: int, stride: int) -> bool:
    """Whether the kernel computes this wgrad: x (N, C, H, W), dy (N, Cout, OH, OW)."""
    _, _, h, w = x_shape
    _, _, oh, ow = dy_shape
    return (stride == 2 and kernel_size % 2 == 1 and h % 2 == 0 and w % 2 == 0
            and oh == h // 2 and ow == w // 2)


def root_conv_wgrad_reference(x: torch.Tensor, dy: torch.Tensor, kernel_size: int = 7,
                              stride: int = 2) -> torch.Tensor:
    """The plain version: im2row of the bf16-rounded x, times the bf16-rounded
    dy, in f32. Returns (Cout, C, k, k) f32."""
    n, c = x.shape[:2]
    cout = dy.shape[1]
    cols = F.unfold(x.to(torch.bfloat16).float(), kernel_size, padding=(kernel_size - 1) // 2,
                    stride=stride)  # (N, C*k*k, OH*OW), rows in (c, kh, kw) order
    if cols.shape[2] != dy.shape[2] * dy.shape[3]:
        raise ValueError(f"dy {tuple(dy.shape)} is not the conv output of x {tuple(x.shape)}")
    d = dy.to(torch.bfloat16).float().reshape(n, cout, -1)
    dw = d.permute(1, 0, 2).reshape(cout, -1) @ cols.permute(0, 2, 1).reshape(-1, cols.shape[1])
    return dw.reshape(cout, c, kernel_size, kernel_size)


def root_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel_size: int = 7,
                    stride: int = 2) -> torch.Tensor:
    """dW (Cout, C, k, k) f32 of the stride-2 conv2d_same conv; see the module docstring."""
    if x.device.type == "cpu":
        return root_conv_wgrad_reference(x, dy, kernel_size, stride)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"root_conv_wgrad: x on {x.device}, dy on {dy.device}")
    if not wgrad_supported(x.shape, dy.shape, kernel_size, stride):
        raise ValueError(f"root_conv_wgrad: no kernel for x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, k={kernel_size}, stride={stride}")
    n, c, h, w = x.shape
    _, cout, oh, ow = dy.shape
    # NCHW views of NHWC memory: permuting back gives contiguous NHWC
    xh = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    dyh = dy.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    if not (xh.is_contiguous() and dyh.is_contiguous()):
        raise ValueError("root_conv_wgrad: x and dy must convert to contiguous NHWC")
    lib = _build.load("root_wgrad")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = n * oh * -(-ow // 64)
    blocks = max(1, min(chunks, _BLOCKS_PER_SM * sms))
    lib.iv_root_wgrad_scratch.argtypes = [ctypes.c_int] * 4
    lib.iv_root_wgrad_scratch.restype = ctypes.c_longlong
    partial = torch.empty(lib.iv_root_wgrad_scratch(c, cout, kernel_size, blocks),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, c, kernel_size, kernel_size), dtype=torch.float32, device=x.device)
    fn = lib.iv_root_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xh.data_ptr(), dyh.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, h, w, c, oh,
             ow, cout, kernel_size, blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"root_conv_wgrad (x {tuple(x.shape)}, dy {tuple(dy.shape)}): "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    root_conv_wgrad.launches += 1
    return dw


root_conv_wgrad.launches = 0

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

On the H100 the work is bound by bytes (dy is read once, 268 MB at the
flagship step; 124 operations per byte). The root conv's own shape (k = 7,
C = 3, Cout = 64, W a multiple of 8) is one ``wgmma`` GEMM with the outputs
as M over chunks of 128 output pixels: dy and the chunk's 7 input rows
arrive by TMA, whose zero fill outside the tensors is the padding and the
ragged row end, and the im2row tile is formed in shared memory from 4-byte
copies. Every other shape the gate takes goes through a general WMMA kernel
with run-time sizes. ``_plan`` decides the route, the chunks and the number
of blocks; the kernels write one f32 partial per block and a second kernel
adds them in block order, so the result is the same from run to run.

``wgrad_supported`` is the gate the model applies (models/resnet.py): stride
2, an odd kernel, even H and W with dy at half of them. The TPU kernel's
further conditions (an output-row tile dividing OH, 128-lane-aligned OW)
come from Mosaic's layout rules and do not apply here.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.ops import _build

__all__ = ["root_conv_wgrad", "root_conv_wgrad_reference", "wgrad_supported"]

# constants of csrc/root_wgrad.cu
_ROOT_PIXELS = 128        # output pixels per chunk of the root kernel
_ROOT_COLUMNS = 160       # its im2row tile's columns: 7 x 22, padded
_ROOT_TAP_ROW = 22        # columns per kh: a stray one, then the 21 taps (kw, c)
_ROOT_SLAB_VALUES = 800   # bf16 values per staged input row (1600 bytes)
_ROOT_SLAB_COLUMN = -8    # the slab's first input column, relative to 2 * ow0: TMA wants the
                          # box's rows to start on 16 bytes, which -3 (the window's edge) is not
_ROOT_SLAB_FIRST = 14     # slab value that lands in pixel 0's stray column: 3 * (8 - 3) - 1
_ROOT_SMEM = 1024 + 4 * 27648 + 2 * 3 * 128 * 128 + 8 * 12
_GENERAL_PIXELS = 64      # output pixels per chunk of the general kernel
_GENERAL_BLOCKS_PER_SM = 2  # its resident 320-thread blocks per SM
_ERRORS = {
    -1: "more than 160 taps (K*K*C) or 64 outputs: over the kernel's tile",
    -2: "the K input rows of a 64-pixel chunk exceed the kernel's staging buffer, or the "
        "chunks of output pixels number 2^31 or more",
    -4: "the launch plan names the root kernel for a shape it does not take",
    -5: "a TMA tensor map could not be encoded",
}


@dataclasses.dataclass(frozen=True)
class _Plan:
    """The launch plan of B6: which kernel, its chunks and its blocks."""

    root: bool            # the wgmma/TMA kernel; else the general one
    pixels: int           # output pixels per chunk
    chunks_per_row: int
    chunks: int           # n * oh * chunks_per_row, each within one output row
    blocks: int           # each owns ``chunks_per_block`` consecutive chunks
    chunks_per_block: int
    partial_floats: int   # the per-block partials' scratch
    smem_bytes: int

    def chunk(self, q: int, oh: int):
        """(image, output row, first output column) of chunk ``q``."""
        row, col = divmod(q, self.chunks_per_row)
        return row // oh, row % oh, col * self.pixels

    def boxes(self, q: int, oh: int):
        """The root kernel's two TMA boxes of chunk ``q``, coordinates
        innermost first: dy in the (N*OH, OW, 64) view, x in the (N, H,
        W*3/4) view of 8-byte elements (four bf16 values each); and the
        input column and row of the slab's first value."""
        n, r, ow0 = self.chunk(q, oh)
        column = 2 * ow0 + _ROOT_SLAB_COLUMN
        return {"dy": (0, ow0, n * oh + r), "x": (3 * column // 4, 2 * r - 3, n),
                "slab_origin": (column, 2 * r - 3)}


def _plan(x_shape, cout: int, kernel_size: int, sms: int, aligned: bool = True) -> _Plan:
    """x_shape (N, C, H, W); ``aligned``: x and dy start on 16-byte boundaries."""
    n, c, h, w = x_shape
    oh, ow = h // 2, w // 2
    root = kernel_size == 7 and c == 3 and cout == 64 and w % 8 == 0 and aligned
    pixels = _ROOT_PIXELS if root else _GENERAL_PIXELS
    per_row = -(-ow // pixels)
    chunks = n * oh * per_row
    per_block = -(-chunks // max(1, min(chunks, sms if root else _GENERAL_BLOCKS_PER_SM * sms)))
    blocks = -(-chunks // per_block)  # no block without a chunk
    taps_pad = -(-kernel_size * kernel_size * c // 16) * 16
    return _Plan(root=root, pixels=pixels, chunks_per_row=per_row, chunks=chunks, blocks=blocks,
                 chunks_per_block=per_block,
                 partial_floats=blocks * taps_pad * (-(-cout // 16) * 16),
                 smem_bytes=_ROOT_SMEM if root else 0)


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
    plan = _plan(x.shape, cout, kernel_size, sms,
                 aligned=xh.data_ptr() % 16 == 0 and dyh.data_ptr() % 16 == 0)
    lib.iv_root_wgrad_scratch.argtypes = [ctypes.c_int] * 4
    lib.iv_root_wgrad_scratch.restype = ctypes.c_longlong
    if lib.iv_root_wgrad_scratch(c, cout, kernel_size, plan.blocks) != plan.partial_floats:
        raise RuntimeError("root_conv_wgrad: the plan's scratch size disagrees with the kernel's")
    partial = torch.empty(plan.partial_floats, dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, c, kernel_size, kernel_size), dtype=torch.float32, device=x.device)
    fn = lib.iv_root_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xh.data_ptr(), dyh.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, h, w, c, oh,
             ow, cout, kernel_size, plan.blocks, int(plan.root),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"root_conv_wgrad (x {tuple(x.shape)}, dy {tuple(dy.shape)}): "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    root_conv_wgrad.launches += 1
    return dw


root_conv_wgrad.launches = 0

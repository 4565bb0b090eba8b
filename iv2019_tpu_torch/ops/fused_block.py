"""Fused eval-mode identity bottleneck: the Hopper kernels and their plain version.

One call computes a whole stride-1 identity bottleneck unit with every
BatchNorm folded into the conv weights (``fold_bn``)::

    y1  = relu(x @ w1 + b1)                    bf16, zero outside the image
    y2  = relu(conv3x3_rate(y1) + b2)          bf16, SAME zero padding
    out = relu(x + y2 @ w3 + b3)               residual in f32, bf16 store

Two kernels, both in ``csrc/fused_bottleneck.cu``:

- ``fused_bottleneck`` replaces ``_kernel`` of iv2019_tpu/ops/pallas_block.py
  (``fused_bottleneck``, block2/block3 units);
- ``fused_bottleneck_ct`` replaces ``_ct_kernel`` of the same file
  (``fused_bottleneck_ct``, block4 units).

Both are bound by tensor-core operations on the H100 (a block3 unit does
~570 FLOP per byte of x and out, above the card's ~295 FLOP/B ridge). The
Pallas kernels lean on the TPU's sequential grid and a 14 MiB VMEM budget;
on the card every block instead owns one output tile, recomputes conv1 on
the tile's dilated halo, and keeps y1 and y2 in shared memory. They differ in
tile shape only (8x4 and 16x2 pixels), so that block4's 512-channel y1 halo
fits in a block's 227 KB. See the source for the design.

Which unit goes to which kernel is the JAX package's rule, copied here
(``fused_bottleneck_supported``, ``pick_ct_config``): it keeps the fused
units, and so their bf16 roundings, the same as the reference's. It is a
dispatch rule, not a memory gate on this card.

The wrappers take the JAX layouts: x (N, H, W, C) bf16; w1 (C, M), w2
(3, 3, M, M) HWIO and w3 (M, C) bf16; biases f32. For a CPU tensor they run
``bottleneck_plain``; for a CUDA tensor they launch the kernel or raise.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.ops import _build

__all__ = [
    "bottleneck_plain",
    "fold_bn",
    "fused_bottleneck",
    "fused_bottleneck_ct",
    "fused_bottleneck_ct_supported",
    "fused_bottleneck_supported",
    "pick_ct_config",
]

# The JAX dispatch rule sizes units against a TPU VMEM budget (bytes); kept
# verbatim so the port fuses exactly the units the reference fuses.
_VMEM_BUDGET = 14 * 1024 * 1024


def fold_bn(kernel, scale, bias, mean, var, epsilon=1e-5):
    """Fold an inference BatchNorm into the preceding conv (f32).

    kernel is OIHW; BN(conv(x)) = conv(x) * g + (bias - mean * g) with
    g = scale * rsqrt(var + eps). Returns (kernel * g, bias - mean * g).
    """
    g = scale * torch.rsqrt(var + epsilon)
    return kernel * g[:, None, None, None], bias - mean * g


def _vmem_bytes(th, r, w, c, m):
    rows = th + 2 * r
    xh = 2 * rows * w * c * 2
    y1 = rows * w * m * 2
    y2 = th * w * m * 4
    wts = (c * m + 9 * m * m + m * c) * 2
    out = 2 * th * w * c * 2
    return xh + y1 + y2 + wts + out


def fused_bottleneck_supported(n, h, w, c, m, rate, th=8):
    """Dispatch rule for ``fused_bottleneck`` (pallas_block.py:93-104)."""
    return (
        rate >= 1
        and c % 128 == 0
        and m % 128 == 0
        and w % 8 == 0
        and h % th == 0
        and h // th >= 2
        and h >= th + rate
        and _vmem_bytes(th, rate, w, c, m) <= _VMEM_BUDGET
    )


def _ct_vmem_bytes(th, r, w, c, m, ct):
    ring = (th + 2 * r) * w * m * 2
    acc = th * w * m * 4
    y2 = th * w * m * 2
    xt = 2 * th * w * ct * 2
    xres = 2 * th * w * ct * 2
    out = 2 * th * w * ct * 2
    wts = (c * m + 9 * m * m + m * c) * 2 + (m + c) * 4
    return ring + acc + y2 + xt + xres + out + wts


def fused_bottleneck_ct_supported(n, h, w, c, m, rate, th=4, ct=128):
    """Dispatch rule for ``fused_bottleneck_ct`` (pallas_block.py:329-342)."""
    return (
        rate >= 1
        and th >= rate
        and c % ct == 0
        and ct % 128 == 0
        and m % 128 == 0
        and w % 8 == 0
        and h % th == 0
        and h // th >= 2
        and h >= th + rate
        and _ct_vmem_bytes(th, rate, w, c, m, ct) <= _VMEM_BUDGET
    )


def pick_ct_config(n, h, w, c, m, rate):
    """(th, ct) the JAX rule would pick, or None (pallas_block.py:345-351)."""
    for th in (8, 4):
        for ct in (512, 256, 128):
            if fused_bottleneck_ct_supported(n, h, w, c, m, rate, th, ct):
                return th, ct
    return None


def bottleneck_plain(x, w1, b1, w2, b2, w3, b3, *, rate):
    """The kernels' function in plain PyTorch.

    Products run in f32 on the bf16-rounded operands; y1 and y2 are rounded
    to bf16 where the kernels round them. Returns bf16 (N, H, W, C).
    """
    xf = x.float()
    y1 = torch.relu(xf @ w1.float() + b1).to(torch.bfloat16)
    y2 = F.conv2d(
        y1.float().permute(0, 3, 1, 2), w2.float().permute(3, 2, 0, 1), b2.float(),
        padding=rate, dilation=rate,
    )
    y2 = torch.relu(y2).to(torch.bfloat16).float().permute(0, 2, 3, 1)
    return torch.relu(y2 @ w3.float() + b3 + xf).to(torch.bfloat16)


_ERRORS = {
    -1: "the unit's dilated halo needs more row tiles than the kernel was compiled for",
    -2: "the unit's halo does not fit in the device's shared memory",
    -3: "channels must be multiples of 128",
}


def _launch(symbol, wrapper, x, w1, b1, w2, b2, w3, b3, rate):
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3, rate=rate)
    if x.device.type != "cuda":
        raise ValueError(f"{symbol}: unsupported device {x.device}")
    n, h, w, c = x.shape
    m = w1.shape[1]
    expect = {
        "x": (x, torch.bfloat16, (n, h, w, c)),
        "w1": (w1, torch.bfloat16, (c, m)),
        "b1": (b1, torch.float32, (m,)),
        "w2": (w2, torch.bfloat16, (3, 3, m, m)),
        "b2": (b2, torch.float32, (m,)),
        "w3": (w3, torch.bfloat16, (m, c)),
        "b3": (b3, torch.float32, (c,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{symbol}: {name} must be {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{symbol}: {name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    fn = getattr(_build.load("fused_bottleneck"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(), n, h, w, c, m, rate,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} (n,h,w,c,m,rate)={(n, h, w, c, m, rate)}: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    wrapper.launches += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, *, rate):
    """Whole identity bottleneck, 8x4-pixel tiles (block2/block3 units; 16x2
    where a unit's 8x4 halo does not fit in shared memory)."""
    return _launch("iv_fused_bottleneck", fused_bottleneck, x, w1, b1, w2, b2, w3, b3, rate)


def fused_bottleneck_ct(x, w1, b1, w2, b2, w3, b3, *, rate):
    """Whole identity bottleneck, 16x2-pixel tiles (block4 units)."""
    return _launch("iv_fused_bottleneck_ct", fused_bottleneck_ct, x, w1, b1, w2, b2, w3, b3, rate)


fused_bottleneck.launches = 0
fused_bottleneck_ct.launches = 0

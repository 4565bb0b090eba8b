"""Fused eval-mode identity bottleneck: the Hopper kernels and their plain version.

One call computes a whole stride-1 identity bottleneck unit with every
BatchNorm folded into the conv weights (``fold_bn``)::

    y1  = relu(x @ w1 + b1)                    bf16
    y2  = relu(conv3x3_rate(y1) + b2)          bf16, SAME zero padding of y1
    out = relu(x + y2 @ w3 + b3)               residual in f32, bf16 store

Two wrappers over ``csrc/fused_bottleneck.cu``:

- ``fused_bottleneck`` replaces ``_kernel`` of iv2019_tpu/ops/pallas_block.py
  (``fused_bottleneck``, block2/block3 units);
- ``fused_bottleneck_ct`` replaces ``_ct_kernel`` of the same file
  (``fused_bottleneck_ct``, block4 units).

Both run the same two CUDA kernels: conv1 as one GEMM over all pixels into
a bf16 (N, H, W, M) scratch allocated here, then conv2 + conv3 per 8x8
output tile with y2 kept in shared memory. block3 and block4 units are
bound by tensor-core operations on the H100, block2 units by bytes. y1
goes through the scratch (25% more bytes, L2-resident at batch 1) instead
of being recomputed on every tile's dilated halo, as keeping it on chip
would need. The products are wgmma, fed by TMA through a ring of
shared-memory stages; see the source for the design. One wrapper call is
one launch in ``<wrapper>.launches``, though it runs two kernels.

Which unit goes to which wrapper is the JAX package's rule, copied here
(``fused_bottleneck_supported``, ``pick_ct_config``): it keeps the fused
units, and so their bf16 roundings, the same as the reference's. It is a
dispatch rule, not a memory gate on this card.

The wrappers take the JAX layouts: x (N, H, W, C) bf16; w1 (C, M), w2
(3, 3, M, M) HWIO and w3 (M, C) bf16; biases f32. For a CPU tensor they run
``bottleneck_plain``; for a CUDA tensor they launch the kernels or raise.
``_plan`` holds the kernels' tile and shared-memory arithmetic in Python,
so that the CPU tests can check it.

A CUDA tensor goes through the operators ``torch.ops.iv2019.fused_bottleneck``
and ``fused_bottleneck_ct`` of ``csrc/torch_ops.cpp`` (``ops_library``), so
that eager calls and exported programs launch the kernels by one route; the
launch plan is an argument, and so a constant of an exported graph. Under
``torch.export`` the wrappers call the operators for a tensor of either
device: the program then holds the unit as one node, which runs the kernels
on the card and ``bottleneck_plain`` on the CPU (registered here, as is the
fake implementation that export traces with). ``_run`` is the ctypes route
to the same kernels, which can launch either kernel alone, for timing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from iv2019_tpu_torch.ops import _build

__all__ = [
    "OP_NAMES",
    "bottleneck_plain",
    "fold_bn",
    "fused_bottleneck",
    "fused_bottleneck_ct",
    "fused_bottleneck_ct_supported",
    "fused_bottleneck_supported",
    "op_plan",
    "ops_library",
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


# Launch plan: the tile and shared-memory arithmetic of the two kernels,
# repeated from csrc/fused_bottleneck.cu, which checks what it is handed.
_SMS = 132            # H100 SXM streaming multiprocessors
_MAX_STAGES = 6       # deepest shared-memory ring
_BOX = 64 * 64 * 2    # bytes of one 64 x 64 bf16 TMA box
_TILE = 8             # conv23 output tile side (8x8 pixels)
MAX_SMEM = 232_448    # shared memory one block may use on the H100


class Plan(NamedTuple):
    tile1: int        # conv1 pixels per tile (x 128 output channels)
    grid1: tuple      # conv1 blocks: (pixel tiles, channel tiles)
    stages1: int      # conv1 ring depth
    smem1: int        # conv1 shared-memory bytes per block
    nc: int           # conv2 / conv3 output channels per chunk
    tiles2: tuple     # conv23 blocks, one per 8x8 tile: (images, along H, along W)
    stages2: int      # conv23 ring depth
    smem2: int        # conv23 shared-memory bytes per block


def _stages(stage_bytes, fixed_bytes):
    """The deepest ring (up to _MAX_STAGES) that fits beside ``fixed_bytes``:
    each stage also holds two 8-byte mbarriers, and 1024 bytes align the
    ring to the 128-byte swizzle's period."""
    return min(_MAX_STAGES, (MAX_SMEM - 1024 - fixed_bytes) // (stage_bytes + 16))


def _plan(n, h, w, c, m, rate, sms=_SMS):
    """Tiles, grids, ring depths and shared memory of the two kernels.

    conv1 takes 128-pixel tiles unless its grid would then leave more than
    half of the ``sms`` multiprocessors idle (block2 at batch 1), then 64.
    conv2 and conv3 run in chunks of 256 output channels where M and C
    allow, else 128. ``rate`` does not enter: no halo lives in shared
    memory.
    """
    p = n * h * w
    tile1 = 128 if -(-p // 128) * (m // 128) >= sms // 2 else 64
    nc = 256 if m % 256 == 0 and c % 256 == 0 else 128
    stage1 = tile1 * 128 + 2 * _BOX
    stage2 = _TILE * _TILE * 128 + nc * 128
    y2 = _TILE * _TILE * m * 2
    stages1, stages2 = _stages(stage1, 0), _stages(stage2, y2)
    return Plan(tile1=tile1, grid1=(-(-p // tile1), m // 128), stages1=stages1,
                smem1=1024 + stages1 * (stage1 + 16), nc=nc,
                tiles2=(n, -(-h // _TILE), -(-w // _TILE)), stages2=stages2,
                smem2=1024 + stages2 * (stage2 + 16) + y2)


_ERRORS = {
    -3: "channels must be multiples of 128",
    -4: "the launch plan disagrees with the kernels' layout",
    -5: "a TMA tensor map could not be encoded",
}


def _check(symbol, x, w1, b1, w2, b2, w3, b3):
    n, h, w, c = x.shape
    m = w1.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, dtype, shape in (
        ("x", x, bf, (n, h, w, c)), ("w1", w1, bf, (c, m)), ("b1", b1, f32, (m,)),
        ("w2", w2, bf, (3, 3, m, m)), ("b2", b2, f32, (m,)), ("w3", w3, bf, (m, c)),
        ("b3", b3, f32, (c,)),
    ):
        if t.dtype != dtype or t.shape != shape or t.device != x.device:
            raise ValueError(
                f"{symbol}: {name} must be {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{symbol}: {name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _entry(symbol):
    fn = getattr(_build.load("fused_bottleneck"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(symbol, x, w1, b1, w2, b2, w3, b3, rate, kernels=3, y1=None):
    """Launch the unit's kernels on a CUDA tensor: bit 0 of ``kernels`` is
    conv1 (into ``y1``, a bf16 (N, H, W, M) scratch allocated here when not
    given), bit 1 conv2 + conv3. Returns the output; counts nothing."""
    _check(symbol, x, w1, b1, w2, b2, w3, b3)
    n, h, w, c = x.shape
    m = w1.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = _plan(n, h, w, c, m, rate, sms)
    if y1 is None:
        y1 = torch.empty((n, h, w, m), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    # the CUDA runtime's current device is per thread: launch on the tensors'
    with torch.cuda.device(x.device):
        err = _entry(symbol)(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), y1.data_ptr(), out.data_ptr(), n, h, w, c, m, rate,
            plan.tile1, plan.stages1, plan.nc, plan.stages2, plan.smem1, plan.smem2, kernels,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"{symbol} (n,h,w,c,m,rate)={(n, h, w, c, m, rate)}: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    return out


OP_NAMES = ("fused_bottleneck", "fused_bottleneck_ct")


# The operators return a contiguous (N, H, W, C) tensor, as the CUDA
# implementation allocates it: a compiled program lays out its readers by
# the fake implementation's strides.
def _op_cpu(x, w1, b1, w2, b2, w3, b3, rate, plan):
    return bottleneck_plain(x, w1, b1, w2, b2, w3, b3, rate=rate).contiguous()


def _op_fake(x, w1, b1, w2, b2, w3, b3, rate, plan):
    return x.new_empty(x.shape)


# bn_eval's output has x's strides (channels_last), as its CUDA
# implementations allocate it (csrc/torch_ops.cpp), in either form
def _bn_eval_fake(x, *_):
    return torch.empty_like(x)


@functools.lru_cache(maxsize=None)
def ops_library() -> str:
    """Load the operator library (``_build.build_ops``, built at first use)
    into this process and register the CPU and fake implementations of its
    two fused-unit operators and the fake ones of ``iv2019::bn_eval`` and
    ``bn_eval.folded`` (ops/fused_bn.py; the card alone runs them); returns
    the library's path. Raises if it cannot be built or loaded."""
    path = str(_build.build_ops())
    torch.ops.load_library(path)
    for name in OP_NAMES:
        torch.library.register_fake(f"iv2019::{name}")(_op_fake)
        torch.library.impl(f"iv2019::{name}", "CPU")(_op_cpu)
    for name in ("bn_eval", "bn_eval.folded"):
        torch.library.register_fake(f"iv2019::{name}")(_bn_eval_fake)
    return path


def op_plan(x, w1, rate) -> list[int]:
    """The plan argument of the operators: (tile1, stages1, nc, stages2,
    smem1, smem2) for x's device (the H100's SM count off the card)."""
    n, h, w, c = x.shape
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else _SMS)
    p = _plan(n, h, w, c, w1.shape[1], rate, sms)
    return [p.tile1, p.stages1, p.nc, p.stages2, p.smem1, p.smem2]


def _launch(name, wrapper, x, w1, b1, w2, b2, w3, b3, rate):
    exporting = torch.compiler.is_exporting()
    if x.device.type == "cpu" and not exporting:
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3, rate=rate)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"iv_{name}: unsupported device {x.device}")
    ops_library()
    out = getattr(torch.ops.iv2019, name)(x, w1, b1, w2, b2, w3, b3, rate, op_plan(x, w1, rate))
    if not exporting:
        wrapper.launches += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, *, rate):
    """Whole identity bottleneck (block2/block3 units, and block4 units on
    maps where the rule picks the full-window kernel)."""
    return _launch("fused_bottleneck", fused_bottleneck, x, w1, b1, w2, b2, w3, b3, rate)


def fused_bottleneck_ct(x, w1, b1, w2, b2, w3, b3, *, rate):
    """Whole identity bottleneck (block4 units): the same kernels."""
    return _launch("fused_bottleneck_ct", fused_bottleneck_ct, x, w1, b1, w2, b2, w3, b3, rate)


fused_bottleneck.launches = 0
fused_bottleneck_ct.launches = 0

"""Fused SGD(M) + weight decay + EMA update of flat f32 vectors: kernel B3.

The counterpart of iv2019_tpu/ops/pallas_update.py::fused_update_pallas.
One pass over the flat parameter vector::

    g' = g + wd * (mask * w)
    m' = g' + mu * m
    w' = w - lr * (g' + mu * m')   (Nesterov)  |  w - lr * m'   (plain)
    s' = s - (1 - decay) * (s - w')
    reg = sum(mask * w * w)        (pre-update weights)

``fused_update`` launches ``csrc/fused_update.cu::iv_fused_update`` for CUDA
vectors and runs ``fused_update_plain`` for CPU vectors. ``lr`` and
``decay`` are 0-d f32 tensors on the vectors' device, read by the kernel
from device memory, so the caller never waits on the host for them. The
vectors are unpadded: the TPU kernel's tile padding (``TILE``) exists only
in the JAX package's checkpoint layout (utils/convert.py).

``out=(w', m', s')`` names the tensors to write, which may be ``w``, ``m``
and ``s`` themselves (the port updates its flat buffers in place).
Each kernel launch adds one to ``fused_update.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from iv2019_tpu_torch.ops import _build

__all__ = ["fused_update", "fused_update_plain"]

_MAX_BLOCKS = 132 * 8  # one wave of 256-thread blocks on the H100's 132 SMs


def fused_update_plain(w, g, m, s, mask, lr, decay, *, momentum: float, weight_decay: float,
                       nesterov: bool = False, out: Optional[tuple] = None):
    """The kernel's function in plain PyTorch, one rounding per operation."""
    wd_w = mask * w
    gd = g + weight_decay * wd_w
    m_new = gd + momentum * m
    upd = gd + momentum * m_new if nesterov else m_new
    w_new = w - lr * upd
    s_new = s - (1.0 - decay) * (s - w_new)
    reg = torch.sum(wd_w * w)
    if out is None:
        return w_new, m_new, s_new, reg
    for dst, src in zip(out, (w_new, m_new, s_new)):
        dst.copy_(src)
    return (*out, reg)


def fused_update(w, g, m, s, mask, lr, decay, *, momentum: float, weight_decay: float,
                 nesterov: bool = False, out: Optional[tuple] = None):
    """Returns (w', m', s', reg); see the module docstring."""
    if w.device.type == "cpu":
        return fused_update_plain(w, g, m, s, mask, lr, decay, momentum=momentum,
                                  weight_decay=weight_decay, nesterov=nesterov, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {w.device}")
    n = w.numel()
    if out is None:
        out = (torch.empty_like(w), torch.empty_like(m), torch.empty_like(s))
    named = {"w": w, "g": g, "m": m, "s": s, "mask": mask, "w_out": out[0], "m_out": out[1],
             "s_out": out[2]}
    for name, t in named.items():
        if t.device != w.device or t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"fused_update: {name} must be float32 ({n},) on {w.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_update: {name} must be contiguous and 16-byte aligned")
    for name, t in (("lr", lr), ("decay", decay)):
        if t.device != w.device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"fused_update: {name} must be a float32 scalar on {w.device}")
    partials = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=w.device)
    reg = torch.empty((), dtype=torch.float32, device=w.device)
    fn = _build.load("fused_update").iv_fused_update
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # the CUDA runtime's current device is per thread: launch on the tensors'
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), s.data_ptr(), mask.data_ptr(),
                 lr.data_ptr(), decay.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 out[2].data_ptr(), partials.data_ptr(), reg.data_ptr(), n, momentum,
                 weight_decay, int(nesterov), _MAX_BLOCKS,
                 torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_update (n={n}): CUDA error {err}")
    fused_update.launches += 1
    return (*out, reg)


fused_update.launches = 0

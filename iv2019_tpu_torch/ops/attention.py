"""Scaled dot-product attention on a fused backend, never on the math one.

``attention(q, k, v, scale)`` is ``softmax(q k^T * scale) v`` over (B, H,
N, d) queries and (B, H, Nk, d) keys and values, through
``F.scaled_dot_product_attention``. For CUDA tensors the call is confined
(``torch.nn.attention.sdpa_kernel``) to one backend chosen from the
inputs: FlashAttention for bf16 and fp16, the memory-efficient kernel for
f32, which FlashAttention does not take. A backend that cannot run the
shapes raises; nothing falls back to the math backend, which would hold
N x Nk scores per head in memory (65,536 x 1,024 a head and an image in
stage 1 of MiT at a 1024x1024 crop). For CPU tensors the call is left to
PyTorch's choice.

Counters: ``attention.launches`` adds one a call (on the card: one
forward kernel; its backward is the backend's own), and
``attention.backend`` names the backend of the last call (``"flash"``,
``"efficient"`` or ``"cpu"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["attention", "backend_for"]


def backend_for(q: torch.Tensor) -> str:
    """The backend ``attention`` runs for queries like ``q``."""
    if q.device.type != "cuda":
        return "cpu"
    return "flash" if q.dtype in (torch.bfloat16, torch.float16) else "efficient"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, N, d) attention output of (B, H, N, d) ``q`` against (B, H,
    Nk, d) ``k`` and ``v``, scores scaled by ``scale``."""
    name = backend_for(q)
    if name == "cpu":
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    else:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        chosen = SDPBackend.FLASH_ATTENTION if name == "flash" else \
            SDPBackend.EFFICIENT_ATTENTION
        with sdpa_kernel([chosen]):
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    attention.launches += 1
    attention.backend = name
    return out


attention.launches = 0
attention.backend = None

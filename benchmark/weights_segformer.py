"""Seeded weights of a ``segformer_*`` configuration, in the model's names,
made on the device.

Every value comes from the run's seed through one ``torch.Generator`` on
the device (``weights.generator``), in two large draws taken by the leaves
in the order of their sorted names: one normal vector for every kernel
(``.weight``: linears, convs, depthwise convs), each scaled to He's fan-in
standard deviation sqrt(2 / fan_in), and one uniform vector for the
vectors: norm scales U(0.8, 1.2), biases U(-0.2, 0.2). Running statistics
are 0 and 1 (the training cell's norms run on the batch's statistics).

Each residual branch's output, the attention's and the Mix-FFN's output
projections (``attn.proj``, ``mlp.fc2``, kernel and bias) and the last norm
of each bottleneck adaptation branch (``conv3.norm``), is drawn at a tenth
of that scale, as ``weights.py`` does for the ResNet's branches: a random
52-block net at full gain amplifies one bf16 rounding until no float32
comparison can tell a sound bf16 program from a broken one.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.segformer import param_spec
from benchmark.weights import RESIDUAL_GAIN, generator

__all__ = ["RESIDUAL_LEAVES", "draw"]

RESIDUAL_LEAVES = (".attn.proj.", ".mlp.fc2.", ".conv3.norm.")


def draw(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor} of every parameter and running statistic."""
    spec = sorted(param_spec(cfg))
    g = generator(seed, device)
    kernels = [(n, s) for n, s in spec if n.endswith(".weight")]
    vectors = [(n, s) for n, s in spec if n.endswith((".scale", ".bias"))]
    out = {}
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=g, device=device)
    offset = 0
    for name, shape in kernels:
        size = math.prod(shape)
        out[name] = flat[offset:offset + size].view(shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        offset += size
    flat = torch.rand(sum(s[0] for _, s in vectors), generator=g, device=device)
    offset = 0
    for name, (c,) in vectors:
        u = flat[offset:offset + c]
        out[name] = 0.8 + 0.4 * u if name.endswith(".scale") else 0.4 * u - 0.2
        offset += c
    for name in out:
        if any(key in name for key in RESIDUAL_LEAVES):
            out[name] = out[name] * RESIDUAL_GAIN
    for name, (c,) in ((n, s) for n, s in spec if n.endswith(".mean")):
        out[name] = torch.zeros(c, device=device)
        out[name[:-len(".mean")] + ".var"] = torch.ones(c, device=device)
    return {k: v.contiguous() for k, v in out.items()}

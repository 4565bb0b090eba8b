"""Seeded weights in the model's published names, made on the device.

Every value comes from the run's seed through one ``torch.Generator`` on
the device, in three large draws: one normal vector for all conv kernels
(each scaled to He's fan-in standard deviation), one uniform vector for
the norms' scales and biases, and one for the running statistics' jitter.
Leaves take their slices in the order of their sorted names, so the values
do not depend on the order anything registers them in.

The last norm of every residual branch (``conv3``) has a tenth of the
others' scale and bias, as trained ResNets keep their residual branches
small against the shortcut (and start them at zero, Goyal et al. 2017):
at full gain a random 50-layer trunk amplifies one bf16 rounding into a
logit error as large as the logits' own spread, and no comparison with a
float32 reference could tell a sound bf16 program from a broken one.

Running statistics: mean 0 and variance 1, or with ``calibrate`` those of
each norm's own input over a batch (the reference's train-mode forward in
float32), jittered (mean + 0.1 std U(-1, 1), variance x U(0.8, 1.25)), as a
trained network's are: activations stay at unit scale through the 60-odd
norms of an evaluation-mode forward.

``steer`` then copies classes within the logit layers so that L1 picks
the vehicle and the human metaclass where two of its frequent classes
would, and no L2 head picks the class its metaclass maps to. A random head
over many classes picks few of them anywhere (over Vistas' 53, neither
metaclass won a pixel), and where L1 never picks a metaclass its L2 head
never decides; nor does a fusion that is skipped change a decision where
the L2 head picks the metaclass's own class. Either way nothing would
check the L2 heads or the fusion. A bias moved to a quantile instead puts
the metaclass's edge among the most uncertain pixels, and its share on the
steering images did not carry over to others.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import HEADS, forward, param_spec

__all__ = ["MARGIN", "RESIDUAL_GAIN", "draw", "generator", "steer"]

RESIDUAL_GAIN = 0.1
# logit margin of the steered classes (``steer``)
MARGIN = 1.0


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def draw(cfg: dict, seed: int, device, calibrate=None) -> dict:
    """{name: float32 tensor} of every parameter and running statistic.
    ``calibrate``: images (N, H, W, 3) on ``device`` whose statistics the
    running ones take."""
    spec = sorted(param_spec(cfg))
    g = generator(seed, device)
    kernels = [(n, s) for n, s in spec if n.endswith(".weight")]
    vectors = [(n, s) for n, s in spec if n.endswith((".scale", ".bias"))]
    out = {}
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=g, device=device)
    offset = 0
    for name, shape in kernels:
        size = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        out[name] = flat[offset:offset + size].view(shape) * math.sqrt(2.0 / fan_in)
        offset += size
    flat = torch.rand(sum(s[0] for _, s in vectors), generator=g, device=device)
    offset = 0
    for name, (c,) in vectors:
        u = flat[offset:offset + c]
        out[name] = 0.8 + 0.4 * u if name.endswith(".scale") else 0.4 * u - 0.2
        if name.endswith((".conv3.norm.scale", ".conv3.norm.bias")):
            out[name] = out[name] * RESIDUAL_GAIN
        offset += c
    stats = [n for n, _ in spec if n.endswith(".mean")]
    for name in stats:
        c = out[name[:-len(".mean")] + ".scale"].shape[0]
        out[name] = torch.zeros(c, device=device)
        out[name[:-len(".mean")] + ".var"] = torch.ones(c, device=device)
    if calibrate is not None:
        seen = {}
        with torch.no_grad():
            forward(out, calibrate, cfg, train=True, record=seen)
        flat = torch.rand(2 * sum(out[n].shape[0] for n in stats), generator=g, device=device)
        offset = 0
        for name in stats:
            prefix = name[:-len(".mean")]
            mean, var = seen[prefix]
            c = mean.shape[0]
            u, v = flat[offset:offset + c], flat[offset + c:offset + 2 * c]
            out[name] = mean + 0.1 * var.sqrt() * (2.0 * u - 1.0)
            out[prefix + ".var"] = var * (0.8 + 0.45 * v)
            offset += 2 * c
    return {k: v.contiguous() for k, v in out.items()}


def _copy_class(w: dict, head: str, src: int, dst: int, shift: float) -> None:
    """Give class ``dst`` of a logit layer class ``src``'s kernel and norm,
    its bias moved by ``shift``: its logit is then ``src``'s plus
    ``shift`` on every pixel."""
    for leaf in ("conv.weight", "norm.scale", "norm.bias", "norm.mean", "norm.var"):
        t = w[f"{head}.{leaf}"].clone()
        t[dst] = t[src]
        if leaf == "norm.bias":
            t[dst] += shift
        w[f"{head}.{leaf}"] = t


def steer(w: dict, cfg: dict, images: torch.Tensor, ranks=(1, 2)) -> dict:
    """``w`` with the logit layers' classes copied, from the reference's
    evaluation-mode forward of ``images``: the vehicle and the human
    metaclass of L1 each take over, by ``MARGIN``, another L1 class, the
    one of rank ``ranks[0]`` and ``ranks[1]`` by the pixels it decides there
    (1 the most), so that they decide where those did and as firmly; in
    each L2 head the class that its metaclass
    maps to becomes the next class less ``MARGIN`` and decides nowhere, so
    that the fusion changes every decision it makes."""
    hier = cfg["hierarchy"]
    w = dict(w)
    with torch.no_grad():
        l1 = forward(w, images, cfg, train=False)[0]
    counts = torch.bincount(torch.argmax(l1, 1).flatten(), minlength=l1.shape[1])
    metaclasses = (hier["cid_l1_vehicle"], hier["cid_l1_human"])
    order = [int(c) for c in torch.argsort(counts, descending=True, stable=True)
             if int(c) not in metaclasses]
    donors = [order[r - 1] for r in ranks]
    for cid, donor in zip(metaclasses, donors):
        _copy_class(w, "softmax_classifier/l1_logits", donor, cid, MARGIN)
    for name, cid in zip(("vehicle", "human"), metaclasses):
        table = hier[f"l2_{name}_cids2common_cids"]
        own = hier["l1_cids2common_cids"][cid]
        if own in table:
            k = table.index(own)
            _copy_class(w, f"softmax_classifier/l2_{name}_logits", (k + 1) % len(table), k,
                        -MARGIN)
    return {k: v.contiguous() for k, v in w.items()}

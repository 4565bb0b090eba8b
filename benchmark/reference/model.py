"""The hierarchical segmentation model in plain PyTorch, in float32.

The model of arXiv:1903.03462 (reference code/models/
resnet50_extended_model_hierarchical.py): a slim ResNet-v1 trunk whose unit
strides turn into dilation rates once the output stride is reached, a 1x1
conv_norm_relu from the trunk's width to ``feature_dims_decreased``, the
optional PSP module, and for each of the three heads (L1, vehicle, human) a
bottleneck adaptation unit and a 1x1 logit conv with its norm. The logits
are upsampled bilinearly with aligned corners (TF1's tables) in float32.

Parameters and running statistics are a dict keyed by the model's published
variable names (flax paths joined with dots: ``<module>.conv.weight`` for a
kernel in OIHW, ``<module>.norm.{scale,bias,mean,var}`` for its batch norm),
so one dict of seeded values can be loaded into any implementation that
keeps those names.

``rounding`` puts a lower precision at the points where a mixed-precision
implementation rounds: the images, every conv kernel, every conv output,
every norm output, every residual sum and every PSP branch, forward and (for
the gradient) backward. ``None`` is float32 throughout.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["HEADS", "PSP_DIVS", "bilinear_matrix", "forward", "nearest_table", "param_spec",
           "rounding", "strict_float32", "stride8_size", "unit_plan", "upsample"]

HEADS = ("l1", "l2_vehicle", "l2_human")
PSP_DIVS = (1, 2, 3, 6)


# -- precision ---------------------------------------------------------------

@contextlib.contextmanager
def strict_float32():
    """float32 matrix products and convolutions without TF32, restoring the
    process's settings after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _cast(dtype):
    def f(x):
        return x.to(dtype).to(torch.float32)
    return f


def _scaled(dtype, largest: float):
    """Round to an 8-bit float after scaling the tensor's largest magnitude
    to the format's largest value (per-tensor scaling, as 8-bit training
    scales)."""
    def f(x):
        scale = largest / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(dtype).to(torch.float32) / scale
    return f


_PRECISIONS = {
    "float32": None,
    "bfloat16": (_cast(torch.bfloat16), _cast(torch.bfloat16)),
    # e4m3 forward, e5m2 for gradients
    "float8": (_scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)),
}


def rounding(precision: str):
    """x -> x rounded to ``precision`` (gradient rounded on the way back),
    or None for float32."""
    pair = _PRECISIONS[precision]
    if pair is None:
        return None
    return lambda x: _Round.apply(x, *pair)


# -- shapes --------------------------------------------------------------------

def unit_plan(blocks, output_stride: int):
    """[(block, unit, depth_in, depth, depth_bottleneck, stride, rate)] of
    slim's stack_blocks_dense: stride 2 on the last unit of each block but
    the last, turned into a dilation rate once the stride reaches
    ``output_stride`` (4 after the root conv and the pool)."""
    current, rate, depth_in, plan = 4, 1, 64, []
    for bi, (units, depth, bottleneck) in enumerate(blocks):
        for ui in range(units):
            stride = 2 if (ui == units - 1 and bi < len(blocks) - 1) else 1
            if current == output_stride:
                plan.append((bi + 1, ui + 1, depth_in, depth, bottleneck, 1, rate))
                rate *= stride
            else:
                plan.append((bi + 1, ui + 1, depth_in, depth, bottleneck, stride, 1))
                current *= stride
            depth_in = depth
    return plan


def stride8_size(h: int, w: int) -> tuple[int, int]:
    """The trunk's output size at output stride 8: the 7x7/2 root conv
    (explicit padding 3 + 3), the 'SAME' 3x3/2 pool, block1's 3x3/2."""
    def axis(n):
        n = (n + 6 - 7) // 2 + 1
        n = -(-n // 2)
        return (n + 2 - 3) // 2 + 1
    return axis(h), axis(w)


def _cnr(prefix: str, cin: int, cout: int, k: int) -> list:
    return [(f"{prefix}.conv.weight", (cout, cin, k, k))] + [
        (f"{prefix}.norm.{leaf}", (cout,)) for leaf in ("scale", "bias", "mean", "var")]


def param_spec(cfg: dict) -> list:
    """[(name, shape)] of every parameter and running statistic."""
    base = "feature_extractor/base"
    spec = [(f"{base}.conv1.conv.weight", (64, 3, 7, 7))] + [
        (f"{base}.conv1_norm.{leaf}", (64,)) for leaf in ("scale", "bias", "mean", "var")]
    for b, u, cin, depth, m, _, _ in unit_plan(cfg["resnet_blocks"], cfg["output_stride"]):
        unit = f"{base}.block{b}/unit_{u}"
        if cin != depth:
            spec += _cnr(f"{unit}.shortcut", cin, depth, 1)
        spec += _cnr(f"{unit}.conv1", cin, m, 1) + _cnr(f"{unit}.conv2", m, m, 3) \
            + _cnr(f"{unit}.conv3", m, depth, 1)
    c = cfg["feature_dims_decreased"]
    spec += _cnr("feature_extractor/extension/decrease_fdims", cfg["resnet_blocks"][-1][1], c, 1)
    if cfg["psp_module"]:
        for d in PSP_DIVS:
            spec += _cnr(f"feature_extractor/pyramid_module.conv{d}", c, c, 1)
        spec += _cnr("feature_extractor/pyramid_module.conv_final", c + len(PSP_DIVS) * c, c, 1)
    for head, n in zip(HEADS, cfg["heads"]):
        spec += _cnr(f"adaptation_module/{head}_features.conv1", c, c, 1) \
            + _cnr(f"adaptation_module/{head}_features.conv2", c, c, 3) \
            + _cnr(f"adaptation_module/{head}_features.conv3", c, c, 1) \
            + _cnr(f"softmax_classifier/{head}_logits", c, n, 1)
    return spec


# -- resize tables (TF r1.12 semantics, float32 coordinates) -------------------

def _scale(n_in: int, n_out: int) -> np.float32:
    return np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(n_in) / \
        np.float32(n_out)


def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 matrix of the aligned-corners bilinear resize."""
    src = np.arange(n_out, dtype=np.float32) * _scale(n_in, n_out)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m


def nearest_table(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output of the aligned-corners nearest resize
    (TF's roundf: half away from zero)."""
    src = np.arange(n_out, dtype=np.float32) * _scale(n_in, n_out)
    return np.clip(np.floor(src + np.float32(0.5)).astype(np.int64), 0, n_in - 1)


def upsample(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, H, W) float32, aligned-corners bilinear."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == tuple(out_hw):
        return x.float()
    a = torch.as_tensor(bilinear_matrix(h, out_hw[0]), device=x.device)
    b = torch.as_tensor(bilinear_matrix(w, out_hw[1]), device=x.device)
    return a @ x.float() @ b.t()


# -- layers ----------------------------------------------------------------------

class _Net:
    def __init__(self, params: dict, cfg: dict, train: bool, rnd, record):
        self.p, self.cfg, self.train, self.record = params, cfg, train, record
        self.r = rnd or (lambda t: t)
        self.eps = cfg["batch_norm_epsilon"]

    def conv(self, x, weight, stride=1, rate=1):
        """slim conv2d_same: stride 1 pads 'SAME'; stride 2 pads keff - 1
        split low/high explicitly; both come to the same symmetric pads for
        odd kernels."""
        k = weight.shape[-1]
        keff = k + (k - 1) * (rate - 1)
        lo = (keff - 1) // 2
        hi = keff - 1 - lo
        if lo or hi:
            x = F.pad(x, (lo, hi, lo, hi))
        return self.r(F.conv2d(x, self.r(weight), stride=stride, dilation=rate))

    def norm(self, x, prefix):
        p = self.p
        scale, bias = p[f"{prefix}.scale"], p[f"{prefix}.bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
            if self.record is not None:
                self.record[prefix] = (mean.detach(), var.detach())
        else:
            mean, var = p[f"{prefix}.mean"], p[f"{prefix}.var"]
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return self.r(y * scale[:, None, None] + bias[:, None, None])

    def cnr(self, x, prefix, stride=1, rate=1, relu=True):
        y = self.norm(self.conv(x, self.p[f"{prefix}.conv.weight"], stride, rate),
                      f"{prefix}.norm")
        return torch.relu(y) if relu else y

    def bottleneck(self, x, prefix, cin, depth, stride, rate):
        if cin != depth:
            shortcut = self.cnr(x, f"{prefix}.shortcut", stride, relu=False)
        else:
            shortcut = x[:, :, ::stride, ::stride] if stride > 1 else x
        y = self.cnr(x, f"{prefix}.conv1")
        y = self.cnr(y, f"{prefix}.conv2", stride, rate)
        y = self.cnr(y, f"{prefix}.conv3", relu=False)
        return torch.relu(self.r(shortcut + y))

    def psp(self, x):
        h, w = x.shape[2], x.shape[3]
        branches = [x]
        for d in PSP_DIVS:
            ph, pw = h // d, w // d
            pooled = F.avg_pool2d(x, (ph, pw), (ph, pw))
            y = self.cnr(pooled, f"feature_extractor/pyramid_module.conv{d}")
            branches.append(self.r(upsample(y, (h, w))))
        return self.cnr(torch.cat(branches, 1), "feature_extractor/pyramid_module.conv_final")


def forward(params: dict, images: torch.Tensor, cfg: dict, train: bool, rnd=None,
            remat: bool = False, record=None) -> list:
    """images (N, H, W, 3) in [-1, 1] -> the three heads' stride-8 logits,
    (N, C, h, w) float32. ``train``: batch norm on the batch's statistics
    (biased variance), else on the running ones. ``remat``: each trunk unit
    recomputes its activations in the backward (the same values: the
    batch statistics are recomputed from the same inputs). ``record``: a
    dict that takes each train-mode norm's (mean, variance) by its name."""
    net = _Net(params, cfg, train, rnd, record)
    base = "feature_extractor/base"
    x = net.r(images.permute(0, 3, 1, 2).float())
    x = torch.relu(net.norm(net.conv(x, params[f"{base}.conv1.conv.weight"], 2),
                            f"{base}.conv1_norm"))
    # TF 'SAME' 3x3/2 max pool: the extra pad row and column at the end
    pad_h = max((-(-x.shape[2] // 2) - 1) * 2 + 3 - x.shape[2], 0)
    pad_w = max((-(-x.shape[3] // 2) - 1) * 2 + 3 - x.shape[3], 0)
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2),
              value=float("-inf"))
    x = F.max_pool2d(x, 3, 2)
    for b, u, cin, depth, _, stride, rate in unit_plan(cfg["resnet_blocks"], cfg["output_stride"]):
        def unit(t, b=b, u=u, cin=cin, depth=depth, stride=stride, rate=rate):
            return net.bottleneck(t, f"{base}.block{b}/unit_{u}", cin, depth, stride, rate)
        x = checkpoint(unit, x, use_reentrant=False) if remat and torch.is_grad_enabled() \
            else unit(x)
    x = net.cnr(x, "feature_extractor/extension/decrease_fdims")
    if cfg["psp_module"]:
        x = net.psp(x)
    c = cfg["feature_dims_decreased"]
    logits = []
    for head in HEADS:
        y = net.bottleneck(x, f"adaptation_module/{head}_features", c, c, 1, 1)
        logits.append(net.cnr(y, f"softmax_classifier/{head}_logits", relu=False).float())
    return logits

"""Layer primitives of the trunk, in PyTorch.

Port of iv2019_tpu/models/layers.py. Tensors inside the network are NCHW
in ``torch.channels_last`` memory, so a ``permute(0, 2, 3, 1)`` hands the
fused-block kernels NHWC without a copy.

Modules are registered under the flax module names of the JAX package, so
a state-dict key is the flax path joined with dots, with ``conv/kernel``
as ``conv.weight`` (OIHW) and ``norm/BatchNorm/<leaf>`` as ``norm.<leaf>``
(utils/convert.py).

- ``conv2d_same`` padding: symmetric ``keff - 1`` split low/high.
- Norm: flax BatchNorm in f32, epsilon 1e-5, cast back to the compute
  dtype. In eval mode (``module.eval()``) on the running statistics,
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias``; in train mode on the
  batch's statistics over (N, H, W), with the running statistics moved by
  ``decay * ra + (1 - decay) * batch`` with the *biased* variance, as flax.
  With more than one rank (parallel/mesh.py) the train-mode statistics
  are those of the global batch: one all-reduce of the per-channel sums
  forward, one of the gradient's sums backward. ``bn_impl="fused"`` (the
  JAX package's FusedBatchNorm, layers.py:207-240; the default of the
  port's ``Settings``, while the layers default to ``"flax"`` as the flax
  modules do) runs train-mode batch norm as ops/fused_bn.py: flax's
  single-pass statistics and the classic two-reduction backward, on the
  compute-type activation (kernels N1/N2 on the card), over every rank's
  rows when there are several; eval mode, group norm and ``"none"`` ignore
  it, as in JAX. A norm may end with a residual add and a ReLU
  (``relu(norm(x) + residual)``, a unit's last norm with its shortcut, or
  conv_norm_relu's ReLU): in eval mode batch norm does the three in one
  pass on the card (kernel N3, ``ops/fused_bn.py::fused_bn_eval``), which
  raises on what it does not take, and as the plain chain of separate ops
  on the CPU (bit for bit what it was).
  ``norm_type="group"`` is flax GroupNorm (``min(groups, C)`` groups,
  f32, the same in both modes, no running statistics), its parameters
  named ``scale`` and ``bias`` as flax's (weight decay applies to
  ``.weight`` only); ``"none"`` is the identity.
- ``BottleneckV1``: slim resnet_v1.bottleneck. With ``fused_block`` an
  eligible identity unit runs as one kernel (ops/fused_block.py) under the
  JAX package's dispatch rule, in eval mode under batch norm only (the
  kernels fold the running statistics into the convs).

When the active mesh splits image height (``parallel.mesh.spatial_mesh``)
every tensor here is a band of rows of the global map, and each op with a
spatial extent takes its halo from the other ranks of the group: a conv
the rows its outputs read beyond the band, by the padding of
``same_padding`` (zeros past the image's edges), then no padding along H;
group norm sums its statistics over the group; a fused unit runs its
kernel on the band and the halo of its dilated 3x3 (``BottleneckV1``).
BatchNorm needs nothing more: its sums already run over every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from iv2019_tpu_torch.ops import fused_block as fb
from iv2019_tpu_torch.ops import fused_bn
from iv2019_tpu_torch.parallel import mesh as pmesh

__all__ = ["BottleneckV1", "Conv", "ConvNormRelu", "Norm"]


def same_padding(kernel_size: int, rate: int) -> tuple[int, int]:
    """conv2d_same padding (low, high): ``keff - 1`` split low/high."""
    keff = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = keff - 1
    return pad_total // 2, pad_total - pad_total // 2


class Conv(nn.Module):
    """A conv kernel, OIHW f32 (the flax ``conv/kernel`` leaf); grouped
    convs hold (cout, cin / groups, k, k)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel_size, kernel_size))


class Norm(nn.Module):
    """BatchNorm (or GroupNorm, or none) in f32 (the flax ``BatchNorm`` /
    ``GroupNorm`` variables); batch norm's mode follows ``module.train()`` /
    ``module.eval()``. ``update_stats`` False keeps the running statistics
    where they are in train mode (a recomputed forward, models/resnet.py).
    ``bn_impl`` "fused" runs train-mode batch norm as ops/fused_bn.py.
    The forward's ``residual`` and ``relu`` end the norm with
    ``relu(y + residual)``; eval-mode batch norm runs all three as
    ops/fused_bn.py's N3 on a CUDA tensor."""

    def __init__(self, channels: int, epsilon: float = 1e-5, decay: float = 0.9,
                 norm_type: str = "batch", groups: int = 32, bn_impl: str = "flax"):
        super().__init__()
        if norm_type not in ("batch", "group", "none"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        if bn_impl not in ("flax", "fused"):
            raise ValueError(f"unknown bn_impl {bn_impl!r}")
        self.norm_type, self.epsilon, self.decay = norm_type, epsilon, decay
        self.bn_impl = bn_impl
        self.num_groups = min(groups, channels)
        self.update_stats = True
        if norm_type == "none":
            return
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if norm_type == "batch":
            self.register_buffer("mean", torch.zeros(channels))
            self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        if self.norm_type == "batch" and not self.training:
            run = fused_bn.fused_bn_eval if x.is_cuda else fused_bn.batch_norm_eval_plain
            return run(x, self.mean, self.var, self.scale, self.bias, self.epsilon, residual,
                       relu)
        y = self._norm(x)
        if residual is not None:
            y = residual + y
        return torch.relu(y) if relu else y

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "none":
            return x
        if self.norm_type == "group":
            mesh = pmesh.spatial_mesh()
            if mesh is not None:
                y = _group_norm_bands(x.float(), self.num_groups, self.scale, self.bias,
                                      self.epsilon, mesh)
            else:
                y = F.group_norm(x.float(), self.num_groups, self.scale, self.bias, self.epsilon)
            return y.to(x.dtype)
        return self._train(x)

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        mesh = pmesh.norm_mesh()
        if self.bn_impl == "fused":
            return self._train_fused(x, mesh)
        if mesh is not None:
            return self._train_global(x, mesh)
        # Autograd differentiates through the batch statistics, as flax's
        # autodiff does. F.batch_norm moves its running buffers with the
        # *unbiased* variance and momentum = 1 - decay, so it is handed fresh
        # buffers with momentum 1 (they come back holding the batch mean and
        # unbiased variance, with no second pass over x) and the flax update
        # with the biased variance is done here.
        xf = x.float()
        batch_mean, batch_var = torch.zeros_like(self.mean), torch.zeros_like(self.var)
        y = F.batch_norm(xf, batch_mean, batch_var, self.scale, self.bias, training=True,
                         momentum=1.0, eps=self.epsilon)
        count = xf.numel() // xf.shape[1]
        if self.update_stats:
            with torch.no_grad():
                self.mean.mul_(self.decay).add_(batch_mean, alpha=1.0 - self.decay)
                self.var.mul_(self.decay).add_(batch_var * ((count - 1) / count),
                                               alpha=1.0 - self.decay)
        return y.to(x.dtype)

    def _train_fused(self, x: torch.Tensor, mesh) -> torch.Tensor:
        # FusedBatchNorm: the running statistics move with the biased variance
        y, mean, var = fused_bn.batch_norm_train(x, self.scale, self.bias, self.epsilon, mesh)
        if self.update_stats:
            with torch.no_grad():
                self.mean.mul_(self.decay).add_(mean, alpha=1.0 - self.decay)
                self.var.mul_(self.decay).add_(var, alpha=1.0 - self.decay)
        return y

    def _train_global(self, x: torch.Tensor, mesh) -> torch.Tensor:
        # statistics of the global batch, as JAX's BatchNorm under SPMD: the
        # per-channel sums are all-reduced, and the variance is flax's
        # E[x^2] - E[x]^2 (biased), which moves the running statistics
        y, mean, var = _GlobalBatchNorm.apply(x.float(), self.scale, self.bias, self.epsilon,
                                              mesh)
        if self.update_stats:
            with torch.no_grad():
                self.mean.mul_(self.decay).add_(mean, alpha=1.0 - self.decay)
                self.var.mul_(self.decay).add_(var, alpha=1.0 - self.decay)
        return y.to(x.dtype)


def _group_norm_bands(x: torch.Tensor, groups: int, scale, bias, eps: float, mesh):
    """Group norm of images split by height: each (image, group)'s sum and
    sum of squares over the band, summed over the spatial group (flax's
    E[x^2] - E[x]^2). Autograd carries the statistics' gradient back
    through ``spatial_sum``, whose backward sums it over the group. A map
    every rank of the group holds whole (PSP's pooled bins) counts P times
    in the sums and in the count alike."""
    n, c, h, w = x.shape
    xg = x.reshape(n, groups, c // groups, h, w)
    sums = pmesh.spatial_sum(torch.stack([xg.sum((2, 3, 4)), (xg * xg).sum((2, 3, 4))]), mesh)
    count = (c // groups) * h * w * mesh.spatial
    mean = sums[0] / count
    var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    xhat = (xg - mean[..., None, None, None]) * torch.rsqrt(var + eps)[..., None, None, None]
    return xhat.reshape(n, c, h, w) * scale[:, None, None] + bias[:, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank, in f32.

    Forward: one all-reduce of the per-channel (sum x, sum x^2) and the row
    count. Backward: one all-reduce of (sum dy, sum dy * xhat), so that the
    input gradient carries the statistics' dependence on every rank's rows;
    the scale and bias gradients are this rank's parts, which the train
    step's gradient all-reduce adds. Returns (y, batch mean, biased batch
    variance); the last two carry no gradient.
    """

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        c = x.shape[1]
        dims = (0, 2, 3)
        stats = torch.cat([x.sum(dims), (x * x).sum(dims),
                           x.new_full((1,), x.numel() // c)])
        pmesh.all_reduce(stats, mesh)
        count = stats[-1]
        mean = stats[:c] / count
        var = torch.clamp_min(stats[c:2 * c] / count - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (x - mean[:, None, None]) * rstd[:, None, None]
        y = xhat * scale[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(xhat, scale, rstd, count)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, scale, rstd, count = ctx.saved_tensors
        c = xhat.shape[1]
        dims = (0, 2, 3)
        dbias = dy.sum(dims)
        dscale = (dy * xhat).sum(dims)
        sums = pmesh.all_reduce(torch.cat([dbias, dscale]), ctx.mesh)
        mean_dy = sums[:c] / count
        mean_dy_xhat = sums[c:] / count
        dx = (dy - mean_dy[:, None, None] - xhat * mean_dy_xhat[:, None, None]) \
            * (scale * rstd)[:, None, None]
        return dx, dscale, dbias, None, None


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, rate: int = 1,
              groups: int = 1) -> torch.Tensor:
    """conv2d_same in the dtype of x, no bias. On a band of rows (spatial
    partitioning) the rows above it are the ``lo`` of the padding and the
    rows below are what the band's last output reads, ``keff - stride -
    lo``; the band starts on a multiple of the stride."""
    k = weight.shape[-1]
    lo, hi = same_padding(k, rate)
    w = weight.to(x.dtype)
    mesh = pmesh.spatial_mesh()
    if mesh is not None and k > 1:
        keff = k + (k - 1) * (rate - 1)
        x = pmesh.halo(x, lo, keff - stride - lo, mesh)
        if lo != hi:
            return F.conv2d(F.pad(x, (lo, hi)), w, stride=stride, dilation=rate, groups=groups)
        return F.conv2d(x, w, stride=stride, padding=(0, lo), dilation=rate, groups=groups)
    if lo != hi:
        return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride, dilation=rate,
                        groups=groups)
    return F.conv2d(x, w, stride=stride, padding=lo, dilation=rate, groups=groups)


class ConvNormRelu(nn.Module):
    """slim.conv2d: conv (no bias) -> norm -> optional relu.

    ``activation=False`` still applies the norm, as the reference's logit
    heads do. ``feature_group_count`` splits the conv into that many groups;
    ``groups`` is the group norm's, ``bn_impl`` the batch norm's. A
    ``residual`` (a unit's shortcut) is added after the norm, and a ReLU
    follows it whatever ``activation``: ``relu(norm(conv(x)) + residual)``.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, rate: int = 1,
                 activation: bool = True, dtype: torch.dtype = torch.bfloat16,
                 norm_type: str = "batch", groups: int = 32, feature_group_count: int = 1,
                 bn_impl: str = "flax"):
        super().__init__()
        self.stride, self.rate, self.activation, self.dtype = stride, rate, activation, dtype
        self.feature_group_count = feature_group_count
        self.conv = Conv(cin, cout, kernel_size, feature_group_count)
        self.norm = Norm(cout, norm_type=norm_type, groups=groups, bn_impl=bn_impl)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = conv_same(x.to(self.dtype), self.conv.weight, self.stride, self.rate,
                      self.feature_group_count)
        return self.norm(y, residual, self.activation or residual is not None)

    def folded(self):
        """(kernel, bias) with the norm folded in, both f32 (kernel OIHW)."""
        n = self.norm
        return fb.fold_bn(self.conv.weight, n.scale, n.bias, n.mean, n.var, n.epsilon)


def fused_band_rows(h: int, rate: int, spatial: int):
    """rank -> the rows [start, stop) of the global map each of ``spatial``
    ranks runs a fused unit's kernel on: its band of ``h`` rows and ``rate``
    rows past each cut, none at the image's edges (the kernel's zero padding
    of y1 is the conv's there), grown at a cut to a multiple of 8 rows, the
    row tile the dispatch rule asks heights to divide by."""
    def need(q):
        start = q * h - (rate if q > 0 else 0)
        stop = (q + 1) * h + (rate if q < spatial - 1 else 0)
        grow = -(stop - start) % 8
        if q < spatial - 1:
            return start, min(stop + grow, spatial * h)
        return max(start - grow, 0), stop

    return need


class BottleneckV1(nn.Module):
    """slim resnet_v1.bottleneck: 1x1 / 3x3(stride, rate) / 1x1 + shortcut.

    Identity shortcut (subsampled by the stride) when depth_in == depth,
    else a 1x1 projection conv + norm; relu after the residual add.
    """

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int, stride: int = 1,
                 rate: int = 1, fused_block: bool = False, dtype: torch.dtype = torch.bfloat16,
                 norm_type: str = "batch", bn_impl: str = "flax"):
        super().__init__()
        self.depth_in, self.depth, self.depth_bottleneck = depth_in, depth, depth_bottleneck
        self.stride, self.rate, self.fused_block, self.dtype = stride, rate, fused_block, dtype
        self.norm_type = norm_type
        kw = dict(dtype=dtype, norm_type=norm_type, bn_impl=bn_impl)
        if depth_in != depth:
            self.shortcut = ConvNormRelu(depth_in, depth, 1, stride, activation=False, **kw)
        self.conv1 = ConvNormRelu(depth_in, depth_bottleneck, 1, **kw)
        self.conv2 = ConvNormRelu(depth_bottleneck, depth_bottleneck, 3, stride, rate, **kw)
        self.conv3 = ConvNormRelu(depth_bottleneck, depth, 1, activation=False, **kw)

    def fused_kernel(self, n: int, h: int, w: int):
        """The kernel wrapper the JAX rule picks for this unit, or None.

        Eligible: batch norm in eval mode (on running statistics), identity
        shortcut, stride 1, bf16. Then the full-window kernel if its rule
        admits the shape, else the channel-tiled one (layers.py:488-531).
        """
        if not (self.fused_block and self.norm_type == "batch" and not self.training
                and self.stride == 1 and self.depth_in == self.depth
                and self.dtype == torch.bfloat16):
            return None
        shape = (n, h, w, self.depth_in, self.depth_bottleneck, self.rate)
        if fb.fused_bottleneck_supported(*shape):
            return fb.fused_bottleneck
        if fb.pick_ct_config(*shape) is not None:
            return fb.fused_bottleneck_ct
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        mesh = pmesh.spatial_mesh()
        if mesh is not None:
            # every rank takes the same path (a halo exchange is collective):
            # fused only if the rule admits every rank's rows
            need = fused_band_rows(h, self.rate, mesh.spatial)
            kernels = [self.fused_kernel(n, b - a, w) for a, b in map(need, range(mesh.spatial))]
            if all(k is not None for k in kernels):
                start = mesh.spatial_index * h - need(mesh.spatial_index)[0]
                out = self._fused(kernels[mesh.spatial_index], pmesh.gather_rows(x, mesh, need))
                return out.narrow(2, start, h).contiguous(memory_format=torch.channels_last)
            kernel = None
        else:
            kernel = self.fused_kernel(n, h, w)
        if kernel is not None:
            return self._fused(kernel, x)
        if self.depth_in == self.depth:
            shortcut = x if self.stride == 1 else x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut(x)
        # relu(shortcut + conv3's norm): in eval mode one pass of N3 on the card
        return self.conv3(self.conv2(self.conv1(x)), residual=shortcut)

    def _fused(self, kernel, x: torch.Tensor) -> torch.Tensor:
        bf = torch.bfloat16
        k1, b1 = self.conv1.folded()
        k2, b2 = self.conv2.folded()
        k3, b3 = self.conv3.folded()
        # NCHW channels_last -> NHWC: a view, contiguous unless the caller
        # handed over another memory format
        xh = x.to(bf).permute(0, 2, 3, 1).contiguous()
        out = kernel(
            xh,
            k1[:, :, 0, 0].t().contiguous().to(bf), b1,
            k2.permute(2, 3, 1, 0).contiguous().to(bf), b2,
            k3[:, :, 0, 0].t().contiguous().to(bf), b3,
            rate=self.rate,
        )
        return out.permute(0, 3, 1, 2).to(x.dtype)

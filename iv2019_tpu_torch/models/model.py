"""Hierarchical segmentation model: dilated ResNet-50 + three heads.

Port of iv2019_tpu/models/model.py::

    images -> ResNet-v1 trunk (output stride 8; optional remat), or the
              port's own ``mit_*`` feature extractor (models/mit.py: MiT
              and SegFormer's decoder, 768 channels at output stride 4)
           -> extension 1x1 conv 2048 (768) -> 256
           -> optional dilated FOV conv (``fov_expansion_kernel_*``)
           -> optional PSP pyramid module (``psp_module``)
           -> three bottleneck adaptation branches, or the same as grouped
              convs (``fuse_adaptation``)
           -> 1x1 logit heads with their norm (L1 / L2-vehicle / L2-human)
           -> x8 (x4 under ``mit_*``) bilinear upsample, align_corners=True,
              f32, after a 3x3
              conv with bias under ``upsampling_method="hybrid"``
              (``"no"``: the stride-8 logits, f32)
           -> softmax / first-max argmax per head, f32
           -> hierarchical decision fusion into the common label space

BatchNorm runs on batch statistics in train mode (``model.train()``) and on
running statistics in eval mode; ``build_model`` picks the mode from the
settings. ``norm_type="group"`` puts GroupNorm (32 groups) everywhere but
in the logit heads, which take one group, as in the JAX package.

Public tensors are NHWC, like the JAX package's: ``forward`` takes
(N, H, W, 3) images in [-1, 1) and returns the same ten-key dict.
``hierarchical_common_probabilities`` turns the three heads' distributions
into one over the common label space (models/model.py:42-73), the
distribution that test-time augmentation and sliding windows average.

Under spatial partitioning (parallel/mesh.py) ``forward`` takes a rank's
band of image rows and returns its band of every output: the trunk and heads
exchange halos (models/layers.py, resnet.py), PSP sums each bin's rows over
the group and resizes its bins back to the band's rows, the hybrid
upsampler's 3x3 takes a halo, and the x8 upsample reads the stride-8 rows
its band's outputs map to, wherever they lie (``ops/resize.py::resize_band``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.layers import BottleneckV1, ConvNormRelu, Norm
from iv2019_tpu_torch.models.mit import MIT_WIDTHS, MitSegFormer, init_mit
from iv2019_tpu_torch.models.resnet import FEATURE_EXTRACTOR_BLOCKS, RESNET50_BLOCKS, ResNetV1
from iv2019_tpu_torch.ops.resize import resize_band, resize_bilinear, resize_bilinear_mxu
from iv2019_tpu_torch.ops.segment_ops import gather_cids, segment_sum_channels
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.problem.taxonomy import Taxonomy, get_taxonomy
from iv2019_tpu_torch.utils.spans import span

__all__ = ["ConvTranspose", "HierarchicalSegmentationModel", "PSPModule", "build_model",
           "hierarchical_common_probabilities", "init_model", "resolve_device"]

_HEADS = ("l1", "l2_vehicle", "l2_human")


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; no silent fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def hierarchical_common_probabilities(preds: dict, tax: Taxonomy) -> torch.Tensor:
    """Factorized per-pixel probabilities over the common label space (f32).

    The probabilistic counterpart of the argmax decision fusion: P(common c)
    collects the L1 mass of every L1 class but the two metaclasses mapped
    to c, plus P(L1=vehicle) * P(vehicle subclass -> c) and P(L1=human) *
    P(human subclass -> c). Sums to 1 over the common space.
    """
    l1 = preds["l1_probabilities"].float()
    veh = preds["l2_vehicle_probabilities"].float()
    hum = preds["l2_human_probabilities"].float()
    keep = np.ones(tax.num_l1_classes, np.float32)
    keep[tax.cid_l1_vehicle] = 0.0
    keep[tax.cid_l1_human] = 0.0
    n = tax.num_common_classes
    with span("iv.sync.common_keep"):
        keep = torch.as_tensor(keep, device=l1.device)
    base = segment_sum_channels(l1 * keep, tax.l1_cids2common_cids, n)
    p_veh = segment_sum_channels(veh, tax.l2_vehicle_cids2common_cids, n)
    p_hum = segment_sum_channels(hum, tax.l2_human_cids2common_cids, n)
    return (base + l1[..., tax.cid_l1_vehicle:tax.cid_l1_vehicle + 1] * p_veh
            + l1[..., tax.cid_l1_human:tax.cid_l1_human + 1] * p_hum)


class PSPModule(nn.Module):
    """Pyramid Scene Parsing module (model.py:76-108): average pools with
    window = stride = (h // d, w // d) for d in 1, 2, 3, 6 ('VALID'), a 1x1
    conv_norm_relu each, bilinear resize back (f32, align_corners=True),
    concat with the input, and a final 1x1 conv_norm_relu."""

    DIVS = (1, 2, 3, 6)

    def __init__(self, cin: int, features: int, dtype: torch.dtype, norm_type: str,
                 bn_impl: str = "flax"):
        super().__init__()
        kw = dict(dtype=dtype, norm_type=norm_type, bn_impl=bn_impl)
        for d in self.DIVS:
            self.add_module(f"conv{d}", ConvNormRelu(cin, features, 1, **kw))
        self.conv_final = ConvNormRelu(cin + len(self.DIVS) * features, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = pmesh.spatial_mesh()
        h, w = x.shape[2], x.shape[3]
        rows = None
        if mesh is not None:
            # the bins span the global height; each rank holds its band
            rows = (mesh.spatial_index * h, (mesh.spatial_index + 1) * h)
            h *= mesh.spatial
        branches = [x]
        for d in self.DIVS:
            ph, pw = h // d, w // d
            if mesh is None:
                pooled = F.avg_pool2d(x, (ph, pw), (ph, pw))
            else:
                pooled = _band_avg_pool(x, ph, pw, rows[0], h, mesh)
            conv = self.get_submodule(f"conv{d}")(pooled)
            up = resize_bilinear(conv.permute(0, 2, 3, 1), (h, w), align_corners=True, rows=rows)
            branches.append(up.permute(0, 3, 1, 2).to(x.dtype))
        cat = torch.cat(branches, 1).contiguous(memory_format=torch.channels_last)
        return self.conv_final(cat)


def _band_avg_pool(x: torch.Tensor, ph: int, pw: int, first: int, h: int, mesh) -> torch.Tensor:
    """'VALID' average pools of window = stride = (ph, pw) over a map of
    ``h`` rows split by height: the band (rows [first, first + x rows)) sums
    its rows of each bin by two f32 matrix products with 0/1 membership
    matrices, and the spatial group adds the sums; every rank of the group
    then holds the (N, C, h // ph, w // pw) pooled map whole."""
    band, w = x.shape[2], x.shape[3]
    rows_of = torch.arange(first, first + band) // ph
    by_h = (torch.arange(h // ph)[:, None] == rows_of[None, :]).float()
    by_w = (torch.arange(w // pw)[:, None] == torch.arange(w)[None, :] // pw).float()
    sums = by_h.to(x.device) @ (x.float() @ by_w.t().to(x.device))
    return (pmesh.spatial_sum(sums, mesh) / (ph * pw)).to(x.dtype)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` at 3x3, stride 1, 'SAME', with bias, as the
    hybrid upsampler uses it (model.py:319-337): with stride 1 and
    ``transpose_kernel=False`` it is a plain conv whose kernel is *not*
    flipped, so ``F.conv2d`` with padding 1 computes it (``nn.ConvTranspose2d``
    would flip the kernel). ``weight`` OIHW f32 (the flax ``kernel`` HWIO),
    ``bias`` f32; computes in the compute dtype."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = pmesh.spatial_mesh()
        x = x.to(self.dtype)
        if mesh is not None:
            return F.conv2d(pmesh.halo(x, 1, 1, mesh), self.weight.to(self.dtype),
                            self.bias.to(self.dtype), padding=(0, 1))
        return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype), padding=1)


class HierarchicalSegmentationModel(nn.Module):
    """Full model; ``forward`` returns the reference's 10-key predictions dict."""

    def __init__(self, taxonomy: Taxonomy, resnet_blocks=None, stride_feature_extractor: int = 8,
                 feature_dims_decreased: int = 256, fused_block: bool = False,
                 dtype: torch.dtype = torch.bfloat16, upsampling_method: str = "bilinear",
                 batch_norm_decay: float = 0.9, root_wgrad_pallas: bool = False,
                 fov_expansion_kernel_size: int = 0, fov_expansion_kernel_rate: int = 0,
                 psp_module: bool = False, fuse_adaptation: bool = False,
                 norm_type: str = "batch", remat: bool = False, bn_impl: str = "flax",
                 mit_widths=None):
        super().__init__()
        if upsampling_method not in ("no", "bilinear", "hybrid"):
            raise ValueError(f"unknown upsampling_method {upsampling_method}")
        self.taxonomy = taxonomy
        self.upsampling_method = upsampling_method
        self.fuse_adaptation = fuse_adaptation
        kw = dict(dtype=dtype, norm_type=norm_type, bn_impl=bn_impl)
        if mit_widths is not None:
            base = MitSegFormer(mit_widths, dtype=dtype, norm_type=norm_type, bn_impl=bn_impl,
                                remat=remat)
        else:
            base = ResNetV1(resnet_blocks or RESNET50_BLOCKS, stride_feature_extractor,
                            fused_block=fused_block, dtype=dtype,
                            root_wgrad_pallas=root_wgrad_pallas, norm_type=norm_type,
                            remat=remat, bn_impl=bn_impl)
        self.add_module("feature_extractor/base", base)
        c = base.depth_out
        self.extension = []
        if feature_dims_decreased > 0:
            self._add_extension("decrease_fdims", ConvNormRelu(c, feature_dims_decreased, 1, **kw))
            c = feature_dims_decreased
        if fov_expansion_kernel_rate > 0 and fov_expansion_kernel_size > 0:
            self._add_extension("increase_fov", ConvNormRelu(
                c, c, fov_expansion_kernel_size, rate=fov_expansion_kernel_rate, **kw))
        self.psp_module = psp_module
        if psp_module:
            self.add_module("feature_extractor/pyramid_module",
                            PSPModule(c, feature_dims_decreased, dtype, norm_type, bn_impl))
            c = feature_dims_decreased
        widths = (taxonomy.num_l1_classes, taxonomy.num_vehicle_classes,
                  taxonomy.num_human_classes)
        self.widths = widths
        # the heads' norm takes one group (a layer norm under group norm)
        head_kw = dict(kw, groups=1)
        if fuse_adaptation:
            self.head_width = max(widths)
            for i, k in ((1, 1), (2, 3), (3, 1)):
                self.add_module(f"adaptation_module/fused/conv{i}", ConvNormRelu(
                    c if i == 1 else 3 * c, 3 * c, k, activation=i != 3,
                    feature_group_count=1 if i == 1 else 3, **kw))
            self.add_module("softmax_classifier/fused_logits", ConvNormRelu(
                3 * c, 3 * self.head_width, 1, activation=False, feature_group_count=3,
                **head_kw))
        else:
            for head, n_out in zip(_HEADS, widths):
                self.add_module(f"adaptation_module/{head}_features",
                                BottleneckV1(c, c, c, **kw))
                self.add_module(f"softmax_classifier/{head}_logits",
                                ConvNormRelu(c, n_out, 1, activation=False, **head_kw))
        if upsampling_method == "hybrid":
            for head, n_out in zip(_HEADS, widths):
                self.add_module(f"softmax_classifier/{head}_logits/upsampling/conv_transpose",
                                ConvTranspose(n_out, dtype))
        for module in self.modules():
            if isinstance(module, Norm):
                module.decay = batch_norm_decay

    @property
    def stochastic(self) -> bool:
        """Whether a training forward draws masks (stochastic depth and
        dropout of ``mit_*``), which ``seed_stochastic`` seeds."""
        return isinstance(self.get_submodule("feature_extractor/base"), MitSegFormer)

    def seed_stochastic(self, seed: int) -> None:
        base = self.get_submodule("feature_extractor/base")
        if isinstance(base, MitSegFormer):
            base.seed_stochastic(seed)

    def _add_extension(self, name: str, module: nn.Module) -> None:
        self.add_module(f"feature_extractor/extension/{name}", module)
        self.extension.append(name)

    def _head_logits(self, x: torch.Tensor) -> list:
        """The three heads' stride-8 logits, NCHW in the compute dtype."""
        if not self.fuse_adaptation:
            return [self.get_submodule(f"softmax_classifier/{head}_logits")(
                self.get_submodule(f"adaptation_module/{head}_features")(x)) for head in _HEADS]
        # the three branches as grouped convs (model.py:276-317): conv1 stacks
        # the branch kernels along its outputs, the shortcut is x three times,
        # and the head outputs are padded to a common width per group
        y = x
        for i in (1, 2):
            y = self.get_submodule(f"adaptation_module/fused/conv{i}")(y)
        feats = self.get_submodule("adaptation_module/fused/conv3")(
            y, residual=torch.cat([x, x, x], 1))
        logits = self.get_submodule("softmax_classifier/fused_logits")(feats)
        hw = self.head_width
        return [logits[:, i * hw:i * hw + n] for i, n in enumerate(self.widths)]

    def forward(self, images: torch.Tensor, upsampling_method: Optional[str] = None) -> dict:
        """images: (N, H, W, 3) float in [-1, 1). ``upsampling_method``
        overrides the model's for this call ("no": stride-8 outputs)."""
        tax = self.taxonomy
        method = upsampling_method or self.upsampling_method
        mesh = pmesh.spatial_mesh()
        hf, wf = images.shape[1], images.shape[2]
        if mesh is not None:
            hf *= mesh.spatial  # the global height; the outputs are this rank's band
        # NHWC -> NCHW view in channels_last memory
        x = self.get_submodule("feature_extractor/base")(images.permute(0, 3, 1, 2))
        for name in self.extension:
            x = self.get_submodule(f"feature_extractor/extension/{name}")(x)
        if self.psp_module:
            x = self.get_submodule("feature_extractor/pyramid_module")(x)
        preds = {}
        for head, logits in zip(_HEADS, self._head_logits(x)):
            if method == "hybrid":
                logits = self.get_submodule(
                    f"softmax_classifier/{head}_logits/upsampling/conv_transpose")(logits)
            # contiguous NHWC (the fused heads' logits are channel slices)
            logits = logits.permute(0, 2, 3, 1).float().contiguous()
            if method != "no" and mesh is not None:
                logits = resize_band(logits, (hf, wf), mesh)
            elif method != "no":
                logits = resize_bilinear_mxu(logits, (hf, wf), align_corners=True)
            preds[f"{head}_logits"] = logits
            preds[f"{head}_probabilities"] = torch.softmax(logits, dim=3)
            preds[f"{head}_decisions"] = torch.argmax(logits, dim=3).int()
        l1 = preds["l1_decisions"]
        preds["decisions"] = torch.where(
            l1 == tax.cid_l1_vehicle,
            gather_cids(tax.l2_vehicle_cids2common_cids, preds["l2_vehicle_decisions"]),
            torch.where(
                l1 == tax.cid_l1_human,
                gather_cids(tax.l2_human_cids2common_cids, preds["l2_human_decisions"]),
                gather_cids(tax.l1_cids2common_cids, l1),
            ),
        )
        return preds


def build_model(settings: Settings, device=None) -> HierarchicalSegmentationModel:
    """The model of ``settings`` on ``device`` (default ``settings.device``),
    the ResNet of ``FEATURE_EXTRACTOR_BLOCKS`` or the MiT of ``MIT_WIDTHS``
    (``Settings.check_feature_extractor`` says what ``mit_*`` refuses),
    with channels_last conv weights, in train mode when ``settings.mode`` is
    train and ``batch_norm_accumulate_statistics`` is set, else in eval
    mode. Weights are uninitialized: load them (utils/convert.py) or draw
    them (``init_model``). ``bn_impl="fused"`` (the default) runs
    train-mode batch norm as ops/fused_bn.py (kernels N1/N2 on the card),
    as the JAX package's FusedBatchNorm; ``conv_impl``, ``dilation_mode``
    and ``root_conv_s2d`` select layouts of the same function on the TPU,
    and the port has one path for all of them."""
    device = resolve_device(device or settings.device)
    settings.check_feature_extractor()
    name = settings.name_feature_extractor
    model = HierarchicalSegmentationModel(
        taxonomy=get_taxonomy(settings.per_pixel_dataset_name),
        resnet_blocks=FEATURE_EXTRACTOR_BLOCKS.get(name),
        mit_widths=MIT_WIDTHS.get(name),
        stride_feature_extractor=settings.stride_feature_extractor,
        feature_dims_decreased=settings.feature_dims_decreased,
        fused_block=settings.fused_block and settings.mode != "train",
        dtype=torch.bfloat16 if settings.compute_dtype == "bfloat16" else torch.float32,
        upsampling_method=settings.upsampling_method,
        batch_norm_decay=settings.batch_norm_decay,
        root_wgrad_pallas=settings.root_wgrad_pallas,
        fov_expansion_kernel_size=settings.fov_expansion_kernel_size,
        fov_expansion_kernel_rate=settings.fov_expansion_kernel_rate,
        psp_module=settings.psp_module,
        fuse_adaptation=settings.fuse_adaptation,
        norm_type=settings.norm_layer,
        remat=settings.remat,
        bn_impl=settings.bn_impl,
    )
    model = model.to(device=device, memory_format=torch.channels_last)
    train = settings.mode == "train" and settings.batch_norm_accumulate_statistics
    return model.train(train)


def _truncated_normal_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax variance scaling, fan-in, truncated normal: std sqrt(scale /
    fan_in), corrected for the truncation at two standard deviations."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    draw = torch.empty(w.shape)
    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
    w.copy_(draw)


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initial values: conv kernels from the slim variance-scaling
    initializer (factor 2, fan-in, truncated normal), the hybrid
    upsampler's from flax's ``lecun_normal`` (factor 1) with a zero bias,
    norm scale 1, bias 0, mean 0, var 1; a ``mit_*`` feature extractor's
    own layers then SegFormer's (``mit.init_mit``). Draws on the CPU from
    ``generator``."""
    for module in model.modules():
        if isinstance(module, ConvTranspose):
            _truncated_normal_(module.weight, 1.0, generator)
            module.bias.fill_(0.0)
        elif hasattr(module, "weight") and module.weight.dim() == 4:
            _truncated_normal_(module.weight, 2.0, generator)
        elif isinstance(module, Norm) and module.norm_type != "none":
            module.scale.fill_(1.0)
            module.bias.fill_(0.0)
            if module.norm_type == "batch":
                module.mean.fill_(0.0)
                module.var.fill_(1.0)
    for module in model.modules():
        if isinstance(module, MitSegFormer):
            init_mit(module, generator)
    return model

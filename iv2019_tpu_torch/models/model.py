"""Hierarchical segmentation model: dilated ResNet-50 + three heads.

Port of the default path of iv2019_tpu/models/model.py::

    images -> ResNet-v1 trunk (output stride 8)
           -> extension 1x1 conv 2048 -> 256
           -> three bottleneck adaptation branches (never fused)
           -> 1x1 logit heads with their BatchNorm (L1 / L2-vehicle / L2-human)
           -> x8 bilinear upsample, align_corners=True, f32
              (``upsampling_method="no"``: the stride-8 logits, f32)
           -> softmax / first-max argmax per head, f32
           -> hierarchical decision fusion into the common label space

BatchNorm runs on batch statistics in train mode (``model.train()``) and on
running statistics in eval mode; ``build_model`` picks the mode from the
settings.

Public tensors are NHWC, like the JAX package's: ``forward`` takes
(N, H, W, 3) images in [-1, 1) and returns the same ten-key dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.models.layers import BottleneckV1, ConvNormRelu, Norm
from iv2019_tpu_torch.models.resnet import FEATURE_EXTRACTOR_BLOCKS, RESNET50_BLOCKS, ResNetV1
from iv2019_tpu_torch.ops.resize import resize_bilinear_mxu
from iv2019_tpu_torch.ops.segment_ops import gather_cids
from iv2019_tpu_torch.problem.taxonomy import Taxonomy, get_taxonomy

__all__ = ["HierarchicalSegmentationModel", "build_model", "init_model", "resolve_device"]

_HEADS = ("l1", "l2_vehicle", "l2_human")


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; no silent fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


class HierarchicalSegmentationModel(nn.Module):
    """Full model; ``forward`` returns the reference's 10-key predictions dict."""

    def __init__(self, taxonomy: Taxonomy, resnet_blocks=None, stride_feature_extractor: int = 8,
                 feature_dims_decreased: int = 256, fused_block: bool = False,
                 dtype: torch.dtype = torch.bfloat16, upsampling_method: str = "bilinear",
                 batch_norm_decay: float = 0.9, root_wgrad_pallas: bool = False):
        super().__init__()
        if upsampling_method not in ("no", "bilinear"):
            raise NotImplementedError(f"upsampling_method={upsampling_method} is not ported yet")
        self.taxonomy = taxonomy
        self.upsampling_method = upsampling_method
        base = ResNetV1(resnet_blocks or RESNET50_BLOCKS, stride_feature_extractor,
                        fused_block=fused_block, dtype=dtype, root_wgrad_pallas=root_wgrad_pallas)
        self.add_module("feature_extractor/base", base)
        c = base.depth_out
        self.has_extension = feature_dims_decreased > 0
        if self.has_extension:
            self.add_module("feature_extractor/extension/decrease_fdims",
                            ConvNormRelu(c, feature_dims_decreased, 1, dtype=dtype))
            c = feature_dims_decreased
        widths = (taxonomy.num_l1_classes, taxonomy.num_vehicle_classes,
                  taxonomy.num_human_classes)
        for head, n_out in zip(_HEADS, widths):
            self.add_module(f"adaptation_module/{head}_features",
                            BottleneckV1(c, c, c, dtype=dtype))
            self.add_module(f"softmax_classifier/{head}_logits",
                            ConvNormRelu(c, n_out, 1, activation=False, dtype=dtype))
        for module in self.modules():
            if isinstance(module, Norm):
                module.decay = batch_norm_decay

    def forward(self, images: torch.Tensor, upsampling_method: Optional[str] = None) -> dict:
        """images: (N, H, W, 3) float in [-1, 1). ``upsampling_method``
        overrides the model's for this call ("no": stride-8 outputs)."""
        tax = self.taxonomy
        upsample = (upsampling_method or self.upsampling_method) != "no"
        hf, wf = images.shape[1], images.shape[2]
        # NHWC -> NCHW view in channels_last memory
        x = self.get_submodule("feature_extractor/base")(images.permute(0, 3, 1, 2))
        if self.has_extension:
            x = self.get_submodule("feature_extractor/extension/decrease_fdims")(x)
        preds = {}
        for head in _HEADS:
            feat = self.get_submodule(f"adaptation_module/{head}_features")(x)
            logits = self.get_submodule(f"softmax_classifier/{head}_logits")(feat)
            logits = logits.permute(0, 2, 3, 1).float()
            if upsample:
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
    with channels_last conv weights, in train mode when ``settings.mode`` is
    train and ``batch_norm_accumulate_statistics`` is set, else in eval
    mode. Weights are uninitialized: load them (utils/convert.py) or draw
    them (``init_model``)."""
    unported = {
        "psp_module": settings.psp_module,
        "fov_expansion": settings.fov_expansion_kernel_rate or settings.fov_expansion_kernel_size,
        "norm_layer=group": settings.norm_layer != "batch",
        f"upsampling_method={settings.upsampling_method}":
            settings.upsampling_method not in ("no", "bilinear"),
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported to the PyTorch package yet")
    device = resolve_device(device or settings.device)
    model = HierarchicalSegmentationModel(
        taxonomy=get_taxonomy(settings.per_pixel_dataset_name),
        resnet_blocks=FEATURE_EXTRACTOR_BLOCKS[settings.name_feature_extractor],
        stride_feature_extractor=settings.stride_feature_extractor,
        feature_dims_decreased=settings.feature_dims_decreased,
        fused_block=settings.fused_block and settings.mode != "train",
        dtype=torch.bfloat16 if settings.compute_dtype == "bfloat16" else torch.float32,
        upsampling_method=settings.upsampling_method,
        batch_norm_decay=settings.batch_norm_decay,
        root_wgrad_pallas=settings.root_wgrad_pallas,
    )
    model = model.to(device=device, memory_format=torch.channels_last)
    train = settings.mode == "train" and settings.batch_norm_accumulate_statistics
    return model.train(train)


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initial values: conv kernels from the slim variance-scaling
    initializer (factor 2, fan-in, truncated normal), BatchNorm scale 1,
    bias 0, mean 0, var 1. Draws on the CPU from ``generator``."""
    for module in model.modules():
        if hasattr(module, "weight") and module.weight.dim() == 4:
            w = module.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            # the truncated normal's std is corrected to the target variance
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            draw = torch.empty(w.shape)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
            w.copy_(draw)
        elif isinstance(module, Norm):
            module.scale.fill_(1.0)
            module.bias.fill_(0.0)
            module.mean.fill_(0.0)
            module.var.fill_(1.0)
    return model

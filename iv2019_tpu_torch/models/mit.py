"""MiT (Mix Transformer) encoder and SegFormer's all-MLP decoder.

SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203; NVlabs/SegFormer
``mmseg/models/backbones/mix_transformer.py`` and
``mmseg/models/decode_heads/segformer_head.py``) as the feature extractor of
the hierarchical model: its output, 768 channels (256 for ``mit_b0``) at
output stride 4, takes the place of the ResNet trunk's 2048 at stride 8,
and models/model.py puts the extension, the adaptation branches and the
three heads on it.

- Four stages. Each starts with an overlapping patch embedding (a conv
  with bias, 7x7/4 padding 3 for stage 1, 3x3/2 padding 1 after, then a
  LayerNorm, eps 1e-5), runs its blocks on the (B, h w, C) tokens and ends
  with a LayerNorm (eps 1e-6).
- A block: ``x + attn(norm1(x))`` then ``x + mlp(norm2(x))`` (LayerNorms
  eps 1e-6). Attention: queries from every token; keys and values from the
  tokens reduced by a conv of kernel and stride R (with bias) and a
  LayerNorm (eps 1e-5) where the stage's ratio R > 1, else from every
  token; heads of 64 channels, scores scaled by 64^-1/2, qkv biases; it
  runs through ops/attention.py (FlashAttention on the card). Mix-FFN:
  Linear C -> 4C, a 3x3 depthwise conv with bias, exact GELU, Linear 4C
  -> C.
- Stochastic depth: block i of all n drops its two residual branches with
  probability ``drop_path_rate * i / (n - 1)`` per image (``DropPath``),
  scaling kept ones by 1 / (1 - p); the decoder drops whole channels with
  probability ``dropout`` per image (mmseg's ``Dropout2d``). Both only in
  training (``module.train()``).
- Decoder: a Linear from each stage's C to D, each map resized to stage
  1's size (bilinear, ``align_corners=False``), the concatenation [c4, c3,
  c2, c1] (4D channels), a 1x1 conv without bias, BatchNorm and ReLU (the
  port's ``ConvNormRelu``, so kernels N1/N2 in training), then the
  channel dropout. SegFormer's ``linear_pred`` classifier is the hierarchical
  model's heads.

Masks. Every mask a forward uses comes from two draws of a
``torch.Generator`` on the model's device, made at the start of the
forward in this order: ``torch.rand((blocks, 2, B))`` (block i's attention
and MLP branch keep image b where the draw is at least the block's
probability, held as float32 in ``drop_path``) and ``torch.rand((B, D))``
for the channels (kept where at least ``dropout``). ``seed_stochastic(s)``
seeds the generator; the train step seeds it with ``mask_seed(random_seed,
fold)`` before each microbatch (train/step.py), so a reference that makes
the same two draws from the same seed on the same device has the same
masks. The masks are drawn outside the blocks, so a recomputed block
(``remat``: each block under ``torch.utils.checkpoint`` when autograd
records) applies the masks of its forward.

CUDA graphs: a training forward on the card, with autograd recording, no
``remat`` and every parameter holding a gradient buffer (the fused
optimizer's), runs each stage's forward and backward from a CUDA graph
captured on the second forward of its input shapes (``_stage_graphs``): the
52 blocks are thousands of small kernels a step, which the host could not
enqueue as fast as the card runs them. The masks are inputs of the graphs.

Precision: activations in the compute dtype; LayerNorm, GELU and the
softmax keep their statistics and sums in float32 inside PyTorch's
kernels; parameters are float32 and cast to the compute dtype where they
are used, so their gradients are float32. LayerNorm's weight is named
``scale`` (flax's name), so that weight decay, which the port's optimizer
applies to ``.weight`` leaves alone, leaves the norms alone, as
SegFormer's ``decay_mult=0`` on norms does.

Spans (utils/spans.py): ``iv.mit.stage1`` .. ``iv.mit.stage4`` and
``iv.mit.decoder``, once a forward each (around a stage's replay too),
inside the step's forward span.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from iv2019_tpu_torch.models.layers import ConvNormRelu
from iv2019_tpu_torch.ops.attention import attention
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.utils.spans import span

__all__ = ["MIT_WIDTHS", "MitSegFormer", "MitWidths", "init_mit", "mask_seed"]


class MitWidths(NamedTuple):
    """The widths of one MiT variant and its decoder (``mit_bN`` of
    mix_transformer.py and ``decoder_params.embed_dim`` of its configs)."""

    embed_dims: tuple
    heads: tuple
    depths: tuple
    sr_ratios: tuple
    mlp_ratio: int
    decoder_dim: int
    drop_path_rate: float
    dropout: float


MIT_WIDTHS = {
    # the CPU tests' size
    "mit_b0": MitWidths((32, 64, 160, 256), (1, 2, 5, 8), (2, 2, 2, 2), (8, 4, 2, 1), 4, 256,
                        0.1, 0.1),
    "mit_b5": MitWidths((64, 128, 320, 512), (1, 2, 5, 8), (3, 6, 40, 3), (8, 4, 2, 1), 4, 768,
                        0.1, 0.1),
}
# LayerNorm epsilons: the blocks' and stages' (``partial(nn.LayerNorm,
# eps=1e-6)``), and the patch embeddings' and key reductions' (the default)
BLOCK_EPS, EMBED_EPS = 1e-6, 1e-5


def mask_seed(random_seed: int, fold: int, shard: int = 0) -> int:
    """The mask generator's seed for microbatch ``fold`` (step x accum + i)
    of a run seeded ``random_seed``, on batch shard ``shard`` (< 1024)."""
    return (int(random_seed) * (1 << 32) + int(fold) * 1024 + int(shard)) % (1 << 63)


class Linear(nn.Module):
    """``nn.Linear``'s parameters (weight (out, in), bias), f32, applied in
    the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """``nn.Conv2d`` with bias (weight OIHW, f32), applied in the input's
    dtype."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding, groups=self.groups)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, in x's dtype with the statistics and the
    parameters' gradients summed in f32. PyTorch's CUDA kernels do so for
    bf16; its CPU kernel sums the parameters' gradients in bf16 (6-26% off
    over 4k-33k rows on one thread), so CPU tensors go through f32."""
    if x.device.type == "cpu" and x.dtype != torch.float32:
        y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
        return y.to(x.dtype)
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; parameters ``scale`` and ``bias`` (f32)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale.to(x.dtype), self.bias.to(x.dtype), self.eps)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h w, C); a view of a channels_last map."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h w, C) -> (B, C, h, w) in channels_last memory, a view."""
    return x.view(x.shape[0], h, w, x.shape[2]).permute(0, 3, 1, 2)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int):
        super().__init__()
        self.proj = Conv2d(cin, cout, kernel_size, stride, kernel_size // 2)
        self.norm = LayerNorm(cout, EMBED_EPS)

    def forward(self, x: torch.Tensor):
        y = self.proj(x)
        return self.norm(_tokens(y)), y.shape[2], y.shape[3]


class Attention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens
    reduced by ``sr_ratio`` (spatial-reduction attention)."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.scale = (dim // heads) ** -0.5
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = LayerNorm(dim, EMBED_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).view(b, n, self.heads, d).transpose(1, 2)
        kv_in = self.norm(_tokens(self.sr(_map(x, h, w)))) if self.sr_ratio > 1 else x
        kv = self.kv(kv_in).view(b, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        out = attention(q, kv[0], kv[1], self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _tokens(self.dwconv(_map(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


def _residual(x: torch.Tensor, y: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """x + y, y scaled by its image's keep factor (B,) when there is one."""
    if keep is None:
        return x + y
    return torch.addcmul(x, y, keep[:, None, None])


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, BLOCK_EPS)
        self.attn = Attention(dim, heads, sr_ratio)
        self.norm2 = LayerNorm(dim, BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int, keep_attn: Optional[torch.Tensor] = None,
                keep_mlp: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _residual(x, self.attn(self.norm1(x), h, w), keep_attn)
        return _residual(x, self.mlp(self.norm2(x), h, w), keep_mlp)


class Stage(nn.Module):
    """One stage as one callable: patch embedding, blocks (each recomputed
    in the backward under ``remat``), norm; (B, Cin, H, W) -> (B, C, h, w)
    channels_last. It holds the encoder's own modules, and the encoder does
    not register it (the parameters keep their names)."""

    def __init__(self, embed: OverlapPatchEmbed, blocks: nn.ModuleList, norm: LayerNorm):
        super().__init__()
        self.embed, self.blocks, self.norm = embed, blocks, norm

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                remat: bool = False) -> torch.Tensor:
        t, h, w = self.embed(x)
        for i, block in enumerate(self.blocks):
            masks = (None, None) if keep is None else keep[i]
            if remat and torch.is_grad_enabled():
                t = torch.utils.checkpoint.checkpoint(block, t, h, w, *masks,
                                                      use_reentrant=False)
            else:
                t = block(t, h, w, *masks)
        return _map(self.norm(t), h, w)


class MLPDecode(nn.Module):
    """SegFormer's ``MLP``: one Linear on the tokens."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)


class SegFormerHead(nn.Module):
    def __init__(self, embed_dims, dim: int, dtype: torch.dtype, norm_type: str, bn_impl: str):
        super().__init__()
        for i, c in enumerate(embed_dims):
            self.add_module(f"linear_c{i + 1}", MLPDecode(c, dim))
        self.linear_fuse = ConvNormRelu(len(embed_dims) * dim, dim, 1, dtype=dtype,
                                        norm_type=norm_type, bn_impl=bn_impl)

    def forward(self, feats: list, keep: Optional[torch.Tensor]) -> torch.Tensor:
        h1, w1 = feats[0].shape[2], feats[0].shape[3]
        ups = []
        for i in reversed(range(len(feats))):
            f = feats[i]
            y = _map(self.get_submodule(f"linear_c{i + 1}").proj(_tokens(f)), f.shape[2],
                     f.shape[3])
            if (f.shape[2], f.shape[3]) != (h1, w1):
                y = F.interpolate(y, size=(h1, w1), mode="bilinear", align_corners=False)
            ups.append(y)
        y = self.linear_fuse(torch.cat(ups, 1).contiguous(memory_format=torch.channels_last))
        if keep is not None:
            y = y * keep[:, :, None, None]
        return y


class MitSegFormer(nn.Module):
    """The MiT encoder and SegFormer's decoder: (B, 3, H, W) images ->
    (B, D, ceil(H / 4), ceil(W / 4)) in the compute dtype, channels_last."""

    def __init__(self, widths: MitWidths, dtype: torch.dtype = torch.bfloat16,
                 norm_type: str = "batch", bn_impl: str = "flax", remat: bool = False):
        super().__init__()
        self.widths, self.dtype, self.remat = widths, dtype, remat
        self.depth_out = widths.decoder_dim
        cin = 3
        for i, c in enumerate(widths.embed_dims):
            self.add_module(f"patch_embed{i + 1}",
                            OverlapPatchEmbed(cin, c, 7 if i == 0 else 3, 4 if i == 0 else 2))
            self.add_module(f"block{i + 1}", nn.ModuleList(
                Block(c, widths.heads[i], widths.mlp_ratio, widths.sr_ratios[i])
                for _ in range(widths.depths[i])))
            self.add_module(f"norm{i + 1}", LayerNorm(c, BLOCK_EPS))
            cin = c
        self.decode_head = SegFormerHead(widths.embed_dims, widths.decoder_dim, dtype, norm_type,
                                         bn_impl)
        n = sum(widths.depths)
        # mix_transformer.py's dpr: torch.linspace's values as Python floats
        dpr = [float(p) for p in torch.linspace(0, widths.drop_path_rate, n)]
        self.register_buffer("drop_path", torch.tensor(dpr, dtype=torch.float32),
                             persistent=False)
        self.stages = [Stage(self.get_submodule(f"patch_embed{i + 1}"),
                             self.get_submodule(f"block{i + 1}"),
                             self.get_submodule(f"norm{i + 1}")) for i in range(len(widths.depths))]
        self._generator = None
        self._seed = 0
        # input signature -> the stages' first inputs, then their CUDA graphs
        self._graphs = {}

    def seed_stochastic(self, seed: int) -> None:
        """Seed the generator of the next forward's masks."""
        self._seed = int(seed)
        if self._generator is not None:
            self._generator.manual_seed(self._seed)

    def _draw(self, n: int, device: torch.device):
        """(keep (blocks, 2, n), channel keep (n, D)), float32 factors 0 or
        1 / (1 - p); None when not training."""
        if not self.training:
            return None, None
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self._seed)
        g, p = self._generator, self.drop_path
        u = torch.rand((p.shape[0], 2, n), generator=g, device=device)
        keep = (u >= p[:, None, None]).float() / (1.0 - p)[:, None, None]
        rate = self.widths.dropout
        c = torch.rand((n, self.depth_out), generator=g, device=device)
        return keep, (c >= rate).float() / (1.0 - rate)

    def _stage_graphs(self, x: torch.Tensor, keep: Optional[torch.Tensor]):
        """(the stages' graphed callables, or None; a list to record the
        stages' inputs in, or None).

        A training forward on the card with autograd recording and no
        ``remat`` runs the four stages from CUDA graphs
        (``torch.cuda.make_graphed_callables``, forward and backward): the
        host enqueues a stage's hundreds of small kernels once, at capture,
        and a step's pace is the card's, not the host's. The first forward
        of an input signature runs eagerly and records what each stage took;
        the next one captures, the first one's activations freed by then.
        Only where every parameter of the stages has a ``.grad`` buffer (the
        fused optimizer's views of its flat buffer): autograd then adds a
        replay's gradients into it, and never keeps the graph's own buffer,
        which the next replay overwrites. The capture needs the last
        forward's autograd graph freed, as the train step frees it: a
        parameter's gradient accumulator made on the default stream and
        still alive would be the capture's, and no capture may wait on the
        default stream."""
        if not (self.training and x.is_cuda and torch.is_grad_enabled() and not self.remat):
            return None, None
        if any(p.grad is None for stage in self.stages for p in stage.parameters()):
            return None, None
        key = (tuple(x.shape), x.stride(), x.dtype, tuple(keep.shape))
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = entry = []
            return None, entry
        if isinstance(entry, list):
            samples = tuple(
                (torch.empty_strided(shape, stride, dtype=dtype, device=x.device).zero_()
                 .requires_grad_(grad), torch.zeros(keep_shape, dtype=keep.dtype, device=x.device))
                for shape, stride, dtype, grad, keep_shape in entry)
            torch.cuda.make_graphed_callables(tuple(self.stages), samples)
            # make_graphed_callables puts each graph in its stage's forward
            entry = self._graphs[key] = tuple(stage.__dict__.pop("forward")
                                              for stage in self.stages)
        return entry, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if pmesh.spatial_mesh() is not None:
            raise ValueError("MiT attends over every token of the image: a band of rows "
                             "has no halo that holds its keys (spatial_partitions must be 1)")
        keep, channel_keep = self._draw(x.shape[0], x.device)
        if keep is not None:
            keep, channel_keep = keep.to(self.dtype), channel_keep.to(self.dtype)
        x = x.to(self.dtype)
        graphs, record = self._stage_graphs(x, keep)
        feats, first = [], 0
        for s, stage in enumerate(self.stages):
            blocks = len(stage.blocks)
            stage_keep = None if keep is None else keep[first:first + blocks]
            first += blocks
            with span(f"iv.mit.stage{s + 1}"):
                if graphs is not None:
                    # a replayed stage counts its attention calls as run
                    attention.launches += blocks
                    x = graphs[s](x, stage_keep)
                else:
                    if record is not None:
                        record.append((x.shape, x.stride(), x.dtype, x.requires_grad,
                                       stage_keep.shape))
                    x = stage(x, stage_keep, self.remat)
            feats.append(x)
        with span("iv.mit.decoder"):
            return self.decode_head(feats, channel_keep)


@torch.no_grad()
def init_mit(module: MitSegFormer, generator: torch.Generator) -> MitSegFormer:
    """SegFormer's ``_init_weights``: Linear weights truncated normal (std
    0.02, cut at +-2 as timm's ``trunc_normal_`` cuts: absolute bounds,
    so no cut in practice), convs normal with std sqrt(2 / fan_out), fan_out =
    k^2 out / groups, biases 0, LayerNorms 1 and 0. Draws on the CPU from
    ``generator``; the decoder's fuse conv and norm keep init_model's."""
    for m in module.modules():
        if isinstance(m, Linear):
            draw = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(draw, 0.0, 0.02, -2.0, 2.0, generator=generator)
            m.weight.copy_(draw)
            m.bias.fill_(0.0)
        elif isinstance(m, Conv2d):
            k = m.weight.shape[2]
            fan_out = k * k * m.weight.shape[0] // m.groups
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_out))
            m.bias.fill_(0.0)
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.fill_(0.0)
    return module

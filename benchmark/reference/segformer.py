"""SegFormer-B5 under the paper's hierarchical heads, in plain PyTorch,
float32: the benchmark's reference of ``segformer_*`` configurations.

The model of NVlabs/SegFormer (``mmseg/models/backbones/mix_transformer.py``,
``mmseg/models/decode_heads/segformer_head.py``; arXiv:2105.15203) read from
the configuration alone: four stages of overlapping patch embeddings
(conv with bias, LayerNorm eps 1e-5), blocks of spatial-reduction attention
(keys and values from a stride-R conv and a LayerNorm eps 1e-5; scores
scaled by d^-1/2, computed image by image in plain matrix products) and
Mix-FFN (Linear, 3x3 depthwise conv, exact GELU, Linear), pre-norm with
LayerNorms eps 1e-6, a LayerNorm at each stage's end; the all-MLP decoder
(a Linear a stage to the decoder width, bilinear resize to stage 1's size
without aligned corners, concatenation [c4, c3, c2, c1], 1x1 conv, batch
norm, ReLU). Parameters are a dict keyed by the program's names.

Departures from NVlabs, each the system's:

- SegFormer's ``linear_pred`` is replaced by the paper's extension (1x1
  conv to ``feature_dims_decreased``, batch norm, ReLU), the three
  bottleneck adaptation branches and the L1 / vehicle / human logit convs
  with their norms (``benchmark/reference/model.py``'s heads);
- the logits are upsampled x4 bilinearly with aligned corners, and the
  losses are the paper's hierarchical ones (``steps.losses``);
- SGD with momentum and weight decay on ``.weight`` leaves (``steps``'
  optimizer) in place of AdamW;
- LayerNorm weights are named ``scale``; images come in [-1, 1];
- stochastic depth (``drop_path_rate`` over the blocks, linearly from 0)
  and the decoder's channel dropout take their masks from two draws of a
  ``torch.Generator`` on the images' device seeded ``mask_seed(random
  seed, step)``: ``torch.rand((blocks, 2, N))`` kept where at least the
  block's probability, then ``torch.rand((N, D))`` kept where at least the
  dropout, the program's order, so both sides drop the same branches.

``rnd`` rounds at the images, every weight, every layer's output and every
residual sum (``model.rounding``). ``SCORE_SCALE`` gives the attention's
score scale from the head width; a fault replaces it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import steps as ref_steps
from benchmark.reference.model import HEADS, upsample

__all__ = ["SCORE_SCALE", "draw_masks", "forward", "mask_seed", "param_spec", "train_steps",
           "widths"]

BASE = "feature_extractor/base"


def SCORE_SCALE(d: int) -> float:  # noqa: N802 (a replaceable constant)
    return d ** -0.5


def widths(cfg: dict) -> tuple:
    """(embed dims, heads, depths, reduction ratios, MLP ratio, decoder
    width) of a configuration."""
    return (tuple(cfg["embed_dims"]), tuple(cfg["num_heads"]), tuple(cfg["depths"]),
            tuple(cfg["sr_ratios"]), cfg["mlp_ratio"], cfg["decoder_embed_dim"])


def mask_seed(random_seed: int, fold: int) -> int:
    return (int(random_seed) * (1 << 32) + int(fold) * 1024) % (1 << 63)


def draw_masks(cfg: dict, seed: int, n: int, device):
    """(keep (blocks, 2, n), channel keep (n, D)) of one training forward."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    blocks = sum(cfg["depths"])
    p = torch.tensor([float(v) for v in torch.linspace(0, cfg["drop_path_rate"], blocks)],
                     dtype=torch.float32, device=device)
    u = torch.rand((blocks, 2, n), generator=g, device=device)
    keep = (u >= p[:, None, None]).float() / (1.0 - p)[:, None, None]
    rate = cfg["decoder_dropout"]
    c = torch.rand((n, cfg["decoder_embed_dim"]), generator=g, device=device)
    return keep, (c >= rate).float() / (1.0 - rate)


def _cnr(prefix, cin, cout, k):
    return [(f"{prefix}.conv.weight", (cout, cin, k, k))] + [
        (f"{prefix}.norm.{leaf}", (cout,)) for leaf in ("scale", "bias", "mean", "var")]


def _lin(prefix, cin, cout):
    return [(f"{prefix}.weight", (cout, cin)), (f"{prefix}.bias", (cout,))]


def _ln(prefix, c):
    return [(f"{prefix}.scale", (c,)), (f"{prefix}.bias", (c,))]


def _conv(prefix, cin, cout, k, groups=1):
    return [(f"{prefix}.weight", (cout, cin // groups, k, k)), (f"{prefix}.bias", (cout,))]


def param_spec(cfg: dict) -> list:
    """[(name, shape)] of every parameter and running statistic."""
    dims, _, depths, srs, ratio, dec = widths(cfg)
    spec, cin = [], 3
    for s, c in enumerate(dims):
        pe = f"{BASE}.patch_embed{s + 1}"
        spec += _conv(f"{pe}.proj", cin, c, cfg["patch_sizes"][s]) + _ln(f"{pe}.norm", c)
        for b in range(depths[s]):
            blk = f"{BASE}.block{s + 1}.{b}"
            spec += _ln(f"{blk}.norm1", c) + _lin(f"{blk}.attn.q", c, c) \
                + _lin(f"{blk}.attn.kv", c, 2 * c) + _lin(f"{blk}.attn.proj", c, c)
            if srs[s] > 1:
                spec += _conv(f"{blk}.attn.sr", c, c, srs[s]) + _ln(f"{blk}.attn.norm", c)
            spec += _ln(f"{blk}.norm2", c) + _lin(f"{blk}.mlp.fc1", c, ratio * c) \
                + _conv(f"{blk}.mlp.dwconv.dwconv", ratio * c, ratio * c, 3, ratio * c) \
                + _lin(f"{blk}.mlp.fc2", ratio * c, c)
        spec += _ln(f"{BASE}.norm{s + 1}", c)
        cin = c
    for s, c in enumerate(dims):
        spec += _lin(f"{BASE}.decode_head.linear_c{s + 1}.proj", c, dec)
    spec += _cnr(f"{BASE}.decode_head.linear_fuse", len(dims) * dec, dec, 1)
    f = cfg["feature_dims_decreased"]
    spec += _cnr("feature_extractor/extension/decrease_fdims", dec, f, 1)
    for head, n in zip(HEADS, cfg["heads"]):
        spec += _cnr(f"adaptation_module/{head}_features.conv1", f, f, 1) \
            + _cnr(f"adaptation_module/{head}_features.conv2", f, f, 3) \
            + _cnr(f"adaptation_module/{head}_features.conv3", f, f, 1) \
            + _cnr(f"softmax_classifier/{head}_logits", f, n, 1)
    return spec


class _Net:
    def __init__(self, p, cfg, rnd):
        self.p, self.cfg = p, cfg
        self.r = rnd or (lambda t: t)
        self.eps, self.embed_eps = cfg["layer_norm_eps"], cfg["embed_layer_norm_eps"]

    def w(self, name):
        return self.r(self.p[name])

    def linear(self, x, prefix):
        return self.r(F.linear(x, self.w(f"{prefix}.weight"), self.w(f"{prefix}.bias")))

    def conv(self, x, prefix, stride=1, padding=0, groups=1):
        return self.r(F.conv2d(x, self.w(f"{prefix}.weight"), self.w(f"{prefix}.bias"), stride,
                               padding, groups=groups))

    def ln(self, x, prefix, eps):
        return self.r(F.layer_norm(x, (x.shape[-1],), self.p[f"{prefix}.scale"],
                                   self.p[f"{prefix}.bias"], eps))

    def bn(self, x, prefix):
        """Train-mode batch norm (the batch's statistics, biased variance)."""
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.cfg["batch_norm_epsilon"])[
            :, None, None]
        return self.r(y * self.p[f"{prefix}.scale"][:, None, None]
                      + self.p[f"{prefix}.bias"][:, None, None])

    def cnr(self, x, prefix, relu=True):
        k = self.p[f"{prefix}.conv.weight"].shape[-1]
        y = self.bn(self.r(F.conv2d(x, self.w(f"{prefix}.conv.weight"), padding=k // 2)),
                    f"{prefix}.norm")
        return torch.relu(y) if relu else y

    def attention(self, x, prefix, heads, sr, h, w):
        b, n, c = x.shape
        d = c // heads
        q = self.linear(x, f"{prefix}.q").reshape(b, n, heads, d).permute(0, 2, 1, 3)
        if sr > 1:
            m = x.transpose(1, 2).reshape(b, c, h, w)
            kv_in = self.ln(self.conv(m, f"{prefix}.sr", sr).flatten(2).transpose(1, 2),
                            f"{prefix}.norm", self.embed_eps)
        else:
            kv_in = x
        kv = self.linear(kv_in, f"{prefix}.kv").reshape(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
        scale = SCORE_SCALE(d)
        outs = []
        for i in range(b):  # the scores of one image at a time
            scores = (q[i] @ kv[0][i].transpose(-2, -1)) * scale
            outs.append(self.r(torch.softmax(scores, -1) @ kv[1][i]))
        o = torch.stack(outs).transpose(1, 2).reshape(b, n, c)
        return self.linear(o, f"{prefix}.proj")

    def mlp(self, x, prefix, h, w):
        y = self.linear(x, f"{prefix}.fc1")
        b, n, c = y.shape
        y = self.conv(y.transpose(1, 2).reshape(b, c, h, w), f"{prefix}.dwconv.dwconv", 1, 1, c)
        y = self.r(F.gelu(y.flatten(2).transpose(1, 2)))
        return self.linear(y, f"{prefix}.fc2")

    def block(self, x, prefix, heads, sr, h, w, ka, km):
        y = self.attention(self.ln(x, f"{prefix}.norm1", self.eps), f"{prefix}.attn", heads, sr,
                           h, w)
        x = self.r(x + (y if ka is None else y * ka[:, None, None]))
        y = self.mlp(self.ln(x, f"{prefix}.norm2", self.eps), f"{prefix}.mlp", h, w)
        return self.r(x + (y if km is None else y * km[:, None, None]))

    def bottleneck(self, x, prefix):
        y = self.cnr(x, f"{prefix}.conv1")
        y = self.cnr(y, f"{prefix}.conv2")
        y = self.cnr(y, f"{prefix}.conv3", relu=False)
        return torch.relu(self.r(x + y))


def forward(params: dict, images: torch.Tensor, cfg: dict, masks=None, rnd=None,
            remat: bool = False) -> list:
    """images (N, H, W, 3) in [-1, 1] -> the three heads' stride-4 logits,
    (N, C, h, w) float32, in training mode (batch norm on the batch's
    statistics; ``masks``, from ``draw_masks``, applied). ``remat``: each
    block, and the decoder and heads, recompute their activations in the
    backward."""
    dims, nheads, depths, srs, _, _ = widths(cfg)
    net = _Net(params, cfg, rnd)
    keep, channel_keep = masks if masks is not None else (None, None)
    grad = remat and torch.is_grad_enabled()
    x = net.r(images.permute(0, 3, 1, 2).float())
    feats, index = [], 0
    for s in range(len(dims)):
        pe = f"{BASE}.patch_embed{s + 1}"
        k = cfg["patch_sizes"][s]
        y = net.conv(x, f"{pe}.proj", cfg["patch_strides"][s], k // 2)
        h, w = y.shape[2], y.shape[3]
        t = net.ln(y.flatten(2).transpose(1, 2), f"{pe}.norm", net.embed_eps)
        for b in range(depths[s]):
            ka = km = None
            if keep is not None:
                ka, km = keep[index, 0], keep[index, 1]

            def blk(t, ka=ka, km=km, prefix=f"{BASE}.block{s + 1}.{b}", heads=nheads[s],
                    sr=srs[s], h=h, w=w):
                return net.block(t, prefix, heads, sr, h, w, ka, km)
            t = checkpoint(blk, t, use_reentrant=False) if grad else blk(t)
            index += 1
        t = net.ln(t, f"{BASE}.norm{s + 1}", net.eps)
        x = t.transpose(1, 2).reshape(t.shape[0], -1, h, w)
        feats.append(x)

    def decode(*feats):
        h1, w1 = feats[0].shape[2], feats[0].shape[3]
        ups = []
        for s in reversed(range(len(feats))):
            f = feats[s]
            y = net.linear(f.flatten(2).transpose(1, 2),
                           f"{BASE}.decode_head.linear_c{s + 1}.proj")
            y = y.transpose(1, 2).reshape(f.shape[0], -1, f.shape[2], f.shape[3])
            if (f.shape[2], f.shape[3]) != (h1, w1):
                y = net.r(F.interpolate(y, size=(h1, w1), mode="bilinear", align_corners=False))
            ups.append(y)
        x = net.cnr(torch.cat(ups, 1), f"{BASE}.decode_head.linear_fuse")
        if channel_keep is not None:
            x = net.r(x * channel_keep[:, :, None, None])
        return net.cnr(x, "feature_extractor/extension/decrease_fdims")

    x = checkpoint(decode, *feats, use_reentrant=False) if grad else decode(*feats)
    logits = []
    for head in HEADS:
        def branch(x, head=head):
            y = net.bottleneck(x, f"adaptation_module/{head}_features")
            return net.cnr(y, f"softmax_classifier/{head}_logits", relu=False).float()
        logits.append(checkpoint(branch, x, use_reentrant=False) if grad else branch(x))
    return logits


def train_steps(params: dict, batches: list, cfg: dict, random_seed: int, rnd=None) -> dict:
    """One SGDM step a batch from ``params`` (left as they are), step i's
    masks from ``mask_seed(random_seed, i)``: the losses of each step
    (floats), the first step's gradient of every parameter, the parameters
    after the last step. Blocks, decoder and heads recompute their
    activations in the backward, so that a step at 8 x 1024x1024 fits beside
    the program's freed memory."""
    names = [k for k in params if not k.endswith((".mean", ".var"))]
    w = {k: params[k].detach().clone().float() for k in params}
    mom = {k: torch.zeros_like(w[k]) for k in names}
    lr, mu, wd = cfg["learning_rate_values"][0], cfg["momentum"], cfg["weight_decay"]
    out = {"losses": [], "first_grads": None}
    for i, batch in enumerate(batches):
        images = torch.cat([batch[k] for k in ("proimages_per_pixel", "proimages_per_bbox",
                                               "proimages_per_image")], 0)
        weak = torch.cat([batch["prolabels_per_bbox"], batch["prolabels_per_image"]], 0)
        masks = draw_masks(cfg, mask_seed(random_seed, i), images.shape[0], images.device)
        leaves = {k: w[k].requires_grad_(k in mom) for k in w}
        logits = forward(leaves, images, cfg, masks=masks, rnd=rnd, remat=True)
        up = [upsample(t, images.shape[1:3]) for t in logits]
        del logits
        terms = ref_steps.losses(up, batch["prolabels_per_pixel"], weak, cfg)
        del up
        grads = torch.autograd.grad(terms["total"], [leaves[k] for k in names])
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        with torch.no_grad():
            if out["first_grads"] is None:
                out["first_grads"] = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                p = w[k].detach()
                if k.endswith(".weight"):
                    g = g + wd * p
                mom[k].mul_(mu).add_(g)
                w[k] = p - lr * mom[k]
        del grads, terms
    out["params"] = {k: w[k].detach() for k in names}
    return out

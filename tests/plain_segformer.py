"""SegFormer under the paper's hierarchical heads, in plain PyTorch, float32.

The reference the port's ``mit_*`` models are held to on the CPU
(tests/test_torch_mit.py). It follows NVlabs/SegFormer
(``mmseg/models/backbones/mix_transformer.py``, ``segformer_head.py``) and
uses no module or kernel of the port: parameters are a dict keyed by the
port's state-dict names, every layer is a ``torch.nn.functional`` call,
attention is the math of ``softmax(q k^T * d^-1/2) v`` on explicit scores,
matrix products and convolutions run without TF32.

Departures from NVlabs, each the port's:

- the heads: SegFormer's ``linear_pred`` classifier is replaced by the
  paper's 768 -> 256 extension (1x1 conv, BatchNorm, ReLU), three
  bottleneck adaptation branches and the L1 / vehicle / human logit convs
  with their BatchNorm (arXiv:1903.03462);
- the logits are upsampled x4 bilinearly with ``align_corners=True`` (the
  system's upsampler for every head), and the losses are the paper's
  hierarchical losses on them;
- the optimizer is SGD with momentum and weight decay on ``.weight``
  leaves (the port's SGDM; its EMA does not touch the parameters), not
  AdamW;
- LayerNorm weights are named ``scale``; images come in [-1, 1], not
  ImageNet-normalized;
- stochastic depth and the decoder's channel dropout take their masks from
  two draws of a ``torch.Generator`` seeded by ``mask_seed``, in the port's
  order (models/mit.py), so that both sides drop the same branches.

``rnd`` rounds at the points where a mixed-precision implementation rounds
(the images, every weight, every layer's output, every residual sum), as
the benchmark's reference does.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# embed dims, heads, depths, reduction ratios, MLP ratio, decoder width,
# drop path rate, dropout (mix_transformer.py's mit_b0 and mit_b5)
WIDTHS = {
    "mit_b0": ((32, 64, 160, 256), (1, 2, 5, 8), (2, 2, 2, 2), (8, 4, 2, 1), 4, 256, 0.1, 0.1),
    "mit_b5": ((64, 128, 320, 512), (1, 2, 5, 8), (3, 6, 40, 3), (8, 4, 2, 1), 4, 768, 0.1, 0.1),
}
HEADS = ("l1", "l2_vehicle", "l2_human")
BASE = "feature_extractor/base"
BN_EPS = 1e-5


@contextlib.contextmanager
def strict_float32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mask_seed(random_seed: int, fold: int) -> int:
    return (int(random_seed) * (1 << 32) + int(fold) * 1024) % (1 << 63)


def draw_masks(seed: int, n: int, widths, device):
    """(keep (blocks, 2, n), channel keep (n, D)) of one training forward."""
    dims, _, depths, _, _, dec, rate, dropout = widths
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    p = torch.tensor([float(v) for v in torch.linspace(0, rate, sum(depths))],
                     dtype=torch.float32, device=device)
    u = torch.rand((p.shape[0], 2, n), generator=g, device=device)
    keep = (u >= p[:, None, None]).float() / (1.0 - p)[:, None, None]
    c = torch.rand((n, dec), generator=g, device=device)
    return keep, (c >= dropout).float() / (1.0 - dropout)


# -- names and shapes ------------------------------------------------------------

def _cnr(prefix, cin, cout, k):
    return [(f"{prefix}.conv.weight", (cout, cin, k, k))] + [
        (f"{prefix}.norm.{leaf}", (cout,)) for leaf in ("scale", "bias", "mean", "var")]


def _lin(prefix, cin, cout):
    return [(f"{prefix}.weight", (cout, cin)), (f"{prefix}.bias", (cout,))]


def _ln(prefix, c):
    return [(f"{prefix}.scale", (c,)), (f"{prefix}.bias", (c,))]


def _conv(prefix, cin, cout, k, groups=1):
    return [(f"{prefix}.weight", (cout, cin // groups, k, k)), (f"{prefix}.bias", (cout,))]


def param_spec(widths, heads, features: int = 256) -> list:
    """[(name, shape)] of every parameter and running statistic."""
    dims, nheads, depths, srs, ratio, dec, _, _ = widths
    spec, cin = [], 3
    for s, c in enumerate(dims):
        pe = f"{BASE}.patch_embed{s + 1}"
        spec += _conv(f"{pe}.proj", cin, c, 7 if s == 0 else 3) + _ln(f"{pe}.norm", c)
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
    spec += _cnr("feature_extractor/extension/decrease_fdims", dec, features, 1)
    for head, n in zip(HEADS, heads):
        spec += _cnr(f"adaptation_module/{head}_features.conv1", features, features, 1) \
            + _cnr(f"adaptation_module/{head}_features.conv2", features, features, 3) \
            + _cnr(f"adaptation_module/{head}_features.conv3", features, features, 1) \
            + _cnr(f"softmax_classifier/{head}_logits", features, n, 1)
    return spec


def draw_params(spec, seed: int, device="cpu") -> dict:
    """Seeded values: kernels normal at He's fan-in scale (the residual
    branches' output projections ``attn.proj``, ``mlp.fc2`` and the
    bottleneck's ``conv3`` at a tenth), biases U(-0.2, 0.2), norm scales
    U(0.8, 1.2), running statistics 0 and 1."""
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in sorted(spec):
        if name.endswith(".weight"):
            fan_in = math.prod(shape[1:])
            v = torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)
        elif name.endswith(".scale"):
            v = 0.8 + 0.4 * torch.rand(shape, generator=g)
        elif name.endswith(".bias"):
            v = 0.4 * torch.rand(shape, generator=g) - 0.2
        elif name.endswith(".mean"):
            v = torch.zeros(shape)
        else:
            v = torch.ones(shape)
        if any(k in name for k in ("attn.proj.", "mlp.fc2.", ".conv3.norm.")):
            v = v * 0.1
        out[name] = v.to(device)
    return out


# -- resize tables -----------------------------------------------------------------

def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of the aligned-corners bilinear resize."""
    scale = np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0)
    src = np.arange(n_out, dtype=np.float32) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - frac)
    np.add.at(m, (np.arange(n_out), hi), frac)
    return m


def upsample(x: torch.Tensor, out_hw) -> torch.Tensor:
    a = torch.as_tensor(bilinear_matrix(x.shape[2], out_hw[0]), device=x.device)
    b = torch.as_tensor(bilinear_matrix(x.shape[3], out_hw[1]), device=x.device)
    return a @ x.float() @ b.t()


# -- the model ------------------------------------------------------------------------

class _Net:
    def __init__(self, p, widths, train, rnd):
        self.p, self.widths, self.train = p, widths, train
        self.r = rnd or (lambda t: t)

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
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            mean, var = self.p[f"{prefix}.mean"], self.p[f"{prefix}.var"]
        y = (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
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
                            f"{prefix}.norm", 1e-5)
        else:
            kv_in = x
        kv = self.linear(kv_in, f"{prefix}.kv").reshape(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        outs = []
        for i in range(b):  # the scores of one image at a time
            scores = (q[i] @ k[i].transpose(-2, -1)) * d ** -0.5
            outs.append(self.r(torch.softmax(scores, -1) @ v[i]))
        o = torch.stack(outs).transpose(1, 2).reshape(b, n, c)
        return self.linear(o, f"{prefix}.proj")

    def mlp(self, x, prefix, h, w):
        y = self.linear(x, f"{prefix}.fc1")
        b, n, c = y.shape
        y = self.conv(y.transpose(1, 2).reshape(b, c, h, w), f"{prefix}.dwconv.dwconv", 1, 1, c)
        y = self.r(F.gelu(y.flatten(2).transpose(1, 2)))
        return self.linear(y, f"{prefix}.fc2")

    def block(self, x, prefix, heads, sr, h, w, ka, km):
        y = self.attention(self.ln(x, f"{prefix}.norm1", 1e-6), f"{prefix}.attn", heads, sr, h, w)
        x = self.r(x + (y if ka is None else y * ka[:, None, None]))
        y = self.mlp(self.ln(x, f"{prefix}.norm2", 1e-6), f"{prefix}.mlp", h, w)
        return self.r(x + (y if km is None else y * km[:, None, None]))

    def bottleneck(self, x, prefix):
        y = self.cnr(x, f"{prefix}.conv1")
        y = self.cnr(y, f"{prefix}.conv2")
        y = self.cnr(y, f"{prefix}.conv3", relu=False)
        return torch.relu(self.r(x + y))


def forward(p: dict, images: torch.Tensor, widths, train: bool, masks=None, rnd=None,
            remat: bool = False) -> list:
    """images (N, H, W, 3) -> the three heads' stride-4 logits (N, C, h, w)
    float32. ``train``: BatchNorm on the batch's statistics, and ``masks``
    (``draw_masks``) applied; ``remat``: each MiT block recomputed in the
    backward."""
    dims, nheads, depths, srs, _, _, _, _ = widths
    net = _Net(p, widths, train, rnd)
    keep, channel_keep = masks if masks is not None else (None, None)
    x = net.r(images.permute(0, 3, 1, 2).float())
    feats, index = [], 0
    for s in range(len(dims)):
        pe = f"{BASE}.patch_embed{s + 1}"
        k = 7 if s == 0 else 3
        y = net.conv(x, f"{pe}.proj", 4 if s == 0 else 2, k // 2)
        h, w = y.shape[2], y.shape[3]
        t = net.ln(y.flatten(2).transpose(1, 2), f"{pe}.norm", 1e-5)
        for b in range(depths[s]):
            ka = km = None
            if keep is not None:
                ka, km = keep[index, 0], keep[index, 1]

            def blk(t, ka=ka, km=km, prefix=f"{BASE}.block{s + 1}.{b}", heads=nheads[s],
                    sr=srs[s], h=h, w=w):
                return net.block(t, prefix, heads, sr, h, w, ka, km)
            t = checkpoint(blk, t, use_reentrant=False) if remat and torch.is_grad_enabled() \
                else blk(t)
            index += 1
        t = net.ln(t, f"{BASE}.norm{s + 1}", 1e-6)
        x = t.transpose(1, 2).reshape(t.shape[0], -1, h, w)
        feats.append(x)
    h1, w1 = feats[0].shape[2], feats[0].shape[3]
    ups = []
    for s in reversed(range(len(dims))):
        f = feats[s]
        y = net.linear(f.flatten(2).transpose(1, 2), f"{BASE}.decode_head.linear_c{s + 1}.proj")
        y = y.transpose(1, 2).reshape(f.shape[0], -1, f.shape[2], f.shape[3])
        if (f.shape[2], f.shape[3]) != (h1, w1):
            y = net.r(F.interpolate(y, size=(h1, w1), mode="bilinear", align_corners=False))
        ups.append(y)
    x = net.cnr(torch.cat(ups, 1), f"{BASE}.decode_head.linear_fuse")
    if channel_keep is not None:
        x = net.r(x * channel_keep[:, :, None, None])
    x = net.cnr(x, "feature_extractor/extension/decrease_fdims")
    logits = []
    for head in HEADS:
        y = net.bottleneck(x, f"adaptation_module/{head}_features")
        logits.append(net.cnr(y, f"softmax_classifier/{head}_logits", relu=False).float())
    return logits


# -- losses and steps ---------------------------------------------------------------------

def _table(values, device):
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def _weighted(raw, weights):
    count = torch.count_nonzero(weights).float()
    total = torch.sum(raw * weights)
    return torch.where(count > 0, total / count.clamp_min(1.0), torch.zeros_like(total))


def losses(up: list, per_pixel: torch.Tensor, weak: torch.Tensor, hier: dict,
           coefficient: float) -> dict:
    """The paper's hierarchical losses on logits at the labels' size (N, C,
    H, W), the batch [per-pixel | weak]; per_pixel (Npp, H, W) training
    class ids, weak (Nweak, H, W, 15) distributions."""
    dev = per_pixel.device
    n_pp = per_pixel.shape[0]
    pp = per_pixel.long()
    l1_lab = _table(hier["per_pixel_cids2l1_cids"], dev)[pp]
    void = up[0].shape[1] - 1
    raw = -F.log_softmax(up[0][:n_pp], 1).gather(1, l1_lab[:, None])[:, 0]
    out = {"l1_segmentation": _weighted(raw, (l1_lab != void).float())}
    l1_dec = torch.argmax(up[0], 1)
    for key, u, head in (("l2_vehicle_segmentation", up[1], "vehicle"),
                         ("l2_human_segmentation", up[2], "human")):
        n = u.shape[1]
        proj = np.zeros((len(hier[f"per_bbox_cids2{head}_cids"]), n), np.float32)
        proj[np.arange(proj.shape[0]), np.asarray(hier[f"per_bbox_cids2{head}_cids"])] = 1.0
        pp_lab = F.one_hot(_table(hier[f"per_pixel_cids2{head}_cids"], dev)[pp], n).float()
        weak_lab = weak.float() @ torch.as_tensor(proj, device=dev)
        lab = torch.cat([pp_lab, weak_lab], 0).permute(0, 3, 1, 2)
        raw = -torch.sum(lab * F.log_softmax(u, 1), 1)
        gate = ((1.0 - lab[n_pp:, -1]) > 0.01) & (l1_dec[n_pp:] == hier[f"cid_l1_{head}"]) \
            & (lab[n_pp:, :-1].amax(1) >= 0.01)
        out[key] = _weighted(raw, torch.cat([1.0 - lab[:n_pp, -1], gate.float()], 0))
    out["total"] = out["l1_segmentation"] + coefficient * (
        out["l2_vehicle_segmentation"] + out["l2_human_segmentation"])
    return out


def batch_tensors(batch: dict):
    """(images [pp | pb | pi], per-pixel labels, weak labels [pb | pi])."""
    images = torch.cat([torch.as_tensor(batch[k]).float() for k in (
        "proimages_per_pixel", "proimages_per_bbox", "proimages_per_image")], 0)
    weak = torch.cat([torch.as_tensor(batch["prolabels_per_bbox"]).float(),
                      torch.as_tensor(batch["prolabels_per_image"]).float()], 0)
    return images, torch.as_tensor(batch["prolabels_per_pixel"]), weak


def train_steps(params: dict, batches: list, widths, hier: dict, lr: float, momentum: float,
                weight_decay: float, coefficient: float, random_seed: int = 0,
                rnd=None, remat: bool = False) -> dict:
    """One SGDM step a batch (step i's masks from ``mask_seed(random_seed,
    i)``): the losses of each step, the first step's gradient of every
    parameter, and the parameters after the last step."""
    names = [k for k in params if not k.endswith((".mean", ".var"))]
    w = {k: v.detach().clone().float() for k, v in params.items()}
    mom = {k: torch.zeros_like(w[k]) for k in names}
    out = {"losses": [], "first_grads": None}
    for i, batch in enumerate(batches):
        images, per_pixel, weak = batch_tensors(batch)
        masks = draw_masks(mask_seed(random_seed, i), images.shape[0], widths, images.device)
        leaves = {k: w[k].requires_grad_(k in mom) for k in w}
        logits = forward(leaves, images, widths, train=True, masks=masks, rnd=rnd, remat=remat)
        up = [upsample(t, images.shape[1:3]) for t in logits]
        terms = losses(up, per_pixel, weak, hier, coefficient)
        grads = torch.autograd.grad(terms["total"], [leaves[k] for k in names])
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        with torch.no_grad():
            if out["first_grads"] is None:
                out["first_grads"] = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                p = w[k].detach()
                if k.endswith(".weight"):
                    g = g + weight_decay * p
                mom[k].mul_(momentum).add_(g)
                w[k] = p - lr * mom[k]
    out["params"] = {k: w[k].detach() for k in names}
    return out

"""Operation and byte counts of a ``segformer_*`` configuration's training
step, from the configuration alone (the peaks are ``counts.py``'s).

Operations (2 a multiply-add), per image at (H, W):

- ``layers``: every linear and convolution of the forward, by name: the
  patch embeddings (k^2 Cin C over the stage's map), each block's q (C^2
  a token), kv (2 C^2 a reduced token), the reduction conv (R^2 C^2 a
  reduced token), proj (C^2), fc1 and fc2 (4 C^2 each) and the depthwise
  conv (9 x 4C a token); the decoder's Linear a stage (C D a token of that
  stage) and its fuse (4D D a stride-4 pixel); the extension (D F), each
  adaptation branch (F^2 + 9 F^2 + F^2) and each logit conv (F n). Training
  counts each three times (forward, input gradient, weight gradient), but
  for the first patch embedding, whose input is the images (twice).
- ``attention``: the score and value products of each block, 4 N Nr d a
  head forward (QK^T and PV), 10 N Nr d backward (the scores recomputed,
  then dV, dP, dQ, dK), N the stage's tokens, Nr the keys (the tokens
  reduced by R^2), d the head width.

Nothing else is counted (norms, GELU, softmax, resizes, residual adds,
the loss): what implements a layer does not move the count.

``attention_bytes``: what the step's attention kernels must move at least,
in bf16: forward Q, K, V read and O written, the f32 log-sum-exp of each
query written; backward Q, K, V, O, dO and the log-sum-exp read and dQ, dK,
dV written.
"""

from __future__ import annotations

__all__ = ["attention_bytes", "attention_flops", "layer_flops", "stage_sizes", "train_flops"]


def stage_sizes(cfg: dict, h: int, w: int) -> list:
    """[(h, w)] of each stage's map: the patch embeddings' convs (kernel
    k, stride s, padding k // 2)."""
    out = []
    for k, s in zip(cfg["patch_sizes"], cfg["patch_strides"]):
        h, w = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        out.append((h, w))
    return out


def layer_flops(cfg: dict, h: int, w: int) -> dict:
    """{layer: forward operations of one image} of every linear and conv."""
    dims, depths, srs = cfg["embed_dims"], cfg["depths"], cfg["sr_ratios"]
    ratio, d_dec, f = cfg["mlp_ratio"], cfg["decoder_embed_dim"], cfg["feature_dims_decreased"]
    sizes = stage_sizes(cfg, h, w)
    out, cin = {}, 3
    for s, (c, (sh, sw)) in enumerate(zip(dims, sizes)):
        n, k, r = sh * sw, cfg["patch_sizes"][s], srs[s]
        nr = (sh // r) * (sw // r)
        out[f"patch_embed{s + 1}"] = 2 * k * k * cin * c * n
        block = {"q": 2 * c * c * n, "kv": 2 * 2 * c * c * nr, "proj": 2 * c * c * n,
                 "fc1": 2 * ratio * c * c * n, "dwconv": 2 * 9 * ratio * c * n,
                 "fc2": 2 * ratio * c * c * n}
        if r > 1:
            block["sr"] = 2 * r * r * c * c * nr
        for name, ops in block.items():
            out[f"block{s + 1}.{name}"] = depths[s] * ops
        out[f"decode.linear_c{s + 1}"] = 2 * c * d_dec * n
        cin = c
    n1 = sizes[0][0] * sizes[0][1]
    out["decode.linear_fuse"] = 2 * len(dims) * d_dec * d_dec * n1
    out["extension"] = 2 * d_dec * f * n1
    out["adaptation"] = len(cfg["heads"]) * 2 * 11 * f * f * n1
    out["logits"] = 2 * f * sum(cfg["heads"]) * n1
    return out


def attention_flops(cfg: dict, h: int, w: int) -> tuple:
    """(forward, backward) operations of one image's attention products."""
    fwd = 0
    for s, (c, (sh, sw)) in enumerate(zip(cfg["embed_dims"], stage_sizes(cfg, h, w))):
        r, heads = cfg["sr_ratios"][s], cfg["num_heads"][s]
        n, nr = sh * sw, (sh // r) * (sw // r)
        fwd += cfg["depths"][s] * 4 * heads * n * nr * (c // heads)
    return fwd, fwd * 10 // 4


def train_flops(cfg: dict, h: int, w: int) -> int:
    """Operations of one training image: the layers three times (the first
    patch embedding twice) and the attention forward and backward."""
    layers = layer_flops(cfg, h, w)
    total = 3 * sum(layers.values()) - layers["patch_embed1"]
    return total + sum(attention_flops(cfg, h, w))


def attention_bytes(cfg: dict, h: int, w: int) -> tuple:
    """(forward, backward) bytes of one image's attention kernels."""
    fwd = bwd = 0
    for s, (c, (sh, sw)) in enumerate(zip(cfg["embed_dims"], stage_sizes(cfg, h, w))):
        r, heads = cfg["sr_ratios"][s], cfg["num_heads"][s]
        n, nr = sh * sw, (sh // r) * (sw // r)
        q, kv, lse = 2 * n * c, 2 * nr * c, 4 * n * heads
        fwd += cfg["depths"][s] * (2 * q + 2 * kv + lse)
        bwd += cfg["depths"][s] * (3 * q + 2 * kv + lse + q + 2 * kv)
    return fwd, bwd

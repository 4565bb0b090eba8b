"""The benchmark's own operation and byte counts, and the chip's peaks.

- ``conv_layers`` / ``model_flops``: the model's convolutions at an image
  size, from the configuration alone (the reference's unit plan): 2 x K^2
  x Cin x Cout x output pixels a forward; training adds the input gradient
  (not for the root conv, whose input is the images) and the weight
  gradient at the same count each. No recomputation, no other operation:
  what implements a layer does not move the count.
- ``loss_counts``: kernels B1 (forward) and B2 (backward) of the fused
  loss, from the stride-8 logits and full-size labels of one call: each
  input read once, each output written once (B1: the decisions and L1
  decisions, int32 a pixel; B2: the logits' gradient), and the f32
  operations a pixel of their arithmetic (the 4-tap upsample, max, exp,
  sum and CE terms a logit, the weak projection and gates a pixel).
- ``unit_counts``: a fused bottleneck unit (kernels B4, B5): the bf16
  activation read and written once, the bf16 kernels and f32 biases read
  once, 2 x (C M + 9 M^2 + M C) operations a pixel.
- ``bound_s``: the least time, the larger of bytes over the memory peak
  and operations over the operation peak.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them, 3.35
TB/s of HBM3; the same arithmetic as the kernel table of PERF.md.
"""

from __future__ import annotations

from benchmark.reference.model import PSP_DIVS, stride8_size, unit_plan

__all__ = ["LOSS_BWD_OPS_PER_LOGIT", "LOSS_FWD_OPS_PER_LOGIT", "LOSS_OPS_PER_PIXEL", "PEAKS",
           "bound_s", "conv_layers", "loss_counts", "model_flops", "peaks", "unit_counts"]

PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}}

LOSS_FWD_OPS_PER_LOGIT, LOSS_BWD_OPS_PER_LOGIT, LOSS_OPS_PER_PIXEL = 15, 24, 40


def peaks(device_name: str):
    """The data-sheet peaks of a device, or None for one this table lacks."""
    return PEAKS.get(device_name)


def conv_layers(cfg: dict, h: int, w: int) -> list:
    """[(cin, cout, k, out_h, out_w, input_needs_grad)] of every convolution
    of one image at (h, w)."""
    layers = []
    oh, ow = (h + 6 - 7) // 2 + 1, (w + 6 - 7) // 2 + 1
    layers.append((3, 64, 7, oh, ow, False))
    oh, ow = -(-oh // 2), -(-ow // 2)
    for _, _, cin, depth, m, stride, _ in unit_plan(cfg["resnet_blocks"], cfg["output_stride"]):
        sh, sw = (oh + 2 - 3) // stride + 1, (ow + 2 - 3) // stride + 1
        if cin != depth:
            layers.append((cin, depth, 1, sh, sw, True))
        layers += [(cin, m, 1, oh, ow, True), (m, m, 3, sh, sw, True), (m, depth, 1, sh, sw, True)]
        oh, ow = sh, sw
    if (oh, ow) != stride8_size(h, w):
        raise ValueError(f"trunk size {(oh, ow)} is not the stride-8 size {stride8_size(h, w)}")
    c = cfg["feature_dims_decreased"]
    layers.append((cfg["resnet_blocks"][-1][1], c, 1, oh, ow, True))
    if cfg["psp_module"]:
        for d in PSP_DIVS:
            layers.append((c, c, 1, oh // (oh // d), ow // (ow // d), True))
        layers.append((c + len(PSP_DIVS) * c, c, 1, oh, ow, True))
    for n in cfg["heads"]:
        layers += [(c, c, 1, oh, ow, True), (c, c, 3, oh, ow, True), (c, c, 1, oh, ow, True),
                   (c, n, 1, oh, ow, True)]
    return layers


def model_flops(cfg: dict, h: int, w: int, train: bool) -> int:
    """Convolution operations of one image at (h, w): a forward, or with
    ``train`` a forward and both gradients."""
    total = 0
    for cin, cout, k, oh, ow, needs_grad in conv_layers(cfg, h, w):
        fwd = 2 * k * k * cin * cout * oh * ow
        total += fwd * ((2 + needs_grad) if train else 1)
    return total


def bound_s(nbytes: float, ops: float, peak_ops: float, peak_bytes: float) -> float:
    return max(nbytes / peak_bytes, ops / peak_ops)


def loss_counts(n_pp: int, n_weak: int, in_hw, out_hw, heads) -> dict:
    """{'fwd': (bytes, ops), 'bwd': (bytes, ops)} of one B1 and one B2 call:
    logits (N, h, w, C) f32 of each head, three int32 per-pixel label maps,
    (n_weak, H, W, 15) f32 weak labels."""
    n = n_pp + n_weak
    pixels = n * out_hw[0] * out_hw[1]
    c_tot = sum(heads)
    logit_bytes = 4 * n * in_hw[0] * in_hw[1] * c_tot
    in_bytes = logit_bytes + 3 * 4 * n_pp * out_hw[0] * out_hw[1] \
        + 4 * 15 * n_weak * out_hw[0] * out_hw[1]
    return {"fwd": (in_bytes + 2 * 4 * pixels,
                    pixels * (LOSS_FWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL)),
            "bwd": (in_bytes + logit_bytes,
                    pixels * (LOSS_BWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL))}


def unit_counts(n: int, h: int, w: int, c: int, m: int) -> tuple:
    """(bytes, ops) of one fused bottleneck unit on (n, h, w, c) bf16."""
    ops = 2 * n * h * w * (c * m + 9 * m * m + m * c)
    nbytes = 2 * 2 * n * h * w * c + 2 * (c * m + 9 * m * m + m * c) + 4 * (2 * m + c)
    return nbytes, ops

"""On-device augmentations of the per-pixel images and labels: batched,
static-shape, each split into a draw and an apply.

Port of iv2019_tpu/ops/augment.py (reference
preprocessing/augmentation_library.py). JAX draws with threefry keys; the
port cannot give the same random numbers, so each augmentation is split:

- ``draw_augmentations`` draws every random number of a batch from one CPU
  ``torch.Generator`` seeded from ``(seed, fold)``, with the distributions,
  ranges and shapes of the JAX package (augment.py:131,140-145,155,211-214,
  281-288,401-403). The batch-wide selectors (which color ordering, which
  blur) are Python ints: they pick code paths, and drawing them on the card
  would cost the host a wait on the device every step.
- the ``*_apply`` functions take those numbers and compute what the JAX
  functions compute from theirs, on the images' device. Given JAX's draws
  they give JAX's labels exactly and its images to rounding
  (tests/test_torch_augment.py).

XLA compiles a division by a constant into a product with its f32
reciprocal, and the JAX package runs these functions compiled (inside the
train step), so the apply functions multiply by ``_recip(c)`` where JAX
divides by a constant c.

``apply_augmentations`` runs them in the reference's order: color, blur,
flip, scale. Images are NHWC f32 in [-1, 1) (the color distortions run in
[0, 1], as the reference applies them before centering); labels NHW int.

- color (reference :323-406): one of 4 orderings of brightness, saturation,
  hue and contrast for the whole batch (selector 4-7: none), per-image
  amounts, clipped to [0, 1];
- blur (:408-466): for the whole batch median (0), bilateral (1) or none
  (2, 3); per-image radius in [1, ``blur_max_radius``]. The median
  quantizes to uint8 like cv2.medianBlur and sorts the (2r+1)^2 window
  (edge replicated); the bilateral filter weights a circular window by the
  space and range Gaussians (edge reflected without repeating it);
- flip (:298-321): per-image horizontal flip with p = 1/2;
- scale (:21-296): per image up (a random crop of floor(HW f), f in
  [1/poi1, 1/poi0], resized back: TF1 bilinear for images, nearest for
  labels) or down (shrunk to floor(HW f), centered on a canvas of the
  image's mean, labels padded with ``unlabeled_cid``), p = 1/2 each.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "VALID_AUGMENTATIONS",
    "apply_augmentations",
    "blur_apply",
    "blur_max_radius",
    "blur_sigma_space",
    "color_apply",
    "draw_augmentations",
    "draws_to",
    "flip_apply",
    "scale_apply",
]

VALID_AUGMENTATIONS = ("color", "blur", "flip", "scale")

_BRIGHTNESS_MAX_DELTA = 32.0 / 255.0
_SAT_CON_RANGE = (0.7, 1.3)
_HUE_MAX_DELTA = 0.1
_ORDERINGS = ("bshc", "sbch", "chbs", "hsbc")  # reference orderings 0-3


def _recip(c) -> float:
    """The f32 reciprocal of a constant divisor."""
    return float(np.float32(1.0) / np.float32(c))


def _check_names(names: Sequence[str]) -> tuple[str, ...]:
    names = tuple(names)
    unknown = set(names) - set(VALID_AUGMENTATIONS)
    if unknown:
        raise ValueError(f"unknown augmentations {sorted(unknown)}; "
                         f"valid: {VALID_AUGMENTATIONS}")
    return names


def blur_max_radius(h: int, w: int) -> int:
    """Largest blur radius at a resolution: the reference's kernel size
    ``2*(randint(0, rint(1.4*(res+1))) + 1) + 1``, res in megapixels
    (augmentation_library.py:448-452)."""
    res = h * w / 1e6
    return max(int(np.rint(1.4 * (res + 1.0))), 1)


def blur_sigma_space(h: int, w: int) -> float:
    """The reference's bilateral sigma: rint(25*(res+1)), res in megapixels
    (augmentation_library.py:458)."""
    res = h * w / 1e6
    return float(np.rint(25.0 * (res + 1.0)))


def _generator(seed: int, fold: int) -> torch.Generator:
    state = np.random.SeedSequence((int(seed), int(fold))).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 ^ int(state[1]))


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(n, generator=gen) * (hi - lo) + lo


def draw_augmentations(seed: int, fold: int, names: Sequence[str], n: int, h: int, w: int,
                       poi=(1.0, 2.0)) -> dict:
    """Every random number the named augmentations need for a batch of
    ``n`` images of h x w, from a CPU generator seeded from ``(seed,
    fold)``: the same draws for the same arguments. CPU tensors of shape
    (n,) and Python ints:

    - color: ``col_r`` in [0, 8); ``brightness`` U(-32/255, 32/255);
      ``saturation``, ``contrast`` U(0.7, 1.3); ``hue`` U(-0.1, 0.1);
    - blur: ``blu_r`` in [0, 4); ``radii`` int in [1, blur_max_radius(h, w)];
    - flip: ``flip`` bool, p = 1/2;
    - scale: ``scale_up`` bool, p = 1/2; ``up_inv``, ``down_inv``
      U(1/poi[1], 1/poi[0]); ``up_oy``, ``up_ox`` U[0, 1) (the crop offset's
      fraction of its range).
    """
    names = _check_names(names)
    gen = _generator(seed, fold)
    draws: dict = {}
    if "color" in names:
        draws["col_r"] = int(torch.randint(0, 8, (), generator=gen))
        draws["brightness"] = _uniform(gen, n, -_BRIGHTNESS_MAX_DELTA, _BRIGHTNESS_MAX_DELTA)
        draws["saturation"] = _uniform(gen, n, *_SAT_CON_RANGE)
        draws["hue"] = _uniform(gen, n, -_HUE_MAX_DELTA, _HUE_MAX_DELTA)
        draws["contrast"] = _uniform(gen, n, *_SAT_CON_RANGE)
    if "blur" in names:
        draws["blu_r"] = int(torch.randint(0, 4, (), generator=gen))
        draws["radii"] = torch.randint(1, blur_max_radius(h, w) + 1, (n,), generator=gen,
                                       dtype=torch.int32)
    if "flip" in names:
        draws["flip"] = torch.rand(n, generator=gen) < 0.5
    if "scale" in names:
        lo, hi = 1.0 / poi[1], 1.0 / poi[0]
        draws["scale_up"] = torch.rand(n, generator=gen) > 0.5
        draws["up_inv"] = _uniform(gen, n, lo, hi)
        draws["up_oy"] = torch.rand(n, generator=gen)
        draws["up_ox"] = torch.rand(n, generator=gen)
        draws["down_inv"] = _uniform(gen, n, lo, hi)
    return draws


def apply_augmentations(images: torch.Tensor, labels: torch.Tensor, names: Sequence[str],
                        draws: dict, unlabeled_cid: int):
    """(images, labels) after the named augmentations, in the order color,
    blur, flip, scale, with ``draws`` from ``draw_augmentations``."""
    names = _check_names(names)
    draws = draws_to(draws, images.device)
    if "color" in names:
        images = color_apply((images + 1.0) * 0.5, draws) * 2.0 - 1.0
    if "blur" in names:
        images = blur_apply(images, draws)
    if "flip" in names:
        images, labels = flip_apply(images, labels, draws["flip"])
    if "scale" in names:
        images, labels = scale_apply(images, labels, draws, unlabeled_cid)
    return images, labels


def draws_to(draws: dict, device) -> dict:
    """The draws' tensors on ``device``: from pinned memory, so the copies
    queue behind the device's work instead of waiting for it."""
    device = torch.device(device)
    out = {}
    for k, v in draws.items():
        if isinstance(v, torch.Tensor) and v.device != device:
            v = (v.pin_memory() if device.type == "cuda" else v).to(device, non_blocking=True)
        out[k] = v
    return out


def _per_image(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(n,) draws as an (n, 1, 1, ...) tensor on ``like``'s device."""
    v = values.to(like.device)
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


# --- color ------------------------------------------------------------------


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0)) * _recip(6.0)
    h = torch.where(d > 0, h, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6).clamp(0, 5).long()[..., None]

    def choose(*options):
        return torch.gather(torch.stack(options, dim=-1), -1, i)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def _adjust_saturation(img, factor):
    hsv = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    sat = torch.clamp(hsv[..., 1] * factor[..., 0], 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], sat, hsv[..., 2]], dim=-1))


def _adjust_hue(img, delta):
    hsv = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    hue = torch.remainder(hsv[..., 0] + delta[..., 0], 1.0)
    return _hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))


def _adjust_contrast(img, factor):
    mean = torch.mean(img, dim=(1, 2), keepdim=True)  # per image and channel
    return (img - mean) * factor + mean


def color_apply(images01: torch.Tensor, draws: dict) -> torch.Tensor:
    """Images in [0, 1] after the color ordering ``col_r`` (4-7: unchanged)
    with per-image brightness, saturation, hue and contrast."""
    order = int(draws["col_r"])
    if order >= 4:
        return images01
    ops = {
        "b": lambda x: x + _per_image(draws["brightness"], x),
        "s": lambda x: _adjust_saturation(x, _per_image(draws["saturation"], x)),
        "h": lambda x: _adjust_hue(x, _per_image(draws["hue"], x)),
        "c": lambda x: _adjust_contrast(x, _per_image(draws["contrast"], x)),
    }
    x = images01
    for op in _ORDERINGS[order]:
        x = ops[op](x)
    return torch.clamp(x, 0.0, 1.0)


# --- blur -------------------------------------------------------------------


def _pad_hw(images: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """NHWC images padded by ``r`` on H and W (F.pad pads NCHW)."""
    return F.pad(images.permute(0, 3, 1, 2), (r, r, r, r), mode=mode).permute(0, 2, 3, 1)


def _median_filter(images: torch.Tensor, radii: torch.Tensor, max_radius: int) -> torch.Tensor:
    """cv2.medianBlur: floor(x * 255) values, the median of each channel's
    (2r+1)^2 window with the edge replicated, / 255; ``radii`` (n,) int."""
    n, h, w, c = images.shape
    R = max_radius
    p = _pad_hw(torch.floor(images * 255.0), R, "replicate")
    taps = torch.stack([p[:, R + dy:R + dy + h, R + dx:R + dx + w]
                        for dy in range(-R, R + 1) for dx in range(-R, R + 1)],
                       dim=-1)  # (n, h, w, c, K), dy major
    span = torch.arange(-R, R + 1, device=images.device).abs()
    reach = torch.maximum(span[:, None], span[None, :]).reshape(-1)  # (K,)
    r = radii.to(images.device).long()
    # taps beyond an image's radius sort to the end; the median of the
    # (2r+1)^2 taps left is the element at 2r^2 + 2r
    invalid = reach[None, :] > r[:, None]  # (n, K)
    taps = torch.where(invalid[:, None, None, None, :], torch.inf, taps)
    taps = torch.sort(taps, dim=-1).values
    idx = (2 * r * r + 2 * r).reshape(n, 1, 1, 1, 1).expand(n, h, w, c, 1)
    return torch.gather(taps, -1, idx)[..., 0] * _recip(255.0)


def _bilateral_filter(images: torch.Tensor, radii: torch.Tensor, max_radius: int,
                      sigma: float) -> torch.Tensor:
    """cv2.bilateralFilter: space weight exp(-d^2 / 2s^2) times range weight
    exp(-(L1 color difference)^2 / 2s^2) over the circular window of radius
    r, edge reflected without repeating it."""
    n, h, w, c = images.shape
    R = max_radius
    p = _pad_hw(images, R, "reflect")
    r2 = (radii.to(images.device).long() ** 2).reshape(n, 1, 1, 1)
    num = torch.zeros_like(images)
    den = torch.zeros((n, h, w, 1), dtype=images.dtype, device=images.device)
    inv2s2 = 0.5 / (sigma * sigma)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            tap = p[:, R + dy:R + dy + h, R + dx:R + dx + w]
            d2 = dy * dy + dx * dx
            valid = (d2 <= r2).to(images.dtype)
            # exp of the f32-rounded exponent, as jnp.exp of a Python float
            space_w = float(np.exp(np.float32(-d2 * inv2s2)))
            diff = torch.abs(tap - images).sum(dim=-1, keepdim=True)
            wgt = valid * space_w * torch.exp(-(diff * diff) * inv2s2)
            num = num + wgt * tap
            den = den + wgt
    return num / den


def blur_apply(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """Median (``blu_r`` 0) or bilateral (1) filter of every image at its own
    radius; unchanged for 2 and 3."""
    which = int(draws["blu_r"])
    if which >= 2:
        return images
    h, w = images.shape[1], images.shape[2]
    max_r = blur_max_radius(h, w)
    if which == 0:
        return _median_filter(images, draws["radii"], max_r)
    return _bilateral_filter(images, draws["radii"], max_r, blur_sigma_space(h, w))


# --- flip and scale ---------------------------------------------------------


def flip_apply(images: torch.Tensor, labels: torch.Tensor, flip):
    """Images and labels with the images where ``flip`` (n,) is set
    mirrored left to right."""
    fi = torch.where(_per_image(flip, images), torch.flip(images, dims=(2,)), images)
    fl = torch.where(_per_image(flip, labels), torch.flip(labels, dims=(2,)), labels)
    return fi, fl


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (n, h, w[, c]) rows picked per image by idx (n, h')."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape))


def _gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (n, h, w[, c]) columns picked per image by idx (n, w')."""
    shape = x.shape[:2] + idx.shape[1:] + x.shape[3:]
    view = idx.reshape(idx.shape[:1] + (1,) + idx.shape[1:] + (1,) * (x.dim() - 3))
    return torch.gather(x, 2, view.expand(shape))


def _lerp_rows_cols(images, ylo, yhi, fy, xlo, xhi, fx):
    """TF1-legacy bilinear sampling, rows first (augment.py:96-106)."""
    rows_lo = _gather_rows(images, ylo)
    rows_hi = _gather_rows(images, yhi)
    rows = rows_lo + (rows_hi - rows_lo) * fy[:, :, None, None]
    cols_lo = _gather_cols(rows, xlo)
    cols_hi = _gather_cols(rows, xhi)
    return cols_lo + (cols_hi - cols_lo) * fx[:, None, :, None]


def _axis_coords(out_size: int, src_size: torch.Tensor, src_offset: torch.Tensor):
    """Per image (lo, hi, frac) source coordinates resizing the crop
    [offset, offset + size) of an axis to ``out_size`` (augment.py:77-92)."""
    y = torch.arange(out_size, dtype=torch.float32, device=src_size.device)
    src = y[None, :] * (src_size.float() * _recip(out_size))[:, None]
    lo = torch.floor(src)
    frac = src - lo
    last = (src_size - 1)[:, None]
    lo = torch.minimum(torch.clamp_min(lo.long(), 0), last)
    hi = torch.minimum(torch.clamp_min(lo + 1, 0), last)
    return lo + src_offset[:, None], hi + src_offset[:, None], frac


def _nearest_index(out_size: int, src_size: torch.Tensor, src_offset: torch.Tensor):
    y = torch.arange(out_size, dtype=torch.float32, device=src_size.device)
    idx = torch.floor(y[None, :] * (src_size.float() * _recip(out_size))[:, None]).long()
    idx = torch.minimum(torch.clamp_min(idx, 0), (src_size - 1)[:, None])
    return idx + src_offset[:, None]


def _upscale(images, labels, inv, uy, ux):
    n, h, w = images.shape[:3]
    ch = torch.floor(inv * h).long()
    cw = torch.floor(inv * w).long()
    oy = (uy * (h - ch + 1).float()).long()
    ox = (ux * (w - cw + 1).float()).long()
    ylo, yhi, fy = _axis_coords(h, ch, oy)
    xlo, xhi, fx = _axis_coords(w, cw, ox)
    pi = _lerp_rows_cols(images, ylo, yhi, fy, xlo, xhi, fx)
    pl = _gather_cols(_gather_rows(labels, _nearest_index(h, ch, oy)),
                      _nearest_index(w, cw, ox))
    return pi, pl


def _ratio(big: int, small: torch.Tensor) -> torch.Tensor:
    """f32 ``big / max(small, 1)`` by a true division (``int / tensor`` in
    torch multiplies by the reciprocal, which rounds differently)."""
    small = torch.clamp_min(small, 1).float()
    return torch.full_like(small, float(big)) / small


def _axis_coords_small(out_rel: torch.Tensor, src_small: torch.Tensor, src_big: int):
    """Bilinear coordinates into the original axis of each pixel of the
    shrunk image (augment.py:203-210)."""
    src = out_rel.float() * _ratio(src_big, src_small)[:, None]
    lo = torch.floor(src)
    frac = src - lo
    lo = torch.clamp(lo.long(), 0, src_big - 1)
    hi = torch.clamp(lo + 1, 0, src_big - 1)
    return lo, hi, frac


def _downscale(images, labels, inv, unlabeled_cid: int):
    n, h, w = images.shape[:3]
    sh = torch.floor(inv * h).long()
    sw = torch.floor(inv * w).long()
    py = torch.div(h - sh, 2, rounding_mode="floor")
    px = torch.div(w - sw, 2, rounding_mode="floor")
    yy = torch.arange(h, device=images.device)[None, :] - py[:, None]
    xx = torch.arange(w, device=images.device)[None, :] - px[:, None]
    valid = (((yy >= 0) & (yy < sh[:, None]))[:, :, None]
             & ((xx >= 0) & (xx < sw[:, None]))[:, None, :])  # (n, h, w)
    ylo, yhi, fy = _axis_coords_small(yy, sh, h)
    xlo, xhi, fx = _axis_coords_small(xx, sw, w)
    out = _lerp_rows_cols(images, ylo, yhi, fy, xlo, xhi, fx)
    mask = valid[..., None]
    count = mask.sum(dim=(1, 2), keepdim=True).float()
    mean = (torch.where(mask, out, 0.0).sum(dim=(1, 2), keepdim=True) / count).mean(
        dim=3, keepdim=True)
    pro_im = torch.where(mask, out, mean)
    yn = torch.clamp(torch.floor(yy.float() * _ratio(h, sh)[:, None]).long(), 0, h - 1)
    xn = torch.clamp(torch.floor(xx.float() * _ratio(w, sw)[:, None]).long(), 0, w - 1)
    lab = _gather_cols(_gather_rows(labels, yn), xn)
    pro_la = torch.where(valid, lab, torch.full_like(lab, unlabeled_cid))
    return pro_im, pro_la


def scale_apply(images: torch.Tensor, labels: torch.Tensor, draws: dict, unlabeled_cid: int):
    """Per image the upscaled crop where ``scale_up`` is set, else the
    downscaled, mean-padded image (augment.py:122-200,261-274)."""
    def dev(key):
        return draws[key].to(images.device)

    up_i, up_l = _upscale(images, labels, dev("up_inv"), dev("up_oy"), dev("up_ox"))
    dn_i, dn_l = _downscale(images, labels, dev("down_inv"), unlabeled_cid)
    sel = dev("scale_up")
    return (torch.where(_per_image(sel, images), up_i, dn_i),
            torch.where(_per_image(sel, labels), up_l, dn_l))

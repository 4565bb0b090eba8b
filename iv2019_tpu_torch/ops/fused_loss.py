"""Fused hierarchical loss from stride-8 logits: kernels B1 (forward) and B2 (backward).

The counterpart of iv2019_tpu/ops/fused_loss.py. The reference computes the
paper's losses on logits bilinearly upsampled to the input resolution
(losses/hierarchical.py); this computes the same sums from the stride-8
logits without materializing the full-resolution logits:

- L1: sparse softmax CE on the per-pixel images, void masked;
- L2 vehicle/human: dense CE over the whole batch; weights are the
  per-pixel non-void pixels, and on weak images not-void AND L1 decision
  == metaclass AND max label >= 0.01;
- the fused hierarchical decisions and the L1 decisions, full resolution.

``fused_loss_fwd`` (B1) and ``fused_loss_bwd`` (B2) launch
``csrc/fused_loss.cu`` for CUDA tensors and run their plain PyTorch versions
(``fused_loss_fwd_plain``, ``fused_loss_bwd_plain``) for CPU tensors. The
plain forward upsamples with the dense f32 matrices of
``ops/resize.py::_bilinear_matrix`` (``A @ lr @ B``), and the plain backward
is autograd through it. Each wrapper counts its launches in
``<wrapper>.launches``.

``make_fused_hierarchical_loss`` returns the ``torch.autograd.Function``
whose forward is B1 and whose backward is B2; ``define_losses_fused`` is the
drop-in counterpart of ``losses.hierarchical.define_losses`` on stride-8
logits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from iv2019_tpu_torch.losses.hierarchical import WEAK_LOSS_COEFFICIENT
from iv2019_tpu_torch.ops import _build
from iv2019_tpu_torch.ops.resize import _bilinear_matrix, _bilinear_tables
from iv2019_tpu_torch.ops.segment_ops import gather_cids, segment_sum_channels
from iv2019_tpu_torch.problem.taxonomy import Taxonomy

__all__ = [
    "define_losses_fused",
    "fused_loss_available",
    "fused_loss_bwd",
    "fused_loss_bwd_plain",
    "fused_loss_fwd",
    "fused_loss_fwd_plain",
    "make_fused_hierarchical_loss",
]

# constants of csrc/fused_loss.cu
_FWD_PIXELS_PER_BLOCK = 1024
_J_CHUNK = 16
_ERRORS = {
    -1: "no kernel is compiled for these head widths (Cityscapes 14/7/3, Vistas 53/12/5)",
    -2: "a column chunk's pixels do not fit in the device's shared memory",
    -3: "the partial-sum buffer is too small",
}


def fused_loss_available(in_hw, out_hw, tax: Taxonomy) -> bool:
    """Whether the fused loss takes these shapes: any upsampling (out >= in)."""
    return out_hw[0] >= in_hw[0] and out_hw[1] >= in_hw[1]


# ------------------------------------------------------------------ plain


def _upsample_plain(lr: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, h, w, C) -> (N, C, H, W) f32 as ``A @ lr @ B`` (rows, then columns)."""
    _, h, w, _ = lr.shape
    a = torch.as_tensor(_bilinear_matrix(h, out_hw[0], True), device=lr.device)
    b = torch.as_tensor(_bilinear_matrix(w, out_hw[1], True).T.copy(), device=lr.device)
    return a @ lr.float().permute(0, 3, 1, 2) @ b


def _plain_terms(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, tax: Taxonomy, out_hw):
    """(sums (6,), decisions, l1_decisions), differentiable in the logits."""
    n_pp = pp_l1.shape[0]
    u1, uv, uh = (_upsample_plain(t, out_hw) for t in (l1_lr, veh_lr, hum_lr))
    lse1, lsev, lseh = (torch.logsumexp(u, 1) for u in (u1, uv, uh))
    # torch.argmax returns the first maximal index, as the reference's argmax
    d1, dv, dh = (u.detach().argmax(1).int() for u in (u1, uv, uh))
    dec = torch.where(
        d1 == tax.cid_l1_vehicle, gather_cids(tax.l2_vehicle_cids2common_cids, dv),
        torch.where(d1 == tax.cid_l1_human, gather_cids(tax.l2_human_cids2common_cids, dh),
                    gather_cids(tax.l1_cids2common_cids, d1)))

    def sparse(u, lse, lab):
        c = u.shape[1]
        pick = u[:n_pp].gather(1, lab.long().clamp(0, c - 1)[:, None])[:, 0]
        w = (lab != c - 1).float()
        return torch.sum((lse[:n_pp] - pick) * w), torch.sum(w)

    def dense(u, lse, table, cid):
        c = u.shape[1]
        lab = segment_sum_channels(weak, table, c).permute(0, 3, 1, 2)
        gate = ((1.0 - lab[:, -1]) > 0.01) & (d1[n_pp:] == cid) & (
            lab[:, :-1].amax(1) >= 0.01)
        w = gate.float()
        ce = torch.sum(lab * (lse[n_pp:, None] - u[n_pp:]), 1)
        return torch.sum(ce * w), torch.sum(w)

    l1_sum, l1_cnt = sparse(u1, lse1, pp_l1)
    veh_weak = dense(uv, lsev, tax.per_bbox_cids2vehicle_cids, tax.cid_l1_vehicle)
    hum_weak = dense(uh, lseh, tax.per_bbox_cids2human_cids, tax.cid_l1_human)
    veh = [a + b for a, b in zip(sparse(uv, lsev, pp_veh), veh_weak)]
    hum = [a + b for a, b in zip(sparse(uh, lseh, pp_hum), hum_weak)]
    return torch.stack([l1_sum, l1_cnt, *veh, *hum]), dec, d1


def fused_loss_fwd_plain(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, *,
                         tax: Taxonomy, out_hw):
    """B1 in plain PyTorch: (sums (6,), decisions, l1_decisions) with sums
    [l1_sum, l1_cnt, veh_sum, veh_cnt, hum_sum, hum_cnt]."""
    with torch.no_grad():
        return _plain_terms(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, tax, out_hw)


def fused_loss_bwd_plain(g3, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, *,
                         tax: Taxonomy, out_hw):
    """B2 in plain PyTorch: d(g3 . [l1_sum, veh_sum, hum_sum]) / d logits,
    by autograd through the plain forward."""
    with torch.enable_grad():
        lrs = [t.detach().float().requires_grad_(True) for t in (l1_lr, veh_lr, hum_lr)]
        sums, _, _ = _plain_terms(*lrs, pp_l1, pp_veh, pp_hum, weak, tax, out_hw)
        grads = torch.autograd.grad(torch.sum(sums[0::2] * g3), lrs)
    return tuple(g.contiguous() for g in grads)


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int):
    """Two-tap table of one axis from the interpolation matrix, plus the
    contiguous range of outputs each input touches."""
    m = _bilinear_matrix(in_size, out_size, True)
    lo, hi, _ = _bilinear_tables(in_size, out_size, True)
    rows = np.arange(out_size)
    w0 = m[rows, lo].astype(np.float32)
    w1 = np.where(hi != lo, m[rows, hi], 0.0).astype(np.float32)
    first = np.zeros(in_size, np.int32)
    end = np.zeros(in_size, np.int32)
    for i in range(in_size):
        touch = np.nonzero((lo == i) | (hi == i))[0]
        if touch.size:
            first[i], end[i] = touch[0], touch[-1] + 1
            if touch.size != end[i] - first[i]:
                raise AssertionError("bilinear taps of one input are not contiguous")
    return lo.astype(np.int32), hi.astype(np.int32), w0, w1, first, end


@functools.lru_cache(maxsize=None)
def _device_tables(h: int, w: int, out_h: int, out_w: int, device: torch.device):
    """(itab int32, ftab f32) on the device, and the backward's shared
    memory per f32 channel; built once per shape."""
    rlo, rhi, rw0, rw1, rfirst, rend = _taps(h, out_h)
    clo, chi, cw0, cw1, cfirst, cend = _taps(w, out_w)
    itab = np.concatenate([rlo, rhi, clo, chi, rfirst, rend, cfirst, cend]).astype(np.int32)
    ftab = np.concatenate([rw0, rw1, cw0, cw1]).astype(np.float32)
    chunk_px = max(int(cend[min(j + _J_CHUNK, w) - 1] - cfirst[j]) for j in range(0, w, _J_CHUNK))
    return (torch.as_tensor(itab, device=device), torch.as_tensor(ftab, device=device),
            chunk_px * 4)


@functools.lru_cache(maxsize=None)
def _host_tables(tax: Taxonomy):
    values = np.concatenate([tax.per_bbox_cids2vehicle_cids, tax.per_bbox_cids2human_cids,
                             tax.l1_cids2common_cids, tax.l2_vehicle_cids2common_cids,
                             tax.l2_human_cids2common_cids]).astype(np.int32)
    return (ctypes.c_int * len(values))(*values.tolist())


def _check_inputs(symbol, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, tax, out_hw):
    n, h, w, _ = l1_lr.shape
    n_pp = pp_l1.shape[0]
    H, W = int(out_hw[0]), int(out_hw[1])
    if not fused_loss_available((h, w), (H, W), tax):
        raise ValueError(f"{symbol}: output {(H, W)} smaller than input {(h, w)}")
    expect = {
        "l1_lr": (l1_lr, torch.float32, (n, h, w, tax.num_l1_classes)),
        "veh_lr": (veh_lr, torch.float32, (n, h, w, tax.num_vehicle_classes)),
        "hum_lr": (hum_lr, torch.float32, (n, h, w, tax.num_human_classes)),
        "pp_l1": (pp_l1, torch.int32, (n_pp, H, W)),
        "pp_veh": (pp_veh, torch.int32, (n_pp, H, W)),
        "pp_hum": (pp_hum, torch.int32, (n_pp, H, W)),
        "weak": (weak, torch.float32, (n - n_pp, H, W, len(tax.per_bbox_cids2vehicle_cids))),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != l1_lr.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{symbol}: {name} must be {dtype} {shape} on {l1_lr.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: {name} must be contiguous")
    return n, n_pp, h, w, H, W


def _common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax):
    return [l1_lr.data_ptr(), veh_lr.data_ptr(), hum_lr.data_ptr(), pp_l1.data_ptr(),
            pp_veh.data_ptr(), pp_hum.data_ptr(), weak.data_ptr(), itab.data_ptr(),
            ftab.data_ptr(), ctypes.cast(_host_tables(tax), ctypes.c_void_p)]


def _head_args(tax: Taxonomy):
    return [tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes,
            tax.cid_l1_vehicle, tax.cid_l1_human]


def fused_loss_fwd(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, *, tax: Taxonomy,
                   out_hw):
    """B1: (sums (6,) f32, decisions, l1_decisions (N, H, W) int32).

    l1_lr/veh_lr/hum_lr: (N, h, w, C) f32 stride-8 logits, [per-pixel | weak]
    images; pp_l1/pp_veh/pp_hum: (Npp, H, W) int32 head labels; weak:
    (N - Npp, H, W, 15) f32 weak multinomials.
    """
    if l1_lr.device.type == "cpu":
        return fused_loss_fwd_plain(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak,
                                    tax=tax, out_hw=out_hw)
    if l1_lr.device.type != "cuda":
        raise ValueError(f"fused_loss_fwd: unsupported device {l1_lr.device}")
    n, n_pp, h, w, H, W = _check_inputs("fused_loss_fwd", l1_lr, veh_lr, hum_lr, pp_l1,
                                        pp_veh, pp_hum, weak, tax, out_hw)
    itab, ftab, _ = _device_tables(h, w, H, W, l1_lr.device)
    blocks = -(-H * W // _FWD_PIXELS_PER_BLOCK)
    partials = torch.empty(n * blocks * 6, dtype=torch.float32, device=l1_lr.device)
    sums = torch.empty(6, dtype=torch.float32, device=l1_lr.device)
    dec = torch.empty((n, H, W), dtype=torch.int32, device=l1_lr.device)
    l1dec = torch.empty_like(dec)
    fn = _build.load("fused_loss").iv_fused_loss_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*_common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax),
             partials.data_ptr(), partials.numel(), sums.data_ptr(), dec.data_ptr(),
             l1dec.data_ptr(), n, n_pp, h, w, H, W, *_head_args(tax),
             torch.cuda.current_stream(l1_lr.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_loss_fwd (n,h,w,H,W)={(n, h, w, H, W)}: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    fused_loss_fwd.launches += 1
    return sums, dec, l1dec


def fused_loss_bwd(g3, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, *,
                   tax: Taxonomy, out_hw):
    """B2: (dl1, dveh, dhum), each (N, h, w, C) f32: the gradient of
    g3[0] * l1_sum + g3[1] * veh_sum + g3[2] * hum_sum (g3: (3,) f32)."""
    if l1_lr.device.type == "cpu":
        return fused_loss_bwd_plain(g3, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak,
                                    tax=tax, out_hw=out_hw)
    if l1_lr.device.type != "cuda":
        raise ValueError(f"fused_loss_bwd: unsupported device {l1_lr.device}")
    n, n_pp, h, w, H, W = _check_inputs("fused_loss_bwd", l1_lr, veh_lr, hum_lr, pp_l1,
                                        pp_veh, pp_hum, weak, tax, out_hw)
    if g3.device != l1_lr.device or g3.dtype != torch.float32 or tuple(g3.shape) != (3,) \
            or not g3.is_contiguous():
        raise ValueError(f"fused_loss_bwd: g3 must be contiguous float32 (3,) on {l1_lr.device}")
    itab, ftab, smem_per_channel = _device_tables(h, w, H, W, l1_lr.device)
    c_tot = tax.num_l1_classes + tax.num_vehicle_classes + tax.num_human_classes
    scratch = torch.empty((n, H, w, c_tot), dtype=torch.float32, device=l1_lr.device)
    grads = [torch.empty_like(t) for t in (l1_lr, veh_lr, hum_lr)]
    fn = _build.load("fused_loss").iv_fused_loss_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*_common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax),
             g3.data_ptr(), scratch.data_ptr(), *(g.data_ptr() for g in grads),
             n, n_pp, h, w, H, W, *_head_args(tax), smem_per_channel * c_tot,
             torch.cuda.current_stream(l1_lr.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_loss_bwd (n,h,w,H,W)={(n, h, w, H, W)}: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    fused_loss_bwd.launches += 1
    return tuple(grads)


fused_loss_fwd.launches = 0
fused_loss_bwd.launches = 0


# ------------------------------------------------------------------ autograd


def make_fused_hierarchical_loss(tax: Taxonomy, n_pp: int, n_weak: int, in_hw, out_hw):
    """The ``torch.autograd.Function`` of the fused loss for these shapes.

    ``apply(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak)`` returns
    (sums (6,), decisions, l1_decisions) as ``fused_loss_fwd``. Only the
    three weighted-CE sums carry gradient (counts, decisions, labels and
    gates carry none, as in the reference); the backward is B2.
    """
    in_hw, out_hw = tuple(int(v) for v in in_hw), tuple(int(v) for v in out_hw)

    class FusedHierarchicalLoss(torch.autograd.Function):
        @staticmethod
        def forward(ctx, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak):
            if (pp_l1.shape[0], weak.shape[0]) != (n_pp, n_weak) or \
                    tuple(l1_lr.shape[1:3]) != in_hw:
                raise ValueError(
                    f"fused loss built for n_pp={n_pp}, n_weak={n_weak}, in_hw={in_hw}; got "
                    f"{pp_l1.shape[0]}, {weak.shape[0]}, {tuple(l1_lr.shape[1:3])}")
            args = (l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak)
            sums, dec, l1dec = fused_loss_fwd(*args, tax=tax, out_hw=out_hw)
            ctx.save_for_backward(*args)
            ctx.mark_non_differentiable(dec, l1dec)
            return sums, dec, l1dec

        @staticmethod
        def backward(ctx, g_sums, _g_dec, _g_l1dec):
            if g_sums is None:
                return (None,) * 7
            g3 = g_sums[0::2].float().contiguous()
            grads = fused_loss_bwd(g3, *ctx.saved_tensors, tax=tax, out_hw=out_hw)
            return (*grads, None, None, None, None)

    return FusedHierarchicalLoss


def define_losses_fused(predictions, labels, tax: Taxonomy, out_hw,
                        weak_loss_coefficient=None) -> dict:
    """The reference losses from the *stride-8* logits of ``predictions``
    ((N, h, w, C) f32) and full-resolution ``labels``; returns the losses
    dict of ``define_losses`` plus full-resolution ``decisions`` and
    ``l1_decisions`` (iv2019_tpu/ops/fused_loss.py:466-611, single device)."""
    pp = labels["prolabels_per_pixel"]
    pb, pi = labels["prolabels_per_bbox"], labels["prolabels_per_image"]
    n_pp = pp.shape[0]
    weak = torch.cat([pb, pi], 0) if pi.shape[0] else pb
    weak = weak.float().contiguous()
    l1_lr = predictions["l1_logits"].float().contiguous()
    veh_lr = predictions["l2_vehicle_logits"].float().contiguous()
    hum_lr = predictions["l2_human_logits"].float().contiguous()
    loss_fn = make_fused_hierarchical_loss(tax, n_pp, weak.shape[0], l1_lr.shape[1:3], out_hw)
    heads = [gather_cids(t, pp).contiguous() if n_pp else pp.int()
             for t in (tax.per_pixel_cids2l1_cids, tax.per_pixel_cids2vehicle_cids,
                       tax.per_pixel_cids2human_cids)]
    sums, dec, l1dec = loss_fn.apply(l1_lr, veh_lr, hum_lr, *heads, weak)

    def norm(s, c):
        return torch.where(c > 0, s / c.clamp_min(1.0), torch.zeros_like(s))

    l1_loss, veh_loss, hum_loss = (norm(sums[i], sums[i + 1]) for i in (0, 2, 4))
    coeff = WEAK_LOSS_COEFFICIENT if weak_loss_coefficient is None else weak_loss_coefficient
    return {
        "total": l1_loss + coeff * (veh_loss + hum_loss),
        "l1_segmentation": l1_loss,
        "l2_vehicle_segmentation": veh_loss,
        "l2_human_segmentation": hum_loss,
        "decisions": dec,
        "l1_decisions": l1dec,
    }

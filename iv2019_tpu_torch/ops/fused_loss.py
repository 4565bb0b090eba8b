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

On the H100 both kernels are bound by bytes by the count (the weak labels,
377 MB at the flagship step, are read once) and by instruction issue in
practice (a few hundred instructions per output pixel). Both walk down the
output rows of a block: the block stages the stride-8 logit rows its taps
reach, blends them once per output row in shared memory, and takes each
row's labels by one bulk copy a row ahead. B1's blocks partition the output
pixels (a chunk of output columns by a band of output rows of one image);
per pixel it does only what the pixel's outputs need and sums into its own
slot, which a one-block pass adds in a fixed order. B2's block owns a chunk
of stride-8 columns and a band of stride-8 rows and walks the output rows
that touch them; it evaluates one pixel per thread (only what the pixel's
gradient needs), contracts the gradients over the columns in shared memory
and adds them into the two live stride-8 rows, which it stores when the
walk has passed them. No atomics, no scratch in device memory, the same
bits from run to run. ``_fwd_plan`` and ``_bwd_plan`` compute the launch
plans (chunk and band sizes, threads, shared-memory regions), which the
kernels check and the CPU tests hold to the tap tables. Label tensors may
start anywhere on 4 bytes: the kernels get each one's address rounded down
to 16 bytes and the skew in words (``_label_pointers``), so a sliced view
costs no copy.

``make_fused_hierarchical_loss`` returns the ``torch.autograd.Function``
whose forward is B1 and whose backward is B2; ``define_losses_fused`` is the
drop-in counterpart of ``losses.hierarchical.define_losses`` on stride-8
logits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from iv2019_tpu_torch.losses.hierarchical import WEAK_LOSS_COEFFICIENT
from iv2019_tpu_torch.ops import _build
from iv2019_tpu_torch.ops.resize import _bilinear_matrix, _bilinear_tables
from iv2019_tpu_torch.ops.segment_ops import gather_cids, segment_sum_channels
from iv2019_tpu_torch.parallel import mesh as pmesh
from iv2019_tpu_torch.problem.taxonomy import Taxonomy
from iv2019_tpu_torch.utils.spans import span

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
_WEAK_CLASSES = 15
_LABEL_RING = 2
_FWD_MAX_THREADS = 128
_FWD_MAX_WARPS = _FWD_MAX_THREADS // 32
_FWD_X_CHUNK = 128  # output columns per chunk, before the plan shrinks it
_FWD_Y_BAND = 64    # output rows per band
_BWD_MAX_THREADS = 320
_BWD_J_CHUNK = 16  # stride-8 columns per chunk, before the plan shrinks it
_BWD_I_BAND = 8    # stride-8 rows per band
_MAX_SMEM = 227 * 1024
_ERRORS = {
    -1: "no kernel is compiled for these head widths (Cityscapes 14/7/3, Vistas 53/12/5)",
    -2: "the launch plan is over the device's shared memory",
    -3: "the partial-sum buffer is too small",
    -4: "the launch plan or a label skew disagrees with the kernel's layout",
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
    """(itab int32, ftab f32) on the device; built once per shape."""
    rlo, rhi, rw0, rw1, rfirst, rend = _taps(h, out_h)
    clo, chi, cw0, cw1, cfirst, cend = _taps(w, out_w)
    itab = np.concatenate([rlo, rhi, clo, chi, rfirst, rend, cfirst, cend]).astype(np.int32)
    ftab = np.concatenate([rw0, rw1, cw0, cw1]).astype(np.float32)
    with span("iv.sync.fused_loss_tables"):
        itab = torch.as_tensor(itab, device=device)
    with span("iv.sync.fused_loss_tables"):
        ftab = torch.as_tensor(ftab, device=device)
    return itab, ftab


def _pad4(v: int) -> int:
    return -(-v // 4) * 4


def _label_buffer_words(px: int) -> int:
    """Words of one label-row buffer for rows of ``px`` pixels
    (``label_buffer_words``): a weak row, or the three per-pixel heads'
    segments, each with up to 3 words of skew."""
    return max(_pad4(px * _WEAK_CLASSES + 3), 3 * _pad4(px + 3))


def _label_pointers(*tensors):
    """(addresses rounded down to 16 bytes, skews in words) of the label
    tensors: the kernels copy label rows in 16-byte pieces from the rounded
    address, and element e of a tensor is word e + skew there."""
    ptrs, skews = [], []
    for t in tensors:
        ptr = t.data_ptr()
        if ptr % 4:
            raise ValueError(f"label tensor at {ptr:#x} does not start on 4 bytes")
        skew = ptr % 16 // 4 if t.numel() else 0
        ptrs.append(ptr - 4 * skew)
        skews.append(skew)
    return ptrs, skews


@dataclasses.dataclass(frozen=True)
class _FwdPlan:
    """The launch plan of B1 (``FwdPlan`` of csrc/fused_loss.cu, in its field
    order up to ``smem_bytes``), and what the tests read of it."""

    xc: int           # output columns per chunk
    yb: int           # output rows per band
    threads: int      # >= xc: one thread per output column of a chunk
    cols_max: int     # most stride-8 columns a chunk stages
    rows_max: int     # most stride-8 rows a band stages
    label_words: int  # 4-byte words of one label-row buffer
    smem_bytes: int
    chunks: tuple     # (x0, x1, jlo, jhi): output columns, stride-8 columns staged
    bands: tuple      # (y0, y1, ilo, ihi): output rows, stride-8 rows staged
    scratch_bytes: int = 0  # device memory besides the outputs and partial sums: none

    def as_ints(self):
        return [self.xc, self.yb, self.threads, self.cols_max, self.rows_max, self.label_words,
                self.smem_bytes]

    def slots(self, n: int) -> int:
        """Partial-sum slots (blocks) of a launch over ``n`` images."""
        return n * len(self.chunks) * len(self.bands)

    def smem_words(self, heads):
        """Word offsets of the shared-memory regions, as ``fwd_smem_words``."""
        cp = sum(_pad4(c) for c in heads)
        sizes = [("lr", self.rows_max * self.cols_max * cp), ("rb", 2 * self.cols_max * cp),
                 ("red", 6 * _FWD_MAX_WARPS), ("bars", 2 * _LABEL_RING)]
        out, at = {}, 0
        for name, words in sizes:
            out[name], at = at, at + _pad4(words)
        out["labels"], at = at, at + _LABEL_RING * self.label_words
        out["total"] = at
        return out


@functools.lru_cache(maxsize=None)
def _fwd_plan(h: int, w: int, out_h: int, out_w: int, heads: tuple,
              xc: int = _FWD_X_CHUNK, yb: int = _FWD_Y_BAND) -> _FwdPlan:
    """How B1 cuts (h, w) -> (out_h, out_w) into blocks: chunks of ``xc``
    output columns by bands of ``yb`` output rows per image, which partition
    the output pixels. Each block stages the stride-8 rows and columns its
    pixels' taps reach. ``yb``, then ``xc``, halves until the staged logits
    fit the shared memory."""
    rlo, rhi, *_ = _taps(h, out_h)
    clo, chi, *_ = _taps(w, out_w)
    xc, yb = max(1, min(xc, out_w, _FWD_MAX_THREADS)), max(1, min(yb, out_h))
    while True:
        chunks = tuple((x0, min(x0 + xc, out_w), int(clo[x0]), int(chi[min(x0 + xc, out_w) - 1]))
                       for x0 in range(0, out_w, xc))
        bands = tuple((y0, min(y0 + yb, out_h), int(rlo[y0]), int(rhi[min(y0 + yb, out_h) - 1]))
                      for y0 in range(0, out_h, yb))
        plan = _FwdPlan(
            xc=xc, yb=yb, threads=32 * -(-xc // 32),
            cols_max=max(j1 - j0 + 1 for _, _, j0, j1 in chunks),
            rows_max=max(i1 - i0 + 1 for _, _, i0, i1 in bands),
            label_words=_label_buffer_words(xc), smem_bytes=0, chunks=chunks, bands=bands)
        plan = dataclasses.replace(plan, smem_bytes=4 * plan.smem_words(heads)["total"])
        if plan.smem_bytes <= _MAX_SMEM:
            return plan
        if yb > 1:
            yb = -(-yb // 2)
        elif xc > 1:
            xc = -(-xc // 2)
        else:
            raise ValueError(f"fused_loss_fwd: no launch plan for {(h, w)} -> {(out_h, out_w)}")


@dataclasses.dataclass(frozen=True)
class _BwdPlan:
    """The launch plan of B2 (``WalkPlan`` of csrc/fused_loss.cu, in its
    field order up to ``smem_bytes``), and what the tests read of it."""

    jc: int           # stride-8 columns per chunk
    ib: int           # stride-8 rows per band
    threads: int      # >= the pixels of a chunk (one trip of the pixel loop), unless one
                      # stride-8 column alone touches more pixels than a block has threads
    px_max: int       # most output pixels of one chunk
    cols_max: int     # most stride-8 columns a chunk stages (its own and the halo)
    rows_max: int     # most stride-8 rows a band stages
    taps_max: int     # most output columns that touch one stride-8 column
    label_words: int  # 4-byte words of one label-row buffer
    smem_bytes: int
    chunks: tuple     # (j0, j1, x_begin, x_end): columns owned, output columns evaluated
    bands: tuple      # (i0, i1, y_begin, y_end): rows owned, output rows walked
    scratch_bytes: int = 0  # device memory besides the outputs: none

    def as_ints(self):
        return [self.jc, self.ib, self.threads, self.px_max, self.cols_max, self.rows_max,
                self.taps_max, self.label_words, self.smem_bytes]

    def smem_words(self, heads):
        """Word offsets of the shared-memory regions, as ``bwd_smem_words``."""
        cp, s = sum(_pad4(c) for c in heads), _bwd_stride(sum(heads))
        sizes = [("lr", self.rows_max * self.cols_max * cp), ("rb", self.cols_max * cp),
                 ("d", self.px_max * s), ("coef", self.jc * self.taps_max),
                 ("cstart", self.jc), ("ccnt", self.jc), ("bars", 2 * _LABEL_RING)]
        out, at = {}, 0
        for name, words in sizes:
            out[name], at = at, at + _pad4(words)
        out["labels"], at = at, at + _LABEL_RING * self.label_words
        out["total"] = at
        return out


def _bwd_stride(c_tot: int) -> int:
    """The gradient tile's pixel stride in words (``bwd_stride``): the
    classes in groups of four, padded to an odd number of groups."""
    return 4 * (-(-c_tot // 4) | 1)


def _bwd_units(c_tot: int) -> int:
    """Most (column, four classes) units one thread owns (``bwd_units``)."""
    return -(-16 * -(-c_tot // 4) // 128)


@functools.lru_cache(maxsize=None)
def _bwd_plan(h: int, w: int, out_h: int, out_w: int, heads: tuple,
              jc: int = _BWD_J_CHUNK, ib: int = _BWD_I_BAND) -> _BwdPlan:
    """How B2 cuts (h, w) -> (out_h, out_w) into blocks: chunks of ``jc``
    stride-8 columns by bands of ``ib`` stride-8 rows per image.

    A chunk evaluates the output columns that touch its stride-8 columns
    (one tap of halo per edge) and a band walks the output rows that touch
    its rows, each keeping only its own columns' and rows' sums. ``jc``
    halves until a chunk's pixels fit one trip of the thread block (a chunk
    of one column that still does not takes several trips); ``ib`` halves
    until the staged logit rows fit the shared memory.
    """
    rlo, rhi, _, _, rfirst, rend = _taps(h, out_h)
    clo, chi, _, _, cfirst, cend = _taps(w, out_w)
    c_tot = sum(heads)
    jc, ib = max(1, min(jc, w)), max(1, min(ib, h))
    while True:
        chunks = tuple((j0, min(j0 + jc, w), int(cfirst[j0]), int(cend[min(j0 + jc, w) - 1]))
                       for j0 in range(0, w, jc))
        bands = tuple((i0, min(i0 + ib, h), int(rfirst[i0]), int(rend[min(i0 + ib, h) - 1]))
                      for i0 in range(0, h, ib))
        px_max = max(x1 - x0 for _, _, x0, x1 in chunks)
        threads = 32 * -(-max(px_max, -(-jc * -(-c_tot // 4) // _bwd_units(c_tot))) // 32)
        if threads > _BWD_MAX_THREADS and jc > 1:
            jc = -(-jc // 2)
            continue
        threads = min(threads, _BWD_MAX_THREADS)
        plan = _BwdPlan(
            jc=jc, ib=ib, threads=threads, px_max=px_max,
            cols_max=max(int(chi[x1 - 1] - clo[x0]) + 1 for _, _, x0, x1 in chunks),
            rows_max=max(int(rhi[y1 - 1] - rlo[y0]) + 1 for _, _, y0, y1 in bands),
            taps_max=int((cend - cfirst).max()),
            label_words=_label_buffer_words(px_max),
            smem_bytes=0, chunks=chunks, bands=bands)
        plan = dataclasses.replace(plan, smem_bytes=4 * plan.smem_words(heads)["total"])
        if plan.smem_bytes > _MAX_SMEM and ib > 1:
            ib = -(-ib // 2)
            continue
        if plan.smem_bytes > _MAX_SMEM:
            raise ValueError(f"fused_loss_bwd: no launch plan for {(h, w)} -> {(out_h, out_w)}: "
                             f"the {px_max} output pixels of one stride-8 column take "
                             f"{plan.smem_bytes} bytes of shared memory")
        return plan


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


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax):
    """The entry points' leading arguments: logits, labels (rounded
    addresses), tables, host tables and the labels' skews. The ctypes arrays
    live as long as the returned list."""
    label_ptrs, skews = _label_pointers(pp_l1, pp_veh, pp_hum, weak)
    return [l1_lr.data_ptr(), veh_lr.data_ptr(), hum_lr.data_ptr(), *label_ptrs,
            itab.data_ptr(), ftab.data_ptr(), ctypes.cast(_host_tables(tax), ctypes.c_void_p),
            _ints(skews)]


def _head_args(tax: Taxonomy):
    return [tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes,
            tax.cid_l1_vehicle, tax.cid_l1_human]


def _heads(tax: Taxonomy):
    return (tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes)


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
    itab, ftab = _device_tables(h, w, H, W, l1_lr.device)
    plan = _fwd_plan(h, w, H, W, _heads(tax), _FWD_X_CHUNK, _FWD_Y_BAND)
    partials = torch.empty(plan.slots(n) * 6, dtype=torch.float32, device=l1_lr.device)
    sums = torch.empty(6, dtype=torch.float32, device=l1_lr.device)
    dec = torch.empty((n, H, W), dtype=torch.int32, device=l1_lr.device)
    l1dec = torch.empty_like(dec)
    fn = _build.load("fused_loss").iv_fused_loss_fwd
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    args = _common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax)
    # the CUDA runtime's current device is per thread: launch on the tensors'
    with torch.cuda.device(l1_lr.device):
        err = fn(*args, _ints(plan.as_ints()), partials.data_ptr(), partials.numel(),
                 sums.data_ptr(), dec.data_ptr(), l1dec.data_ptr(), n, n_pp, h, w, H, W,
                 *_head_args(tax), torch.cuda.current_stream(l1_lr.device).cuda_stream)
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
    itab, ftab = _device_tables(h, w, H, W, l1_lr.device)
    plan = _bwd_plan(h, w, H, W, _heads(tax), _BWD_J_CHUNK, _BWD_I_BAND)
    grads = [torch.empty_like(t) for t in (l1_lr, veh_lr, hum_lr)]
    fn = _build.load("fused_loss").iv_fused_loss_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _common_args(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, itab, ftab, tax)
    with torch.cuda.device(l1_lr.device):
        err = fn(*args, g3.data_ptr(), _ints(plan.as_ints()), *(g.data_ptr() for g in grads),
                 n, n_pp, h, w, H, W, *_head_args(tax),
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
                        weak_loss_coefficient=None, mesh=None) -> dict:
    """The reference losses from the *stride-8* logits of ``predictions``
    ((N, h, w, C) f32) and full-resolution ``labels``; returns the losses
    dict of ``define_losses`` plus full-resolution ``decisions`` and
    ``l1_decisions`` (iv2019_tpu/ops/fused_loss.py:466-611).

    With a ``mesh`` (parallel/mesh.py) the batch is this rank's rows of each
    sub-batch, as JAX's mesh branch hands each device (:510-585): B1 runs on
    them, its six sums are all-reduced before the normalization, and the
    decisions stay local. The gradient reaches only the local sums (with
    1 / the global count), so B2 gets the right ``g3`` as it is."""
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
    if mesh is not None:
        sums = pmesh.global_sum(sums, mesh)

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

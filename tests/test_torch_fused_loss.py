"""The fused loss's plain versions (B1/B2 on CPU tensors) against the JAX
package's Pallas kernels run as its own CPU tests run them (interpret mode).

Tolerances (f32 on both sides; the Pallas kernel upsamples with dense
matrix products, the plain version too, in another summation order):
- the six sums and counts: 1e-5 relative;
- ``decisions`` and ``l1_decisions`` equal on >= 99.9% of pixels (a
  near-tie may flip under another summation order);
- gradients w.r.t. the stride-8 logits: 1e-5 of the largest |gradient|;
- the normalized losses of ``define_losses_fused``: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.ops import fused_loss as jfl
from iv2019_tpu.ops.segment_ops import gather_cids as jax_gather_cids
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu_torch.ops import fused_loss as tfl
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from torch_parity import loss_inputs_np, threads

LOGIT_KEYS = ("l1_logits", "l2_vehicle_logits", "l2_human_logits")
SUM_KEYS = ("l1_sum", "l1_cnt", "veh_sum", "veh_cnt", "hum_sum", "hum_cnt")
LOSS_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation")

# (dataset, n_pp, n_pb, n_pi, stride-8 h, w, upsample factor)
CASES = [
    ("cityscapes", 2, 1, 1, 4, 8, 8),   # (4, 8) -> (32, 64)
    ("cityscapes", 2, 0, 0, 4, 8, 8),   # no weak images
    ("vistas", 2, 1, 1, 9, 16, 4),      # 36 rows: no Pallas tile divides it
]


def _inputs(dataset, seed, n_pp, n_pb, n_pi, h, w, scale):
    jtax = jax_taxonomy(dataset)
    lr, labels, out_hw = loss_inputs_np(jtax, seed, n_pp, n_pb, n_pi, h=h, w=w, scale=scale)
    pp = labels["prolabels_per_pixel"]
    heads = [np.asarray(jax_gather_cids(t, jnp.asarray(pp))).astype(np.int32) for t in (
        jtax.per_pixel_cids2l1_cids, jtax.per_pixel_cids2vehicle_cids,
        jtax.per_pixel_cids2human_cids)]
    weak = np.concatenate([labels["prolabels_per_bbox"], labels["prolabels_per_image"]])
    return jtax, lr, labels, heads, weak, out_hw


@pytest.mark.parametrize("case", CASES)
def test_plain_fwd_bwd_match_pallas_interpret(case):
    threads()
    dataset, n_pp, n_pb, n_pi, h, w, scale = case
    jtax, lr, _, heads, weak, out_hw = _inputs(dataset, 0, n_pp, n_pb, n_pi, h, w, scale)
    jfn = jfl.make_fused_hierarchical_loss(jtax, n_pp, weak.shape[0], (h, w), out_hw,
                                           interpret=True)
    jargs = [jnp.asarray(lr[k]) for k in LOGIT_KEYS]
    jlabels = [jnp.asarray(x) for x in heads] + [jnp.asarray(weak)]
    want = jfn(*jargs, *jlabels)
    g3 = np.array([0.3, 0.07, 0.11], np.float32)

    def objective(a, b, c):
        out = jfn(a, b, c, *jlabels)
        return g3[0] * out["l1_sum"] + g3[1] * out["veh_sum"] + g3[2] * out["hum_sum"]

    want_grads = jax.grad(objective, argnums=(0, 1, 2))(*jargs)

    tax = get_taxonomy(dataset)
    targs = [torch.from_numpy(lr[k]) for k in LOGIT_KEYS] + [torch.from_numpy(x) for x in heads]
    targs.append(torch.from_numpy(weak))
    sums, dec, l1dec = tfl.fused_loss_fwd(*targs, tax=tax, out_hw=out_hw)
    grads = tfl.fused_loss_bwd(torch.from_numpy(g3), *targs, tax=tax, out_hw=out_hw)
    np.testing.assert_allclose(sums.numpy(), [float(want[k]) for k in SUM_KEYS], rtol=1e-5)
    assert dec.dtype == l1dec.dtype == torch.int32 and tuple(dec.shape) == (
        n_pp + weak.shape[0], *out_hw)
    assert (dec.numpy() == np.asarray(want["decisions"])).mean() >= 0.999
    assert (l1dec.numpy() == np.asarray(want["l1_decisions"])).mean() >= 0.999
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        assert float(np.abs(g.numpy() - w_).max()) <= 1e-5 * float(np.abs(w_).max())
    if weak.shape[0]:
        assert float(grads[0][n_pp:].abs().max()) == 0.0  # weak images: no L1 gradient


@pytest.mark.parametrize("case", CASES[:2])
def test_define_losses_fused_matches_jax(case):
    """Normalized losses and the gradients that reach the logits through the
    port's autograd Function (forward B1, backward B2)."""
    threads()
    dataset, n_pp, n_pb, n_pi, h, w, scale = case
    jtax, lr, labels, _, _, out_hw = _inputs(dataset, 1, n_pp, n_pb, n_pi, h, w, scale)

    def jax_total(l1, veh, hum):
        out = jfl.define_losses_fused(
            {"l1_logits": l1, "l2_vehicle_logits": veh, "l2_human_logits": hum},
            {k: jnp.asarray(v) for k, v in labels.items()}, jtax, out_hw, interpret=True)
        return out["total"], out

    (_, want), want_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(lr[k]) for k in LOGIT_KEYS))
    preds = {k: torch.from_numpy(lr[k]).requires_grad_(True) for k in LOGIT_KEYS}
    got = tfl.define_losses_fused(preds, {k: torch.from_numpy(v) for k, v in labels.items()},
                                  get_taxonomy(dataset), out_hw)
    got["total"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in ("decisions", "l1_decisions"):
        assert (got[k].numpy() == np.asarray(want[k])).mean() >= 0.999
    for k, w_ in zip(LOGIT_KEYS, want_grads):
        w_ = np.asarray(w_)
        assert float(np.abs(preds[k].grad.numpy() - w_).max()) <= 1e-5 * float(np.abs(w_).max())


def test_plain_fused_loss_at_x4_matches_the_unfused_loss():
    """B1/B2's plain path at x4 (64x64 logits to 256x256 labels, the
    stride-4 logits of ``mit_*`` models) against the unfused hierarchical
    loss (losses/hierarchical.py) on the logits upsampled x4 by the model's
    upsampler: the losses 1e-5 relative, the decisions on >= 99.9% of
    pixels, the logits' gradients 1e-5 of the largest (f32, the same
    upsample as matrices in another order)."""
    from iv2019_tpu_torch.losses.hierarchical import define_losses
    from iv2019_tpu_torch.ops.resize import resize_bilinear_mxu

    threads()
    tax = get_taxonomy("cityscapes")
    lr, labels, out_hw = loss_inputs_np(tax, 4, 2, 2, 1, h=64, w=64, scale=4)
    assert out_hw == (256, 256)
    labels = {k: torch.from_numpy(v) for k, v in labels.items()}
    fused = {k: torch.from_numpy(lr[k]).requires_grad_(True) for k in LOGIT_KEYS}
    got = tfl.define_losses_fused(fused, labels, tax, out_hw)
    got["total"].backward()
    plain = {k: torch.from_numpy(lr[k]).requires_grad_(True) for k in LOGIT_KEYS}
    preds = {k: resize_bilinear_mxu(plain[k], out_hw, align_corners=True) for k in LOGIT_KEYS}
    preds["l1_decisions"] = torch.argmax(preds["l1_logits"], -1).int()
    want = define_losses(preds, labels, tax)
    want["total"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert (got["l1_decisions"] == preds["l1_decisions"]).float().mean() >= 0.999
    for k in LOGIT_KEYS:
        w_ = plain[k].grad
        assert float((fused[k].grad - w_).abs().max()) <= 1e-5 * float(w_.abs().max()), k


def test_fused_loss_availability_and_shape_checks():
    tax = get_taxonomy("cityscapes")
    assert tfl.fused_loss_available((64, 128), (512, 1024), tax)
    assert tfl.fused_loss_available((78, 107), (621, 855), get_taxonomy("vistas"))
    assert not tfl.fused_loss_available((64, 128), (32, 64), tax)
    fn = tfl.make_fused_hierarchical_loss(tax, 1, 1, (4, 8), (32, 64))
    logits = [torch.zeros(2, 4, 8, c) for c in (14, 7, 3)]
    labels = [torch.zeros(2, 32, 64, dtype=torch.int32)] * 3  # two per-pixel images, not one
    with pytest.raises(ValueError):
        fn.apply(*logits, *labels, torch.zeros(0, 32, 64, 15))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused; a
    CUDA tensor would reach the kernel (tests/test_torch_kernels_gpu.py)."""
    tax = get_taxonomy("cityscapes")
    meta = [torch.empty(1, 4, 8, c, device="meta") for c in (14, 7, 3)]
    with pytest.raises(ValueError):
        tfl.fused_loss_fwd(*meta, *[torch.empty(1, 32, 64, dtype=torch.int32)] * 3,
                           torch.empty(0, 32, 64, 15), tax=tax, out_hw=(32, 64))


# ---------------------------------------------------------------- B2's launch plan

MAX_SMEM = 232_448
CITY, VISTAS = (14, 7, 3), (53, 12, 5)
# (h, w, H, W, heads, jc, ib): the flagship at both head widths, ragged
# shapes, a single row, out == in, a last chunk of one column, a last band
# of one row, a large factor (the plan shrinks the chunk), tiny blocks, one
# column that touches more pixels than a block has threads (several trips)
PLAN_SHAPES = [
    (64, 128, 512, 1024, CITY, 16, 8),
    (64, 128, 512, 1024, VISTAS, 16, 8),
    (5, 7, 33, 49, CITY, 16, 8),
    (1, 9, 8, 72, CITY, 16, 8),
    (6, 7, 6, 7, CITY, 16, 8),
    (9, 17, 70, 131, CITY, 16, 8),
    (9, 16, 36, 64, VISTAS, 16, 8),
    (17, 33, 129, 257, CITY, 16, 8),
    (4, 8, 128, 256, CITY, 16, 8),
    (11, 37, 50, 150, CITY, 4, 2),
    (78, 107, 621, 855, VISTAS, 16, 8),
    (3, 1, 20, 5, CITY, 16, 8),
    (1, 1, 8, 700, CITY, 16, 8),
    # x4: SegFormer-B5's stride-4 logits at its 1024x1024 crop, and the CPU
    # tests' 64x64 -> 256x256
    (256, 256, 1024, 1024, CITY, 16, 8),
    (64, 64, 256, 256, CITY, 16, 8),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_bwd_plan_covers_every_tap_once(shape):
    """Every stride-8 row and column is owned by exactly one band and chunk,
    and the owner evaluates every output row and column that touches it: so
    each logit's sum is complete and is stored once, with no scratch."""
    h, w, H, W, heads, jc, ib = shape
    plan = tfl._bwd_plan(h, w, H, W, heads, jc, ib)
    for size, out_size, blocks in ((h, H, plan.bands), (w, W, plan.chunks)):
        lo, hi, _, _, first, end = tfl._taps(size, out_size)
        owner = np.full(size, -1)
        for b, (i0, i1, o0, o1) in enumerate(blocks):
            assert (owner[i0:i1] == -1).all() and i1 > i0
            owner[i0:i1] = b
            assert (o0, o1) == (first[i0:i1].min(), end[i0:i1].max())
        assert (owner >= 0).all()
        for o in range(out_size):  # each tap of each output index has one owner, who walks it
            for tap in {int(lo[o]), int(hi[o])}:
                _, _, o0, o1 = blocks[owner[tap]]
                assert o0 <= o < o1
        covered = np.zeros(out_size, int)
        for _, _, o0, o1 in blocks:
            covered[o0:o1] += 1
        assert covered.min() >= 1 and covered.max() <= 2  # one tap of halo per edge
    assert plan.scratch_bytes == 0


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_bwd_plan_fits_the_block(shape):
    """Threads cover a chunk's pixels in one trip (unless a single column has
    more), the (column, four classes) units fit the threads, the staged tiles hold what the taps reach, the
    label rows copy in whole 16-byte pieces inside their buffers and tensors,
    and the shared memory is within the card's."""
    h, w, H, W, heads, jc, ib = shape
    plan = tfl._bwd_plan(h, w, H, W, heads, jc, ib)
    c_tot, c4 = sum(heads), -(-sum(heads) // 4)
    rlo, rhi, *_ = tfl._taps(h, H)
    clo, chi, _, _, cfirst, cend = tfl._taps(w, W)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= tfl._BWD_MAX_THREADS
    assert plan.jc * c4 <= tfl._bwd_units(c_tot) * plan.threads
    assert plan.taps_max == (cend - cfirst).max()
    for _, _, x0, x1 in plan.chunks:
        assert 0 < x1 - x0 <= plan.px_max
        assert plan.px_max <= plan.threads or plan.jc == 1
        assert chi[x1 - 1] - clo[x0] + 1 <= plan.cols_max
    for _, _, y0, y1 in plan.bands:
        assert rhi[y1 - 1] - rlo[y0] + 1 <= plan.rows_max
    words = plan.smem_words(heads)
    assert plan.smem_bytes == 4 * words["total"] <= MAX_SMEM
    assert all(v % 4 == 0 for v in words.values())  # every region starts on 16 bytes
    assert tfl._bwd_stride(c_tot) % 4 == 0 and tfl._bwd_stride(c_tot) // 4 % 2 == 1
    # the label copies of every (image, row, chunk): from e0 rounded down to 4
    # words, in 4-word pieces, the last zero-filled past the tensor's end
    n_img = 3
    for per_px, total, room in ((15, n_img * H * W * 15, plan.label_words),
                                (1, n_img * H * W, tfl._pad4(plan.px_max + 3))):
        assert 3 * tfl._pad4(plan.px_max + 3) <= plan.label_words
        for img in (0, n_img - 1):
            for y in (0, H // 2, H - 1):
                for _, _, x0, x1 in plan.chunks:
                    e0 = ((img * H + y) * W + x0) * per_px
                    e1 = e0 + (x1 - x0) * per_px
                    start, pieces = e0 & ~3, (e1 - (e0 & ~3) + 3) // 4
                    assert start % 4 == 0 and 0 <= start and 4 * pieces <= room
                    assert start + 4 * (pieces - 1) < total and e1 <= total


def test_bwd_plan_shrinks_to_fit():
    """A large upsampling factor halves the chunk until its pixels fit one
    trip; Vistas rows that overflow the shared memory halve the band."""
    plan = tfl._bwd_plan(4, 64, 128, 2048, CITY)
    assert plan.jc < 16 and plan.px_max <= plan.threads <= tfl._BWD_MAX_THREADS
    big = tfl._bwd_plan(64, 128, 512, 1024, VISTAS, 16, 64)
    assert big.ib < 64 and big.smem_bytes <= MAX_SMEM
    wide = tfl._bwd_plan(1, 1, 8, 700, CITY)  # one column, 700 pixels: three trips
    assert wide.jc == 1 and wide.px_max == 700 and wide.threads == tfl._BWD_MAX_THREADS
    with pytest.raises(ValueError):
        tfl._bwd_plan(2, 2, 2, 2000, CITY)  # one column's pixels over the shared memory


# ---------------------------------------------------------------- B2's walk, emulated


def _emulate_walk(g3, l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, tax, out_hw, jc, ib):
    """The kernel's walk in plain PyTorch, block by block: the staged logit
    tile with its relative indices, the row blend, the pixel gradients, the
    column contraction from the coefficient table, the two live rows and
    their retirement. Checks the indexing where no card is needed; the
    arithmetic is torch's (f32, sums in the kernel's order)."""
    n, h, w, _ = l1_lr.shape
    H, W = out_hw
    heads = (tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes)
    c1, cv, _ = heads
    plan = tfl._bwd_plan(h, w, H, W, heads, jc, ib)
    rlo, rhi, rw0, rw1, _, _ = tfl._taps(h, H)
    clo, chi, cw0, cw1, cfirst, cend = tfl._taps(w, W)
    n_pp = pp_l1.shape[0]
    lr_all = torch.cat([l1_lr, veh_lr, hum_lr], -1)
    out = torch.full_like(lr_all, float("nan"))
    masks = [torch.tensor(np.asarray(t)[:, None] == np.arange(c)[None], dtype=torch.float32)
             for t, c in ((tax.per_bbox_cids2vehicle_cids, heads[1]),
                          (tax.per_bbox_cids2human_cids, heads[2]))]

    def softmax_grad(u, onehot_or_label, weight):
        return weight[:, None] * (torch.softmax(u, -1) - onehot_or_label)

    for img in range(n):
        for i0, i1, y_begin, y_end in plan.bands:
            for j0, j1, x_begin, x_end in plan.chunks:
                px = x_end - x_begin
                jlo, ilo = int(clo[x_begin]), int(rlo[y_begin])
                tile = lr_all[img, ilo:int(rhi[y_end - 1]) + 1, jlo:int(chi[x_end - 1]) + 1]
                assert tile.shape[0] <= plan.rows_max and tile.shape[1] <= plan.cols_max
                xs = np.arange(x_begin, x_end)
                x0l, x1l = clo[xs] - jlo, chi[xs] - jlo
                wx0, wx1 = torch.tensor(cw0[xs])[:, None], torch.tensor(cw1[xs])[:, None]
                coef = torch.zeros(j1 - j0, plan.taps_max)
                for jl, j in enumerate(range(j0, j1)):
                    for k, x in enumerate(range(cfirst[j], cend[j])):
                        coef[jl, k] = float(cw0[x] if clo[x] == j else 0.0) + float(
                            cw1[x] if chi[x] == j else 0.0)
                cur = ilo
                acc_lo = torch.zeros(j1 - j0, lr_all.shape[-1])
                acc_hi = torch.zeros_like(acc_lo)

                def retire(i):
                    nonlocal acc_lo, acc_hi
                    if i0 <= i < i1:
                        assert torch.isnan(out[img, i, j0:j1]).all()  # stored exactly once
                        out[img, i, j0:j1] = acc_lo
                    acc_lo, acc_hi = acc_hi, torch.zeros_like(acc_hi)

                for y in range(y_begin, y_end):
                    rb = float(rw0[y]) * tile[int(rlo[y]) - ilo] + float(rw1[y]) * tile[int(rhi[y]) - ilo]
                    u = wx0 * rb[x0l] + wx1 * rb[x1l]
                    u1, uv, uh = u[:, :c1], u[:, c1:c1 + cv], u[:, c1 + cv:]
                    d = torch.zeros(px, lr_all.shape[-1])
                    if img < n_pp:
                        for head, (uu, lab) in enumerate(((u1, pp_l1), (uv, pp_veh), (uh, pp_hum))):
                            lab = lab[img, y, x_begin:x_end].long()
                            c = uu.shape[1]
                            grad = softmax_grad(uu, torch.nn.functional.one_hot(lab, c).float(),
                                                (lab != c - 1).float() * g3[head])
                            d[:, sum(heads[:head]):sum(heads[:head + 1])] = grad
                    else:
                        wk = weak[img - n_pp, y, x_begin:x_end]
                        d1 = u1.argmax(-1)
                        for head, (uu, cid) in enumerate(((uv, tax.cid_l1_vehicle),
                                                          (uh, tax.cid_l1_human)), 1):
                            lab = wk @ masks[head - 1]
                            gate = ((1.0 - lab[:, -1]) > 0.01) & (d1 == cid) & (
                                lab[:, :-1].amax(-1) >= 0.01)
                            grad = softmax_grad(uu, lab, gate.float() * g3[head])
                            d[:, sum(heads[:head]):sum(heads[:head + 1])] = grad
                    while cur < rlo[y]:
                        retire(cur)
                        cur += 1
                    r = torch.zeros_like(acc_lo)
                    for jl, j in enumerate(range(j0, j1)):
                        start, cnt = int(cfirst[j]) - x_begin, int(cend[j] - cfirst[j])
                        r[jl] = coef[jl, :cnt] @ d[start:start + cnt]
                    acc_lo = acc_lo + float(rw0[y]) * r
                    acc_hi = acc_hi + float(rw1[y]) * r
                retire(cur)
                retire(cur + 1)
    assert not torch.isnan(out).any()
    return out[..., :c1], out[..., c1:c1 + cv], out[..., c1 + cv:]


# CASES with one block per image, then ragged shapes cut into several chunks
# and bands (3 x 2 and 3 x 6 blocks per image)
WALK_CASES = [(*case, 16, 8) for case in CASES] + [
    ("cityscapes", 1, 1, 1, 11, 37, None, 16, 8),
    ("cityscapes", 1, 2, 0, 11, 13, None, 5, 2),
]


@pytest.mark.parametrize("case", WALK_CASES)
def test_emulated_walk_matches_plain_bwd(case):
    """The walk (bands, chunks, halo, the two live rows, the tap tables)
    against autograd through the plain forward: 1e-5 of the largest
    |gradient| (f32, another summation order)."""
    threads()
    dataset, n_pp, n_pb, n_pi, h, w, scale, jc, ib = case
    if scale is None:  # ragged: no integer factor
        out_hw = {(11, 37): (50, 150), (11, 13): (41, 37)}[(h, w)]
        jtax, lr, _, heads, weak, _ = _inputs(dataset, 2, n_pp, n_pb, n_pi, h, w, 4)
        rng = np.random.RandomState(5)
        heads = [rng.randint(0, c, (n_pp, *out_hw)).astype(np.int32) for c in (
            jtax.num_l1_classes, jtax.num_vehicle_classes, jtax.num_human_classes)]
        raw = rng.dirichlet(np.full(15, 0.3), (weak.shape[0], *out_hw)).astype(np.float32)
        weak = np.where(rng.rand(*raw.shape[:3], 1) < 0.5, raw, np.eye(15, dtype=np.float32)[
            rng.randint(0, 15, raw.shape[:3])]).astype(np.float32)
    else:
        _, lr, _, heads, weak, out_hw = _inputs(dataset, 0, n_pp, n_pb, n_pi, h, w, scale)
    tax = get_taxonomy(dataset)
    args = [torch.from_numpy(lr[k]) for k in LOGIT_KEYS] + [torch.from_numpy(x) for x in heads]
    args.append(torch.from_numpy(weak))
    g3 = torch.tensor([0.3, 0.07, 0.11])
    want = tfl.fused_loss_bwd_plain(g3, *args, tax=tax, out_hw=out_hw)
    got = _emulate_walk(g3, *args, tax, out_hw, jc, ib)
    for g, w_ in zip(got, want):
        assert float((g - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


# ---------------------------------------------------------------- B1's launch plan


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_fwd_plan_owns_every_pixel_once(shape):
    """The chunks and bands partition the output pixels (no halo: each is
    evaluated once), each block stages every stride-8 row and column its
    pixels' taps reach, and there is one partial-sum slot per block."""
    h, w, H, W, heads, _, _ = shape
    plan = tfl._fwd_plan(h, w, H, W, heads)
    owned = np.zeros((H, W), int)
    for y0, y1, _, _ in plan.bands:
        for x0, x1, _, _ in plan.chunks:
            owned[y0:y1, x0:x1] += 1
    assert (owned == 1).all()
    for size, out_size, blocks in ((h, H, plan.bands), (w, W, plan.chunks)):
        lo, hi, *_ = tfl._taps(size, out_size)
        assert blocks[0][0] == 0 and blocks[-1][1] == out_size
        for (o0, o1, s0, s1), nxt in zip(blocks, blocks[1:] + ((out_size,),)):
            assert o0 < o1 == nxt[0]
            assert (s0, s1) == (lo[o0], hi[o1 - 1])
            assert s0 <= lo[o0:o1].min() and hi[o0:o1].max() <= s1 < size
    assert plan.slots(16) == 16 * len(plan.chunks) * len(plan.bands)
    assert plan.scratch_bytes == 0


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_fwd_plan_fits_the_block(shape):
    """One thread per output column of a chunk, the staged tile holds the
    taps' rows and columns, the block sums of every warp fit their region,
    the label rows copy in whole 16-byte pieces inside their buffers at every
    skew, and the shared memory is within the card's."""
    h, w, H, W, heads, _, _ = shape
    plan = tfl._fwd_plan(h, w, H, W, heads)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= tfl._FWD_MAX_THREADS
    assert plan.xc <= plan.threads
    for x0, x1, j0, j1 in plan.chunks:
        assert x1 - x0 <= plan.xc and j1 - j0 + 1 <= plan.cols_max
    for y0, y1, i0, i1 in plan.bands:
        assert y1 - y0 <= plan.yb and i1 - i0 + 1 <= plan.rows_max
    words = plan.smem_words(heads)
    assert plan.smem_bytes == 4 * words["total"] <= MAX_SMEM
    assert all(v % 4 == 0 for v in words.values())  # every region starts on 16 bytes
    assert words["rb"] - words["lr"] >= plan.rows_max * plan.cols_max * sum(
        tfl._pad4(c) for c in heads)
    assert words["bars"] - words["red"] >= 6 * plan.threads // 32
    sub = tfl._pad4(plan.xc + 3)
    assert plan.label_words == tfl._label_buffer_words(plan.xc) >= 3 * sub
    for per_px, room in ((15, plan.label_words), (1, sub)):
        for skew in range(4):
            for x0, x1, _, _ in plan.chunks:
                e0 = (2 * H * W + (H - 1) * W + x0) * per_px + skew
                e1 = e0 + (x1 - x0) * per_px
                assert 4 * ((e1 - (e0 & ~3) + 3) // 4) <= room


def test_fwd_plan_shrinks_to_fit():
    """Vistas bands too tall for the shared memory halve, down to bands of
    two rows at out == in (a stride-8 column per output column, and the
    next one as the second tap)."""
    big = tfl._fwd_plan(64, 128, 512, 1024, VISTAS, 128, 512)
    assert big.yb < 512 and big.smem_bytes <= MAX_SMEM
    same = tfl._fwd_plan(30, 200, 30, 200, VISTAS)
    assert same.smem_bytes <= MAX_SMEM and same.cols_max == same.xc + 1 and same.yb == 2
    assert tfl._fwd_plan(64, 128, 512, 1024, CITY).as_ints()[:3] == [128, 64, 128]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_label_pointers_round_down_to_16_bytes(offset):
    """Views that start 1-3 elements off 16 bytes are taken as they are: the
    kernels get the address rounded down and the skew in words."""
    buf = torch.zeros(64, dtype=torch.int32)
    base = buf[(-buf.data_ptr() // 4) % 4:]  # a view that starts on 16 bytes
    views = [base[offset:offset + 8], base[offset:offset + 8].float(), torch.zeros(0)]
    ptrs, skews = tfl._label_pointers(*views)
    for t, ptr, skew in zip(views, ptrs, skews):
        assert ptr % 16 == 0 and 0 <= skew <= 3
        assert ptr + 4 * skew == t.data_ptr() or t.numel() == 0
    assert skews[0] == offset and skews[2] == 0
    odd = torch.frombuffer(bytearray(64), dtype=torch.int32, offset=1, count=4)
    with pytest.raises(ValueError):
        tfl._label_pointers(odd)


# ---------------------------------------------------------------- B1's walk, emulated


def _stage(flat, skew, e0, count, room):
    """One label row as ``stage_labels`` copies it: from element e0 of
    ``flat`` (a tensor whose memory starts ``skew`` words past 16 bytes),
    whole 4-word pieces from the rounded-down word, the last words by plain
    loads at the tensor's end. Returns (buffer, word of element e0 in it)."""
    a, total = (e0 + skew) & ~3, flat.numel() + skew
    e1 = e0 + skew + count
    pieces = min((e1 - a + 3) // 4, (total - a) // 4)
    assert 4 * pieces <= room and e1 - a <= room
    memory = torch.cat([torch.zeros(skew, dtype=flat.dtype), flat])  # from the rounded address
    buf = torch.full((room,), -12345, dtype=flat.dtype)
    buf[:4 * pieces] = memory[a:a + 4 * pieces]
    buf[4 * pieces:e1 - a] = memory[a + 4 * pieces:e1]  # the tail, at most 3 words
    return buf, e0 + skew - a


def _emulate_fwd_walk(l1_lr, veh_lr, hum_lr, pp_l1, pp_veh, pp_hum, weak, tax, out_hw,
                      xc=128, yb=64, skews=(0, 0, 0, 0), skips=True):
    """B1's walk in plain PyTorch, block by block: the staged logit tile and
    its non-finite flags, the label rows as the bulk copies leave them, the
    row blend, the column blend, per pixel only the heads its outputs need
    (``skips``; else every head, weighted by 0 where unused), each thread's
    sums over its rows, the block's fixed-order reduction into its slot.
    Returns (sums (6,), decisions, l1_decisions). The arithmetic is torch's
    (f32, each blend a separate multiply and add)."""
    n, h, w, _ = l1_lr.shape
    H, W = out_hw
    heads = (tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes)
    plan = tfl._fwd_plan(h, w, H, W, heads, xc, yb)
    rlo, rhi, rw0, rw1, _, _ = tfl._taps(h, H)
    clo, chi, cw0, cw1, _, _ = tfl._taps(w, W)
    n_pp = pp_l1.shape[0]
    masks = [torch.tensor(np.asarray(t)[:, None] == np.arange(c)[None], dtype=torch.float32)
             for t, c in ((tax.per_bbox_cids2vehicle_cids, heads[1]),
                          (tax.per_bbox_cids2human_cids, heads[2]))]
    commons = [torch.as_tensor(np.asarray(t, np.int64)) for t in (
        tax.l1_cids2common_cids, tax.l2_vehicle_cids2common_cids, tax.l2_human_cids2common_cids)]
    cids = (tax.cid_l1_vehicle, tax.cid_l1_human)
    sub = tfl._pad4(plan.xc + 3)
    dec = torch.full((n, H, W), -1, dtype=torch.int32)
    l1dec = torch.full_like(dec, -1)
    slots = []

    def sparse_ce(u, lab):
        m = u.max(-1).values
        pick = u.gather(-1, lab.long().clamp(0, u.shape[-1] - 1)[:, None])[:, 0]
        return (m - pick) + torch.log(torch.exp(u - m[:, None]).sum(-1))

    def dense_ce(u, lab):
        m = u.max(-1).values
        lse = m + torch.log(torch.exp(u - m[:, None]).sum(-1))
        return (lab * (lse[:, None] - u)).sum(-1)

    for img in range(n):
        for y0, y1, ilo, ihi in plan.bands:
            for x0, x1, jlo, jhi in plan.chunks:
                px = x1 - x0
                tiles = [t[img, ilo:ihi + 1, jlo:jhi + 1] for t in (l1_lr, veh_lr, hum_lr)]
                assert tiles[0].shape[0] <= plan.rows_max and tiles[0].shape[1] <= plan.cols_max
                bad = [not bool(torch.isfinite(t).all()) for t in tiles]
                xs = np.arange(x0, x1)
                wx0, wx1 = torch.tensor(cw0[xs])[:, None], torch.tensor(cw1[xs])[:, None]
                acc = torch.zeros(6, plan.threads)
                for y in range(y0, y1):
                    u1, uv, uh = (
                        wx0 * rb[clo[xs] - jlo] + wx1 * rb[chi[xs] - jlo]
                        for rb in (float(rw0[y]) * t[rlo[y] - ilo] + float(rw1[y]) * t[rhi[y] - ilo]
                                   for t in tiles))
                    d1 = u1.argmax(-1)
                    dv, dh = uv.argmax(-1), uh.argmax(-1)
                    terms = torch.zeros(6, px)
                    if img < n_pp:
                        labs = []
                        for k, t in enumerate((pp_l1, pp_veh, pp_hum)):
                            buf, at = _stage(t.reshape(-1), skews[k], (img * H + y) * W + x0,
                                             px, sub)
                            labs.append(buf[at:at + px])
                        for k, (u, lab) in enumerate(zip((u1, uv, uh), labs)):
                            used = lab != heads[k] - 1
                            if skips:
                                ce = torch.zeros(px)
                                ce[used] = sparse_ce(u[used], lab[used])
                            else:
                                ce = sparse_ce(u, lab) * used.float()
                            terms[2 * k], terms[2 * k + 1] = ce, used.float()
                    else:
                        buf, at = _stage(weak.reshape(-1), skews[3],
                                         ((img - n_pp) * H + y) * W * 15 + x0 * 15, px * 15,
                                         plan.label_words)
                        wk = buf[at:at + 15 * px].reshape(px, 15)
                        for k, (u, mask, cid) in enumerate(zip((uv, uh), masks, cids), 1):
                            lab = torch.zeros(px, mask.shape[1])
                            for j in range(15):  # the weak classes in order
                                lab = lab + wk[:, j:j + 1] * mask[j]
                            gate = ((1.0 - lab[:, -1]) > 0.01) & (lab[:, :-1].amax(-1) >= 0.01)
                            gate &= d1 == cid
                            if skips:
                                ce = torch.zeros(px)
                                ce[gate] = dense_ce(u[gate], lab[gate])
                            else:
                                ce = dense_ce(u, lab) * gate.float()
                            terms[2 * k], terms[2 * k + 1] = ce, gate.float()
                    acc[:, :px] = acc[:, :px] + terms
                    fused = torch.where(d1 == cids[0], commons[1][dv],
                                        torch.where(d1 == cids[1], commons[2][dh], commons[0][d1]))
                    assert (dec[img, y, x0:x1] == -1).all()  # each pixel once
                    dec[img, y, x0:x1], l1dec[img, y, x0:x1] = fused.int(), d1.int()
                # lanes by a shuffle tree, then warps in order
                v = acc.reshape(6, -1, 32)
                for off in (16, 8, 4, 2, 1):
                    v = v + v[:, :, np.arange(32) ^ off]
                block = v[:, 0, 0]
                for k in range(1, v.shape[1]):
                    block = block + v[:, k, 0]
                for k, flag in ((0, bad[0] and img < n_pp), (2, bad[1]), (4, bad[2])):
                    if flag:
                        block[k] = float("nan")
                slots.append(block)
    sums = torch.stack(slots).double().sum(0).float()
    assert (dec >= 0).all()
    return sums, dec, l1dec


def _case_args(dataset, n_pp, n_pb, n_pi, h, w, scale, seed=0):
    """numpy inputs of one case as torch tensors; ragged shapes (scale None)
    get random labels and Dirichlet/one-hot weak labels."""
    if scale is None:
        out_hw = {(11, 37): (50, 150), (11, 13): (41, 37)}[(h, w)]
        jtax, lr, _, heads, weak, _ = _inputs(dataset, 2, n_pp, n_pb, n_pi, h, w, 4)
        rng = np.random.RandomState(5)
        heads = [rng.randint(0, c, (n_pp, *out_hw)).astype(np.int32) for c in (
            jtax.num_l1_classes, jtax.num_vehicle_classes, jtax.num_human_classes)]
        raw = rng.dirichlet(np.full(15, 0.3), (weak.shape[0], *out_hw)).astype(np.float32)
        weak = np.where(rng.rand(*raw.shape[:3], 1) < 0.5, raw, np.eye(15, dtype=np.float32)[
            rng.randint(0, 15, raw.shape[:3])]).astype(np.float32)
    else:
        jtax, lr, _, heads, weak, out_hw = _inputs(dataset, seed, n_pp, n_pb, n_pi, h, w, scale)
    args = [torch.from_numpy(lr[k]) for k in LOGIT_KEYS] + [torch.from_numpy(x) for x in heads]
    args.append(torch.from_numpy(weak))
    return jtax, args, out_hw


# CASES with one block per image, ragged shapes cut into several chunks and
# bands (small chunks and bands: 3 x 5 and 5 x 3 blocks per image), label
# skews of 1-3 words
FWD_WALK_CASES = [(*case, 128, 64, (0, 0, 0, 0)) for case in CASES] + [
    ("cityscapes", 1, 1, 1, 11, 37, None, 64, 12, (1, 2, 3, 1)),
    ("cityscapes", 1, 2, 0, 11, 13, None, 15, 9, (3, 0, 1, 2)),
]


@pytest.mark.parametrize("case", FWD_WALK_CASES)
def test_emulated_fwd_walk_matches_plain_and_pallas(case):
    """The walk (chunks, bands, staged tiles, label rows at every skew, the
    skips, the per-block slots) against the plain forward and the JAX Pallas
    kernel in interpret mode: sums within 1e-5 relative (f32, another
    summation order); decisions equal but for near-ties (>= 99.9%)."""
    threads()
    dataset, n_pp, n_pb, n_pi, h, w, scale, xc, yb, skews = case
    jtax, args, out_hw = _case_args(dataset, n_pp, n_pb, n_pi, h, w, scale)
    tax = get_taxonomy(dataset)
    sums, dec, l1dec = _emulate_fwd_walk(*args, tax, out_hw, xc, yb, skews)
    want_sums, want_dec, want_l1dec = tfl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw)
    np.testing.assert_allclose(sums.numpy(), want_sums.numpy(), rtol=1e-5)
    assert (dec == want_dec).float().mean() >= 0.999
    assert (l1dec == want_l1dec).float().mean() >= 0.999
    jfn = jfl.make_fused_hierarchical_loss(jtax, n_pp, args[6].shape[0], (h, w), out_hw,
                                           interpret=True)
    jout = jfn(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(sums.numpy(), [float(jout[k]) for k in SUM_KEYS], rtol=1e-5)
    assert (dec.numpy() == np.asarray(jout["decisions"])).mean() >= 0.999


@pytest.mark.parametrize("case", FWD_WALK_CASES[:1] + FWD_WALK_CASES[3:])
def test_emulated_fwd_decisions_equal_the_four_tap_blend(case):
    """The walk's decisions are bit-equal to an argmax of the 4-tap blend
    written as separate tensor multiplies and adds over the whole image
    (chip_smoke.tap_decisions, which holds the kernel to the same on the
    card): the row blend once per row changes no rounding."""
    import chip_smoke

    dataset, n_pp, n_pb, n_pi, h, w, scale, xc, yb, skews = case
    _, args, out_hw = _case_args(dataset, n_pp, n_pb, n_pi, h, w, scale)
    tax = get_taxonomy(dataset)
    _, dec, l1dec = _emulate_fwd_walk(*args, tax, out_hw, xc, yb, skews)
    want_dec, want_l1dec = chip_smoke.tap_decisions(tax, *args[:3], out_hw)
    assert torch.equal(dec, want_dec) and torch.equal(l1dec, want_l1dec)


@pytest.mark.parametrize("case", FWD_WALK_CASES[1:2] + FWD_WALK_CASES[3:])
def test_emulated_fwd_skips_change_no_bit(case):
    """Leaving out the terms of weight 0 (void labels, closed gates, the L2
    head a weak pixel's decision does not name) gives the same bits as
    adding them times 0, on finite logits."""
    dataset, n_pp, n_pb, n_pi, h, w, scale, xc, yb, skews = case
    _, args, out_hw = _case_args(dataset, n_pp, n_pb, n_pi, h, w, scale)
    tax = get_taxonomy(dataset)
    with_skips = _emulate_fwd_walk(*args, tax, out_hw, xc, yb, skews, skips=True)
    without = _emulate_fwd_walk(*args, tax, out_hw, xc, yb, skews, skips=False)
    assert all(torch.equal(a, b) for a, b in zip(with_skips, without))


# (logit tensor, image, value): an inf in a per-pixel image's L1 logits, a
# NaN in a weak image's vehicle logits, an inf in a weak image's L1 logits
# (which no sum takes)
NONFINITE = [(0, 0, float("inf")), (1, 3, float("nan")), (0, 2, float("-inf"))]


@pytest.mark.parametrize("where", NONFINITE)
def test_emulated_fwd_nonfinite_logits_show_where_plain_does(where):
    """A non-finite logit makes exactly the sums non-finite that the plain
    version's are: a diverged step is not hidden by the skips."""
    k, img, value = where
    _, args, out_hw = _case_args("cityscapes", 2, 1, 1, 4, 8, 8)
    args[k] = args[k].clone()
    args[k][img, 1, 2, 3] = value
    tax = get_taxonomy("cityscapes")
    sums, _, _ = _emulate_fwd_walk(*args, tax, out_hw, 16, 8)
    want, _, _ = tfl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw)
    assert torch.equal(torch.isfinite(sums), torch.isfinite(want))
    assert not bool(torch.isfinite(want).all()) or k == 0 and img >= 2

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

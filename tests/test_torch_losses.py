"""The port's hierarchical losses against iv2019_tpu/losses/hierarchical.py.

Full-resolution f32 logits, the same labels on both sides. Tolerances: the
losses 1e-5 relative and the gradients w.r.t. the logits 1e-5 of the
largest |gradient| (f32, sums over the batch in another order); the weight
masks are 0/1 from the same f32 comparisons and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.losses import hierarchical as jl
from iv2019_tpu.ops.resize import resize_bilinear_mxu
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu_torch.losses import hierarchical as tl
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from torch_parity import loss_inputs_np, threads

LOSS_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation")
MASK_KEYS = ("l1_weights", "l2_vehicle_weights", "l2_human_weights")
LOGIT_KEYS = ("l1_logits", "l2_vehicle_logits", "l2_human_logits")


def _full_res(dataset, seed, n_pp, n_pb, n_pi):
    lr, labels, out_hw = loss_inputs_np(jax_taxonomy(dataset), seed, n_pp, n_pb, n_pi)
    logits = {k: np.asarray(resize_bilinear_mxu(jnp.asarray(v), out_hw, align_corners=True))
              for k, v in lr.items()}
    return logits, labels


@pytest.mark.parametrize("dataset,n_pp,n_pb,n_pi,boot", [
    ("cityscapes", 2, 1, 1, -1),
    ("vistas", 1, 1, 1, -1),
    ("cityscapes", 2, 0, 0, -1),  # empty weak sub-batches
    ("cityscapes", 0, 2, 1, -1),  # no per-pixel images
    ("cityscapes", 2, 1, 1, 30),  # bootstrapped L1
])
def test_define_losses_matches_jax(dataset, n_pp, n_pb, n_pi, boot):
    threads()
    logits, labels = _full_res(dataset, 5, n_pp, n_pb, n_pi)

    def jax_losses(l1, veh, hum):
        preds = {"l1_logits": l1, "l2_vehicle_logits": veh, "l2_human_logits": hum,
                 "l1_decisions": jnp.argmax(l1, -1).astype(jnp.int32)}
        out = jl.define_losses(preds, {k: jnp.asarray(v) for k, v in labels.items()},
                               jax_taxonomy(dataset), bootstrapping_percentage=boot)
        return out["total"], out

    (_, want), want_grads = jax.value_and_grad(jax_losses, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(logits[k]) for k in LOGIT_KEYS))

    tlogits = {k: torch.from_numpy(logits[k]).requires_grad_(True) for k in LOGIT_KEYS}
    preds = dict(tlogits, l1_decisions=tlogits["l1_logits"].detach().argmax(-1).int())
    got = tl.define_losses(preds, {k: torch.from_numpy(v) for k, v in labels.items()},
                           get_taxonomy(dataset), bootstrapping_percentage=boot)
    got["total"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in MASK_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, w in zip(LOGIT_KEYS, want_grads):
        w = np.asarray(w)
        err = float(np.abs(tlogits[k].grad.numpy() - w).max())
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-30), k


def test_weighted_loss_and_regularization():
    raw = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(tl.weighted_loss(raw, torch.tensor([1.0, 0.0, 1.0, 0.0]))) == 2.0
    assert float(tl.weighted_loss(raw, torch.zeros(4))) == 0.0
    named = [("a.conv.weight", torch.ones(2, 2, 1, 1)), ("a.norm.scale", torch.full((3,), 5.0))]
    assert float(tl.l2_regularization(named, 0.5)) == pytest.approx(0.5 * 4 * 0.5)


def test_bootstrap_k_does_not_overflow_int32():
    """Above ~21.5M valid pixels ``num_valid * percentage`` passes 2^31.
    The port computes k in int64: at 100% every valid pixel is kept. (The
    JAX package's int32 product wraps negative there, clamps k to 1 and
    keeps only the hardest pixel: a fault of the reference, ROADMAP queue C.)"""
    n = 2**31 // 100 + 1000
    loss = torch.rand(n, generator=torch.Generator().manual_seed(0))
    weights = torch.ones(n)
    weights[:7] = 0.0
    kept = tl.bootstrap_weights(loss, weights, 100)
    assert int(torch.count_nonzero(kept)) == n - 7
    half = tl.bootstrap_weights(loss, weights, 50)
    assert abs(int(torch.count_nonzero(half)) - (n - 7) // 2) <= 1  # ties at the threshold are kept

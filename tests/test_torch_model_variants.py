"""The port's model variants against the JAX package's, on the same weights.

Variants: PSP (Cityscapes and Vistas heads), the FOV conv (size 3, rate 2),
hybrid upsampling, group norm, the fused adaptation heads with batch norm
and with group norm, PSP + fused heads + hybrid together, and
``bn_impl="fused"`` (train-mode BatchNorm as ops/fused_bn.py, in both
packages). Each is built
on a short trunk (``TRUNK``) at 32 feature dims, f32 on both sides; the
flax variables are initialized by flax, their running statistics set to
the batch statistics of random images and randomized around them
(torch_parity.randomize_stats), and loaded into the port through
utils/convert.py.

In eval mode and in train mode, on a [1 | 1 | 1] mixed batch: the 10-key
predictions dict (logits within 1e-3 absolute, probabilities within 1e-4:
the bounds of tests/test_torch_model.py; decisions equal wherever the
head's top-2 logit margin exceeds 1e-3); in train mode the moved running
statistics (1e-4 of each leaf's largest value, as
tests/test_torch_train_layers.py); and the parameter gradients of
``define_losses``' total. The weak images' L2 losses are gated by the L1
decisions, where a near-tie that flips moves a head's gradient by a whole
pixel's share, so the port's loss takes JAX's L1 decisions (the decisions
are held on their own above).

- eval mode (BatchNorm on running statistics), and train mode without
  BatchNorm (the group-norm variants): each gradient leaf within
  ``GRAD_RTOL`` = 1e-4 of its largest |value| (measured below 1e-5 in eval
  mode, 3e-5 in train mode);
- train mode with BatchNorm on batch statistics: the gradient of a random
  net through train-mode BatchNorm on a few images is ill-conditioned in
  f32 (each norm's backward projects the batch mean and the normalized
  input out of the incoming gradient, and the cancellations compound over
  the layers): JAX's own gradient moves by 1-7% of a leaf's norm when the
  images are scaled by 1 + 1e-6 noise, and the port's differs from JAX's
  by 1-11% (measured on these cases at 3, 6 and 12 images). Each leaf is
  held, in norm, to ``TRAIN_BN_GRAD_RTOL`` = 0.25 of its own norm: a
  missing or wrong gradient term, a transposed or flipped kernel moves a
  leaf by its own size. The exact backward of train-mode BatchNorm is held
  alone by tests/test_torch_train_layers.py, and each variant's other
  layers by the eval-mode gradients.

Also: the JAX package's TPU layout switches (``conv_impl="dot"``,
``dilation_mode="space_to_batch"``, ``root_conv_s2d``) against the port's
one path; ``Settings`` and ``build_model`` for every variant; and the
weight-decay set (``is_decayed``, ``l2_regularization`` and FusedSGDM's
flat mask) against JAX's ``kernel`` leaves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.losses.hierarchical import define_losses as jax_define_losses
from iv2019_tpu.losses.hierarchical import l2_regularization as jax_l2
from iv2019_tpu.models.model import HierarchicalSegmentationModel as JaxModel
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu.train.fused_update import make_weight_decay_mask
from iv2019_tpu_torch.config import Settings
from iv2019_tpu_torch.losses.hierarchical import define_losses, l2_regularization
from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel as TorchModel
from iv2019_tpu_torch.models.model import build_model
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from iv2019_tpu_torch.train.fused_update import FusedSGDM, is_decayed
from iv2019_tpu_torch.utils.convert import (
    flax_params,
    flax_variables,
    load_flax_variables,
    opt_vector_to_jax,
)
from torch_parity import numpy_tree, randomize_stats, threads, to_numpy

# three blocks, so that the last runs at rate 2 (space_to_batch has work)
TRUNK = ((2, 32, 8), (2, 64, 16), (1, 64, 16))
FDIMS = 32
HW = (64, 64)
PART = 1  # images of each supervision in the batch
LOGITS_ATOL, PROBS_ATOL, MARGIN = 1e-3, 1e-4, 1e-3
STATS_RTOL = 1e-4
GRAD_RTOL = 1e-4
TRAIN_BN_GRAD_RTOL = 0.25

VARIANTS = {
    "psp": dict(psp_module=True),
    "psp_vistas": dict(psp_module=True, dataset="vistas"),
    "fov": dict(fov_expansion_kernel_size=3, fov_expansion_kernel_rate=2),
    "hybrid": dict(upsampling_method="hybrid"),
    "group_norm": dict(norm_type="group"),
    "fused_heads": dict(fuse_adaptation=True),
    "fused_heads_group_norm": dict(fuse_adaptation=True, norm_type="group"),
    "psp_fused_hybrid": dict(psp_module=True, fuse_adaptation=True, upsampling_method="hybrid"),
    # train-mode BatchNorm as ops/fused_bn.py in both packages
    "bn_impl_fused": dict(bn_impl="fused"),
}
# the JAX package's layout switches: the same function as its default path
ALIASES = {
    "conv_impl_dot": dict(conv_impl="dot"),
    "space_to_batch": dict(dilation_mode="space_to_batch"),
    "root_conv_s2d": dict(root_conv_s2d=True),
}
KEYS = ("l1_logits", "l1_probabilities", "l1_decisions",
        "l2_vehicle_logits", "l2_vehicle_probabilities", "l2_vehicle_decisions",
        "l2_human_logits", "l2_human_probabilities", "l2_human_decisions", "decisions")


def _split(kw):
    kw = dict(kw)
    return kw.pop("dataset", "cityscapes"), kw


def _jax_model(kw, train=False, decay=0.9):
    dataset, kw = _split(kw)
    return JaxModel(taxonomy=jax_taxonomy(dataset), resnet_blocks=TRUNK,
                    feature_dims_decreased=FDIMS, dtype=jnp.float32,
                    accumulate_norm_statistics=train, batch_norm_decay=decay, **kw)


def _port_model(kw, variables, train=False):
    dataset, kw = _split(kw)
    for alias in ("conv_impl", "dilation_mode", "root_conv_s2d"):
        kw.pop(alias, None)
    model = TorchModel(taxonomy=get_taxonomy(dataset), resnet_blocks=TRUNK,
                       feature_dims_decreased=FDIMS, dtype=torch.float32, **kw)
    model = model.to(memory_format=torch.channels_last).train(train)
    return load_flax_variables(model, numpy_tree(variables["params"]),
                               numpy_tree(variables.get("batch_stats", {})))


def _images(seed, n=None):
    n = n or 3 * PART
    return np.random.RandomState(seed).uniform(-1, 1, (n, *HW, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables(name, seed=0):
    """flax init, running statistics calibrated on random images (momentum
    0) and randomized around them. Cached: callers must not modify them."""
    kw = (VARIANTS | ALIASES)[name]
    images = jnp.asarray(_images(seed + 100, 2))
    variables = jax.jit(_jax_model(kw).init)(jax.random.PRNGKey(seed), images[:1])
    if "batch_stats" in variables:
        calibrate = _jax_model(kw, train=True, decay=0.0)
        _, mutated = jax.jit(lambda v, x: calibrate.apply(v, x, mutable=["batch_stats"]))(
            variables, images)
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    return randomize_stats(dict(variables), np.random.RandomState(seed))


def _labels(dataset, seed):
    """A [PART | PART | PART] batch's labels: per-pixel cids over the whole
    per-pixel space, sparse weak multinomials with void pixels."""
    tax = get_taxonomy(dataset)
    rng = np.random.RandomState(seed)

    def weak():
        lab = rng.rand(PART, *HW, 15).astype(np.float32) ** 4
        lab[lab < 0.3] = 0.0
        lab[rng.rand(PART, *HW) < 0.25] = 0.0
        lab[lab.sum(-1) == 0, -1] = 1.0
        return lab / lab.sum(-1, keepdims=True)

    return {"prolabels_per_pixel": rng.randint(0, len(tax.per_pixel_cids2l1_cids),
                                               (PART, *HW)).astype(np.int32),
            "prolabels_per_bbox": weak(), "prolabels_per_image": weak()}


@functools.lru_cache(maxsize=None)
def _jax_run(name, train):
    """JAX's (predictions, moved statistics, gradients)."""
    kw = (VARIANTS | ALIASES)[name]
    dataset, _ = _split(kw)
    variables = _variables(name)
    model = _jax_model(kw, train=train)
    labels = {k: jnp.asarray(v) for k, v in _labels(dataset, 2).items()}
    stats = variables.get("batch_stats", {})

    def loss(params):
        preds, mutated = model.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(_images(1)), mutable=["batch_stats"])
        total = jax_define_losses(preds, labels, jax_taxonomy(dataset))["total"]
        return total, (preds, mutated.get("batch_stats", {}))

    (_, (preds, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return ({k: np.asarray(v) for k, v in preds.items()}, _leaves(numpy_tree(new_stats)),
            _leaves(numpy_tree(grads)))


def _port_run(name, train, kw=None, l1_decisions=None):
    """The port's (predictions, moved statistics, gradients), its loss
    gated by ``l1_decisions``."""
    kw = kw if kw is not None else (VARIANTS | ALIASES)[name]
    model = _port_model(kw, _variables(name), train)
    dataset, _ = _split(kw)
    labels = {k: torch.from_numpy(v) for k, v in _labels(dataset, 2).items()}
    preds = model(torch.from_numpy(_images(1)))
    gated = dict(preds, l1_decisions=torch.from_numpy(np.array(l1_decisions)))
    define_losses(gated, labels, get_taxonomy(dataset))["total"].backward()
    grads = flax_params({k: p.grad for k, p in model.named_parameters()}, model)
    return ({k: to_numpy(v) for k, v in preds.items()},
            _leaves(flax_variables(model)["batch_stats"]), _leaves(grads))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_preds(got, want):
    for key in KEYS:
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        if key.endswith("_decisions"):
            logits = want[key.replace("decisions", "logits")]
            top2 = np.sort(logits, -1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > MARGIN
            assert clear.mean() > 0.9, key
            np.testing.assert_array_equal(g[clear], w[clear], err_msg=key)
        elif key == "decisions":
            margins = [np.diff(np.sort(want[f"{h}_logits"], -1)[..., -2:], axis=-1)[..., 0]
                       for h in ("l1", "l2_vehicle", "l2_human")]
            clear = np.minimum.reduce(margins) > MARGIN
            np.testing.assert_array_equal(g[clear], w[clear], err_msg=key)
        elif key.endswith("probabilities"):
            np.testing.assert_allclose(g, w, atol=PROBS_ATOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=LOGITS_ATOL, rtol=0, err_msg=key)


def _assert_stats(got, want):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for path, w in want.items():
        err, bound = float(np.abs(got[path] - w).max()), STATS_RTOL * float(np.abs(w).max())
        assert err <= bound, ("batch_stats", path, err, bound)


def _assert_grads(got, want, batch_statistics):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for path, w in want.items():
        if batch_statistics:
            err = float(np.linalg.norm(got[path] - w))
            bound = TRAIN_BN_GRAD_RTOL * float(np.linalg.norm(w))
        else:
            err, bound = float(np.abs(got[path] - w).max()), GRAD_RTOL * float(np.abs(w).max())
        assert err <= bound, ("grads", path, err, bound)


def _check(name, train, kw=None):
    threads()
    want_preds, want_stats, want_grads = _jax_run(name, train)
    got_preds, got_stats, got_grads = _port_run(name, train, kw,
                                                l1_decisions=want_preds["l1_decisions"])
    _assert_preds(got_preds, want_preds)
    _assert_stats(got_stats, want_stats)
    _assert_grads(got_grads, want_grads, train and bool(want_stats))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name, train):
    _check(name, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(ALIASES))
def test_layout_switch_matches_port_default(name, train):
    """JAX with a TPU layout switch against the port's default model: the
    switches are aliases of the one path the port has."""
    _check(name, train, kw={})


def test_variant_stride8_logits_are_contiguous():
    """The fused heads' logits are channel slices: the stride-8 outputs the
    fused loss takes are contiguous NHWC all the same, in f32 compute."""
    threads()
    model = _port_model(VARIANTS["fused_heads"], _variables("fused_heads"), train=True)
    preds = model(torch.from_numpy(_images(1)), upsampling_method="no")
    for head in ("l1", "l2_vehicle", "l2_human"):
        assert preds[f"{head}_logits"].dtype == torch.float32
        assert preds[f"{head}_logits"].is_contiguous(), head


_SETTINGS = {
    "psp": dict(psp_module=True),
    "fov": dict(fov_expansion_kernel_size=3, fov_expansion_kernel_rate=2),
    "hybrid": dict(upsampling_method="hybrid"),
    "group_norm": dict(norm_layer="group"),
    "fused_heads": dict(fuse_adaptation=True),
    "remat": dict(remat=True),
    "layout_switches": dict(conv_impl="dot_bwd", bn_impl="fused", dilation_mode="space_to_batch",
                            root_conv_s2d=True, enable_xla=False, distribute=True),
}


@pytest.mark.parametrize("name", list(_SETTINGS))
def test_settings_and_build_model_accept_variant(name):
    """Every single-device variant validates and builds (ResNet-50, CPU)."""
    settings = Settings(device="cpu", mode="train", learning_rate_decay=0.5,
                        **_SETTINGS[name]).finalize()
    model = build_model(settings)
    names = [k for k, _ in model.named_parameters()]
    expect = {"psp": "feature_extractor/pyramid_module.conv_final.conv.weight",
              "fov": "feature_extractor/extension/increase_fov.conv.weight",
              "hybrid": "softmax_classifier/l1_logits/upsampling/conv_transpose.bias",
              "fused_heads": "softmax_classifier/fused_logits.conv.weight"}.get(name)
    assert expect is None or expect in names
    if name == "group_norm":
        assert not list(model.buffers())
    if name == "remat":
        assert model.get_submodule("feature_extractor/base").remat


def test_multi_device_settings_stay_refused():
    # data parallelism and spatial partitions are ported
    # (tests/test_torch_parallel.py, tests/test_torch_spatial*.py); several
    # processes still need a coordinator, and a spatial split a height that
    # divides by 8 x partitions
    for kw in (dict(num_devices=2), dict(num_slices=2),
               dict(num_processes=2, coordinator_address="h:1"), dict(spatial_partitions=2)):
        Settings(device="cpu", learning_rate_decay=0.5, **kw).finalize()
    with pytest.raises(ValueError, match="coordinator_address"):
        Settings(device="cpu", learning_rate_decay=0.5, num_processes=2).finalize()
    with pytest.raises(ValueError, match="8 x spatial_partitions"):
        Settings(device="cpu", learning_rate_decay=0.5, spatial_partitions=2,
                 height_feature_extractor=520).finalize()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decay_set_matches_jax_kernels(name):
    """is_decayed, l2_regularization and FusedSGDM's flat mask select what
    JAX's ``kernel`` leaves are (the conv-transpose kernel in, its bias and
    every norm parameter out)."""
    threads()
    variables = _variables(name)
    model = _port_model(VARIANTS[name], variables)
    decayed = flax_params({k: p for k, p in model.named_parameters() if is_decayed(k)}, model)
    kernels = {k for k in _leaves(numpy_tree(variables["params"])) if k.endswith("['kernel']")}
    assert set(_leaves(decayed)) == kernels
    got = float(l2_regularization(model.named_parameters(), 0.00017))
    want = float(jax_l2(variables["params"], 0.00017))
    assert got == pytest.approx(want, rel=1e-6)
    settings = Settings(device="cpu", mode="train", learning_rate_decay=0.5).finalize()
    opt = FusedSGDM(settings, model)
    mask = make_weight_decay_mask(variables["params"])
    flat = opt_vector_to_jax(opt.wd_mask.numpy(), opt.layout)
    np.testing.assert_array_equal(flat[:mask.size], mask)
    assert not flat[mask.size:].any()

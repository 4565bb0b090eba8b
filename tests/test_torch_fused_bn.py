"""The port's ``bn_impl="fused"`` BatchNorm against the JAX package's, on the CPU.

iv2019_tpu_torch/ops/fused_bn.py (kernels N1/N2 on the card; their plain
versions here, since the tensors lie on the CPU) against
iv2019_tpu/ops/fused_bn.py and ``Norm(bn_impl="fused")``, inputs made with
numpy from a seed and handed to both:

- (a) ``batch_stats`` and the forward of ``batch_norm_train`` at
  tests/test_fused_bn.py's shapes (NHWC there, NCHW here) and at one with a
  channel of constant input: ``y`` within 1e-5, mean and var within 1e-6,
  absolute and relative (the bounds of test_fused_bn.py). The constant is
  2.0, whose mean both packages round exactly: XLA on the CPU takes the
  mean of 1.5 over 240 rows as 1.5000001 (a product with the reciprocal
  of the count), and rstd = 1/sqrt(eps) ~ 316 turns that one ulp of
  JAX's mean into 5e-5 of y, a check of XLA's rounding rather than of the
  branch both take;
- (b) the gradients of x, scale and bias against ``jax.grad`` through
  JAX's custom VJP, within 1e-4 absolute and relative, the constant
  channel included (both take the unclamped branch: dx = scale * rstd *
  (dy - mean(dy)) there);
- (c) bf16 input: the port's ``Norm(bn_impl="fused")`` in train mode
  against JAX's ``Norm(bn_impl="fused", use_running_average=False)``:
  ``y`` within one bf16 ulp (both compute in f32 from the same bf16 values
  and round once), the moved running statistics within 1e-6;
- (d) eval mode, group norm and ``"none"`` ignore ``bn_impl``, as in JAX
  (tests/test_fused_bn.py:74-82): the same values as ``bn_impl="flax"``;
- (e) test_fused_bn.py's model and the small model of
  tests/torch_parity.py (``SMALL_BLOCKS``) with ``bn_impl="fused"`` in both
  packages, the same weights through utils/convert.py, one train-mode
  forward and backward of test_fused_bn.py's loss (the mean square of the
  L1 logits): the loss, every parameter gradient and the moved running
  statistics at test_fused_bn.py's bounds (1e-6 relative; 2e-4 absolute /
  2e-3 relative; 1e-5 / 1e-4), or within twice the distance at which the
  port's flax path (``bn_impl="flax"``) stands from JAX's on the same
  inputs, where that already exceeds them (the test's docstring);
- (f) under ``remat`` the recomputed forward leaves the running statistics
  alone: they move once, to the values of the run without remat;
- (g) two gloo ranks (tests/torch_dist_worker.py, scenario ``fused_bn``),
  each with half of the batch's rows, or half of each image's rows under a
  spatial mesh of 2, against one rank on the whole batch: y and dx rows,
  and dscale / dbias summed over the ranks, within 1e-5 of the largest
  value (f32; the sums are added in another order), one all-reduce forward
  and one backward;
- (h) ``batch_norm_train.layout_copies`` counts an x and a dy that are not
  channels_last (here on the CPU path as on the card), and the results do
  not change.

Eval mode (kernel N3 on the card): on the CPU ``Norm`` computes the plain
chain it always has, bit for bit (the chain written out here), with a
residual and a ReLU where its callers hand them over, in bf16 and f32, a
strided residual included, and launches nothing; ``fused_bn_eval`` refuses
a tensor off the card; the gradient N3 gives under autograd is the plain
chain's (checked here through a CPU stand-in for the operator); the
model's units end on it (a bottleneck unit's output is ``relu(shortcut +
conv3's norm)``); the operator library's declaration of ``iv_bn_eval``
matches the source's.

Also the plan the wrapper gives the kernels (``bn_plan``): every row and
channel covered once, loads no wider than the alignment allows, a grid the
card holds at once (and a C whose tiles alone it cannot hold refused), the
path chosen by the mesh, the same grid for both paths, the plan memoised,
the workspace carved without overlap, and each C entry's ctypes types as
many as its parameters.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from iv2019_tpu.models.layers import Norm as JaxNorm
from iv2019_tpu.models.model import HierarchicalSegmentationModel as JaxModel
from iv2019_tpu.ops import fused_bn as jbn
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu_torch.models.layers import Norm
from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel as TorchModel
from iv2019_tpu_torch.models.model import init_model
from iv2019_tpu_torch.ops import fused_bn as tbn
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from iv2019_tpu_torch.utils.convert import flax_params, flax_variables, load_flax_variables
from torch_parity import (SMALL_BLOCKS, SMALL_FDIMS, SMALL_HW, numpy_tree, randomize_stats,
                          run_ranks, small_images, small_variables, threads)

EPS = 1e-5
# NHWC shapes of tests/test_fused_bn.py, and one with channel 5 constant
SHAPES = {"4x6x10x16": ((4, 6, 10, 16), None), "2x1x1x3": ((2, 1, 1, 3), None),
          "8x5x7x1": ((8, 5, 7, 1), None), "constant_channel": ((4, 6, 10, 16), 5)}
CONSTANT = 2.0
Y_TOL, STATS_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
MODEL_GRAD_ATOL, MODEL_GRAD_RTOL = 2e-4, 2e-3
MODEL_STATS_ATOL, MODEL_STATS_RTOL = 1e-5, 1e-4
RANK_TOL = 1e-5


def _inputs(name, seed=0):
    """NHWC x (randn * 3 + 1, as test_fused_bn.py), scale, bias, dy."""
    shape, constant = SHAPES[name]
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    if constant is not None:
        x[..., constant] = CONSTANT
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_and_stats_match_jax(name):
    threads()
    x, scale, bias, _ = _inputs(name)
    want_mean, want_var = jbn.batch_stats(jnp.asarray(x))
    y_want, m_want, v_want = jbn.batch_norm_train(jnp.asarray(x), jnp.asarray(scale),
                                                  jnp.asarray(bias), EPS)
    mean, var = tbn.batch_stats(_nchw(x))
    y, m, v = tbn.batch_norm_train(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    for got, want in ((mean, want_mean), (var, want_var), (m, m_want), (v, v_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STATS_TOL, rtol=STATS_TOL)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_want), atol=Y_TOL, rtol=Y_TOL)
    assert y.dtype == torch.float32 and y.is_contiguous(memory_format=torch.channels_last)
    assert not m.requires_grad and not v.requires_grad


@pytest.mark.parametrize("name", list(SHAPES))
def test_gradients_match_jax_custom_vjp(name):
    threads()
    x, scale, bias, dy = _inputs(name, seed=1)

    def loss(x, s, b):
        y, _, _ = jbn.batch_norm_train(x, s, b, EPS)
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = _nchw(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, _, _ = tbn.batch_norm_train(xt, st, bt, EPS)
    y.backward(_nchw(dy))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want[0]), atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want[1]), atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), atol=GRAD_TOL, rtol=GRAD_TOL)
    if SHAPES[name][1] is not None:
        # the unclamped branch on the constant channel: xhat = 0
        c = SHAPES[name][1]
        g = dy[..., c]
        branch = scale[c] / np.sqrt(EPS) * (g - g.mean())
        np.testing.assert_allclose(_nhwc(xt.grad)[..., c], branch, rtol=GRAD_TOL, atol=GRAD_TOL)


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_norm_bf16_matches_jax_within_one_ulp():
    threads()
    rng = np.random.RandomState(2)
    c = 24
    x = (rng.randn(4, 9, 11, c) * 2 + 0.5).astype(np.float32)
    x_bf16 = jnp.asarray(x, jnp.bfloat16)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jnorm = JaxNorm(use_running_average=False, bn_impl="fused")
    variables = {"params": {"BatchNorm": params}, "batch_stats": {"BatchNorm": stats}}
    y_want, moved = jnorm.apply(variables, x_bf16, mutable=["batch_stats"])
    assert y_want.dtype == jnp.bfloat16

    norm = Norm(c, bn_impl="fused").train()
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(norm, k).copy_(torch.from_numpy(v))
    xt = _nchw(np.asarray(x_bf16.astype(jnp.float32)), torch.bfloat16)
    y = norm(xt)
    assert y.dtype == torch.bfloat16
    want = np.asarray(y_want.astype(jnp.float32))
    assert (np.abs(_nhwc(y) - want) <= _bf16_ulp(want)).all()
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(norm, k).numpy(),
                                   np.asarray(moved["batch_stats"]["BatchNorm"][k]),
                                   atol=STATS_TOL, rtol=STATS_TOL)


@pytest.mark.parametrize("case", ["batch_eval", "group_train", "none_train"])
def test_bn_impl_ignored_outside_train_mode_batch_norm(case):
    """Eval-mode batch norm (running statistics), group norm and no norm
    compute what they compute under ``bn_impl="flax"``; JAX's eval-mode
    Norm with ``bn_impl="fused"`` gives the same (test_fused_bn.py:74-82)."""
    threads()
    rng = np.random.RandomState(3)
    c = 16
    x = _nchw((rng.randn(2, 5, 6, c) * 2).astype(np.float32))
    norm_type, train = {"batch_eval": ("batch", False), "group_train": ("group", True),
                        "none_train": ("none", True)}[case]
    outs = {}
    for impl in ("flax", "fused"):
        norm = Norm(c, norm_type=norm_type, groups=4, bn_impl=impl).train(train)
        if norm_type != "none":
            with torch.no_grad():
                norm.scale.copy_(torch.linspace(0.5, 1.5, c))
                norm.bias.copy_(torch.linspace(-0.3, 0.3, c))
        if norm_type == "batch":
            with torch.no_grad():
                norm.mean.copy_(torch.linspace(-0.1, 0.1, c))
                norm.var.copy_(torch.linspace(0.8, 1.2, c))
        outs[impl] = norm(x)
        if norm_type == "batch":
            outs[impl + "_stats"] = (norm.mean.clone(), norm.var.clone())
    assert torch.equal(outs["flax"], outs["fused"])
    if case == "batch_eval":
        assert all(torch.equal(a, b) for a, b in zip(outs["flax_stats"], outs["fused_stats"]))
        jnorm = JaxNorm(use_running_average=True, bn_impl="fused")
        variables = {"params": {"BatchNorm": {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
                                              "bias": np.linspace(-0.3, 0.3, c,
                                                                  dtype=np.float32)}},
                     "batch_stats": {"BatchNorm": {"mean": np.linspace(-0.1, 0.1, c,
                                                                       dtype=np.float32),
                                                   "var": np.linspace(0.8, 1.2, c,
                                                                      dtype=np.float32)}}}
        want = jnorm.apply(variables, jnp.asarray(_nhwc(x)))
        np.testing.assert_allclose(_nhwc(outs["fused"]), np.asarray(want), atol=1e-5, rtol=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# test_fused_bn.py's model (two units, 16 feature dims, 2 images at 32x64)
# and the small model of tests/torch_parity.py (2 images at 128x128)
MODELS = {"tiny": (((1, 32, 8), (1, 64, 16)), 16, (32, 64)),
          "small": (SMALL_BLOCKS, SMALL_FDIMS, SMALL_HW)}


def _model_step(name, package, bn_impl):
    """One train-mode forward and backward of the mean square of the L1
    logits: (loss, gradient leaves, moved-statistics leaves)."""
    blocks, fdims, hw = MODELS[name]
    images = small_images(5, n=2, hw=hw)
    if name == "small":
        variables = small_variables(0)
    else:
        init = JaxModel(taxonomy=jax_taxonomy("cityscapes"), resnet_blocks=blocks,
                        feature_dims_decreased=fdims, dtype=jnp.float32)
        variables = randomize_stats(dict(jax.jit(init.init)(jax.random.PRNGKey(0),
                                                            jnp.asarray(images))),
                                    np.random.RandomState(0))
    if package == "jax":
        model = JaxModel(taxonomy=jax_taxonomy("cityscapes"), resnet_blocks=blocks,
                         feature_dims_decreased=fdims, dtype=jnp.float32,
                         accumulate_norm_statistics=True, bn_impl=bn_impl)

        def loss(params):
            out, updates = model.apply({"params": params,
                                        "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(images), mutable=["batch_stats"])
            return jnp.mean(out["l1_logits"].astype(jnp.float32) ** 2), updates

        (value, updates), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        return (float(value), _leaves(numpy_tree(grads)),
                _leaves(numpy_tree(updates["batch_stats"])))
    model = TorchModel(taxonomy=get_taxonomy("cityscapes"), resnet_blocks=blocks,
                       feature_dims_decreased=fdims, dtype=torch.float32, bn_impl=bn_impl)
    model = load_flax_variables(model.to(memory_format=torch.channels_last).train(),
                                numpy_tree(variables["params"]),
                                numpy_tree(variables["batch_stats"]))
    value = torch.mean(model(torch.from_numpy(images))["l1_logits"] ** 2)
    value.backward()
    # the L2 heads take no gradient from this loss (zeros in JAX)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    return (float(value.detach()), _leaves(flax_params(grads, model)),
            _leaves(flax_variables(model)["batch_stats"]))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_train_step_matches_jax(name):
    """bn_impl="fused" in both packages on the same weights and images.

    Each quantity is held to test_fused_bn.py's bound (loss 1e-6 relative,
    gradients 2e-4 / 2e-3, statistics 1e-5 / 1e-4) or, where the two
    packages' f32 convolutions already part by more on the flax path,
    to twice the distance of the port's ``bn_impl="flax"`` from JAX's on
    the same inputs. The loss parts by 2-4e-6 relative on both paths (the
    convolutions round in other orders), and on the small model 10 of 102
    gradient leaves pass 2e-4 / 2e-3 on neither path: a random net's
    train-mode BatchNorm gradient is ill-conditioned
    (tests/test_torch_model_variants.py measured 1-11%), while a missing or
    wrong term of the backward moves a leaf by its own size."""
    threads()
    want, got = _model_step(name, "jax", "fused"), _model_step(name, "torch", "fused")
    ref_want, ref_got = _model_step(name, "jax", "flax"), _model_step(name, "torch", "flax")
    assert abs(got[0] - want[0]) <= max(1e-6 * abs(want[0]), 2 * abs(ref_got[0] - ref_want[0]))
    for i, (atol, rtol) in ((1, (MODEL_GRAD_ATOL, MODEL_GRAD_RTOL)),
                            (2, (MODEL_STATS_ATOL, MODEL_STATS_RTOL))):
        assert got[i].keys() == want[i].keys() == ref_got[i].keys()
        for path, w in want[i].items():
            if np.allclose(got[i][path], w, atol=atol, rtol=rtol):
                continue
            err = np.linalg.norm(got[i][path] - w)
            bar = 2 * np.linalg.norm(ref_got[i][path] - ref_want[i][path])
            assert err <= bar, (path, err, bar)


def test_remat_moves_running_statistics_once():
    threads()
    trunk = ((1, 32, 8), (1, 64, 16))
    images = torch.from_numpy(small_images(6, n=2, hw=(32, 32)))
    stats, grads = {}, {}
    for remat in (False, True):
        model = TorchModel(taxonomy=get_taxonomy("cityscapes"), resnet_blocks=trunk,
                           feature_dims_decreased=16, dtype=torch.float32, bn_impl="fused",
                           remat=remat)
        model = init_model(model.to(memory_format=torch.channels_last),
                           torch.Generator().manual_seed(0)).train()
        before = {k: v.clone() for k, v in model.named_buffers()}
        torch.mean(model(images)["l1_logits"] ** 2).backward()
        stats[remat] = dict(model.named_buffers())
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
    assert stats[True].keys() == before.keys()
    for k, v in stats[False].items():
        assert not torch.equal(v, before[k]), k
        assert torch.equal(stats[True][k], v), k
    for k, g in grads[False].items():
        torch.testing.assert_close(grads[True][k], g, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("spatial", [1, 2], ids=["data", "spatial"])
def test_ranks_match_one_rank(tmp_path, spatial):
    """Two ranks, each with half the rows (data) or half of each image's
    rows (spatial), give the one-rank result on the whole batch."""
    threads()
    rng = np.random.RandomState(4)
    n, c, h, w = 4, 6, 8, 5
    inp = {"x": (rng.randn(n, c, h, w) * 2 + 1).astype(np.float32),
           "dy": rng.randn(n, c, h, w).astype(np.float32),
           "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
           "bias": rng.randn(c).astype(np.float32), "eps": EPS}
    ranks = run_ranks("fused_bn", inp, tmp_path, world=2, spatial=spatial)
    one = worker.run_fused_bn(inp, None)
    axis = 2 if spatial > 1 else 0
    for key in ("y", "dx"):
        got = np.concatenate([r[key] for r in ranks], axis=axis)
        np.testing.assert_allclose(got, one[key], atol=RANK_TOL * np.abs(one[key]).max(), rtol=0)
    for key in ("dscale", "dbias"):
        got = sum(r[key] for r in ranks)
        np.testing.assert_allclose(got, one[key], atol=RANK_TOL * np.abs(one[key]).max(), rtol=0)
    for r in ranks:
        for key in ("mean", "var"):
            np.testing.assert_allclose(r[key], one[key], atol=RANK_TOL, rtol=RANK_TOL)
        assert r["all_reduces"] == 2


def test_layout_copies_counted():
    threads()
    x, scale, bias, dy = _inputs("4x6x10x16", seed=7)
    results = {}
    for layout in ("channels_last", "contiguous"):
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        xt = _nchw(x).contiguous(memory_format=fmt).requires_grad_(True)
        before = tbn.batch_norm_train.layout_copies
        y, _, _ = tbn.batch_norm_train(xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
        after_fwd = tbn.batch_norm_train.layout_copies
        y.backward(_nchw(dy).contiguous(memory_format=fmt))
        results[layout] = (after_fwd - before, tbn.batch_norm_train.layout_copies - after_fwd,
                           y.detach(), xt.grad)
    assert results["channels_last"][:2] == (0, 0)
    assert results["contiguous"][:2] == (1, 1)
    for a, b in zip(results["channels_last"][2:], results["contiguous"][2:]):
        assert torch.equal(a, b)


# (m, c, itemsize, align) of the flagship's maps, the heads, f32, a map of
# one block, unaligned pointers, one element, and a ragged f32 C
PLAN_SHAPES = [
    (2_097_152, 64, 2, 16), (131_072, 2048, 2, 16), (131_072, 3, 2, 16), (131_072, 14, 2, 16),
    (131_072, 2048, 4, 16), (16, 256, 2, 16), (7, 24, 2, 4), (1, 1, 4, 16), (100, 13, 4, 8)]
# blocks the card holds at once: four or three 256-thread blocks on each of
# the H100's 132 SMs, eight, and a card smaller than some maps' tiles
CAPACITIES = [132 * 4, 132 * 3, 132 * 8, 6]


def _tiles(c, itemsize, align):
    tc = min(1 << (c // tbn.bn_vec(c, itemsize, align) - 1).bit_length(), tbn._TC_MAX)
    return -(-(c // tbn.bn_vec(c, itemsize, align)) // tc)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("m,c,itemsize,align", PLAN_SHAPES)
def test_plan_covers_every_row_and_channel(m, c, itemsize, align, capacity):
    if _tiles(c, itemsize, align) > capacity:
        with pytest.raises(ValueError, match="cannot hold"):
            tbn.bn_plan(m, c, itemsize, align, capacity)
        return
    plan = tbn.bn_plan(m, c, itemsize, align, capacity)
    assert c % plan.vec == 0 and plan.vec * itemsize <= min(16, align)
    assert plan.vec == tbn.bn_vec(c, itemsize, align)
    assert 256 % plan.tc == 0 and plan.tc <= tbn._TC_MAX
    assert plan.tc * plan.vec <= 256  # the kernels' per-block arrays of a tile
    cv = c // plan.vec
    assert plan.tiles * plan.tc >= cv > (plan.tiles - 1) * plan.tc
    assert plan.splits * plan.rows >= m > (plan.splits - 1) * plan.rows
    assert plan.capacity == capacity
    # every row once: each (split, row lane) walks first, first + tr, ...
    tr = 256 // plan.tc
    if m <= 4096:
        seen = np.zeros(m, dtype=np.int64)
        for split in range(plan.splits):
            b0, b1 = split * plan.rows, min((split + 1) * plan.rows, m)
            for lane in range(tr):
                seen[b0 + lane:b1:tr] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("m,c,itemsize,align", PLAN_SHAPES)
def test_plan_grid_is_co_resident(m, c, itemsize, align, capacity):
    """Every grid the card holds at once (both paths' launches are
    cooperative), one launch without a mesh; as many splits as fill the card
    while a thread keeps its 16 rows."""
    if _tiles(c, itemsize, align) > capacity:
        with pytest.raises(ValueError, match="cannot hold"):
            tbn.bn_plan(m, c, itemsize, align, capacity)
        return
    plan = tbn.bn_plan(m, c, itemsize, align, capacity)
    assert plan.path == "one"
    want = max(1, min(capacity // plan.tiles, m // (256 // plan.tc * tbn._MIN_ROWS_PER_THREAD)))
    assert plan.rows == -(-m // want) and plan.splits <= want
    assert plan.tiles * plan.splits <= capacity


@pytest.mark.parametrize("m,c,itemsize,align", PLAN_SHAPES)
def test_plan_same_for_both_paths(m, c, itemsize, align):
    """A mesh (``split``) changes the path and nothing else: on one rank the
    two paths cut the map alike, so their sums add in the same order."""
    one = tbn.bn_plan(m, c, itemsize, align, 132 * 4)
    split = tbn.bn_plan(m, c, itemsize, align, 132 * 4, True)
    assert split.path == "split"
    assert dataclasses.replace(split, path=one.path) == one


def test_plan_path_by_shape_and_mesh():
    # block4's 2048 channels in f32: 16 tiles, which a card of 6 blocks
    # cannot hold at once: refused, not launched
    assert tbn.bn_plan(131_072, 2048, 4, 16, 132 * 4).path == "one"
    with pytest.raises(ValueError, match="cannot hold"):
        tbn.bn_plan(131_072, 2048, 4, 16, 6)
    with pytest.raises(ValueError, match="cannot hold"):
        tbn.bn_plan(131_072, 2048, 4, 16, 6, split=True)
    assert tbn.bn_plan(131_072, 2048, 4, 16, 16).splits == 1
    assert tbn.bn_plan(131_072, 3, 2, 16, 6).path == "one"
    assert tbn.bn_plan(131_072, 3, 2, 16, 132 * 4, split=True).path == "split"
    with pytest.raises(ValueError):
        tbn.bn_plan(16, 8, 2, 16, 0)
    with pytest.raises(ValueError):
        tbn.bn_plan(0, 8, 2, 16, 528)


def test_plan_is_memoised():
    before = tbn.bn_plan.cache_info().hits
    assert tbn.bn_plan(524_288, 256, 2, 16, 528) is tbn.bn_plan(524_288, 256, 2, 16, 528)
    assert tbn.bn_plan.cache_info().hits == before + 1


@pytest.mark.parametrize("m,c,itemsize,align", PLAN_SHAPES)
def test_workspace_carved_without_overlap(m, c, itemsize, align):
    """The workspace's parts (``_layout``, as csrc/fused_bn.cu reads them)
    lie inside it, apart, the f64 sums on 8 bytes and the f64 partials on
    16;
    the wrapper's views of N1's and N2's outputs are those parts."""
    plan = tbn.bn_plan(m, c, itemsize, align, 132 * 4)
    at = tbn._layout(c)
    assert at["dbias"] == at["count"] and at["dscale"] == at["dbias"] + c
    # N1's parts; N2 writes dbias and dscale over N1's count and mean
    parts = [("sums", at["sums"], 4 * c + 2), ("count", at["count"], 1), ("mean", at["mean"], c),
             ("var", at["var"], c), ("rstd", at["rstd"], c),
             ("partials", plan.partials_at, plan.splits * 4 * c)]
    assert plan.partials_at == at["partials"] and plan.partials_at % 4 == 0
    assert at["sums"] % 2 == 0 and at["rstd"] + c <= plan.partials_at
    spans = sorted((start, start + size, name) for name, start, size in parts)
    assert spans[0][0] == 0 and spans[-1][1] == plan.workspace
    for (_, end, name), (start, _, after) in zip(spans, spans[1:]):
        assert end <= start, (name, after)
    assert at["dscale"] + c <= plan.partials_at
    ws = torch.arange(plan.workspace, dtype=torch.float32)
    _, count, mean, var, rstd, _ = ws.split_with_sizes(
        (4 * c + 2, 1, c, c, c, plan.workspace - 7 * c - 3))
    for view, name in ((count, "count"), (mean, "mean"), (var, "var"), (rstd, "rstd")):
        assert int(view[0]) == at[name]
    _, dbias, dscale, _ = ws.split_with_sizes((4 * c + 2, c, c, plan.workspace - 6 * c - 2))
    assert int(dbias[0]) == at["dbias"] and int(dscale[0]) == at["dscale"]
    assert ws[:4 * c + 2].view(torch.float64).numel() == 2 * c + 1


def test_entry_argtypes_match_the_source():
    """Each C entry's ctypes argument list has as many types as the
    source's declaration has parameters (a missing one would shift every
    argument after it; nothing on the CPU would notice)."""
    source = (tbn._build.CSRC_DIR / "fused_bn.cu").read_text()
    for name, types in tbn._ARGTYPES.items():
        decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", source)
        assert decl, name
        assert len(decl.group(1).split(",")) == len(types), name


def _eval_chain(x, mean, var, scale, bias, eps, residual, relu):
    """Eval-mode Norm as the port computed it before kernel N3, then the
    callers' residual add and ReLU."""
    mul = torch.rsqrt(var + eps) * scale
    y = ((x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]).to(x.dtype)
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [None, "channels_last", "strided"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_eval_on_cpu_is_the_plain_chain(dtype, residual, relu):
    threads()
    rng = np.random.RandomState(7)
    c = 24
    x = _nchw((rng.randn(2, 6, 10, c) * 3).astype(np.float32), dtype)
    norm = Norm(c).eval()
    with torch.no_grad():
        norm.scale.copy_(torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32))
        norm.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c), dtype=torch.float32))
        norm.mean.copy_(torch.tensor(rng.uniform(-1, 1, c), dtype=torch.float32))
        norm.var.copy_(torch.tensor(rng.uniform(0.1, 4, c), dtype=torch.float32))
    r = None
    if residual is not None:
        big = _nchw(rng.randn(2, 12, 20, c).astype(np.float32), dtype)
        r = big[:, :, ::2, ::2] if residual == "strided" else big[:, :, :6, :10].contiguous(
            memory_format=torch.channels_last)
    before = tbn.fused_bn_eval.launches
    with torch.no_grad():
        got = norm(x, r, relu)
    want = _eval_chain(x, norm.mean, norm.var, norm.scale, norm.bias, norm.epsilon, r, relu)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tbn.batch_norm_eval_plain(x, norm.mean, norm.var, norm.scale, norm.bias,
                                                 norm.epsilon, r, relu), want)
    assert tbn.fused_bn_eval.launches == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_fused_bn_eval_runs_on_the_card_alone(device):
    """N3 has no CPU mode: a tensor off the card is refused (``Norm`` sends
    it the plain chain instead), and nothing is counted."""
    c = 8
    x = torch.empty(2, c, 3, 5, device=device).contiguous(memory_format=torch.channels_last)
    params = [torch.zeros(c, device=device), torch.ones(c, device=device),
              torch.ones(c, device=device), torch.zeros(c, device=device)]
    before = tbn.fused_bn_eval.launches, tbn.fused_bn_eval.layout_copies
    with pytest.raises(ValueError, match="runs on the card"):
        tbn.fused_bn_eval(x, *params, 1e-5)
    assert (tbn.fused_bn_eval.launches, tbn.fused_bn_eval.layout_copies) == before


@pytest.mark.parametrize("with_residual,relu", [(False, False), (True, True)])
def test_bn_eval_gradient_is_the_plain_chains(with_residual, relu):
    """``_BnEval`` (N3 where autograd asks for a gradient) gives the plain
    chain's gradients of x, the residual, scale and bias, and none of the
    running statistics; the operator's forward is stood in for on the CPU
    by the plain chain, as the card's gives it within an ulp."""
    from iv2019_tpu_torch.ops.fused_block import ops_library

    threads()
    ops_library()
    stand_in = torch.library.Library("iv2019", "IMPL")
    stand_in.impl("bn_eval", tbn.batch_norm_eval_plain, "CPU")
    try:
        rng = np.random.RandomState(11)
        c = 12

        def leaf(values, grad=True):
            return torch.tensor(values, dtype=torch.float32).requires_grad_(grad)

        def inputs():
            x = leaf(rng.randn(2, c, 4, 6) * 2)
            r = leaf(rng.randn(2, c, 4, 6)) if with_residual else None
            return (x, leaf(rng.uniform(-1, 1, c), False), leaf(rng.uniform(0.1, 4, c), False),
                    leaf(rng.uniform(0.5, 1.5, c)), leaf(rng.uniform(-0.5, 0.5, c)), r)

        state = rng.get_state()
        fused = inputs()
        rng.set_state(state)
        plain = inputs()
        dy = torch.tensor(rng.randn(2, c, 4, 6), dtype=torch.float32)
        y = tbn._BnEval.apply(*fused[:5], 1e-5, fused[5], relu)
        want = tbn.batch_norm_eval_plain(*plain[:5], 1e-5, plain[5], relu)
        assert torch.equal(y, want)
        y.backward(dy)
        want.backward(dy)
        for got, ref in zip(fused, plain):
            if ref is None:
                continue
            assert (got.grad is None) == (ref.grad is None)
            if ref.grad is not None:
                assert torch.equal(got.grad, ref.grad)
        assert fused[1].grad is None and fused[2].grad is None
    finally:
        stand_in._destroy()


def test_bottleneck_ends_on_its_last_norm_with_the_shortcut():
    """An unfused unit in eval mode: relu(shortcut + conv3's norm), the
    stride-2 identity shortcut strided, equal to the chain written out."""
    from iv2019_tpu_torch.models.layers import BottleneckV1, conv_same

    threads()
    torch.manual_seed(3)
    unit = BottleneckV1(16, 16, 8, stride=2, rate=1, dtype=torch.float32)
    for m in unit.modules():
        if isinstance(m, Norm):
            with torch.no_grad():
                m.mean.uniform_(-0.2, 0.2)
                m.var.uniform_(0.5, 1.5)
                m.scale.uniform_(0.5, 1.5)
    for conv in (unit.conv1, unit.conv2, unit.conv3):
        torch.nn.init.normal_(conv.conv.weight, std=0.2)
    unit.eval()
    x = torch.randn(2, 16, 9, 11).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = unit(x)
        y = x
        for conv, act in ((unit.conv1, True), (unit.conv2, True), (unit.conv3, False)):
            n = conv.norm
            y = _eval_chain(conv_same(y, conv.conv.weight, conv.stride, conv.rate), n.mean,
                            n.var, n.scale, n.bias, n.epsilon, None, act)
    assert torch.equal(got, torch.relu(x[:, :, ::2, ::2] + y))


def test_torch_ops_declares_iv_bn_eval_as_the_source():
    """csrc/torch_ops.cpp's declaration of iv_bn_eval has as many
    parameters as csrc/fused_bn.cu's definition (a missing one would shift
    every argument after it, and only the card would notice)."""
    ops = (tbn._build.CSRC_DIR / "torch_ops.cpp").read_text()
    source = (tbn._build.CSRC_DIR / "fused_bn.cu").read_text()
    decl = re.search(r"int iv_bn_eval\(([^)]*)\);", ops)
    defn = re.search(r'extern "C" int iv_bn_eval\(([^)]*)\)', source)
    assert decl and defn
    assert len(decl.group(1).split(",")) == len(defn.group(1).split(",")) == 13

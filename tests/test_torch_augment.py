"""The port's on-device augmentations against the JAX package's.

JAX draws with threefry keys, the port with a torch generator, so each
augmentation is split into a draw and an apply. Here the JAX draws are
computed with the same ``jax.random`` calls on the same split keys as
iv2019_tpu/ops/augment.py makes, handed to the port's apply, and the result
is held against the JAX function, compiled as the JAX train step runs it
(XLA turns a division by a constant into a product with its reciprocal,
and the port does the same): labels exactly, images within 1e-5
(color, warps: reductions and HSV round in another order), the median
filter exactly (its values are integers over 255), the bilateral filter
within 2e-6 relative (exp may differ by an ulp). The port's own draws are
checked for range, shape, probability and determinism per (seed, fold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.ops import augment as jaug
from iv2019_tpu_torch.ops import augment
from torch_parity import threads

IMAGE_ATOL = 1e-5
BILATERAL_RTOL = 2e-6
POI = (1.0, 2.0)
UNLABELED = 19


def _images(seed, n=3, h=24, w=40):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    labels = rng.randint(0, 20, (n, h, w)).astype(np.int32)
    return images, labels


def _jax_draws(key, names, n, h, w, poi=POI):
    """The draws iv2019_tpu/ops/augment.py makes from ``key``, under the
    port's names (apply_augmentations' split, then each op's)."""
    k_color, k_blur, k_flip, k_scale = jax.random.split(key, 4)
    d = {}
    if "color" in names:
        k_sel, k_b, k_s, k_h, k_c = jax.random.split(k_color, 5)
        d["col_r"] = int(jax.random.randint(k_sel, (), 0, 8))
        d["brightness"] = jax.random.uniform(k_b, (n,), minval=-jaug._BRIGHTNESS_MAX_DELTA,
                                             maxval=jaug._BRIGHTNESS_MAX_DELTA)
        d["saturation"] = jax.random.uniform(k_s, (n,), minval=0.7, maxval=1.3)
        d["hue"] = jax.random.uniform(k_h, (n,), minval=-0.1, maxval=0.1)
        d["contrast"] = jax.random.uniform(k_c, (n,), minval=0.7, maxval=1.3)
    if "blur" in names:
        k1, k2 = jax.random.split(k_blur)
        d["blu_r"] = int(jax.random.randint(k1, (), 0, 4))
        d["radii"] = jax.random.randint(k2, (n,), 1, jaug.blur_max_radius(h, w) + 1)
    if "flip" in names:
        d["flip"] = jax.random.bernoulli(k_flip, 0.5, (n,))
    if "scale" in names:
        k_sel, k_up, k_down = jax.random.split(k_scale, 3)
        k_f, k_oy, k_ox = jax.random.split(k_up, 3)
        d["scale_up"] = jax.random.uniform(k_sel, (n,)) > 0.5
        d["up_inv"] = jax.random.uniform(k_f, (n,), minval=1.0 / poi[1], maxval=1.0 / poi[0])
        d["up_oy"] = jax.random.uniform(k_oy, (n,))
        d["up_ox"] = jax.random.uniform(k_ox, (n,))
        d["down_inv"] = jax.random.uniform(k_down, (n,), minval=1.0 / poi[1],
                                           maxval=1.0 / poi[0])
    return {k: v if isinstance(v, int) else torch.as_tensor(np.array(v)) for k, v in d.items()}


def _key_with(name, value, n, h, w):
    """A key whose draw of the batch-wide selector ``name`` is ``value``."""
    names = ("color", "blur")
    for seed in range(500):
        key = jax.random.PRNGKey(seed)
        if _jax_draws(key, names, n, h, w)[name] == value:
            return key
    raise AssertionError(f"no key draws {name} = {value}")


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("order", [0, 1, 2, 3, 5])
def test_color_given_jax_draws_matches_jax(order):
    threads()
    images, _ = _images(order)
    n, h, w = images.shape[:3]
    key = _key_with("col_r", order, n, h, w)
    k_color = jax.random.split(key, 4)[0]
    images01 = (images + 1.0) * 0.5
    want = np.asarray(jax.jit(jaug.random_color)(k_color, jnp.asarray(images01)))
    got = augment.color_apply(_t(images01), _jax_draws(key, ("color",), n, h, w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    if order >= 4:
        np.testing.assert_array_equal(got, images01)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_blur_given_jax_draws_matches_jax(which):
    threads()
    images, _ = _images(10 + which)
    n, h, w = images.shape[:3]
    key = _key_with("blu_r", which, n, h, w)
    k_blur = jax.random.split(key, 4)[1]
    want = np.asarray(jax.jit(jaug.random_blur)(k_blur, jnp.asarray(images)))
    got = augment.blur_apply(_t(images), _jax_draws(key, ("blur",), n, h, w)).numpy()
    if which == 1:
        np.testing.assert_allclose(got, want, rtol=BILATERAL_RTOL, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_radius", [1, 2, 3])
def test_median_filter_is_exact_at_each_radius(max_radius):
    images, _ = _images(20 + max_radius, n=max_radius, h=13, w=17)
    radii = np.arange(1, max_radius + 1, dtype=np.int32)
    median = jax.jit(jax.vmap(jaug._median_filter, (0, 0, None)), static_argnums=2)
    want = np.asarray(median(jnp.asarray(images), jnp.asarray(radii), max_radius))
    got = augment._median_filter(_t(images), _t(radii), max_radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_radius", [1, 2, 3])
def test_bilateral_filter_within_an_ulp_or_two_at_each_radius(max_radius):
    images, _ = _images(30 + max_radius, n=max_radius, h=13, w=17)
    radii = np.arange(1, max_radius + 1, dtype=np.int32)
    sigma = 3.0  # small enough that the range kernel weighs the colors
    bilateral = jax.jit(jax.vmap(jaug._bilateral_filter, (0, 0, None, None)),
                        static_argnums=(2, 3))
    want = np.asarray(bilateral(jnp.asarray(images), jnp.asarray(radii), max_radius, sigma))
    got = augment._bilateral_filter(_t(images), _t(radii), max_radius, sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=BILATERAL_RTOL, atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
def test_flip_given_jax_draws_matches_jax(seed):
    images, labels = _images(40 + seed, n=6)
    n, h, w = images.shape[:3]
    key = jax.random.PRNGKey(seed)
    k_flip = jax.random.split(key, 4)[2]
    wi, wl = jax.jit(jaug.random_flipping)(k_flip, jnp.asarray(images), jnp.asarray(labels))
    draws = _jax_draws(key, ("flip",), n, h, w)
    gi, gl = augment.flip_apply(_t(images), _t(labels), draws["flip"])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("seed,hw", [(0, (24, 40)), (1, (33, 47)), (2, (16, 16)), (3, (31, 64))])
def test_scale_given_jax_draws_matches_jax(seed, hw):
    threads()
    images, labels = _images(50 + seed, n=6, h=hw[0], w=hw[1])
    n, h, w = images.shape[:3]
    key = jax.random.PRNGKey(100 + seed)
    k_scale = jax.random.split(key, 4)[3]
    scaling = jax.jit(jaug.random_scaling, static_argnums=(3, 4))
    wi, wl = scaling(k_scale, jnp.asarray(images), jnp.asarray(labels), POI, UNLABELED)
    draws = _jax_draws(key, ("scale",), n, h, w)
    assert 0 < int(draws["scale_up"].sum()) < n  # both branches taken
    gi, gl = augment.scale_apply(_t(images), _t(labels), draws, UNLABELED)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=IMAGE_ATOL)
    assert (gl.numpy() == UNLABELED).any()  # a downscaled canvas shows


@pytest.mark.parametrize("seed", range(3))
def test_all_four_in_order_given_jax_draws_matches_jax(seed):
    threads()
    names = ("color", "blur", "flip", "scale")
    images, labels = _images(60 + seed, n=4)
    n, h, w = images.shape[:3]
    key = jax.random.PRNGKey(200 + seed)
    apply = jax.jit(jaug.apply_augmentations, static_argnums=(3, 4, 5))
    wi, wl = apply(key, jnp.asarray(images), jnp.asarray(labels), names, UNLABELED, POI)
    draws = _jax_draws(key, names, n, h, w)
    # the order is the reference's whatever the order of the names
    gi, gl = augment.apply_augmentations(_t(images), _t(labels), names[::-1], draws, UNLABELED)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=IMAGE_ATOL)


def test_draws_are_deterministic_per_seed_and_fold():
    names = augment.VALID_AUGMENTATIONS
    a = augment.draw_augmentations(3, 7, names, 5, 64, 128)
    b = augment.draw_augmentations(3, 7, names, 5, 64, 128)
    c = augment.draw_augmentations(3, 8, names, 5, 64, 128)
    d = augment.draw_augmentations(4, 7, names, 5, 64, 128)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    for other in (c, d):
        assert not torch.equal(a["brightness"], other["brightness"])
        assert not torch.equal(a["up_inv"], other["up_inv"])


def test_draws_have_the_jax_ranges_shapes_and_probabilities():
    n, h, w = 4000, 512, 1024
    d = augment.draw_augmentations(0, 0, augment.VALID_AUGMENTATIONS, n, h, w, (1.0, 2.0))
    for k in ("brightness", "saturation", "hue", "contrast", "radii", "flip", "scale_up",
              "up_inv", "up_oy", "up_ox", "down_inv"):
        assert tuple(d[k].shape) == (n,), k
    assert d["radii"].dtype == torch.int32 and d["flip"].dtype == torch.bool
    lim = 32.0 / 255.0
    assert -lim <= float(d["brightness"].min()) and float(d["brightness"].max()) < lim
    for k in ("saturation", "contrast"):
        assert 0.7 <= float(d[k].min()) and float(d[k].max()) < 1.3
    assert -0.1 <= float(d["hue"].min()) and float(d["hue"].max()) < 0.1
    assert augment.blur_max_radius(h, w) == 2
    assert set(d["radii"].tolist()) == {1, 2}
    for k in ("up_inv", "down_inv"):
        assert 0.5 <= float(d[k].min()) and float(d[k].max()) < 1.0
    for k in ("up_oy", "up_ox"):
        assert 0.0 <= float(d[k].min()) and float(d[k].max()) < 1.0
    for k in ("flip", "scale_up"):
        assert abs(float(d[k].float().mean()) - 0.5) < 0.05, k
    cols = {augment.draw_augmentations(0, f, ("color",), 1, h, w)["col_r"] for f in range(200)}
    blurs = {augment.draw_augmentations(0, f, ("blur",), 1, h, w)["blu_r"] for f in range(200)}
    assert cols == set(range(8)) and blurs == set(range(4))
    assert set(augment.draw_augmentations(0, 0, ("flip",), 3, h, w)) == {"flip"}


@pytest.mark.parametrize("hw", [(32, 64), (512, 1024), (1024, 2048), (700, 1500)])
def test_blur_constants_match_jax(hw):
    assert augment.blur_max_radius(*hw) == jaug.blur_max_radius(*hw)
    assert augment.blur_sigma_space(*hw) == jaug.blur_sigma_space(*hw)


def test_unknown_augmentation_is_refused():
    images, labels = _images(0)
    with pytest.raises(ValueError, match="unknown augmentations"):
        augment.draw_augmentations(0, 0, ("flip", "rotate"), 3, 24, 40)
    with pytest.raises(ValueError, match="unknown augmentations"):
        augment.apply_augmentations(_t(images), _t(labels), ("rotate",), {}, UNLABELED)

"""Port fused bottleneck (iv2019_tpu_torch/ops/fused_block.py) against the
JAX package's Pallas kernels, run in interpret mode as
tests/test_pallas_block.py runs them.

On the CPU the port's wrappers run the plain version, so these hold the
plain version (the arithmetic the CUDA kernels are checked against on the
card) to the Pallas kernels: max |got - want| / max(1, |want|) < 2e-2, the
bound tests/test_pallas_block.py holds the Pallas kernel to against XLA
(both sides round y1 and y2 to bf16; a one-ulp flip propagates through
conv3). The dispatch rule must pick the same kernel for every ResNet-50
unit as the JAX rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.ops import pallas_block as jb
from iv2019_tpu_torch.ops import fused_block as tb
from torch_parity import threads

REL_TOL = 2e-2


@pytest.fixture(autouse=True)
def _threads():
    threads()


def _unit(rng, c, m):
    """Folded (w1, b1, w2, b2, w3, b3) as numpy, via the JAX fold_bn."""
    def bn(n):
        return (rng.uniform(0.5, 1.5, n), rng.uniform(-0.5, 0.5, n),
                rng.uniform(-0.2, 0.2, n), rng.uniform(0.3, 1.2, n))

    def kern(kh, ci, co):
        return rng.normal(0, (2.0 / (kh * kh * ci)) ** 0.5, (kh, kh, ci, co))

    out = []
    for k, stats in ((kern(1, c, m), bn(m)), (kern(3, m, m), bn(m)), (kern(1, m, c), bn(c))):
        kf, bf = jb.fold_bn(*(jnp.asarray(a, jnp.float32) for a in (k, *stats)))
        out += [np.array(kf), np.array(bf)]
    k1, b1, k2, b2, k3, b3 = out
    return k1[0, 0], b1, k2, b2, k3[0, 0], b3


def _rel_err(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _port(x, unit, wrapper, rate):
    bf = torch.bfloat16
    w1, b1, w2, b2, w3, b3 = unit
    args = (torch.from_numpy(x).to(bf), torch.from_numpy(w1).to(bf), torch.from_numpy(b1),
            torch.from_numpy(w2).to(bf), torch.from_numpy(b2), torch.from_numpy(w3).to(bf),
            torch.from_numpy(b3))
    return wrapper(*args, rate=rate).float().numpy()


@pytest.mark.parametrize(
    "n,h,w,c,m,rate",
    [
        (1, 16, 16, 128, 128, 2),
        (2, 24, 16, 128, 128, 2),
        (1, 16, 24, 128, 128, 1),
        (1, 32, 16, 128, 128, 4),
    ],
)
def test_fused_bottleneck_plain_matches_pallas(n, h, w, c, m, rate):
    rng = np.random.RandomState(0)
    unit = _unit(rng, c, m)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    bf = jnp.bfloat16
    w1, b1, w2, b2, w3, b3 = (jnp.asarray(a) for a in unit)
    want = np.asarray(jb.fused_bottleneck(
        jnp.asarray(x).astype(bf), w1, b1, w2, b2, w3, b3, rate=rate, interpret=True,
    ).astype(jnp.float32))
    before = tb.fused_bottleneck.launches
    got = _port(x, unit, tb.fused_bottleneck, rate)
    assert tb.fused_bottleneck.launches == before  # CPU: plain version, no launch
    assert _rel_err(got, want) < REL_TOL


@pytest.mark.parametrize(
    "n,h,w,c,m,rate,th,ct",
    [
        (1, 16, 16, 256, 128, 4, 4, 128),
        (2, 24, 16, 256, 128, 2, 4, 128),
        (1, 16, 16, 384, 128, 1, 8, 128),
        (1, 16, 24, 256, 128, 4, 8, 256),
    ],
)
def test_fused_bottleneck_ct_plain_matches_pallas(n, h, w, c, m, rate, th, ct):
    rng = np.random.RandomState(0)
    unit = _unit(rng, c, m)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    w1, b1, w2, b2, w3, b3 = (jnp.asarray(a) for a in unit)
    want = np.asarray(jb.fused_bottleneck_ct(
        jnp.asarray(x).astype(jnp.bfloat16), w1, b1, w2, b2, w3, b3,
        rate=rate, th=th, ct=ct, interpret=True,
    ).astype(jnp.float32))
    got = _port(x, unit, tb.fused_bottleneck_ct, rate)
    assert _rel_err(got, want) < REL_TOL


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.normal(0, 1, (3, 3, 8, 16)).astype(np.float32)  # HWIO
    stats = [rng.uniform(0.3, 1.2, 16).astype(np.float32) for _ in range(4)]
    kj, bj = jb.fold_bn(jnp.asarray(k), *(jnp.asarray(s) for s in stats))
    kt, bt = tb.fold_bn(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                        *(torch.from_numpy(s) for s in stats))
    np.testing.assert_allclose(kt.numpy().transpose(2, 3, 1, 0), np.asarray(kj), rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6, atol=1e-7)


def _resnet50_units():
    from iv2019_tpu.models.resnet import RESNET50_BLOCKS, _unit_plan

    depth_in = 64
    for bi, units in enumerate(_unit_plan(RESNET50_BLOCKS, 8)):
        for ui, (depth, mid, stride, rate) in enumerate(units):
            yield f"block{bi + 1}/unit_{ui + 1}", depth_in, depth, mid, stride, rate
            depth_in = depth


def _dispatch_counts(h, w):
    """The port's kernel choice for every ResNet-50 unit at an (h, w)
    feature map, checked unit by unit against layers.py:488-531, in eval
    mode (the rule's ``use_running_average``; train mode fuses nothing)."""
    from iv2019_tpu_torch.models.resnet import ResNetV1

    with torch.device("meta"):
        trunk = ResNetV1(fused_block=True).eval()
    port_units = dict(zip(trunk.unit_names, trunk.units()))
    counts = {"full": 0, "ct": 0, None: 0}
    for name, depth_in, depth, mid, stride, rate in _resnet50_units():
        shape = (1, h, w, depth_in, mid, rate)
        eligible = stride == 1 and depth_in == depth
        full = eligible and jb.fused_bottleneck_supported(*shape)
        ct = eligible and not full and jb.pick_ct_config(*shape) is not None
        want = "full" if full else "ct" if ct else None
        assert tb.fused_bottleneck_supported(*shape) == jb.fused_bottleneck_supported(*shape)
        assert tb.pick_ct_config(*shape) == jb.pick_ct_config(*shape)
        kernel = port_units[name].fused_kernel(1, h, w)
        got = {tb.fused_bottleneck: "full", tb.fused_bottleneck_ct: "ct", None: None}[kernel]
        assert got == want, name
        counts[got] += 1
    return counts


def test_dispatch_matches_jax_rule_at_flagship():
    """All 16 ResNet-50 units at 1x512x1024 (feature map 64x128): the same
    choices as the JAX rule, 8 full-window, 2 channel-tiled, 6 unfused."""
    assert _dispatch_counts(64, 128) == {"full": 8, "ct": 2, None: 6}


def test_dispatch_matches_jax_rule_on_small_map():
    """At a 128x128 input (16x16 map) the rule sends block4's units to the
    full-window kernel too (the CUDA entry point then takes 16x2 tiles)."""
    assert _dispatch_counts(16, 16) == {"full": 10, "ct": 0, None: 6}


@pytest.mark.parametrize("shape", [(4, 64, 128, 2048, 512, 4), (2, 32, 64, 1024, 256, 2),
                                   (1, 60, 128, 1024, 256, 2), (1, 64, 128, 2048, 512, 8)])
def test_dispatch_rule_matches_jax_off_flagship(shape):
    assert tb.fused_bottleneck_supported(*shape) == jb.fused_bottleneck_supported(*shape)
    assert tb.pick_ct_config(*shape) == jb.pick_ct_config(*shape)


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 16, 16, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.fused_bottleneck(x, x, x, x, x, x, x, rate=1)

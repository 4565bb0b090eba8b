"""Every op of the port with a spatial extent on a band of image rows, held
to the same op on the whole image: 4 gloo ranks on the CPU, one spatial
group of 4 (``--spatial 4``), each rank running the op on its quarter of
the rows (tests/torch_dist_worker.py, scenario ``spatial_ops``) under the
active mesh, against the op in this process without a mesh.

Forward: the ranks' bands stacked equal the whole output. Backward (an
upstream gradient drawn for the whole output, each rank its band of it):
the bands of the input gradient stacked equal the whole input gradient,
and the parameter gradients summed over the ranks (what the train step's
gradient all-reduce does) equal the whole one.

The cases: the conv at rates 1, 2 and 4 and at stride 2, a rate-4 conv on
a map of 8 rows (2 a band: the halo reaches past the neighbour into the
band beyond), the 7x7/2 root conv in f32 (the library's wgrad) and in bf16
(B6's plain version with the haloed band's pad rows), the TF 'SAME' max
pool, the x8 bilinear and a nearest align_corners resize (the global row
mapping), PSP under batch and group norm (train mode: BatchNorm sums over
every rank), group norm with 32 groups and one, the FOV conv (3x3 at rate
2 with train-mode BatchNorm) and the hybrid upsampler's 3x3, and a fused
eval unit (bf16, B4's plain version on the CPU) on its haloed band.

Tolerances: f32 1e-5 of the largest |value| (summation order: a band's
conv, its sums over the group and E[x^2] - E[x]^2 against the whole map's);
the nearest resize exactly; the bf16 cases (the root conv with B6's plain
version, whose dW is rounded to bf16 as in JAX, and the fused unit) 2e-2,
the kernel bound of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from torch_parity import run_ranks, threads

WORLD = 4
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _nchw(rng, n, c, h, w):
    return rng.standard_normal((n, c, h, w)).astype(np.float32)


def _cases():
    rng = np.random.RandomState(0)
    cases = {}

    def add(name, op, x, dim=2, **kw):
        cases[name] = {"op": op, "x": x, "dim": dim, "kw": kw, "seed": len(cases)}

    for rate in (1, 2, 4):
        add(f"conv_rate{rate}", "conv", _nchw(rng, 2, 6, 16, 12), cin=6, cout=5, k=3, stride=1,
            rate=rate)
    add("conv_stride2", "conv", _nchw(rng, 2, 6, 16, 12), cin=6, cout=5, k=3, stride=2, rate=1)
    add("conv_halo_wider_than_band", "conv", _nchw(rng, 2, 6, 8, 12), cin=6, cout=5, k=3,
        stride=1, rate=4)
    add("root_f32", "root", _nchw(rng, 2, 3, 32, 16), dtype="float32")
    add("root_bf16_b6", "root", _nchw(rng, 2, 3, 32, 16), dtype="bfloat16")
    add("max_pool", "maxpool", _nchw(rng, 2, 4, 16, 10))
    add("bilinear_x8", "bilinear", rng.standard_normal((2, 4, 8, 5)).astype(np.float32), dim=1,
        size=(32, 64))
    add("nearest", "nearest", rng.randint(0, 19, (2, 8, 16)).astype(np.int32), dim=1,
        size=(20, 40))
    # the model's PSP width under group norm: 8 channels a group (in the one
    # bin of d = 1 a group of fewer values is E[x^2] - E[x]^2 of near equals)
    for norm in ("batch", "group"):
        add(f"psp_{norm}", "psp", _nchw(rng, 4, 32, 8, 12), cin=32, features=256, norm=norm)
    add("group_norm_32", "group_norm", _nchw(rng, 2, 64, 8, 6) * 2 + 1, c=64, groups=32)
    add("group_norm_1", "group_norm", _nchw(rng, 2, 14, 8, 6) * 2 + 1, c=14, groups=1)
    add("fov_conv", "fov", _nchw(rng, 2, 8, 16, 10), c=8, rate=2)
    add("hybrid_conv_transpose", "hybrid", _nchw(rng, 2, 7, 8, 10), c=7)
    add("fused_unit", "fused", np.abs(_nchw(rng, 1, 128, 32, 8)), c=128, m=128, rate=2)
    for case in cases.values():
        if case["op"] not in ("nearest", "fused"):
            fn, _ = worker._spatial_op(case)
            x = torch.from_numpy(case["x"])
            if case["op"] == "root" and case["kw"]["dtype"] == "bfloat16":
                x = x.bfloat16()
            shape = fn(x).shape
            case["dy"] = rng.standard_normal(tuple(shape)).astype(np.float32)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads()
    inp = list(CASES.values())
    ranks = run_ranks("spatial_ops", inp, tmp_path_factory.mktemp("spatial_ops"), world=WORLD,
                      spatial=WORLD)
    whole = worker.run_spatial_ops(inp, None)
    return {name: (whole[i], [r[i] for r in ranks]) for i, name in enumerate(CASES)}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest |value| over {tol}"


@pytest.mark.parametrize("name", list(CASES))
def test_band_forward_and_backward_equal_the_whole(runs, name):
    whole, ranks = runs[name]
    case = CASES[name]
    dim = case["dim"]
    y = np.concatenate([r["y"] for r in ranks], axis=dim)
    assert y.shape == whole["y"].shape
    bf16 = case["op"] == "fused" or case["kw"].get("dtype") == "bfloat16"
    if case["op"] == "nearest":
        np.testing.assert_array_equal(y, whole["y"])
    else:
        _close(y, whole["y"], BF16_TOL if bf16 else F32_TOL, "output")
    if "dx" not in whole:
        return
    dx = np.concatenate([r["dx"] for r in ranks], axis=dim)
    _close(dx, whole["dx"], BF16_TOL if bf16 else F32_TOL, "input gradient")
    assert whole["grads"].keys() == ranks[0]["grads"].keys()
    for k, want in whole["grads"].items():
        _close(sum(r["grads"][k] for r in ranks), want, BF16_TOL if bf16 else F32_TOL,
               f"gradient of {k}")

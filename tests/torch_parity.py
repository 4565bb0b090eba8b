"""Shared helpers of the PyTorch-port parity tests.

Both packages get the same weights: the JAX model is initialized by flax,
its BatchNorm statistics are randomized from a numpy seed, and the port
loads the same trees through iv2019_tpu_torch/utils/convert.py.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from iv2019_tpu.models.model import HierarchicalSegmentationModel as JaxModel
from iv2019_tpu.problem.taxonomy import get_taxonomy as jax_taxonomy
from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel as TorchModel
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy as torch_taxonomy
from iv2019_tpu_torch.utils.convert import load_flax_variables

# a short stack whose identity units at C=256, M=128 pass the fused rule at a
# 128x128 input (16x16 feature map): block2/unit_2, block3/unit_1, unit_2
SMALL_BLOCKS = ((2, 128, 128), (2, 256, 128), (2, 256, 128))
SMALL_FDIMS = 64
SMALL_HW = (128, 128)


def threads():
    """Tier-1 runs six test workers: keep each to one torch thread."""
    torch.set_num_threads(1)


def randomize_stats(variables, rng):
    """Randomize BN scale/bias and jitter the running statistics around
    their current values, so that folding and the norms are exercised
    non-trivially while activations keep the scale the statistics give."""
    flat = flax.traverse_util.flatten_dict(variables)
    out = {}
    for k, v in flat.items():
        leaf = k[-1]
        if leaf == "scale":
            out[k] = jnp.asarray(rng.uniform(0.6, 1.4, v.shape), v.dtype)
        elif leaf == "bias":
            out[k] = jnp.asarray(rng.uniform(-0.3, 0.3, v.shape), v.dtype)
        elif leaf == "mean":
            std = np.sqrt(np.asarray(flat[k[:-1] + ("var",)]))
            out[k] = jnp.asarray(v + 0.1 * std * rng.uniform(-1, 1, v.shape), v.dtype)
        elif leaf == "var":
            out[k] = jnp.asarray(v * rng.uniform(0.8, 1.25, v.shape), v.dtype)
        else:
            out[k] = v
    return flax.traverse_util.unflatten_dict(out)


def jax_small_model(dtype=jnp.float32, fused_block=False):
    return JaxModel(
        taxonomy=jax_taxonomy("cityscapes"), resnet_blocks=SMALL_BLOCKS,
        feature_dims_decreased=SMALL_FDIMS, fused_block=fused_block, dtype=dtype,
    )


@functools.lru_cache(maxsize=None)
def small_variables(seed=0):
    """Flax variables of the small model: flax init, running statistics
    set to the batch statistics of random images (one train-mode forward
    with momentum 0, so every layer sees normalized inputs, as in a trained
    net), then randomized around them. Cached per seed: callers must not
    modify the trees."""
    images = jnp.asarray(small_images(seed + 100, n=2))
    variables = jax.jit(jax_small_model().init)(jax.random.PRNGKey(seed), images[:1])
    calibrate = JaxModel(
        taxonomy=jax_taxonomy("cityscapes"), resnet_blocks=SMALL_BLOCKS,
        feature_dims_decreased=SMALL_FDIMS, dtype=jnp.float32,
        accumulate_norm_statistics=True, batch_norm_decay=0.0,
    )
    _, mutated = jax.jit(lambda v, x: calibrate.apply(v, x, mutable=["batch_stats"]))(
        variables, images)
    variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    return randomize_stats(variables, np.random.RandomState(seed))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def torch_small_model(variables, dtype=torch.float32, fused_block=False):
    model = TorchModel(
        taxonomy=torch_taxonomy("cityscapes"), resnet_blocks=SMALL_BLOCKS,
        feature_dims_decreased=SMALL_FDIMS, fused_block=fused_block, dtype=dtype,
    ).to(memory_format=torch.channels_last).eval()
    return load_flax_variables(
        model, numpy_tree(variables["params"]), numpy_tree(variables["batch_stats"]))


def small_images(seed=0, n=1, hw=SMALL_HW):
    return np.random.RandomState(seed).uniform(-1, 1, (n, *hw, 3)).astype(np.float32)


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.is_floating_point() else x.cpu().numpy()
    return np.asarray(x)


_BN_INV = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def _cnr_name(prefix, rest):
    if list(rest) == ["conv", "kernel"]:
        return f"{prefix}/weights"
    if rest[0] == "norm":
        return f"{prefix}/BatchNorm/{_BN_INV[rest[-1]]}"
    raise AssertionError(rest)


def flax_path_to_tf_name(path):
    """Test-side inverse of tf_trained_name_to_flax_path for the default
    model (tests/test_trained_checkpoint.py:55-83)."""
    col, module, *rest = path
    if module == "feature_extractor/base":
        sub = rest[0]
        if sub == "conv1":
            return "feature_extractor/resnet_v1_50/conv1/weights"
        if sub == "conv1_norm":
            return "feature_extractor/resnet_v1_50/conv1/BatchNorm/" + _BN_INV[rest[-1]]
        return _cnr_name(f"feature_extractor/resnet_v1_50/{sub}/bottleneck_v1/{rest[1]}", rest[2:])
    if module.startswith("adaptation_module/"):
        return _cnr_name(f"{module}/bottleneck_v1/{rest[0]}", rest[1:])
    return _cnr_name(module, rest)


def write_trained_npz(path, variables, seed=7, with_ema=True, own_values=False):
    """An .npz of the reference's trained-checkpoint names for ``variables``:
    raw values (random, or with ``own_values`` the variables' own), EMA
    shadows for every param (not BN moving stats), and optimizer junk.
    Returns the path."""
    rng = np.random.RandomState(seed)
    arrays = {"global_step": np.asarray(10)}
    flat = flax.traverse_util.flatten_dict(
        {"params": dict(variables["params"]), "batch_stats": dict(variables["batch_stats"])})
    for p, v in flat.items():
        name = flax_path_to_tf_name(p)
        value = (rng.randn(*v.shape) * 0.05).astype(np.float32)
        if p[-1] == "var":
            value = np.abs(value) + 0.5
        if own_values:
            value = np.asarray(v, np.float32)
        arrays[name] = value
        if with_ema and p[0] == "params":
            arrays[f"exponential_moving_averages/{name}/ExponentialMovingAverage"] = value + 1.0
            arrays[f"{name}/Momentum"] = value * 0
    np.savez(path, **arrays)
    return str(path)


def torch_tiny_model(settings, variables, train=True):
    """The port's counterpart of helpers.tiny_model, f32, with the flax
    variables loaded (``settings``: the port's Settings, whose ``bn_impl``
    the model takes)."""
    from helpers import TINY_BLOCKS

    model = TorchModel(
        taxonomy=torch_taxonomy(settings.per_pixel_dataset_name), resnet_blocks=TINY_BLOCKS,
        feature_dims_decreased=settings.feature_dims_decreased, dtype=torch.float32,
        upsampling_method=settings.upsampling_method, batch_norm_decay=settings.batch_norm_decay,
        bn_impl=settings.bn_impl,
    ).to(memory_format=torch.channels_last).train(train)
    return load_flax_variables(
        model, numpy_tree(variables["params"]), numpy_tree(variables["batch_stats"]))


def torch_tiny_settings(**kw):
    """(JAX Settings, the port's Settings) with helpers.tiny_settings'
    values, the port's on the CPU. ``bn_impl`` is ``"flax"`` on both sides
    unless ``kw`` names it (the port's default is ``"fused"``, the JAX
    package's ``"flax"``)."""
    from helpers import tiny_settings
    from iv2019_tpu_torch.config import Settings as TorchSettings

    jax_settings = tiny_settings(**{"bn_impl": "flax", **kw})
    derived = ("height_network", "width_network", "num_", "learning_rate_boundaries_",
               "learning_rate_values_")
    fields = {f for f in TorchSettings.__dataclass_fields__ if not f.startswith(derived)}
    values = {k: getattr(jax_settings, k) for k in fields if k not in ("mode", "device")}
    return jax_settings, TorchSettings(device="cpu", **values).finalize()


def loss_inputs_np(tax, seed, n_pp, n_pb, n_pi, h=8, w=16, scale=4):
    """Stride-8 logits (dict), full-resolution labels and the output size:
    random logits, per-pixel labels over the whole per-pixel space, sparse
    weak multinomials with exact-void pixels (tests/test_fused_loss.py)."""
    rng = np.random.RandomState(seed)
    n = n_pp + n_pb + n_pi
    H, W = h * scale, w * scale
    lr = {k: (rng.randn(n, h, w, c) * 2).astype(np.float32) for k, c in (
        ("l1_logits", tax.num_l1_classes), ("l2_vehicle_logits", tax.num_vehicle_classes),
        ("l2_human_logits", tax.num_human_classes))}

    def weak(nb):
        lab = rng.rand(nb, H, W, 15).astype(np.float32) ** 4
        lab[lab < 0.3] = 0.0
        void = rng.rand(nb, H, W) < 0.25
        lab[void] = 0.0
        lab[void, -1] = 1.0
        lab[lab.sum(-1) == 0, -1] = 1.0
        return lab / lab.sum(-1, keepdims=True)

    labels = {
        "prolabels_per_pixel": rng.randint(0, len(tax.per_pixel_cids2l1_cids),
                                           (n_pp, H, W)).astype(np.int32),
        "prolabels_per_bbox": weak(n_pb),
        "prolabels_per_image": weak(n_pi),
    }
    return lr, labels, (H, W)


def run_ranks(scenario, inp, tmp_path, world=2, timeout=120, slices=1, devices=False,
              spatial=1):
    """Run ``scenario`` of tests/torch_dist_worker.py on ``world`` gloo ranks
    (separate processes, meeting at a free localhost port) with the inputs
    ``inp``; returns each rank's output. With ``devices`` the ranks are
    those of one process's ``world`` devices, else ``world`` processes;
    ``spatial`` ranks split each image's height. A
    rank that fails, or a run that outlasts ``timeout`` seconds, fails the
    test (every rank is killed)."""
    import os
    import subprocess
    import sys
    import time

    from iv2019_tpu_torch.parallel.multihost import free_port

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
    tag = f"{scenario}_w{world}_s{slices}_p{spatial}{'_d' if devices else ''}"
    path = str(tmp_path / f"{tag}_in.pt")
    torch.save(inp, path)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        out = str(tmp_path / f"{tag}_rank{rank}.pt")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, worker, scenario, path, out, "--rank", str(rank), "--world",
             str(world), "--port", str(port), "--slices", str(slices), "--spatial",
             str(spatial)]
            + (["--devices"] if devices else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{logs[rank]}"
    return [torch.load(o, weights_only=False) for o in outs]

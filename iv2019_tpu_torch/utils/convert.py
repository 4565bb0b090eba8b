"""Weights between the JAX package's flax trees, trained checkpoints and the port.

- ``state_dict_from_flax`` / ``flax_from_state_dict``: flax
  ``params``/``batch_stats`` trees (nested dicts of numpy arrays) to and
  from the port's state dicts. A state-dict key is the flax module path
  joined with dots. The mapping goes by module, not by leaf:
  ``<module>/kernel`` (HWIO; ``<module>`` a ``conv`` or a hybrid
  upsampler's ``conv_transpose``) is ``<module>.weight`` (OIHW; grouped
  kernels (kh, kw, Cin/g, Cout) -> (Cout, Cin/g, kh, kw)), a
  ``conv_transpose``'s ``bias`` is ``<module>.bias``, and
  ``<norm>/BatchNorm/<leaf>`` or ``<norm>/GroupNorm/<leaf>`` is
  ``<norm>.<leaf>``. A state dict alone does not tell a GroupNorm from a
  BatchNorm's parameters, so the model's group norms are passed along
  (``group_norm_modules``; ``flax_variables`` and ``flax_params`` take the
  model).
- ``tf_trained_name_to_flax_path`` and ``restore_trained_from_npz``: the
  reference's trained-checkpoint names, as converted to an ``.npz``, onto a
  flax tree, with the EMA shadow names under ``restore_emas``. Copies of
  iv2019_tpu/utils/checkpoint.py:112-418 (numpy only).
- ``optax_state_to_jax`` / ``load_optax_state``: the JAX package's optax
  path state (the SGD momentum trace, the schedule count, ``EmaState``'s
  ``biased`` tree and ``decay_product``) to and from the port's
  (train/state.py), as flax-shaped trees of numpy arrays.
- ``opt_state_from_jax`` / ``opt_state_to_jax``: the JAX package's
  ``FusedOptState`` (``momentum``, ``ema_biased``, ``ema_decay_product``)
  to and from the port's (train/fused_update.py). JAX's flat vectors are in
  ``ravel_pytree`` order (flax paths sorted), with HWIO kernels and a tail
  padded to a multiple of ``JAX_UPDATE_TILE``; the port's follow its
  optimizer's ``layout`` (parameter order, OIHW kernels in their memory
  strides, each parameter 512-byte aligned with zero gaps).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "JAX_UPDATE_TILE",
    "flax_from_state_dict",
    "flax_params",
    "flax_variables",
    "group_norm_modules",
    "load_flax_variables",
    "load_optax_state",
    "opt_state_from_jax",
    "opt_state_to_jax",
    "opt_vector_from_jax",
    "opt_vector_to_jax",
    "optax_state_to_jax",
    "port_params",
    "restore_trained_from_npz",
    "state_dict_from_flax",
    "tf_trained_name_to_flax_path",
]

_PARAM_LEAVES = ("scale", "bias")
_STAT_LEAVES = ("mean", "var")


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _get_path(tree: dict, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def _is_conv_transpose(mods) -> bool:
    return mods[-1].endswith("conv_transpose")


def _port_key(col: str, path: tuple) -> tuple[str, bool]:
    """(port state-dict key, is a kernel) of a flax variable path."""
    *mods, leaf = path
    if col == "params" and leaf == "kernel":
        return ".".join(mods) + ".weight", True
    if col == "params" and leaf == "bias" and _is_conv_transpose(mods):
        return ".".join(mods) + ".bias", False
    leaves = _PARAM_LEAVES if col == "params" else _STAT_LEAVES
    if mods[-1] in ("BatchNorm", "GroupNorm") and leaf in leaves:
        if mods[-1] == "GroupNorm" and col != "params":
            raise KeyError(f"GroupNorm has no {col}")
        return ".".join(mods[:-1]) + "." + leaf, False
    raise KeyError(f"no port counterpart for {col}/{'/'.join(path)}")


def group_norm_modules(model: torch.nn.Module) -> frozenset:
    """Names of the model's GroupNorm modules."""
    from iv2019_tpu_torch.models.layers import Norm

    return frozenset(name for name, m in model.named_modules()
                     if isinstance(m, Norm) and m.norm_type == "group")


def _flax_key(key: str, group_norms=frozenset()) -> tuple[str, tuple, bool]:
    """(collection, flax path, is a kernel) of a port state-dict key;
    a norm's parameters are a GroupNorm's if its module is in
    ``group_norms``, else a BatchNorm's."""
    mod, leaf = key.rsplit(".", 1)
    mods = tuple(mod.split("."))
    if leaf == "weight":
        return "params", mods + ("kernel",), True
    if leaf == "bias" and _is_conv_transpose(mods):
        return "params", mods + ("bias",), False
    if leaf in _STAT_LEAVES:
        return "batch_stats", mods + ("BatchNorm", leaf), False
    if leaf in _PARAM_LEAVES:
        kind = "GroupNorm" if mod in group_norms else "BatchNorm"
        return "params", mods + (kind, leaf), False
    raise KeyError(f"no flax counterpart for {key}")


def _to_port(value: np.ndarray, is_kernel: bool) -> torch.Tensor:
    value = np.asarray(value, np.float32)
    return torch.from_numpy(np.ascontiguousarray(value.transpose(3, 2, 0, 1) if is_kernel
                                                 else value.copy()))


def _to_flax(value: torch.Tensor, is_kernel: bool) -> np.ndarray:
    # a copy: a CPU tensor's .numpy() would share the live parameters
    value = np.array(value.detach().float().cpu().numpy())
    return np.ascontiguousarray(value.transpose(2, 3, 1, 0)) if is_kernel else value


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Port state dict (f32 CPU tensors) from flax variable trees."""
    out = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _flatten(tree):
            key, is_kernel = _port_key(col, path)
            out[key] = _to_port(value, is_kernel)
    return out


def flax_from_state_dict(state_dict: dict, group_norms=frozenset()) -> tuple[dict, dict]:
    """(params, batch_stats) flax trees of numpy arrays from a port state
    dict, or a dict of some of its parameters; ``group_norms``: the names
    of the model's GroupNorm modules (``group_norm_modules``)."""
    trees = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        col, path, is_kernel = _flax_key(key, group_norms)
        _set_path(trees[col], path, _to_flax(value, is_kernel))
    return trees["params"], trees["batch_stats"]


def flax_params(named: dict, model: torch.nn.Module) -> dict:
    """A flax params-shaped tree (numpy) of per-parameter tensors keyed by
    the model's parameter names (gradients, momentum, EMA shadows)."""
    return flax_from_state_dict(named, group_norm_modules(model))[0]


def port_params(tree: dict) -> dict[str, torch.Tensor]:
    """{parameter name: f32 CPU tensor} of a flax params-shaped tree."""
    out = {}
    for path, value in _flatten(tree):
        key, is_kernel = _port_key("params", path)
        out[key] = _to_port(value, is_kernel)
    return out


def flax_variables(model: torch.nn.Module) -> dict:
    """The model's variables as a flax ``{'params', 'batch_stats'}`` tree."""
    params, batch_stats = flax_from_state_dict(model.state_dict(), group_norm_modules(model))
    return {"params": params, "batch_stats": batch_stats}


def load_flax_variables(model: torch.nn.Module, params: dict, batch_stats: dict) -> torch.nn.Module:
    """Load flax trees into the model; every variable must be covered."""
    model.load_state_dict(state_dict_from_flax(params, batch_stats), strict=True)
    return model


# --- reference trained-checkpoint names --------------------------------------

_BN_LEAF_MAP = {
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
_PSP_CONV_NAMES = {
    "Conv": "conv1",
    "Conv_1": "conv2",
    "Conv_2": "conv3",
    "Conv_3": "conv6",
    "Conv_4": "conv_final",
}
_UPSAMPLING_HEADS = {
    "upsampling": "l1_logits",
    "upsampling_1": "l2_vehicle_logits",
    "upsampling_2": "l2_human_logits",
}


def _backbone_rest_to_path(rest: str) -> Optional[tuple[str, ...]]:
    """The part of a slim name after ``resnet_v1_*/`` -> flax tree path."""
    base = "feature_extractor/base"
    if re.match(r"conv1/weights$", rest):
        return ("params", base, "conv1", "conv", "kernel")
    m = re.match(r"conv1/BatchNorm/(\w+)$", rest)
    if m and m.group(1) in _BN_LEAF_MAP:
        col, leaf = _BN_LEAF_MAP[m.group(1)]
        return (col, base, "conv1_norm", "BatchNorm", leaf)
    m = re.match(
        r"(block\d+)/(unit_\d+)/bottleneck_v1/(conv\d|shortcut)/(weights|BatchNorm/\w+)$",
        rest,
    )
    if m:
        block, unit, conv, tail = m.groups()
        module = f"{block}/{unit}"
        if tail == "weights":
            return ("params", base, module, conv, "conv", "kernel")
        bn_leaf = tail.split("/")[1]
        if bn_leaf in _BN_LEAF_MAP:
            col, leaf = _BN_LEAF_MAP[bn_leaf]
            return (col, base, module, conv, "norm", "BatchNorm", leaf)
    return None


def _cnr_tail_to_path(module: str, tail: str) -> Optional[tuple[str, ...]]:
    """weights / BatchNorm-leaf tail of a conv_norm_relu module -> path."""
    if tail == "weights":
        return ("params", module, "conv", "kernel")
    m = re.match(r"BatchNorm/(\w+)$", tail)
    if m and m.group(1) in _BN_LEAF_MAP:
        col, leaf = _BN_LEAF_MAP[m.group(1)]
        return (col, module, "norm", "BatchNorm", leaf)
    return None


def tf_trained_name_to_flax_path(name: str) -> Optional[tuple[bool, tuple[str, ...]]]:
    """Map a variable of the reference's trained model to ``(is_ema, path)``.

    Covers the backbone, extension, PSP, adaptation branches, heads and
    hybrid upsamplers, plus ``exponential_moving_averages/<name>/
    ExponentialMovingAverage`` shadows. None for non-model variables
    (global_step, Momentum slots, train_ops).
    """
    name = name.split(":")[0]
    is_ema = False
    m = re.match(r"exponential_moving_averages/(.*)/ExponentialMovingAverage$", name)
    if m:
        is_ema, name = True, m.group(1)

    if name == "global_step" or name.endswith("/Momentum") or name.startswith("train_ops"):
        return None

    m = re.match(r"(?:feature_extractor/)?resnet_v1_(?:50|101|152)/(.*)", name)
    if m:
        path = _backbone_rest_to_path(m.group(1))
        return (is_ema, path) if path else None

    m = re.match(r"feature_extractor/extension/(decrease_fdims|increase_fov)/(.*)", name)
    if m:
        path = _cnr_tail_to_path(f"feature_extractor/extension/{m.group(1)}", m.group(2))
        return (is_ema, path) if path else None

    m = re.match(r"feature_extractor/pyramid_module/(Conv(?:_\d)?)/(.*)", name)
    if m and m.group(1) in _PSP_CONV_NAMES:
        path = _cnr_tail_to_path(_PSP_CONV_NAMES[m.group(1)], m.group(2))
        if path:
            return (is_ema, (path[0], "feature_extractor/pyramid_module") + path[1:])
        return None

    m = re.match(
        r"adaptation_module/(l1_features|l2_vehicle_features|l2_human_features)"
        r"/bottleneck_v1/(conv\d|shortcut)/(.*)",
        name,
    )
    if m:
        branch, conv, tail = m.groups()
        path = _cnr_tail_to_path(conv, tail)
        if path:
            return (is_ema, (path[0], f"adaptation_module/{branch}") + path[1:])
        return None

    m = re.match(r"softmax_classifier/(l1_logits|l2_vehicle_logits|l2_human_logits)/(.*)", name)
    if m:
        path = _cnr_tail_to_path(f"softmax_classifier/{m.group(1)}", m.group(2))
        return (is_ema, path) if path else None

    m = re.match(
        r"softmax_classifier/(upsampling(?:_\d)?)/Conv2d_transpose/(weights|biases)$", name)
    if m and m.group(1) in _UPSAMPLING_HEADS:
        head = _UPSAMPLING_HEADS[m.group(1)]
        module = f"softmax_classifier/{head}/upsampling/conv_transpose"
        leaf = "kernel" if m.group(2) == "weights" else "bias"
        return (is_ema, ("params", module, leaf))
    return None


def _tf_transpose_conv_to_flax(w: np.ndarray) -> np.ndarray:
    """tf.layers.conv2d_transpose weights (kh, kw, out, in) -> flax
    ConvTranspose kernel (kh, kw, in, out): TF's transpose conv is the
    gradient of a forward conv, flax's (``transpose_kernel=False``) a
    regular conv, so the kernel is flipped in space and its channels
    swapped (checkpoint.py:335-345)."""
    return np.ascontiguousarray(w.transpose(0, 1, 3, 2)[::-1, ::-1])


def restore_trained_from_npz(variables: dict, npz_path: str, restore_emas: bool = False):
    """Restore every model variable from a converted trained checkpoint.

    ``variables`` is a flax ``{'params', 'batch_stats'}`` tree (see
    ``flax_variables``). With ``restore_emas`` the EMA shadow replaces the
    raw value wherever one exists (BatchNorm moving statistics have none).
    Returns ``(params, batch_stats, num_restored)``; raises if a model
    variable has no counterpart in the npz.
    """
    arrays = np.load(npz_path)
    tree: dict[str, Any] = {
        "params": _copy(variables["params"]),
        "batch_stats": _copy(variables.get("batch_stats", {})),
    }
    chosen: dict[tuple[str, ...], str] = {}
    for want_ema in (False, True) if restore_emas else (False,):
        for name in arrays.files:
            mapped = tf_trained_name_to_flax_path(name)
            if mapped is None:
                continue
            is_ema, path = mapped
            if is_ema == want_ema:
                chosen[path] = name

    restored = 0
    for path, name in chosen.items():
        try:
            current = _get_path(tree, path)
        except KeyError:
            continue  # a module this model was built without (PSP, FOV, ...)
        value = arrays[name]
        if path[-1] == "kernel" and "conv_transpose" in path[-2]:
            value = _tf_transpose_conv_to_flax(value)
        if value.shape != current.shape:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {value.shape} vs model {current.shape}")
        _set_path(tree, path, value.astype(current.dtype))
        restored += 1

    missing = ["/".join(path) for path, _ in _flatten(tree) if path not in chosen]
    if missing:
        raise ValueError(
            f"trained checkpoint {npz_path} is missing {len(missing)} model "
            f"variables (architecture mismatch?): {missing[:8]}...")
    return tree["params"], tree["batch_stats"], restored


def _copy(tree: dict) -> dict:
    return {k: _copy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


# --- fused optimizer state ----------------------------------------------------

# f32 elements per grid step of the JAX package's update kernel; its flat
# state vectors are padded to a multiple of it (iv2019_tpu/ops/pallas_update.py)
JAX_UPDATE_TILE = 512 * 128


def _jax_order(layout):
    """The port layout's entries in ``ravel_pytree`` order, each with its
    flax shape: [(flax shape, is_kernel, (name, shape, stride, offset))]."""
    entries = []
    # a norm's kind does not change the order (its module has one child)
    for entry in layout:
        name, shape, _, _ = entry
        _, path, is_kernel = _flax_key(name)
        flax_shape = (shape[2], shape[3], shape[1], shape[0]) if is_kernel else tuple(shape)
        entries.append((path, flax_shape, is_kernel, entry))
    return [e[1:] for e in sorted(entries, key=lambda e: e[0])]


def _port_view(flat: np.ndarray, shape, stride, offset) -> np.ndarray:
    return np.lib.stride_tricks.as_strided(
        flat[offset:], shape=shape, strides=[st * flat.itemsize for st in stride])


def opt_vector_from_jax(vec, layout) -> np.ndarray:
    """A JAX flat optimizer vector (raveled, padded) in the port's layout."""
    from iv2019_tpu_torch.train.fused_update import ALIGN

    vec = np.asarray(vec, np.float32)
    _, shape, _, offset = layout[-1]
    out = np.zeros(-(-(offset + int(np.prod(shape))) // ALIGN) * ALIGN, np.float32)
    pos = 0
    for flax_shape, is_kernel, (_, shape, stride, offset) in _jax_order(layout):
        size = int(np.prod(flax_shape))
        chunk = vec[pos:pos + size].reshape(flax_shape)
        if is_kernel:
            chunk = chunk.transpose(3, 2, 0, 1)
        _port_view(out, shape, stride, offset)[...] = chunk
        pos += size
    if np.any(vec[pos:]):
        raise ValueError("the JAX vector's padding is not zero")
    return out


def opt_vector_to_jax(vec, layout) -> np.ndarray:
    """A port flat optimizer vector in the JAX layout, padded again."""
    vec = np.ascontiguousarray(np.asarray(vec, np.float32))
    chunks = []
    for _, is_kernel, (_, shape, stride, offset) in _jax_order(layout):
        value = _port_view(vec, shape, stride, offset)
        chunks.append((value.transpose(2, 3, 1, 0) if is_kernel else value).reshape(-1))
    flat = np.concatenate(chunks)
    padded = -(-flat.size // JAX_UPDATE_TILE) * JAX_UPDATE_TILE
    return np.pad(flat, (0, padded - flat.size))


def opt_state_from_jax(jax_state: dict, layout, device="cpu"):
    """The port's FusedOptState from the JAX one's arrays (a dict with
    ``momentum``, ``ema_biased`` and ``ema_decay_product``)."""
    from iv2019_tpu_torch.train.fused_update import FusedOptState

    def vector(key):
        return torch.as_tensor(opt_vector_from_jax(jax_state[key], layout), device=device)

    return FusedOptState(
        momentum=vector("momentum"), ema_biased=vector("ema_biased"),
        ema_decay_product=torch.tensor(float(np.asarray(jax_state["ema_decay_product"])),
                                       dtype=torch.float32, device=device))


def opt_state_to_jax(state, layout) -> dict:
    """The JAX FusedOptState's arrays (numpy) from the port's FusedOptState."""
    return {
        "momentum": opt_vector_to_jax(state.momentum.detach().cpu().numpy(), layout),
        "ema_biased": opt_vector_to_jax(state.ema_biased.detach().cpu().numpy(), layout),
        "ema_decay_product": np.asarray(float(state.ema_decay_product), np.float32),
    }


# --- optax path state ----------------------------------------------------------


def optax_state_to_jax(state) -> dict:
    """The JAX package's optax-path state (numpy) from the port's TrainState
    (train/state.py): ``trace`` (the momentum, a params-shaped tree; None
    for plain SGD), ``count`` (the schedule's), ``ema_biased`` (None
    without EMA) and ``ema_decay_product``."""
    from iv2019_tpu_torch.train.state import momentum_buffers

    model = state.model
    momentum = momentum_buffers(state)
    out = {"trace": flax_params(momentum, model) if momentum is not None else None,
           "count": int(state.step), "ema_biased": None, "ema_decay_product": None}
    if state.ema is not None:
        out["ema_biased"] = flax_params(state.ema.biased, model)
        out["ema_decay_product"] = np.asarray(float(state.ema.decay_product), np.float32)
    return out


def load_optax_state(state, jax_state: dict):
    """Load the arrays of ``optax_state_to_jax``'s form into the port's
    TrainState in place (step = the schedule count); returns the state."""
    from iv2019_tpu_torch.train.state import set_momentum_buffers

    with torch.no_grad():
        state.step.fill_(int(jax_state["count"]))
        if jax_state["trace"] is not None:
            set_momentum_buffers(state, port_params(jax_state["trace"]))
        if state.ema is not None:
            for name, value in port_params(jax_state["ema_biased"]).items():
                state.ema.biased[name].copy_(value)
            state.ema.decay_product.fill_(float(jax_state["ema_decay_product"]))
    return state

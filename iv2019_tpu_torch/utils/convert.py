"""Weights between the JAX package's flax trees, trained checkpoints and the port.

- ``state_dict_from_flax`` / ``flax_from_state_dict``: flax
  ``params``/``batch_stats`` trees (nested dicts of numpy arrays) to and
  from the port's state dicts. A state-dict key is the flax module path
  joined with dots; ``<module>/conv/kernel`` (HWIO) is ``<module>.conv.weight``
  (OIHW) and ``<module>/BatchNorm/<leaf>`` is ``<module>.<leaf>``.
- ``tf_trained_name_to_flax_path`` and ``restore_trained_from_npz``: the
  reference's trained-checkpoint names, as converted to an ``.npz``, onto a
  flax tree, with the EMA shadow names under ``restore_emas``. Copies of
  iv2019_tpu/utils/checkpoint.py:112-418 (numpy only).
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
    "flax_variables",
    "load_flax_variables",
    "opt_state_from_jax",
    "opt_state_to_jax",
    "opt_vector_from_jax",
    "opt_vector_to_jax",
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


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Port state dict (f32 CPU tensors) from flax variable trees."""
    out = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _flatten(tree):
            value = np.asarray(value, np.float32)
            *mods, leaf = path
            if col == "params" and leaf == "kernel" and mods[-1] == "conv":
                out[".".join(mods) + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
            elif mods[-1] == "BatchNorm" and leaf in (_PARAM_LEAVES if col == "params" else _STAT_LEAVES):
                out[".".join(mods[:-1]) + "." + leaf] = torch.from_numpy(value.copy())
            else:
                raise KeyError(f"no port counterpart for {col}/{'/'.join(path)}")
    return out


def flax_from_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """(params, batch_stats) flax trees of numpy arrays from a port state dict."""
    params, batch_stats = {}, {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        # a copy: a CPU tensor's .numpy() would share the live parameters
        value = np.array(value.detach().float().cpu().numpy())
        if leaf == "weight":
            _set_path(params, tuple(mods) + ("kernel",), np.ascontiguousarray(value.transpose(2, 3, 1, 0)))
        elif leaf in _PARAM_LEAVES:
            _set_path(params, tuple(mods) + ("BatchNorm", leaf), value)
        elif leaf in _STAT_LEAVES:
            _set_path(batch_stats, tuple(mods) + ("BatchNorm", leaf), value)
        else:
            raise KeyError(f"no flax counterpart for {key}")
    return params, batch_stats


def flax_variables(model: torch.nn.Module) -> dict:
    """The model's variables as a flax ``{'params', 'batch_stats'}`` tree."""
    params, batch_stats = flax_from_state_dict(model.state_dict())
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
    for entry in layout:
        name, shape, _, _ = entry
        *mods, leaf = name.split(".")
        if leaf == "weight":
            path, flax_shape = tuple(mods) + ("kernel",), (shape[2], shape[3], shape[1], shape[0])
        else:
            path, flax_shape = tuple(mods) + ("BatchNorm", leaf), tuple(shape)
        entries.append((path, flax_shape, leaf == "weight", entry))
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

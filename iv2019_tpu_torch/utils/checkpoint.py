"""Training checkpoints and the ImageNet warm start of the PyTorch port.

Port of iv2019_tpu/utils/checkpoint.py:36-98,141-158,300-333.

- ``CheckpointManager`` keeps ``log_dir/checkpoints/<step>/`` directories,
  one per saved step, unbounded by default (reference
  system_factory.py:246-248,287-295). The JAX package writes orbax
  checkpoints; orbax is not a PyTorch package, so the port has its own
  format: ``<step>/state.pt``, one ``torch.save`` dict of CPU tensors, of
  one of two kinds. The fused optimizer's (``"kind": "fused"``; a file
  without ``kind`` is one)::

      {"format": 1, "kind": "fused", "step": int, "model": the model's state
       dict, "momentum": flat f32, "ema_biased": flat f32,
       "ema_decay_product": 0-d f32, "layout": [(name, shape, stride, offset)]}

  with the flat vectors in the optimizer's own layout
  (train/fused_update.py), which ``layout`` records and ``restore`` checks;
  the optax path's (``"kind": "optax"``)::

      {"format": 1, "kind": "optax", "step": int, "model": state dict,
       "momentum": {name: f32} or None (plain SGD), "count": int (the
       schedule's), "ema_biased": {name: f32} or None (no EMA),
       "ema_decay_product": 0-d f32 or None}

  ``restore`` refuses a checkpoint of the other kind.
  A save writes ``<step>.tmp/`` and renames it, so a directory named by a
  step is always complete. With ``async_save`` the state is copied to the
  host when ``save`` is called and written by a background thread; every
  read (``latest_step``, ``all_steps``, ``restore``) and ``close`` waits
  for writes in flight and re-raises their errors.
- ``restore`` copies into the live model and optimizer state in place: the
  parameters stay views of the optimizer's flat buffer.
- ``warm_start_from_npz`` loads a slim ``resnet_v1_*`` ImageNet checkpoint
  (an ``.npz`` of slim variable names) into the trunk, with the reference's
  exclusion list (define_initializers.py:100-105).
- ``convert_tf_checkpoint_to_npz`` (checkpoint.py:421-447) makes those
  ``.npz`` files from TF checkpoints, read by utils/tf_checkpoint.py with
  no TensorFlow.

``torch.load`` unpickles: restore only checkpoints this program wrote.
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from iv2019_tpu_torch.utils import tf_checkpoint
from iv2019_tpu_torch.utils.convert import (_backbone_rest_to_path, group_norm_modules,
                                            tf_trained_name_to_flax_path)

__all__ = ["CheckpointManager", "WARM_START_EXCLUSIONS", "convert_tf_checkpoint_to_npz",
           "slim_name_to_flax_path", "warm_start_from_npz"]

FORMAT = 1
STATE_FILE = "state.pt"

# reference define_initializers.py:100-105
WARM_START_EXCLUSIONS = (
    "global_step",
    "train_ops",
    "ExponentialMovingAverage",
    "Momentum",
    "classifier",
    "extension",
    "psp",
)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    # from the card: queued into pinned memory, read after one wait (snapshot)
    return t.detach().to("cpu", copy=True, non_blocking=t.is_cuda)


def _kind(state) -> str:
    from iv2019_tpu_torch.train.fused_update import FusedOptState

    return "fused" if isinstance(state.opt_state, FusedOptState) else "optax"


def snapshot(state, layout) -> dict:
    """The checkpoint dict of a TrainState, on the host (copies). From the
    card the copies are queued on the current stream and waited for once."""
    from iv2019_tpu_torch.train.state import momentum_buffers

    kind = _kind(state)
    snap = {
        "format": FORMAT,
        "kind": kind,
        "step": _host_copy(state.step),
        "model": {k: _host_copy(v) for k, v in state.model.state_dict().items()},
    }
    if kind == "fused":
        opt = state.opt_state
        snap.update(momentum=_host_copy(opt.momentum), ema_biased=_host_copy(opt.ema_biased),
                    ema_decay_product=_host_copy(opt.ema_decay_product),
                    layout=[(name, tuple(shape), tuple(stride), int(offset))
                            for name, shape, stride, offset in layout])
    else:
        momentum = momentum_buffers(state)
        ema = state.ema
        snap.update(
            momentum=None if momentum is None else {k: _host_copy(v) for k, v in momentum.items()},
            ema_biased=None if ema is None else {k: _host_copy(v) for k, v in ema.biased.items()},
            ema_decay_product=None if ema is None else _host_copy(ema.decay_product))
    if state.step.is_cuda:
        torch.cuda.current_stream(state.step.device).synchronize()
    snap["step"] = int(snap["step"])
    if kind == "optax":
        snap["count"] = snap["step"]
    return snap


class CheckpointManager:
    """Step-numbered checkpoints under ``log_dir/checkpoints``.

    ``keep``: how many of the newest to keep (None: all). ``async_save``:
    write in a background thread (see the module docstring). ``primary``:
    whether this rank writes (rank 0 of a data-parallel run; the others'
    ``save`` does nothing, and every rank restores).
    """

    def __init__(self, log_dir: str, keep: Optional[int] = None, async_save: bool = False,
                 primary: bool = True):
        self._dir = os.path.abspath(os.path.join(log_dir, "checkpoints"))
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        self._primary = primary
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint") \
            if async_save else None
        self._pending: list[Future] = []

    def save(self, step: int, state, layout) -> None:
        """Save ``state`` (a TrainState of the fused optimizer with its
        ``layout``, or of the optax path with ``layout`` None) as checkpoint
        ``step``; an existing checkpoint of that step is replaced."""
        if not self._primary:
            return
        snap = snapshot(state, layout)
        if snap["step"] != step:
            raise ValueError(f"saving the state of step {snap['step']} as step {step}")
        if self._pool is None:
            self._write(step, snap)
        else:
            self._pending.append(self._pool.submit(self._write, step, snap))

    def _write(self, step: int, snap: dict) -> None:
        final = os.path.join(self._dir, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(snap, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self._keep is not None:
            for old in self._steps()[:-self._keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)))

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def _steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.isfile(os.path.join(self._dir, d, STATE_FILE)))

    def all_steps(self) -> list[int]:
        self.wait_until_finished()
        return self._steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> dict:
        """The dict of checkpoint ``step`` (None: the latest), with its kind."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        self.wait_until_finished()
        snap = torch.load(os.path.join(self._dir, str(step), STATE_FILE), map_location="cpu",
                          weights_only=True)
        if snap.get("format") != FORMAT:
            raise ValueError(f"checkpoint {step}: unknown format {snap.get('format')}")
        snap.setdefault("kind", "fused")
        return snap

    def restore(self, step: Optional[int], state, layout, snap: Optional[dict] = None):
        """Load checkpoint ``step`` (None: the latest; or ``snap``, its dict
        from ``load``) into ``state`` in place; returns the state with its
        step set. The checkpoint must be of the state's kind, and for the
        fused optimizer of its layout."""
        from iv2019_tpu_torch.train.state import set_momentum_buffers

        snap = self.load(step) if snap is None else snap
        kind = _kind(state)
        if snap["kind"] != kind:
            raise ValueError(
                f"checkpoint {snap['step']} in {self._dir} was written by the "
                f"{snap['kind']} optimizer; this run uses the {kind} one "
                "(fused_optimizer must be the same as in the run that wrote it)")
        if kind == "fused":
            saved = [(n, tuple(s), tuple(st), int(o)) for n, s, st, o in snap["layout"]]
            if saved != [(n, tuple(s), tuple(st), int(o)) for n, s, st, o in layout]:
                raise ValueError("checkpoint was written for another model or parameter layout")
        else:
            if (snap["momentum"] is None) != (not state.opt_state.param_groups[0]["momentum"]):
                raise ValueError("checkpoint was written with another optimizer (SGD / SGDM)")
            if (snap["ema_biased"] is None) != (state.ema is None):
                raise ValueError("checkpoint was written with another ema_decay (EMA on / off)")
        with torch.no_grad():
            state.model.load_state_dict(snap["model"], strict=True)
            state.step.fill_(snap["step"])
            if kind == "fused":
                opt = state.opt_state
                opt.momentum.copy_(snap["momentum"])
                opt.ema_biased.copy_(snap["ema_biased"])
                opt.ema_decay_product.copy_(snap["ema_decay_product"])
                return state
            if snap["momentum"] is not None:
                set_momentum_buffers(state, snap["momentum"])
            if state.ema is not None:
                for name, value in snap["ema_biased"].items():
                    state.ema.biased[name].copy_(value)
                state.ema.decay_product.copy_(snap["ema_decay_product"])
        return state

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


# --- ImageNet warm start -------------------------------------------------------


def slim_name_to_flax_path(name: str) -> Optional[tuple[str, ...]]:
    """A slim ``resnet_v1_{50,101,152}`` variable name -> flax tree path, or
    None for excluded and unknown names (checkpoint.py:141-158)."""
    name = name.split(":")[0]
    if any(e in name for e in WARM_START_EXCLUSIONS):
        return None
    m = re.match(r"(?:.*?)?resnet_v1_(?:50|101|152)/(.*)", name)
    if not m:
        return None
    return _backbone_rest_to_path(m.group(1))


def _state_dict_key(path: tuple[str, ...]) -> tuple[str, bool]:
    """(port state-dict key, is a conv kernel) of a flax path
    (utils/convert.py naming)."""
    _, *mods, leaf = path
    if leaf == "kernel":  # <module>/conv/kernel
        return ".".join(mods) + ".weight", True
    return ".".join(mods[:-1]) + "." + leaf, False  # <module>/BatchNorm/<leaf>


def warm_start_from_npz(model: torch.nn.Module, npz_path: str) -> int:
    """Copy the trunk variables of a slim-named ``.npz`` into ``model`` in
    place; returns how many were restored. Names the model lacks are
    skipped; a shape mismatch raises. Unmatched model variables keep
    their values."""
    arrays = np.load(npz_path)
    state = model.state_dict()
    # slim names carry BatchNorm variables: a group-norm model has no such
    # paths, as in the JAX package
    group_norms = group_norm_modules(model)
    restored = 0
    with torch.no_grad():
        for name in arrays.files:
            path = slim_name_to_flax_path(name)
            if path is None:
                continue
            key, is_kernel = _state_dict_key(path)
            if key not in state or key.rsplit(".", 1)[0] in group_norms:
                continue
            value = arrays[name]
            if is_kernel:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if tuple(value.shape) != tuple(state[key].shape):
                raise ValueError(f"shape mismatch for {name}: ckpt {value.shape} vs model "
                                 f"{tuple(state[key].shape)}")
            state[key].copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))
            restored += 1
    return restored


def convert_tf_checkpoint_to_npz(ckpt_path: str, out_path: str, full: bool = False) -> int:
    """One-time TF checkpoint -> ``.npz`` conversion; returns the count of
    variables written.

    ``full=False``: the ImageNet warm-start subset, every variable whose name
    holds none of ``WARM_START_EXCLUSIONS`` (define_initializers.py:100-105).
    ``full=True``: the whole trained model with its EMA shadows, every
    variable ``tf_trained_name_to_flax_path`` maps, for
    ``utils/convert.py::restore_trained_from_npz``. ``ckpt_path``: a V2
    prefix, a V1 file or a directory (utils/tf_checkpoint.py), checked
    against its checksums while read.
    """
    reader = tf_checkpoint.load_checkpoint(ckpt_path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if full:
            if tf_trained_name_to_flax_path(name) is None:
                continue
        elif any(e in name for e in WARM_START_EXCLUSIONS):
            continue
        out[name] = reader.get_tensor(name)
    np.savez(out_path, **out)
    return len(out)

"""Settings and the predict and train command lines of the PyTorch port.

A copy of the fields of ``iv2019_tpu/config.py`` that the predict, evaluate,
train-step and training-run paths read, with the same names and defaults
(but for ``mode``, which defaults to ``predict`` here), ``finalize()`` with
its epoch-to-step math, ``dump()`` in the same format, and the predict and
train flags, plus one field and flag of the port's own: ``--device``
(``cuda`` unless the caller asks for ``cpu``). The train command line
accepts the flags of paths the port does not have yet (gradient
accumulation, augmentations, multi-process and multi-device training,
spatial partitions); ``validate()`` raises ``NotImplementedError`` when one
of them is set. ``root_wgrad_pallas`` has no flag, as in the JAX package.
Flags of inference paths the port does not have yet (test-time
augmentation, sliding window, plotting) are not accepted.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Optional

__all__ = [
    "EVAL",
    "PREDICT",
    "TRAIN",
    "Settings",
    "build_argparser",
    "resolve_dataset_name",
    "resolve_trained_model",
    "settings_from_args",
]

TRAIN = "train"
EVAL = "eval"
PREDICT = "predict"


@dataclasses.dataclass
class Settings:
    """The settings the predict, evaluate and train-step paths read."""

    # -- system size -------------------------------------------------------
    height_system: Optional[int] = None
    width_system: Optional[int] = None
    height_feature_extractor: int = 512
    width_feature_extractor: int = 1024

    # -- mode / dirs -------------------------------------------------------
    mode: str = PREDICT
    log_dir: str = ""
    per_pixel_dataset_name: str = "cityscapes"
    device: str = "cuda"

    # -- problem definitions ----------------------------------------------
    training_problem_def_path: str = ""
    inference_problem_def_path: Optional[str] = None
    evaluation_problem_def_path: Optional[str] = None
    train_void_class: bool = False

    # -- training schedule (iv2019_tpu/config.py:51-76) --------------------
    Ntrain: int = 2975
    Ne: int = 17
    Nb: int = 4
    learning_rate_schedule: str = "piecewise_constant"  # | polynomial_decay
    learning_rate_initial: float = 0.01
    learning_rate_boundaries: tuple[int, ...] = (8, 15, 17)  # epochs
    learning_rate_decay: Optional[float] = None
    learning_rate_values: Optional[tuple[float, ...]] = None
    learning_rate_final: float = 0.5
    learning_rate_power: float = 0.9
    optimizer: str = "SGDM"  # | SGD
    momentum: float = 0.9
    use_nesterov: bool = False
    ema_decay: float = 0.9
    regularization_weight: float = 0.00017
    # -1 = off; else bootstrapped CE keeps the top-p% per-pixel L1 losses
    bootstrapping_percentage: int = -1
    save_checkpoints_steps: Optional[int] = None
    save_summaries_steps: int = 120
    init_ckpt_path: str = ""

    # -- mixed-supervision sub-batches -------------------------------------
    Nb_per_pixel: int = 4
    Nb_per_bbox: int = 8
    Nb_per_image: int = 4
    preserve_aspect_ratio_per_pixel: bool = False
    preserve_aspect_ratio_per_bbox: bool = True
    preserve_aspect_ratio_per_image: bool = True

    # -- training options (iv2019_tpu/config.py:88-92,110-215) -------------
    augmentations: tuple[str, ...] = ()  # not ported: the step raises if set
    batch_norm_accumulate_statistics: bool = True
    batch_norm_decay: float = 0.9
    grad_accum_steps: int = 1  # not ported beyond 1: the step raises
    # SGDM + weight decay + EMA as one pass over flat f32 vectors
    # (train/fused_update.py); False (the optax path) is not ported
    fused_optimizer: bool = True
    # the fused update runs as the CUDA kernel B3 (ops/fused_update.py)
    pallas_update: bool = True
    weak_loss_coefficient: float = 0.1
    # the loss runs from stride-8 logits through kernels B1/B2
    # (ops/fused_loss.py)
    fused_loss: bool = True
    rasterize_on_device: bool = False  # not ported: bbox_cids batches raise
    # per-image weak labels as (Nb, 15) vectors, broadcast on the device
    compact_image_labels: bool = False
    # the root conv's weight gradient as kernel B6 (ops/root_wgrad.py); set
    # in Settings only, as in the JAX package
    root_wgrad_pallas: bool = False
    random_seed: int = 0
    # seeds the host input pipelines (shuffle, crops); None: OS entropy
    input_seed: Optional[int] = None
    # checkpoint writes overlap the following steps (utils/checkpoint.py)
    async_checkpoints: bool = True
    # not ported beyond their defaults: validate() raises when set
    num_devices: Optional[int] = None
    num_slices: int = 1
    spatial_partitions: int = 1
    remat: bool = False
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0

    # -- model -------------------------------------------------------------
    name_feature_extractor: str = "resnet_v1_50"
    stride_feature_extractor: int = 8
    feature_dims_decreased: int = 256
    fov_expansion_kernel_size: int = 0
    fov_expansion_kernel_rate: int = 0
    upsampling_method: str = "bilinear"
    psp_module: bool = False
    norm_layer: str = "batch"
    norm_train_variables: bool = True
    cross_replica_norm: bool = False
    compute_dtype: str = "bfloat16"
    # eval/predict: identity units of the trunk as one CUDA kernel each
    # (ops/fused_block.py), BatchNorm folded into the convs
    fused_block: bool = False

    # -- inference / evaluation -------------------------------------------
    ckpt_path: Optional[str] = None
    replace_voids: bool = False
    restore_emas: bool = False
    predict_dir: str = ""
    results_dir: Optional[str] = None
    preserve_aspect_ratio: bool = False
    export_color_decisions: bool = False
    export_overlapped_color_decisions: bool = False
    export_lids_images: bool = False
    predict_keys: tuple[str, ...] = (
        "decisions",
        "l1_probabilities",
        "l2_vehicle_probabilities",
        "rawimages",
        "rawimagespaths",
    )

    # -- dataset paths -----------------------------------------------------
    tfrecords_path: str = ""
    tfrecords_path_per_pixel: str = ""
    dataset_directory: str = ""
    openimages_image_dir: str = ""
    openimages_bboxes_path: str = ""  # imageid2bboxes pickle/json
    openimages_image_labels_path: str = ""  # imageid2mids pickle/json
    # weak-label MID aggregation: "v2" (15 classes) or the legacy "v1"
    openimages_label_space: str = "v2"
    # random batches of the real shapes instead of datasets on disk
    synthetic_data: bool = False

    # -- derived by finalize() ---------------------------------------------
    height_network: int = 0
    width_network: int = 0
    num_examples_per_epoch: int = 0
    num_batches_per_epoch: int = 0
    num_training_steps: int = 0
    learning_rate_boundaries_epochs: tuple[int, ...] = ()
    learning_rate_boundaries_steps: tuple[int, ...] = ()
    learning_rate_values_resolved: tuple[float, ...] = ()

    def replace(self, **kw: Any) -> "Settings":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """The checks of iv2019_tpu/config.py:302-397 on the fields here."""
        if (self.height_network, self.width_network) != (
                self.height_feature_extractor, self.width_feature_extractor):
            raise ValueError("For now height/width_network must equal "
                             "height/width_feature_extractor (patch-wise training is not "
                             "implemented).")
        if self.learning_rate_schedule == "piecewise_constant":
            if bool(self.learning_rate_decay) == bool(self.learning_rate_values):
                raise AttributeError(
                    "If learning_rate_schedule is piecewise_constant exactly one "
                    "of learning_rate_decay or learning_rate_values must be given.")
        if self.upsampling_method not in ("no", "bilinear", "hybrid"):
            raise ValueError(f"unknown upsampling_method {self.upsampling_method}")
        if bool(self.fov_expansion_kernel_rate) != bool(self.fov_expansion_kernel_size):
            raise ValueError("Both or neither of fov_expansion_kernel_{rate,size} must be set.")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1.")
        for name in ("Nb_per_pixel", "Nb_per_bbox", "Nb_per_image"):
            if getattr(self, name) % self.grad_accum_steps:
                raise ValueError(f"grad_accum_steps={self.grad_accum_steps} must divide "
                                 f"{name}={getattr(self, name)}.")
        if self.bootstrapping_percentage != -1 and not 1 <= self.bootstrapping_percentage <= 100:
            raise ValueError("--bootstrapping_percentage must be -1 (off) or in [1, 100], "
                             f"got {self.bootstrapping_percentage}")
        if self.openimages_label_space not in ("v1", "v2"):
            raise ValueError(f"openimages_label_space must be 'v1' or 'v2', got "
                             f"{self.openimages_label_space!r}.")
        unported = {
            "num_processes > 1 (multi-process training)": self.num_processes != 1,
            "num_devices > 1 (multi-device training)": (self.num_devices or 1) > 1,
            "num_slices > 1": self.num_slices != 1,
            "spatial_partitions > 1": self.spatial_partitions != 1,
            "remat": self.remat,
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported to the PyTorch package yet "
                                          "(ROADMAP.md queue A)")

    def finalize(self) -> "Settings":
        """Fill the derived fields; returns a new Settings (iv2019_tpu/config.py:423-486,
        reference system_factory.py:197-248: learning-rate boundaries from
        epochs to steps)."""
        s = self.replace(height_network=self.height_feature_extractor,
                         width_network=self.width_feature_extractor)
        lr_decay, lr_values = s.learning_rate_decay, s.learning_rate_values
        if s.learning_rate_schedule == "piecewise_constant" and not (lr_decay or lr_values):
            lr_decay = 0.5
        num_examples_per_epoch = int(
            s.Ntrain * (s.height_network // s.height_feature_extractor)
            * (s.width_network // s.width_feature_extractor))
        num_batches_per_epoch = int(num_examples_per_epoch / s.Nb)
        num_training_steps = int(s.Ne * num_batches_per_epoch)
        boundaries = list(s.learning_rate_boundaries)
        values: tuple[float, ...] = ()
        if s.learning_rate_schedule == "piecewise_constant":
            last_boundary = s.Ne - boundaries[-1]
            if last_boundary == 0:
                boundaries.pop()
            elif last_boundary < 0:
                raise ValueError("Ne is less than learning rate boundaries.")
            boundaries_steps = [b * num_batches_per_epoch for b in boundaries]
            if lr_decay:
                values = tuple(s.learning_rate_initial * lr_decay**i
                               for i in range(len(boundaries_steps) + 1))
            else:
                values = tuple(lr_values)
                if len(values) != len(boundaries_steps) + 1:
                    raise ValueError(
                        f"piecewise_constant needs len(values) == len(boundaries)+1; "
                        f"got {len(values)} values, {len(boundaries_steps)} boundaries.")
        else:
            boundaries_steps = []
        s = s.replace(
            learning_rate_decay=lr_decay,
            num_examples_per_epoch=num_examples_per_epoch,
            num_batches_per_epoch=num_batches_per_epoch,
            num_training_steps=num_training_steps,
            learning_rate_boundaries_epochs=tuple(boundaries),
            learning_rate_boundaries_steps=tuple(boundaries_steps),
            learning_rate_values_resolved=values,
            save_checkpoints_steps=s.save_checkpoints_steps or num_batches_per_epoch,
        )
        s.validate()
        return s

    def dump(self, path: str) -> None:
        """Write the settings as ``i : key : value`` lines, sorted by key
        (the format of iv2019_tpu/config.py:491-496)."""
        items = sorted(dataclasses.asdict(self).items())
        with open(path, "w") as f:
            for i, (k, v) in enumerate(items):
                print(f"{i:2} : {k} : {v}", file=f)


def _add_system_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--height_system", type=int, default=None)
    p.add_argument("--width_system", type=int, default=None)
    p.add_argument("--height_feature_extractor", type=int, default=512)
    p.add_argument("--width_feature_extractor", type=int, default=1024)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused_block", action="store_true",
                   help="run supported trunk identity units as one CUDA kernel "
                        "each (BN folded into the convs; ops/fused_block.py)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the network runs (default: the CUDA card)")


def _add_train_system_arguments(p: argparse.ArgumentParser) -> None:
    """The training flags of iv2019_tpu/config.py:504-539; those of paths the
    port does not have yet are accepted and refused by validate()."""
    p.add_argument("--enable_xla", action="store_true", default=True)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--num_slices", type=int, default=1)
    p.add_argument("--spatial_partitions", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--coordinator_address", type=str, default="")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--async_checkpoints", action=argparse.BooleanOptionalAction, default=True,
                   help="overlap checkpoint writes with training steps")
    p.add_argument("--input_seed", type=int, default=None,
                   help="seed the host input pipelines (shuffle, crops) for reproducible "
                        "runs; default: OS entropy")
    p.add_argument("--synthetic_data", action="store_true")


def _add_model_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--stride_feature_extractor", type=int, default=8)
    p.add_argument("--name_feature_extractor", type=str, default="resnet_v1_50",
                   choices=["resnet_v1_50", "resnet_v1_101", "resnet_v1_152"])
    p.add_argument("--feature_dims_decreased", type=int, default=256)
    p.add_argument("--fov_expansion_kernel_size", type=int, default=0)
    p.add_argument("--fov_expansion_kernel_rate", type=int, default=0)
    p.add_argument("--upsampling_method", type=str, default="bilinear",
                   choices=["no", "bilinear", "hybrid"])
    p.add_argument("--psp_module", action="store_true")
    p.add_argument("--norm_layer", type=str, default="batch", choices=["batch", "group"])


def _add_train_model_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cross_replica_norm", action="store_true")
    p.add_argument("--norm_train_variables", action="store_true", default=True)
    p.add_argument("--batch_norm_accumulate_statistics", action="store_true", default=True)
    p.add_argument("--batch_norm_decay", type=float, default=0.9)


def _add_train_arguments(p: argparse.ArgumentParser) -> None:
    """iv2019_tpu/config.py:560-617 (reference utils/utils.py:56-119)."""
    p.add_argument("log_dir", type=str)
    p.add_argument("per_pixel_dataset_name", type=str, choices=["cityscapes", "vistas"])
    p.add_argument("--Ntrain", type=int, default=2975)
    p.add_argument("--init_ckpt_path", type=str, default="")
    p.add_argument("--training_problem_def_path", type=str, default="")
    p.add_argument("--save_checkpoints_steps", type=int, default=None)
    p.add_argument("--save_summaries_steps", type=int, default=120)
    p.add_argument("--train_void_class", action="store_true")
    p.add_argument("--Ne", type=int, default=17)
    p.add_argument("--Nb", type=int, default=4)
    p.add_argument("--learning_rate_schedule", type=str, default="piecewise_constant",
                   choices=["piecewise_constant", "polynomial_decay"])
    p.add_argument("--learning_rate_initial", type=float, default=0.01)
    p.add_argument("--learning_rate_boundaries", type=int, default=[8, 15, 17], nargs="*")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--learning_rate_decay", type=float, default=None)
    g.add_argument("--learning_rate_values", type=float, nargs="*", default=None)
    p.add_argument("--learning_rate_final", type=float, default=0.5)
    p.add_argument("--learning_rate_power", type=float, default=0.9)
    p.add_argument("--optimizer", type=str, default="SGDM", choices=["SGD", "SGDM"])
    p.add_argument("--ema_decay", type=float, default=0.9)
    p.add_argument("--regularization_weight", type=float, default=0.00017)
    p.add_argument("--bootstrapping_percentage", type=int, default=-1,
                   help="bootstrapped CE: keep only the top-p%% hardest non-void pixels in "
                        "the L1 loss; -1 disables")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--use_nesterov", action="store_true")
    p.add_argument("--distribute", action="store_true")
    p.add_argument("--Nb_per_pixel", type=int, default=None)
    p.add_argument("--Nb_per_bbox", type=int, default=None)
    p.add_argument("--Nb_per_image", type=int, default=None)
    p.add_argument("--weak_loss_coefficient", type=float, default=0.1,
                   help="weight of the L2 vehicle/human (weak) losses in the total")
    p.add_argument("--augmentations", type=str, default="",
                   help="comma list from {color,blur,flip,scale}; not ported yet")
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--tfrecords_path_per_pixel", type=str, default="")
    p.add_argument("--dataset_directory", type=str, default="")
    p.add_argument("--openimages_image_dir", type=str, default="")
    p.add_argument("--openimages_bboxes_path", type=str, default="")
    p.add_argument("--openimages_image_labels_path", type=str, default="")
    p.add_argument("--openimages_label_space", type=str, default="v2", choices=("v1", "v2"),
                   help="MID aggregation: v2 = 15 fine weak classes; v1 = legacy 10 classes")


def _add_inference_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("log_dir", type=str)
    p.add_argument("training_problem_def_path", type=str)
    p.add_argument("predict_dir", type=str)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--inference_problem_def_path", type=str, default=None)
    p.add_argument("--replace_voids", action="store_true")
    p.add_argument("--restore_emas", action="store_true")
    p.add_argument("--train_void_class", action="store_true")
    p.add_argument("--results_dir", type=str, default=None)
    p.add_argument("--per_pixel_dataset_name", type=str, default=None,
                   choices=["cityscapes", "vistas"],
                   help="training dataset (default: read from log_dir/settings.txt)")
    p.add_argument("--export_color_decisions", action="store_true")
    p.add_argument("--export_overlapped_color_decisions", action="store_true")
    p.add_argument("--export_lids_images", action="store_true")
    p.add_argument("--preserve_aspect_ratio", action="store_true")


def build_argparser(mode: str = PREDICT) -> argparse.ArgumentParser:
    if mode not in (PREDICT, TRAIN):
        raise NotImplementedError(f"the port has no {mode} command line yet")
    p = argparse.ArgumentParser()
    _add_system_arguments(p)
    _add_model_arguments(p)
    if mode == TRAIN:
        _add_train_system_arguments(p)
        _add_train_model_arguments(p)
        _add_train_arguments(p)
    else:
        _add_inference_arguments(p)
    return p


def dataset_name_from_log_dir(log_dir: str) -> Optional[str]:
    """per_pixel_dataset_name from a training run's settings.txt."""
    try:
        with open(os.path.join(log_dir, "settings.txt")) as f:
            for line in f:
                parts = [t.strip() for t in line.split(":")]
                if len(parts) == 3 and parts[1] == "per_pixel_dataset_name":
                    return parts[2]
    except OSError:
        return None
    return None


# flags that decide the trained architecture: read from settings.txt
# unless given on the command line
_MODEL_SHAPE_FIELDS = {
    "name_feature_extractor": str,
    "stride_feature_extractor": int,
    "feature_dims_decreased": int,
    "fov_expansion_kernel_size": int,
    "fov_expansion_kernel_rate": int,
    "psp_module": lambda s: s == "True",
    "upsampling_method": str,
}


def trained_model_fields_from_log_dir(log_dir: str) -> dict:
    out: dict = {}
    try:
        with open(os.path.join(log_dir, "settings.txt")) as f:
            for line in f:
                parts = [t.strip() for t in line.split(" : ", 2)]
                if len(parts) == 3 and parts[1] in _MODEL_SHAPE_FIELDS:
                    out[parts[1]] = _MODEL_SHAPE_FIELDS[parts[1]](parts[2])
    except OSError:
        pass
    return out


def resolve_trained_model(settings: Settings, argv: Optional[list] = None) -> Settings:
    """Apply the trained run's architecture flags; an explicit flag that
    contradicts the training run is a hard error."""
    argv = sys.argv[1:] if argv is None else argv

    def given(key: str) -> bool:
        return any(t == f"--{key}" or t.startswith(f"--{key}=") for t in argv)

    updates = {}
    for key, trained in trained_model_fields_from_log_dir(settings.log_dir).items():
        current = getattr(settings, key)
        if given(key):
            if current != trained:
                raise SystemExit(
                    f"--{key} {current} contradicts the training run in "
                    f"{settings.log_dir} (settings.txt says {trained})."
                )
        elif current != trained:
            updates[key] = trained
    return settings.replace(**updates) if updates else settings


def resolve_dataset_name(settings: Settings, explicit: Optional[str]) -> Settings:
    """Apply the trained dataset name (``explicit`` None: read settings.txt)."""
    trained = dataset_name_from_log_dir(settings.log_dir)
    if explicit is None:
        return settings.replace(per_pixel_dataset_name=trained or "cityscapes")
    if trained and trained != explicit:
        raise SystemExit(
            f"--per_pixel_dataset_name {explicit} contradicts the training "
            f"run in {settings.log_dir} (settings.txt says {trained})."
        )
    return settings


def settings_from_args(args: argparse.Namespace, mode: str, **extra: Any) -> Settings:
    field_names = {f.name for f in dataclasses.fields(Settings)}
    kw = {k: v for k, v in vars(args).items() if k in field_names and v is not None}
    for k in ("learning_rate_boundaries", "learning_rate_values", "predict_keys"):
        if isinstance(kw.get(k), list):
            kw[k] = tuple(kw[k])
    if isinstance(kw.get("augmentations"), str):
        kw["augmentations"] = tuple(a.strip() for a in kw["augmentations"].split(",")
                                    if a.strip())
    kw.update(extra)
    kw["mode"] = mode
    return Settings(**kw)

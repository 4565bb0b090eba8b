#!/usr/bin/env bash
# One-command Cityscapes + OpenScapes quality-parity runbook of the PyTorch
# port: tools/real_data_runbook.sh's stages on the port's CLIs.
#
# The day the real datasets exist on disk, this reproduces the reference's
# headline (Cityscapes val mIoU 70.46, reference code/README.md:37-38) with
# a single invocation on the CUDA card. No stage needs TensorFlow: the TF
# checkpoints are read by iv2019_tpu_torch/utils/tf_checkpoint.py.
#
# Usage:
#   iv2019_tpu_torch/tools/real_data_runbook.sh \
#     CITYSCAPES_DIR          # leftImg8bit/{train,val}/..., gtFine/...
#     OPENSCAPES_DIR          # images/ + imageid2bboxes.pkl + imageid2mids.pkl
#     IMAGENET_CKPT           # slim resnet_v1_50.ckpt (TF-format, ImageNet)
#     LOG_DIR                 # fresh output directory
#
# Stage summary (each idempotent; comment out what is already done):
#   1. TFRecords from the raw dataset trees (v5 schema)
#   2. TF checkpoint -> npz warm-start conversion (no TF required)
#   3. Train: reference recipe (Nb 4+8+4, 512x1024, 17 epochs, SGDM,
#      LR 0.01 piecewise [8,15] /2 each) = train.py:42-68 constants
#   4. Evaluate: full val sweep at 512x1024, EMA restore, per-class report
set -euo pipefail

CITYSCAPES_DIR=${1:?cityscapes dir}
OPENSCAPES_DIR=${2:?openscapes dir}
IMAGENET_CKPT=${3:?imagenet ckpt}
LOG_DIR=${4:?log dir}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
PROBLEM=iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json

DATA_DIR=${DATA_DIR:-"$LOG_DIR/data"}
mkdir -p "$DATA_DIR"

echo "== 1/4 TFRecords =="
[ -f "$DATA_DIR/train.tfrecords" ] || python -m iv2019_tpu_torch.tools.make_tfrecords \
    cityscapes "$CITYSCAPES_DIR" train "$DATA_DIR/train.tfrecords"
[ -f "$DATA_DIR/val.tfrecords" ] || python -m iv2019_tpu_torch.tools.make_tfrecords \
    cityscapes "$CITYSCAPES_DIR" val "$DATA_DIR/val.tfrecords"

echo "== 2/4 ImageNet warm start =="
[ -f "$DATA_DIR/resnet50_imagenet.npz" ] || python - "$IMAGENET_CKPT" \
    "$DATA_DIR/resnet50_imagenet.npz" <<'PY'
import sys
from iv2019_tpu_torch.utils.checkpoint import convert_tf_checkpoint_to_npz
n = convert_tf_checkpoint_to_npz(sys.argv[1], sys.argv[2])
print(f"converted {n} variables (ImageNet warm start)")
PY

# Optional shortcut: the reference's RELEASED TRAINED checkpoint evaluates
# directly, no training needed (logit parity: tests/test_torch_tf_checkpoint.py).
# Set RELEASED_CKPT to its model.ckpt-* prefix and skip to evaluate with
# "--ckpt_path $DATA_DIR/trained.npz --restore_emas":
if [ -n "${RELEASED_CKPT:-}" ] && [ ! -f "$DATA_DIR/trained.npz" ]; then
    python - "$RELEASED_CKPT" "$DATA_DIR/trained.npz" <<'PY'
import sys
from iv2019_tpu_torch.utils.checkpoint import convert_tf_checkpoint_to_npz
n = convert_tf_checkpoint_to_npz(sys.argv[1], sys.argv[2], full=True)
print(f"converted {n} variables (full trained model + EMA shadows)")
PY
fi

echo "== 3/4 Train (reference recipe; resumes from latest ckpt if present) =="
python -m iv2019_tpu_torch.train_cli "$LOG_DIR" cityscapes \
    --tfrecords_path_per_pixel "$DATA_DIR/train.tfrecords" \
    --openimages_image_dir "$OPENSCAPES_DIR/images" \
    --openimages_bboxes_path "$OPENSCAPES_DIR/imageid2bboxes.pkl" \
    --openimages_image_labels_path "$OPENSCAPES_DIR/imageid2mids.pkl" \
    --init_ckpt_path "$DATA_DIR/resnet50_imagenet.npz" \
    --Ntrain 2975 --Ne 17 \
    --learning_rate_boundaries 8 15 17 \
    --learning_rate_values 0.01 0.005 0.0025 \
    --height_feature_extractor 512 --width_feature_extractor 1024

echo "== 4/4 Evaluate (val, EMA) =="
python -m iv2019_tpu_torch.evaluate_cli "$LOG_DIR" 500 "$PROBLEM" \
    --tfrecords_path "$DATA_DIR/val.tfrecords" --Nb 2 --restore_emas \
    --height_feature_extractor 512 --width_feature_extractor 1024
echo "Compare mean IoU against the reference's 70.46 (code/README.md:38)."

echo "== 4b/4 (optional) native-resolution protocol =="
# evaluates at the full 1024x2048 cityscapes resolution with Gaussian-
# blended 512x1024 windows, scored against native-resolution labels (the
# protocol of docs/QUALITY.md section 8); the reference cannot do this
python -m iv2019_tpu_torch.evaluate_cli "$LOG_DIR" 500 "$PROBLEM" \
    --tfrecords_path "$DATA_DIR/val.tfrecords" --Nb 1 --restore_emas \
    --height_feature_extractor 512 --width_feature_extractor 1024 \
    --eval_size 1024 2048 --sliding_window --window_blend gaussian

#!/usr/bin/env bash
# docs/QUALITY.md section 8's evaluation protocols on the port, one seed:
# 256 procedural scenes at 256x512, trained at 128x256 with
# --augmentations flip,scale for 6 epochs (Nb 4, per-pixel only), then the
# EMA weights evaluated on 48 held-out scenes by resize to the training
# size (the reference's protocol), at native resolution (--eval_size 256
# 512), and with 128x256 sliding windows, uniform and Gaussian-blended.
# Prints one "protocol: mean IoU" line each (and OUT_DIR/protocols.txt).
#
# Usage: iv2019_tpu_torch/tools/eval_protocols.sh OUT_DIR [cuda|cpu]
set -euo pipefail
OUT=${1:?output directory}
DEVICE=${2:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
PROBLEM=iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$OUT"
python3 -m iv2019_tpu_torch.tools.synthetic_scenes "$WORK/data" --n_train 256 --n_val 48 \
    --n_weak 4 --height 256 --width 512
python3 -m iv2019_tpu_torch.train_cli "$WORK/log" cityscapes \
    --tfrecords_path_per_pixel "$WORK/data/train.tfrecords" \
    --height_feature_extractor 128 --width_feature_extractor 256 \
    --Ntrain 256 --Ne 6 --Nb_per_pixel 4 --Nb_per_bbox 0 --Nb_per_image 0 \
    --learning_rate_boundaries 4 5 --learning_rate_values 0.01 0.005 0.0025 \
    --random_seed 0 --input_seed 0 --augmentations flip,scale \
    --save_checkpoints_steps 384 --device "$DEVICE"
: > "$OUT/protocols.txt"
run() {
    local name=$1
    shift
    python3 -m iv2019_tpu_torch.evaluate_cli "$WORK/log" 48 "$PROBLEM" \
        --tfrecords_path "$WORK/data/val.tfrecords" --restore_emas \
        --height_feature_extractor 128 --width_feature_extractor 256 \
        "$@" --device "$DEVICE" > "$WORK/eval.log" 2>&1 || { cat "$WORK/eval.log"; exit 1; }
    local eval_dir
    eval_dir=$(ls -d "$WORK"/log/eval_* | sort | tail -1)
    python3 -c "import pickle, sys; print(sys.argv[1] + ': ' + str(round(pickle.load(open(sys.argv[2], 'rb'))[-1]['mean_iou'], 2)))" \
        "$name" "$eval_dir/all_metrics.p" | tee -a "$OUT/protocols.txt"
}
run "resize to 128x256" --Nb 4
run "native 256x512" --eval_size 256 512 --Nb 2
run "windows, uniform" --eval_size 256 512 --sliding_window --Nb 2
run "windows, gaussian" --eval_size 256 512 --sliding_window --window_blend gaussian --Nb 2

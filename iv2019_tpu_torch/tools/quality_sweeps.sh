#!/usr/bin/env bash
# The port's two seeded quality sweeps at their defaults, one after the
# other on the CUDA card, with the wall time of each:
#   python -m iv2019_tpu_torch.tools.weak_ab   (3 seeds, rate 0.2, EMA evals)
#   python -m iv2019_tpu_torch.tools.quality_ab (3 seeds, sliding windows)
#
# Usage: iv2019_tpu_torch/tools/quality_sweeps.sh OUT_DIR
#
# OUT_DIR receives the card's name and power limit (card.txt), both state
# files (torch_weak_ab_arms.jsonl, torch_quality_ab.jsonl: copy them into
# docs/ to keep them), the tools' logs and JSON, each weak arm's
# settings.txt and train_metrics.jsonl, and walls.txt. State files already
# in OUT_DIR are reused: a recorded arm or eval is never rerun, so a cut
# sweep resumes. Work directories: $TMPDIR/wab and $TMPDIR/qab.
set -u
OUT=${1:?output directory}
WORK=${TMPDIR:-/tmp}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
t0=$(date +%s.%N)
python3 -m iv2019_tpu_torch.tools.weak_ab "$WORK/wab" --seeds 3 --rate 0.2 \
    --state "$OUT/torch_weak_ab_arms.jsonl" --ema_evals > "$OUT/weak_ab.log" 2>&1
rc1=$?
t1=$(date +%s.%N)
cp "$WORK/wab/weak_ab.json" "$OUT/" 2>/dev/null
for d in "$WORK"/wab/*_s*_*; do
    n=$(basename "$d")
    mkdir -p "$OUT/wab_arms/$n"
    cp "$d/train_metrics.jsonl" "$d/settings.txt" "$OUT/wab_arms/$n/" 2>/dev/null
done
python3 -m iv2019_tpu_torch.tools.quality_ab "$WORK/qab" --seeds 3 \
    --state "$OUT/torch_quality_ab.jsonl" > "$OUT/quality_ab.log" 2>&1
rc2=$?
t2=$(date +%s.%N)
cp "$WORK/qab/quality_ab.json" "$OUT/" 2>/dev/null
python3 -c "print('weak_ab wall s', $t1 - $t0, 'rc', $rc1); print('quality_ab wall s', $t2 - $t1, 'rc', $rc2)" | tee "$OUT/walls.txt"
tail -25 "$OUT/weak_ab.log"
tail -12 "$OUT/quality_ab.log"
exit $((rc1 | rc2))

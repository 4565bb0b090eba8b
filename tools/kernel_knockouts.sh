#!/bin/bash
# Where the time of the fused-loss forward (B1) and backward (B2) and of the
# root-conv wgrad (B6) goes, on one CUDA card: times each kernel with one
# phase taken out of its source, and B1 and B2 with other block shapes than
# their plans'.
#
#     bash tools/kernel_knockouts.sh [b1|b2|b6 ...]   (default: all three)
#
# Works on a copy of the tree under ${TMPDIR:-/tmp}; each variant patches
# the copy's CUDA source with sed, rebuilds it and runs
# tools/kernel_probe.py there, which prints the kernel's ms per launch and
# the device time of each of its CUDA kernels. A variant with a phase left
# out computes wrong outputs: only its time means anything (the probe's
# checks are expected to fail there, and their lines are not shown).
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
copy=$(mktemp -d "${TMPDIR:-/tmp}/knockouts.XXXXXX")
trap 'rm -rf "$copy"' EXIT
mkdir -p "$copy/tools"
cp -r "$root/iv2019_tpu_torch" "$root/chip_smoke.py" "$copy/"
cp "$root/tools/kernel_probe.py" "$copy/tools/"
rm -rf "$copy/build"
loss=$copy/iv2019_tpu_torch/csrc/fused_loss.cu
wgrad=$copy/iv2019_tpu_torch/csrc/root_wgrad.cu

which_ones=${*:-b1 b2 b6}
probe() {  # probe <b1|b2|b6> <label> [probe options]
  local which=$1 label=$2
  shift 2
  echo "== $which: $label"
  python3 "$copy/tools/kernel_probe.py" --root "$copy" --only "$which" "$@" 2>&1 |
    grep '"ms"' | sed -e 's/"check".*"bit_equal"/"bit_equal"/; s/, "sass".*/}/' | cut -c1-400
}
variant() {  # variant <b1|b2|b6> <label> <sed script>: the source with one patch, then restored
  local which=$1 label=$2 script=$3 src=$loss
  [ "$which" = b6 ] && src=$wgrad
  cp "$src" "$src.orig"
  sed -i "$script" "$src"
  cmp -s "$src" "$src.orig" && echo "== $which: $label: the patch matched nothing" >&2
  probe "$which" "$label"
  mv "$src.orig" "$src"
}

no_label_copies='s/^  if (bytes)$/  if (false)/; s/^  return bytes;$/  return 0;/'
if [[ " $which_ones " == *" b1 "* ]]; then
  no_row_blend='s/for (int idx = threadIdx.x; idx < n4; idx += blockDim.x) {/for (int idx = threadIdx.x; idx < 0; idx += blockDim.x) {/'
  no_l2_heads='s/if (vlab != CV - 1 || d1 == tb.cid_v) {/if (false) {/; s/if (hlab != CH - 1 || d1 == tb.cid_h) {/if (false) {/; s/      if (d1 == tb.cid_v) {/      if (false) {/; s/} else if (d1 == tb.cid_h) {/} else if (false) {/'
  no_stores='s/^    dec_out\[q\] = fused;/    if (fused == -7) dec_out[q] = fused;/; s/^    l1dec_out\[q\] = d1;/    if (d1 == -7) l1dec_out[q] = d1;/'
  probe b1 "as shipped"
  variant b1 "no label copies (the barriers still complete)" "$no_label_copies"
  variant b1 "no row blend" "$no_row_blend"
  variant b1 "no L2 heads" "$no_l2_heads"
  variant b1 "no decision stores (decisions still computed)" "$no_stores"
  variant b1 "no label copies, no L2 heads, no stores" "$no_label_copies; $no_l2_heads; $no_stores"
  for shape in "64 32" "128 16" "128 64" "96 32"; do
    set -- $shape
    probe b1 "chunks of $1 columns, bands of $2 rows" --xc "$1" --yb "$2"
  done
fi

if [[ " $which_ones " == *" b2 "* ]]; then
no_contraction='s/for (int k = 0; k < cnt; ++k) {/for (int k = 0; k < 0; ++k) {/'
no_weak_heads='s/if (d1 == cid_v) {/if (false \&\& d1 == cid_v) {/; s/if (d1 == cid_h) {/if (false \&\& d1 == cid_h) {/'
probe b2 "as shipped"
variant b2 "no column contraction" "$no_contraction"
variant b2 "no L2 heads on weak images" "$no_weak_heads"
variant b2 "no label copies (the barriers still complete)" "$no_label_copies"
variant b2 "no contraction, no L2 heads on weak images" "$no_contraction; $no_weak_heads"
for shape in "32 8" "8 8" "14 8" "16 4" "16 16"; do
  set -- $shape
  probe b2 "chunks of $1 columns, bands of $2 rows" --jc "$1" --ib "$2"
done
fi

if [[ " $which_ones " == *" b6 "* ]]; then
no_build='s/for (int g = 0; g < 2; ++g) {/for (int g = 0; g < 0; ++g) {/'
no_products='s|for (int kk = 0; kk < kP / 16; ++kk)|for (int kk = 0; kk < 0; ++kk)|'
probe b6 "as shipped"
variant b6 "no im2row build" "$no_build"
variant b6 "no products" "$no_products"
variant b6 "no im2row build, no products (the TMA stream alone)" "$no_build; $no_products"
fi

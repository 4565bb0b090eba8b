"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. build: compiles the port's CUDA sources (``iv2019_tpu_torch/csrc``),
   then the operator library and the C++ serving loader with ``g++``.
2. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the flagship predict and train paths give it, with times
   (B1, B2 and B6 at one microbatch of the real-format run, 2 + 6 images,
   and at the synthetic run's 4 + 12);
   for the fused units also the device times of their two kernels apart,
   the achieved TFLOP/s and the share of the bound. The fused-loss kernels
   (B1, B2) are also checked at ragged shapes, at the Vistas head widths
   and with label views that start 1-3 elements off 16 bytes, and B1's
   decisions against an argmax of the 4-tap blend done as separate tensor
   multiplies and adds (equal on every pixel); the root-conv wgrad (B6) on
   its ragged edge and on its general kernel; for B1, B2 and B6 two
   launches on the same inputs must agree bit for bit, and ``device_ms``
   (replays of a CUDA graph of one call) stands beside ``ms``. The fused
   units (B4, B5) are also checked, and timed, at the feature maps
   evaluation gives them (``EVAL_MAPS``: TTA scales 0.75 and 1.25, the
   1024x2048 eval size, batch 2) and at phase 12's haloed bands
   (``spatial_band_units``), on each trunk unit the dispatch rule fuses
   there; B6 with explicit pad rows at ``WGRAD_BAND_SHAPES`` (phase 12's
   band, timed beside its bound, and two edge cases). Train-mode BatchNorm
   under ``bn_impl="fused"`` (N1 forward, N2 backward; they replace no
   Pallas kernel): at each distinct map of the flagship train step's 66
   batch-norm layers (found by hooks on one forward; the heads' ragged 14,
   7 and 3 channels among them) in bf16, timed (ms, device ms, plain,
   ``F.batch_norm`` forward and backward as the library, the bound of one
   pass and of the algorithm's two, the host's share and the shares of
   both bounds, the two-launch path's device ms), again in f32 and at
   ``BN_EDGE_SHAPES`` (one channel, pointers 2 bytes off 16), each against
   its plain version at ``BN_*``'s bounds, on the one-launch path of one
   rank (bit for bit over two runs) and on the two-launch path of a mesh
   (bit for bit against the one launch); the kernel line gives their
   launch-weighted means. Eval-mode BatchNorm (N3, ``fused_bn_eval``; no
   Pallas kernel either): at every distinct eval-norm call (x's shape,
   with or without a residual and a ReLU) of one forward of each of the
   benchmark's eval cells (``N3_EVAL_CELLS``), in bf16, timed (ms, device
   ms, the plain chain, the bound of one pass), and in f32, the operator and
   the exported program's folded form each against the plain chain within
   ``N3_MAX_ULPS`` and bit for bit on all but ``N3_MAX_NOT_BITWISE`` of the
   elements; its launches in an eval step of each cell's model
   (``N3_STEP_LAUNCHES``: 71 and 36, no layout copy) are the kernel line's
   ``launches``.
3. predict: the port's predict path at full ResNet-50 width (Cityscapes
   taxonomy, 512x1024 input, 1024x2048 output, bf16, fused blocks) on
   seeded random weights; checks the kernel launch counts, compares with
   the unfused path, and reports latency.
4. cli: the port's predict CLI over synthetic PNGs and an .npz of the same
   weights under the reference's variable names.
5. train: the port's train step at full ResNet-50 width on a constant
   synthetic 512x1024 batch of 4 per-pixel + 8 bbox + 4 image-label
   images (bf16, train-mode BatchNorm as N1/N2, fused loss B1/B2, fused
   update B3), with the root conv's weight gradient from cuDNN and from B6
   (``root_wgrad_pallas``) in turns, both from the same initial weights:
   one launch of each kernel per step (B6 only with the flag; N1 and N2
   once each a batch-norm layer of the model, no layout copy), B6's dW
   against cuDNN's on the same step, finite and falling losses, the EMA
   decay product; step time, images/s, device busy and idle share, the
   root wgrad's device time, peak memory.
6. train run: the port's training run through its entry points at full
   width with ``root_wgrad_pallas`` (``SemanticSegmentation.train`` to step
   6 on synthetic input, checkpoints every 3 steps, then a rerun on the same
   directory that resumes at 6 and stops at 8), then ``train_cli.main`` at
   256x512 for 2 steps: the run's artifacts, one B6 launch per step; step
   p50/p90, images/s, the host input's time per batch, phase 5's device
   busy of one step, peak memory. Then ``predict_cli`` on train_cli's checkpoint, with and without
   ``--restore_emas``: the exports, and the predictions against a model
   holding the run's weights (or their unbiased EMA shadows); and with TTA
   (scales 0.75/1.0/1.25 and the flip) and with 3 x 3 sliding windows over
   512x1024: exports at each image's raw size, lids in cids2lids, B4/B5
   launch counts exact.
7. eval (inside the train run, on its checkpoints 3, 6 and 8 at full width,
   ``--fused_block``): ``evaluate_cli --eval_all_ckpts`` at Nb 2, each
   checkpoint's matrix against a fresh model holding its weights, eval_00's
   files, B4/B5 launch counts exact (by the dispatch rule), peak memory of
   three restores against one; then checkpoint 8 with TTA (6 forwards a
   batch), with the flip alone against the by-hand mean of two forwards'
   common-space probabilities, with 3 x 3 windows over 1024x2048 (uniform
   and gaussian blend), and with one window the size of the image against
   one forward's common-space argmax. Then, for plain, TTA and windowed
   eval steps: ms per image, device busy and idle share, peak memory.

8. real-format train: the training run on input in the real formats,
   written by the port's ``tools/synthetic_scenes.py`` at 512x1024 (per-pixel
   TFRecords, JPEG weak images, bbox and image-label pickles): decode +
   resize per image with the native helpers and with PIL + numpy in turns
   (fails if ``g++`` is here and the helpers did not build); the host input
   per batch with dense host labels and with ``rasterize_on_device`` +
   ``compact_image_labels``, in turns, and the bytes each ships;
   ``SemanticSegmentation.train`` for 8 steps of 4 + 8 + 4 with those two,
   all four augmentations, ``grad_accum_steps=2`` and ``root_wgrad_pallas``:
   launch counts exact (B1, B2, B6 twice a step, B3 once), step p50/p90,
   images/s, the device busy and idle share of the same step on one batch,
   peak memory; on that batch the device rasterizer (bit-equal on two
   launches and to its CPU run), each augmentation's apply on the card
   against the CPU with the same draws, and accum=2 steps against accum=1
   steps on their halves (two identical halves against one step on that
   half; the batch's two halves against the mean of a step on each); then
   ``train_cli`` at 256x512 for 2 steps with ``--augmentations
   color,blur,flip,scale --grad_accum_steps 2``. The kernel line's
   ``launches`` of B1, B2, B3 and B6 are this run's, and their other numbers
   those of phase 2 at this run's shapes (``train_run_launches`` and
   ``train_run_shape``: phase 6's).

9. variants (full width, 4 + 8 + 4 at 512x1024, bf16, seeded weights):
   Cityscapes + PSP, Vistas + PSP, FOV (3, 2), hybrid upsampling, group
   norm, fused adaptation heads: each 2 predict requests with
   ``--fused_block`` held to an f32 truth as in phase 3 (B4/B5 8 + 2 a
   request, 0 under group norm) and 2 fused-optimizer train steps (B1, B2,
   B3 once a step; B1/B2 not under hybrid), with step ms, device busy, peak
   memory and finite losses; then B1/B2 at the Vistas heads (53/12/5,
   4 + 12 images at 64x128 -> 512x1024) against their plain versions, bit
   for bit over two launches, timed; N1/N2 once each a batch-norm layer a
   step in every variant but group norm (the default ``bn_impl="fused"``).
   ``bn_fused`` (no predict requests: eval mode ignores ``bn_impl``):
   VARIANT_STEPS steps of ``bn_impl="fused"`` and of ``bn_impl="flax"``
   (the keys ``fused`` and ``default``, the JAX package's default) from the
   same weights, and an f32 step 1: N1/N2 ``FLAGSHIP_BATCH_NORMS`` times a
   step under fused, never under flax; fused's losses finite and falling, its
   step-1 losses within ``BAR_FACTOR`` times the largest distance that
   reordering the same sums shows (``step1_rows``: each path's step 1 also
   on ``BN_PERMUTATIONS`` of the batch's rows, from the same weights; the
   default's distance to the f32 step on the same rows, the fused step's to
   its own on the constant batch), and a permutation may move the fused
   step no farther than ``BAR_FACTOR`` times what it moves the default
   step or its distance to f32; and the fused path's step 1 in f32 against
   the f32 default step, on the same row orders, within ``BAR_FACTOR``
   times what the permutations move either (``f32_step1_rows``: f32's
   reordering, far below bf16's rounding), N1/N2 once a layer in it; per
   path step ms, device busy, the
   BatchNorm and copies-and-casts groups, peak memory. The kernel line's
   ``launches`` of N1/N2 are this run's.
10. optax path and remat: ``SemanticSegmentation.train`` with
   ``fused_optimizer=False`` and B6 to step 4, resumed to 6 (B1, B2, B6
   once a step, B3 never; an optax-kind checkpoint), ``predict_cli`` from
   it with and without ``--restore_emas`` against models holding the run's
   weights or the EMA shadow unbiased by hand; 3 steps of the optax path and
   of the fused optimizer from the same weights on one batch (step-1 losses
   equal, the parameters' differences printed); 2 steps with ``remat`` and
   B6 against 2 without (running statistics equal after one step, a lower
   peak; step ms, peak memory).

11. multi-rank (data parallelism, ``iv2019_tpu_torch/parallel``): (a) two
   full-width train steps (4 + 8 + 4, B6) through the distributed code path
   on an NCCL group of one rank, bit-equal to the non-distributed step from
   the same weights, 3 all-reduces a step; (b) two gloo ranks sharing the
   card (NCCL refuses two ranks on one device), each with its 2 + 4 + 2 rows
   of the global 4 + 8 + 4 at full width: step 1 in f32 (``bn_impl="flax"``,
   the f32 BatchNorm's all-reduce) and in bf16 (the default, N1/N2), its
   losses and (in f32) its all-reduced gradient, as a whole and parameter
   by parameter, against the single-process step on the global batch,
   under ``BAR_FACTOR`` times what a permutation of the rows does to that
   step (in bf16 the losses' bar also covers the step's distance to the f32
   step: the ranks' halved batch runs other bf16 convolutions, which the
   permutation does not; a random bf16 net's step-1 gradient moves by ~120%
   in norm under the permutation, so the bf16 gradient is printed, not
   held); then 3 bf16
   steps with B6: the state bit-equal on both ranks after 2 steps; B1, B2,
   B3, B6 once a step on each; step 1 in f32 with ``bn_impl="fused"`` too
   (N1/N2 all-reduce their sums over the ranks), held to the
   single-process fused step under ``BAR_FACTOR`` times the largest
   reordering distance (a row permutation of the fused and of the default
   step, the default step's two ranks), N1/N2 66 times on each rank; per rank the step ms, peak memory and the time in collectives
   (gloo stages CUDA tensors through the host: that time says nothing of
   NCCL); (c) ``evaluate_cli --eval_all_ckpts --fused_block`` as a sweep of
   two gloo processes over the train run's checkpoints 3, 6 and 8: the
   merged matrices equal to phase 7's, B4/B5 launches per process exact.
   The per-rank shapes of B1/B2/B6 (2 + 6 images) are those phase 2 holds
   them to their plain versions at. ``multirank_launches`` in the kernel
   line: each kernel's launches in (a), per rank in (b), per process in
   (c).

12. spatial (spatial partitioning, ``spatial_partitions=2``): one spatial
   group of two gloo ranks sharing the card. (a) The train cell (4 + 8 + 4
   at 512x1024, full width), each rank the band of 256 rows of the 16
   images: step 1 in f32 against the single-process step on the global
   batch with the unfused loss (which the spatial step runs, as JAX's
   does), its losses and gradient (whole and parameter by parameter) under
   ``BAR_FACTOR`` times a row permutation's distance; then
   ``SPATIAL_STEPS`` bf16 steps with B6 on the haloed band: the state
   bit-equal on both ranks, B3 and B6 once a step, B1/B2 never, halo
   exchanges in every step; per rank the step ms, device busy, the time in
   the spatial group's collectives (the halo exchanges: this model has no
   group norm or PSP) and in the other all-reduces (each timed alone),
   their counts and bytes, and the peak memory, which must stay below
   ``SPATIAL_PEAK_RATIO`` of the single-process bf16 step's at the same
   batch. (b) ``evaluate_cli --num_devices 2 --spatial_partitions 2
   --fused_block`` on the train run's checkpoint 8 at 1024x2048 (the two
   ranks of one process's devices, both on cuda:0): B4/B5 launches per rank
   exact by the dispatch rule on the haloed bands and above 0, each rank's
   matrix equal integer for integer to the eval step's in one process on
   the same batches, an image a step, and the decisions of all 8 eval
   batches equal on every pixel to that process's, an image a forward (the
   distances to phase 7's batch of 2 in one forward are printed). B4/B5 at the haloed
   bands' shape and B6 with pad rows at the band's are held to their plain
   versions in phase 2. ``spatial_launches`` in the kernel line: each
   kernel's launches per rank in (a) and (b).

13. export and serve (``tools/export_model.py``, ``serving/``): the
   export CLI on phase 4's log dir and .npz (the predict phase's weights),
   ``--fused_block --wire_u8`` at 1x512x1024 on the card, a process started
   after phase 9 whose export and AOTInductor compile run beside phases
   10-12 (``start_export``, as does the unfused program's below), collected
   here: the graph holds 8
   ``iv2019::fused_bottleneck`` and 2 ``_ct`` nodes (the registered
   operators of ``csrc/torch_ops.cpp``, built with ``g++`` in phase 1), one
   ``iv2019::bn_eval.folded`` node for each of the 36 batch norms the units
   leave (N3 on a table folded at export) and no arithmetic on the weights
   alone; the AOTInductor package served by the
   C++ loader with no Python in its process: ``serve`` (20 timed executes,
   p50/p90), then a ``StreamServer`` answering ``REQUESTS`` seeded u8 frames
   one at a time and pipelined (``infer_many``): ms a request, requests a
   second; the operator library's own counter in the loader 8 B4 and 2 B5
   launches a request; the served decisions against the eager
   ``--fused_block`` forward on the same frames (>= 99.9% equal) and against
   the f32 truth (the predict phase's bar). Beside it the export CLI's
   default program, unfused with the f32 signature, a second process
   started with the first: no fused-unit node, 66 ``bn_eval.folded``
   nodes, no arithmetic on the weights alone, its package served by the C++ loader with f32 inputs (20 timed
   executes) and no B4/B5 launch. Printed: export and compile seconds, the
   packages' sizes, the phase's wall time. The kernel line's
   ``serve_launches``: B4/B5 in the fused package's runs.
   Phase 2 times the registered operator (``ms``) beside the ctypes route
   to the same kernels (``ctypes_ms``).

14. bench (``python -m iv2019_tpu_torch.bench``, each run its own process,
   at full width and reduced step counts, ``BENCH_RUNS``): train (N1/N2 66
   times a step), and train with ``IV_ROOT_WGRAD_PALLAS=1`` and
   ``IV_BN_IMPL=flax`` together (B6 once a step, no N1/N2), predict and
   eval with ``IV_FUSED_BLOCK=1``, input, e2e. Each run's JSON line is
   printed and must carry its mode's metric and a finite, positive value;
   the kernels' launches in its timed part, which the bench reads from
   their counters, must be exact (B1, B2, B3
   once a train or e2e step, N1/N2 66 times unless ``IV_BN_IMPL=flax``, B6
   only with its flag; B4/B5 8 + 2 a predict request and by the dispatch
   rule an eval step; none elsewhere). The kernel line's
   ``bench_launches``: each kernel's launches in those runs, by run.
15. quality tools (the port's TF checkpoint converter, overfit probe,
   weak-supervision and quality A/Bs, ``quality_phase``; (c) and (d) start
   first, as processes, and run beside (a), (b) and phase 16): (a) whether
   ``import tensorflow`` fails here (it may: nothing of this phase needs
   it); the TF-written fixtures of ``tests/data/tf_ckpt`` (a V1 file, a V1
   file with a kernel in two slices, a V2 bundle in two shards) converted
   with ``full=False`` and ``full=True``, each array bit-equal to the
   committed ``expected_*.npz`` (TF's own reads and the JAX package's
   conversions); the CRC-32C's rate on this host, native and plain; the
   full-width ResNet-50 warm-started from the converted V1 files (the root
   conv and its BatchNorm, block1/unit_1/conv1: 6 variables, bit-equal) and
   one train step on it at 2 + 2 + 2 x 128x256 (B1, B2, B3 once each, a
   finite loss). (b) ``tools/overfit_probe.run`` in this process at its
   default Settings and 128x256, ``PROBE_STEPS`` steps: ``learned`` must be
   true and B1, B2, B3 must launch exactly once a step; trajectory and wall
   time printed. (c) and (d), both at once, each its own process, cut to
   ``WEAK_AB_CUT`` / ``QUALITY_AB_CUT``: ``python -m
   iv2019_tpu_torch.tools.weak_ab`` (both arms through ``train_cli`` and
   ``evaluate_cli`` on the card; ``weak_ab.json`` with a finite mIoU in
   each arm, the table printed; the weak arm's traced steps, which
   ``train_cli`` writes to ``profile/step_K/trace.json``, must hold one
   launch each of B1's, B2's and B3's main kernels, the per-pixel arm's B3's
   alone) and ``python -m iv2019_tpu_torch.tools.quality_ab`` with the
   sliding-window evals (every mIoU finite). The kernel line's
   ``quality_launches``: the launches of (a)'s step and (b)'s run, and the
   traced steps' counts of (c).
16. spatial memory table (``python -m
   iv2019_tpu_torch.tools.spatial_memory_table``, each row's ranks gloo
   processes sharing the card, ``memory_phase``; (a), (b) and (c) at once,
   beside phase 15's tools): (a) the CLI with
   ``--quick`` in a child process: 512x1024 at factor 1 (one process, one
   image of each type) and at factor 4 (four ranks of 128 rows); both rows
   without error, finite, ``temp`` at f 4 under ``MEMORY_TEMP_RATIO`` of f
   1's, and the measured step's launches from the kernels' counters: B1, B2,
   B3 once at f 1; B3 once a rank and B1/B2 never at f 4 (the spatial mesh
   runs the unfused loss), B6 never (``root_wgrad_pallas`` off, as in the
   JAX tool); halo exchanges on every rank at f 4. (b) One spatial group
   against every rank of its mesh (``MEMORY_GROUP_ROW``: 256x512, ndev 4,
   f 2; two ranks against four, at once): the largest per-rank peak within
   ``MEMORY_GROUP_REL_TOL``. (c) (a)'s f 1 row again with ``LiveBytes``
   counting the same step's storages on the card beside the allocator: the
   count at or below the allocator's args and total (the allocator also
   holds cuDNN's workspaces and rounds blocks). The kernel line's
   ``memory_launches``: each kernel's launches in the measured steps of
   (a)-(c), by row and rank.

The next-to-last line is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import glob
import inspect
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# the card's peaks, the least-time arithmetic and the fused loss's f32
# operations per output pixel are the benchmark's
from benchmark.counts import (LOSS_BWD_OPS_PER_LOGIT, LOSS_FWD_OPS_PER_LOGIT,
                              LOSS_OPS_PER_PIXEL, bound_s, peaks)
from benchmark.trace import capture

# f32 operations per parameter of the update (B3), counted from the
# kernel's arithmetic; its bound's only reader is the kernel line
UPDATE_OPS_PER_PARAM = 14

# max |got - want| / max(1, |want|) of a kernel against its plain version;
# the bound the reference holds its Pallas kernel to
# (tests/test_pallas_block.py:107): both sides round y1 and y2 to bf16, so a
# one-ulp bf16 flip of a mid activation propagates through conv3.
KERNEL_REL_TOL = 2e-2

# Fused loss kernels (B1/B2) against their plain versions. Both upsample in
# f32 with the same weights; the plain version runs dense matrix products
# (cuBLAS, FMA, another summation order) and the kernel 4-tap blends, so
# logits differ in the last bits: sums within 1e-4 relative, decisions
# equal but for near-ties (>= 99.99% of pixels), gradients within 1e-4 of
# the largest |gradient|.
LOSS_SUM_REL_TOL = 1e-4
LOSS_DECISIONS_MIN = 0.9999
LOSS_GRAD_REL_TOL = 1e-4
# The update kernel (B3) rounds every operation as the plain version's
# separate tensor ops do (no FMA contraction), so its vectors are expected
# bit-equal; the bound allows one contraction per element. reg is a sum of
# 26M terms in another order (f64 in the kernel, f32 in the plain version).
UPDATE_REL_TOL = 1e-6
UPDATE_REG_REL_TOL = 1e-5

# N1 and N2 (ops/fused_bn.py) against their plain versions, which do the
# same f32 arithmetic on the same inputs and round once to the input's
# type. y and dx: within one bf16 ulp of the plain version's value, plus
# BN_NEAR_ZERO of the tensor's largest |value| for values near zero (there
# a bf16 ulp is finer than the f32 rounding of the terms: the kernel's sums
# run in another order and its statistics are finished in f64); f32 outputs
# within BN_F32_REL_TOL of the tensor's largest |value|. The statistics and
# the gradient's sums within BN_SUM_REL_TOL of the sum of their terms'
# magnitudes (f64 on the card), over up to 2.1M rows: compensated f32 a
# thread and f64 from there on in the kernel, torch.sum's order in f32 in
# the plain version.
BN_NEAR_ZERO = 2.0 ** -16
BN_F32_REL_TOL = 1e-5
BN_SUM_REL_TOL = 1e-5
BN_EPS = 1e-5
# f32 operations an element: N1 sum, square, sum, then subtract, multiply,
# add; N2 subtract, multiply, sum, multiply, sum, then subtract, multiply,
# subtract, multiply, subtract, multiply
BN_FWD_OPS, BN_BWD_OPS = 6, 11
# (images, C, h, w, storage offset in elements) beside the flagship's maps:
# one channel, a ragged odd map, pointers 2 bytes off 16 at C = 24
BN_EDGE_SHAPES = [(2, 1, 5, 7, 0), (3, 24, 7, 9, 1), (1, 2048, 3, 5, 0), (2, 14, 33, 17, 0)]
# train-mode BatchNorm layers of the flagship model (trunk 53, extension 1,
# three adaptation units 9, three logit heads 3): under bn_impl="fused" (the
# default) N1 and N2 launch once each a layer a step
FLAGSHIP_BATCH_NORMS = 66

# the benchmark's two eval cells (benchmark/configs, benchmark/traffic) as
# Settings fields, and N3's launches in one eval step of each: Vistas with
# PSP (53 trunk norms, no unit fuses at 115x159, PSP and the heads' 18
# more) and Cityscapes with the fused units (66 norms, 30 of them folded by
# B4/B5's 10 units)
N3_EVAL_CELLS = [("vistas_psp", dict(per_pixel_dataset_name="vistas", psp_module=True, Nb=4,
                                     height_feature_extractor=918,
                                     width_feature_extractor=1266)),
                 ("cityscapes", dict(per_pixel_dataset_name="cityscapes", fused_block=True, Nb=8,
                                     height_feature_extractor=512,
                                     width_feature_extractor=1024))]
N3_STEP_LAUNCHES = {"vistas_psp": 71, "cityscapes": 36}
# what N3 stands for in the JAX package (no Pallas kernel, and no counter of
# the main paths, so not in REPLACES): flax's eval-mode BatchNorm
# (use_running_average) in Norm, which XLA fuses with its neighbours
N3_REPLACES = "iv2019_tpu/models/layers.py:268"
# N3 against the plain chain: within this many units in the last place of
# x's type everywhere, and bit for bit on all but this share of elements
N3_MAX_ULPS = 1.0
N3_MAX_NOT_BITWISE = 1e-3

REQUESTS = 8  # predict requests of the predict phase

# Fused vs unfused predict path, same weights, both bf16. The two paths round
# differently (the fused one folds BN into bf16 weights before the convs, the
# unfused one rounds conv outputs to bf16 before the BN affine), and a deep
# net on random weights amplifies the difference: on the card, mean
# |l1 prob diff| was 0.011-0.014 and only 66-70% of decisions agreed, while
# each bf16 path agreed with an f32 truth on just 26-33% (the random net's
# probabilities are near-uniform: mean max 0.20, mean top-2 gap 0.06). So the
# check that catches a wrong kernel is against the f32 truth: the fused path
# must be as close to it as the unfused bf16 path (the criterion of
# tests/test_pallas_block.py::test_resnet_fused_flag_matches_unfused); the
# fused-vs-unfused mean bound only catches gross breakage.
PREDICT_MEAN_ABS_TOL = 5e-2
PREDICT_TRUTH_RATIO = 1.1
PREDICT_TRUTH_DECISIONS_SLACK = 0.02

# (unit, C, M, rate, launches per request) of the fused units on the
# flagship path, feature map 64x128
UNIT_SHAPES = {
    "fused_bottleneck": [("block2", 512, 128, 1, 3), ("block3", 1024, 256, 2, 5)],
    "fused_bottleneck_ct": [("block4", 2048, 512, 4, 2)],
}
# feature maps (images, h, w) that evaluation gives the fused units beyond
# the flagship's: TTA scales 0.75 and 1.25 of 512x1024, the 1024x2048 eval
# size, and batch 2 (--Nb 2) at 64x128
EVAL_MAPS = [(1, 48, 96), (1, 80, 160), (1, 128, 256), (2, 64, 128)]
# (unit, C, M, rate, identity units per forward) of the ResNet-50 trunk
TRUNK_UNITS = [("block2", 512, 128, 1, 3), ("block3", 1024, 256, 2, 5), ("block4", 2048, 512, 4, 2)]
REPLACES = {
    # N1/N2 replace no Pallas kernel: the plain-JAX custom VJP's forward and
    # backward (ops/fused_bn.py, bn_impl="fused")
    "fused_bn_fwd": "iv2019_tpu/ops/fused_bn.py:52",
    "fused_bn_bwd": "iv2019_tpu/ops/fused_bn.py:75",
    "fused_bottleneck": "iv2019_tpu/ops/pallas_block.py:120",
    "fused_bottleneck_ct": "iv2019_tpu/ops/pallas_block.py:354",
    "fused_loss_fwd": "iv2019_tpu/ops/fused_loss.py:196",
    "fused_loss_bwd": "iv2019_tpu/ops/fused_loss.py:250",
    "fused_update": "iv2019_tpu/ops/pallas_update.py:38",
    "root_conv_wgrad": "iv2019_tpu/ops/pallas_wgrad.py:115",
}

# B2 beside the flagship check: (dataset, n_pp, n_weak, stride-8 size, output
# size) of a ragged shape (no chunk, band or 16-byte label row comes out
# even), the Vistas head widths, and Vistas at a ragged mid size
LOSS_EDGE_SHAPES = [("cityscapes", 0, 3, (5, 9), (37, 67)),
                    ("vistas", 1, 2, (9, 16), (36, 64)),
                    ("vistas", 1, 1, (39, 54), (310, 427))]
# phase 12: the ranks of a spatial group (gloo, sharing the card), the eval
# size of its evaluate_cli run (images and labels; the model runs there)
SPATIAL_RANKS = 2
SPATIAL_EVAL_SIZE = (1024, 2048)
# the flagship train step: per-pixel, bbox and image-label images, input size
TRAIN_NB = (4, 8, 4)
TRAIN_HW = (512, 1024)
TRAIN_STEPS = 4  # timed steps, after one warm-up step
# the real-format run's grad_accum_steps, and the microbatch each of its
# B1, B2 and B6 launches sees: the flagship batch split in two
REAL_ACCUM = 2
MICRO_NB = tuple(n // REAL_ACCUM for n in TRAIN_NB)
# The root-conv wgrad kernel (B6) against its plain version (one f32 matrix
# product over the same bf16 operands, cuBLAS without TF32): only the order
# of the f32 sums differs, over up to 2.1M products per output (measured
# 7.6e-6 of the largest |dW| at the flagship shape, 2.3e-7 at 2x36x70).
WGRAD_REL_TOL = 1e-4
# the root conv of the flagship train step, x (16, 3, 512, 1024) and dy
# (16, 64, 256, 512), and of one real-format microbatch (8 images)
WGRAD_SHAPE = ((sum(TRAIN_NB), 3) + TRAIN_HW, 64, 7)
MICRO_WGRAD_SHAPE = ((sum(MICRO_NB), 3) + TRAIN_HW, 64, 7)
# B6 on a band of rows that carries its halo (spatial partitioning),
# (x_shape, cout, k, channels_last dy, pad_rows): phase 12's per-rank band
# (16 images, 256 rows + 3 above + 2 below, no pad rows), the same on the
# general kernel (W = 70), and a band at the image's top with its zero rows
# given as pad rows instead of a halo
WGRAD_BAND_SHAPES = [((sum(TRAIN_NB), 3, TRAIN_HW[0] // SPATIAL_RANKS + 5, TRAIN_HW[1]),
                      64, 7, True, (0, 0)),
                     ((2, 3, 21, 70), 64, 7, True, (0, 0)),
                     ((2, 3, 18, 400), 64, 7, False, (3, 0))]
# the train run: steps of the first run, of the resumed run, checkpoint cadence
RUN_STEPS, RESUME_STEPS, RUN_SAVE_EVERY = 6, 8, 3
# evaluation from the train run: examples and batch of the --eval_all_ckpts
# sweep; TTA scales; the native size the windows tile (3 x 3 windows of
# 512x1024 at overlap 0.5)
EVAL_NEVAL, EVAL_NB = 16, 2
TTA_SCALES = (0.75, 1.0, 1.25)
WINDOW_EVAL_SIZE = (1024, 2048)
# evaluate's matrices against an independent computation on the card (a
# fresh model holding the checkpoint's weights, or the common-space argmax
# done by hand): equal but for 0.01% of pixels, each moving two entries
EVAL_CM_TOL = 1e-4
# a second set of the fused optimizer's flat buffers (26.2M f32 x 4 = 0.42
# GB) must not stay behind per restored checkpoint
EVAL_PEAK_GROWTH_GIB = 0.2
# the real-format train phase: scenes written at the flagship size (enough
# for 10 steps of 4 + 8 + 4 without repeating), steps of the
# SemanticSegmentation run (all with grad_accum_steps=2), batches of the
# host-input measurement per configuration and turn, images of the decode
# measurement
REAL_TRAIN_IMAGES, REAL_WEAK_IMAGES = 40, 80
REAL_AUGMENTATIONS = ("color", "blur", "flip", "scale")
REAL_STEPS, REAL_INPUT_BATCHES, REAL_DECODE_IMAGES = 8, 3, 8
# an accum=2 step against accum=1 steps on its halves (two identical
# halves against one step on that half; the run's batch against the mean of
# one step on each half): each microbatch is one half, so the BatchNorm
# statistics, losses and gradients are the same computation (only the
# running statistics, excluded, take two updates). The averaged gradients
# are held to the train phase's bf16 bound (one bf16 ulp of the largest
# |gradient|, as B6's dW against cuDNN's), the losses to 1e-5 relative
HALVES_LOSS_REL_TOL = 1e-5
# an augmentation's apply on the card against the same apply on the CPU
# with the same draws: labels equal, images within 1e-5 (exp, the
# reductions and HSV round in other orders on the card)
AUGMENT_IMAGE_ATOL = 1e-5


def log(*args):
    print(*args, flush=True)


def time_ms(fn, runs=20, warmup=3):
    """Median device time of one call, from CUDA events around each run.

    The runs are queued back to back with one synchronize at the end, so
    the host's time to launch a call overlaps the device's work on the one
    before: a start event fires when the previous call ends, not while the
    device waits for the host.
    """
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def device_ms(fn, runs=20):
    """Median device time of one call of ``fn`` with the host's time taken
    out: the call is captured once in a CUDA graph and the graph replayed,
    with CUDA events around each replay. For calls whose kernels take less
    time than the host needs to launch them (the small fused units),
    ``time_ms`` measures the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, runs=runs)


def random_unit(rng, c, m, device):
    """Folded weights of one identity unit with randomized BN statistics.

    Each running variance is drawn around the variance its conv's output
    has for unit-variance input under the He init (2 for conv1 on x, about
    1 for conv2 and conv3), as in a trained net, where BN keeps activations
    at unit scale. Drawn far from it, the gains compound over the three
    convs, outputs reach |30|, and a one-ulp bf16 flip of a large y2 value
    moves a small output by several of its own ulps: on the card that gave
    max rel errors of 2.3e-2 to 3.9e-2 with the reference test's draws
    (var in [0.3, 1.2]) against 1.2e-2 to 1.6e-2 with these.
    """
    from iv2019_tpu_torch.ops.fused_block import fold_bn

    def bn(k, var0):
        return [torch.tensor(a, dtype=torch.float32, device=device) for a in (
            rng.uniform(0.5, 1.5, k), rng.uniform(-0.5, 0.5, k),
            rng.uniform(-0.2, 0.2, k), var0 * rng.uniform(0.5, 1.5, k))]

    def kern(co, ci, kh):
        std = (2.0 / (kh * kh * ci)) ** 0.5
        return torch.tensor(rng.normal(0, std, (co, ci, kh, kh)), dtype=torch.float32, device=device)

    k1, b1 = fold_bn(kern(m, c, 1), *bn(m, 2.0))
    k2, b2 = fold_bn(kern(m, m, 3), *bn(m, 1.0))
    k3, b3 = fold_bn(kern(c, m, 1), *bn(c, 1.0))
    bf = torch.bfloat16
    return dict(
        w1=k1[:, :, 0, 0].t().contiguous().to(bf), b1=b1,
        w2=k2.permute(2, 3, 1, 0).contiguous().to(bf), b2=b2,
        w3=k3[:, :, 0, 0].t().contiguous().to(bf), b3=b3,
    )


def loss_inputs(rng, tax, n_pp, n_weak, in_hw, out_hw, device):
    """Inputs of the fused loss (B1/B2) as the train step hands them over:
    stride-8 f32 logits, per-pixel labels gathered into the three head
    spaces, and one-hot weak labels of random weak classes (bench.py:83-93)."""
    from iv2019_tpu_torch.ops.segment_ops import gather_cids

    n = n_pp + n_weak
    (h, w), (H, W) = in_hw, out_hw

    def logits(c):
        return torch.tensor(rng.normal(0, 2, (n, h, w, c)), dtype=torch.float32, device=device)

    pp = torch.tensor(rng.randint(0, len(tax.per_pixel_cids2l1_cids), (n_pp, H, W)),
                      dtype=torch.int32, device=device)
    eye = np.eye(len(tax.per_bbox_cids2vehicle_cids), dtype=np.float32)
    weak = torch.tensor(eye[rng.randint(0, len(eye), (n_weak, H, W))], device=device)
    heads = [gather_cids(t, pp).contiguous() for t in (
        tax.per_pixel_cids2l1_cids, tax.per_pixel_cids2vehicle_cids, tax.per_pixel_cids2human_cids)]
    return (logits(tax.num_l1_classes), logits(tax.num_vehicle_classes),
            logits(tax.num_human_classes), *heads, weak)


def compare_loss(tax, args, out_hw, g3):
    """B1 and B2 against their plain versions on the same inputs: sums
    relative and absolute error, decision agreement, gradient error
    relative to the largest |gradient| and absolute."""
    from iv2019_tpu_torch.ops import fused_loss as fl

    sums, dec, l1dec = fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)
    grads = fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)
    want_sums, want_dec, want_l1dec = fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw)
    want_grads = fl.fused_loss_bwd_plain(g3, *args, tax=tax, out_hw=out_hw)
    tap_dec, tap_l1dec = tap_decisions(tax, *args[:3], out_hw)
    torch.cuda.synchronize()
    return dict(
        sums_rel_err=float(((sums - want_sums).abs() / want_sums.abs().clamp_min(1.0)).max()),
        sums_max_abs_err=float((sums - want_sums).abs().max()),
        decisions_equal=float((dec == want_dec).float().mean()),
        l1_decisions_equal=float((l1dec == want_l1dec).float().mean()),
        tap_decisions_equal=min(float((dec == tap_dec).float().mean()),
                                float((l1dec == tap_l1dec).float().mean())),
        grad_rel_err=max(float((g - gw).abs().max() / gw.abs().max().clamp_min(1e-30))
                         for g, gw in zip(grads, want_grads)),
        grad_max_abs_err=max(float((g - gw).abs().max()) for g, gw in zip(grads, want_grads)))


def loss_ok(check):
    return (check["sums_rel_err"] < LOSS_SUM_REL_TOL
            and min(check["decisions_equal"], check["l1_decisions_equal"]) >= LOSS_DECISIONS_MIN
            and check["grad_rel_err"] < LOSS_GRAD_REL_TOL
            and check.get("tap_decisions_equal", 1.0) == 1.0)


def tap_decisions(tax, l1_lr, veh_lr, hum_lr, out_hw):
    """(decisions, l1_decisions) from the 4-tap blend written as separate
    tensor multiplies and adds, rows first (each rounded once, as the
    kernels' blend), and torch's first-max argmax: what B1's decisions must
    equal bit for bit."""
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops.segment_ops import gather_cids

    dev = l1_lr.device
    (H, W), (h, w) = out_hw, l1_lr.shape[1:3]
    rlo, rhi, rw0, rw1, _, _ = (torch.as_tensor(t, device=dev) for t in fl._taps(h, H))
    clo, chi, cw0, cw1, _, _ = (torch.as_tensor(t, device=dev) for t in fl._taps(w, W))

    def argmax(lr):
        rows = rw0[None, :, None, None] * lr[:, rlo.long()] + rw1[None, :, None, None] * lr[:, rhi.long()]
        u = cw0[None, None, :, None] * rows[:, :, clo.long()] + cw1[None, None, :, None] * rows[:, :, chi.long()]
        return u.argmax(-1).int()

    d1, dv, dh = argmax(l1_lr), argmax(veh_lr), argmax(hum_lr)
    dec = torch.where(
        d1 == tax.cid_l1_vehicle, gather_cids(tax.l2_vehicle_cids2common_cids, dv),
        torch.where(d1 == tax.cid_l1_human, gather_cids(tax.l2_human_cids2common_cids, dh),
                    gather_cids(tax.l1_cids2common_cids, d1)))
    return dec, d1


def unaligned_labels(args, offset):
    """The loss inputs with each label tensor replaced by an equal view that
    starts ``offset`` elements (4-byte words) into a fresh buffer."""
    out = list(args)
    for k in range(3, 7):
        t = out[k]
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out[k] = buf[offset:].view(t.shape).copy_(t)
    return out


def update_inputs(n, device, seed=0):
    """(w, g, m, s, mask, lr, decay) of the update kernel (B3): flat f32
    vectors at weight, gradient and momentum scales, a 0/1 decay mask."""
    gen = torch.Generator(device).manual_seed(seed)

    def vec(scale):
        return torch.randn(n, generator=gen, device=device) * scale

    mask = (torch.rand(n, generator=gen, device=device) < 0.9).float()
    return (vec(0.05), vec(0.01), vec(0.01), vec(0.05), mask,
            torch.tensor(0.01, device=device), torch.tensor(0.9, device=device))


def compare_update(args, nesterov):
    """B3 against its plain version: the largest vector error relative to
    the largest |value| and absolute, and reg's relative error."""
    from iv2019_tpu_torch.ops.fused_update import fused_update, fused_update_plain

    kw = dict(momentum=0.9, weight_decay=0.00017, nesterov=nesterov)
    got = fused_update(*args, **kw)
    want = fused_update_plain(*args, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(got[:3], want[:3]))
    return dict(
        vec_rel_err=max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs),
        vec_max_abs_err=max(float((a - b).abs().max()) for a, b in pairs),
        reg_rel_err=float((got[3] - want[3]).abs() / want[3].abs()))


def update_ok(check):
    return check["vec_rel_err"] <= UPDATE_REL_TOL and check["reg_rel_err"] <= UPDATE_REG_REL_TOL


def bn_inputs(n, c, h, w, dtype, device, seed=0, offset=0):
    """x and dy of N1/N2 as the train step hands them over: NCHW in
    channels_last memory, x around a per-channel mean in [-1, 1) with a
    per-channel std in [0.5, 2), dy at the scale of a loss's gradient; f32
    scale in [0.5, 1.5) and bias in [-0.5, 0.5). ``offset`` elements of
    storage before x and dy (pointers off 16 bytes: the ragged load)."""
    gen = torch.Generator(device).manual_seed(seed)

    def nhwc(values):
        buf = torch.empty(offset + values.numel(), dtype=dtype, device=device)
        view = buf[offset:].view(n, h, w, c)
        view.copy_(values)
        return view.permute(0, 3, 1, 2)

    mu = torch.rand(c, generator=gen, device=device) * 2 - 1
    sd = torch.rand(c, generator=gen, device=device) * 1.5 + 0.5
    x = nhwc(torch.randn((n, h, w, c), generator=gen, device=device) * sd + mu)
    dy = nhwc(torch.randn((n, h, w, c), generator=gen, device=device) * 1e-3)
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    bias = torch.rand(c, generator=gen, device=device) - 0.5
    return x, dy, scale, bias


def _bn_out_err(got, want, dtype):
    """(the largest error over what it may be, the largest |error|) of y or
    dx against the plain version's (BN_NEAR_ZERO, BN_F32_REL_TOL)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    top = float(want.abs().max())
    if dtype == torch.bfloat16:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
        allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7) + BN_NEAR_ZERO * top
    else:
        allowed = torch.full_like(want, BN_F32_REL_TOL * max(top, 1e-30))
    return float((diff / allowed).max()), float(diff.max())


def ulps_off(got, want):
    """|got - want| in units in the last place of want's type (bf16 or f32)
    at the larger magnitude of the two, element by element."""
    bits = {torch.bfloat16: 7, torch.float32: 23}[want.dtype]
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - bits)


def bn_check(n, c, h, w, dtype, device, seed=0, offset=0, timed=False):
    """N1 and N2 at one (n, c, h, w) against their plain versions on the same
    inputs (y and dx, the statistics, the gradient's sums, the row count),
    on both paths: one launch a half (the plan's path on one rank) twice,
    bit for bit, and the two-launch path of a mesh (``_split``) once, bit for
    bit against it; one run of each counted. With ``timed`` also ms and
    device ms of each beside the plain version's and the library's
    (``F.batch_norm`` forward, and its backward alone, on the same
    channels_last input with f32 parameters), the host's share (ms -
    device ms), the shares of the one-pass and two-pass bounds, and the
    two-launch path's device ms. Returns the row."""
    from iv2019_tpu_torch.ops import fused_bn as fbn

    x, dy, scale, bias = bn_inputs(n, c, h, w, dtype, device, seed, offset)
    before = fbn.fused_bn_fwd.launches, fbn.fused_bn_bwd.launches
    y, mean, var, rstd, count = fbn.fused_bn_fwd(x, scale, bias, BN_EPS)
    dx, dscale, dbias = fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count)
    launches = [fbn.fused_bn_fwd.launches - before[0], fbn.fused_bn_bwd.launches - before[1]]
    first = (y, mean, var, rstd, count, dx, dscale, dbias)
    again = (*fbn.fused_bn_fwd(x, scale, bias, BN_EPS),
             *fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count))
    split = (*fbn.fused_bn_fwd(x, scale, bias, BN_EPS, _split=True),
             *fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count, _split=True))
    bit_equal = all(torch.equal(a, b) for a, b in zip(first, again))
    paths_bit_equal = all(torch.equal(a, b) for a, b in zip(first, split))
    py, pmean, pvar, prstd, _ = fbn.batch_norm_train_plain(x, scale, bias, BN_EPS)
    pdx, pdscale, pdbias = fbn.batch_norm_backward_plain(x, dy, mean, rstd, scale, count)
    torch.cuda.synchronize()
    m = n * h * w
    xd, dyd = x.double(), dy.double()
    xhat = (xd - pmean.double()[:, None, None]) * prstd.double()[:, None, None]
    mags = {"mean": xd.abs().sum((0, 2, 3)) / m, "var": (xd * xd).sum((0, 2, 3)) / m,
            "dbias": dyd.abs().sum((0, 2, 3)), "dscale": (dyd * xhat).abs().sum((0, 2, 3))}
    del xd, dyd, xhat
    sums = {k: float(((a.double() - b.double()).abs() / mags[k].clamp_min(1e-30)).max())
            for k, a, b in (("mean", mean, pmean), ("var", var, pvar),
                            ("dbias", dbias, pdbias), ("dscale", dscale, pdscale))}
    y_ratio, y_err = _bn_out_err(y, py, dtype)
    dx_ratio, dx_err = _bn_out_err(dx, pdx, dtype)
    plan, bwd_plan = fbn.launch_plan(0, x, y), fbn.launch_plan(1, x, dy, dx)
    split_plans = [fbn.launch_plan(0, x, y, split=True).path,
                   fbn.launch_plan(1, x, dy, dx, split=True).path]
    row = dict(n=n, C=c, h=h, w=w, M=m, dtype=str(dtype).split(".")[-1], offset=offset,
               vec=plan.vec, blocks=plan.tiles * plan.splits, capacity=plan.capacity,
               bwd_blocks=bwd_plan.tiles * bwd_plan.splits, bwd_capacity=bwd_plan.capacity,
               path=[plan.path, bwd_plan.path], split_path=split_plans, launches=launches,
               bit_equal=bit_equal, paths_bit_equal=paths_bit_equal,
               count_equal=float(count) == m,
               y_max_abs_err=y_err, y_err_over_allowed=y_ratio,
               dx_max_abs_err=dx_err, dx_err_over_allowed=dx_ratio,
               sum_rel_err=sums)
    row["ok"] = (bit_equal and paths_bit_equal and row["count_equal"] and launches == [1, 1]
                 and row["path"] == ["one", "one"] and split_plans == ["split", "split"]
                 and y_ratio <= 1 and dx_ratio <= 1 and max(sums.values()) <= BN_SUM_REL_TOL)
    del py, pdx, again, split
    if not timed:
        return row
    isz = x.element_size()
    fwd = lambda: fbn.fused_bn_fwd(x, scale, bias, BN_EPS)  # noqa: E731
    bwd = lambda: fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count)  # noqa: E731
    xl = x.detach().requires_grad_(True)
    sl, bl = scale.detach().requires_grad_(True), bias.detach().requires_grad_(True)
    yl = F.batch_norm(xl, None, None, sl, bl, True, 0.0, BN_EPS)
    # fewer runs where one call moves a quarter gigabyte or more
    runs, plain_runs = (10, 5) if m * c > 2 ** 26 else (20, 20)
    row.update(
        ms=time_ms(fwd, runs=runs), device_ms=device_ms(fwd, runs=runs),
        bwd_ms=time_ms(bwd, runs=runs), bwd_device_ms=device_ms(bwd, runs=runs),
        split_device_ms=device_ms(
            lambda: fbn.fused_bn_fwd(x, scale, bias, BN_EPS, _split=True), runs=runs),
        bwd_split_device_ms=device_ms(lambda: fbn.fused_bn_bwd(x, dy, mean, rstd, scale, count,
                                                               _split=True), runs=runs),
        plain_ms=time_ms(lambda: fbn.batch_norm_train_plain(x, scale, bias, BN_EPS),
                         runs=plain_runs),
        bwd_plain_ms=time_ms(lambda: fbn.batch_norm_backward_plain(x, dy, mean, rstd, scale,
                                                                    count), runs=plain_runs),
        library_ms=time_ms(lambda: F.batch_norm(x, None, None, scale, bias, True, 0.0, BN_EPS),
                           runs=runs),
        bwd_library_ms=time_ms(lambda: torch.autograd.grad(yl, (xl, sl, bl), dy,
                                                           retain_graph=True), runs=runs),
        mbytes=2 * m * c * isz / 1e6, bwd_mbytes=3 * m * c * isz / 1e6)
    # the least bytes: x (and dy) read once and y (dx) written once; the two
    # passes of the algorithm read x (and dy) twice
    fwd_bound = least_ms(2 * m * c * isz + 20 * c, BN_FWD_OPS * m * c, "f32")
    bwd_bound = least_ms(3 * m * c * isz + 28 * c, BN_BWD_OPS * m * c, "f32")
    row.update(bound_ms=fwd_bound[0], bound_by=fwd_bound[1], bwd_bound_ms=bwd_bound[0],
               bwd_bound_by=bwd_bound[1], two_pass_bound_ms=least_ms(3 * m * c * isz)[0],
               bwd_two_pass_bound_ms=least_ms(5 * m * c * isz)[0])
    for pre in ("", "bwd_"):
        dev = row[pre + "device_ms"]
        row.update({pre + "host_ms": row[pre + "ms"] - dev,
                    pre + "bound_share": _share(row[pre + "bound_ms"], dev),
                    pre + "two_pass_share": _share(row[pre + "two_pass_bound_ms"], dev)})
    return row


def bn_shapes(device):
    """((images, C, h, w), layers) of each distinct map the flagship train
    step's BatchNorm layers normalize: the norms' inputs in one eval-mode
    forward of a 512x1024 image, with the step's 16 images."""
    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.models.model import build_model, init_model

    model = init_model(build_model(_train_settings(device)),
                       torch.Generator().manual_seed(0)).eval()
    seen = {}

    def hook(module, inputs):
        key = (sum(TRAIN_NB), *inputs[0].shape[1:])
        seen[key] = seen.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Norm) and m.norm_type == "batch"]
    with torch.no_grad():
        model(torch.zeros((1, *TRAIN_HW, 3), device=device))
    for handle in handles:
        handle.remove()
    if sum(seen.values()) != FLAGSHIP_BATCH_NORMS:
        raise AssertionError(f"{sum(seen.values())} batch norms in the flagship model, "
                             f"expected {FLAGSHIP_BATCH_NORMS}")
    return sorted(seen.items(), key=lambda kv: -kv[0][2] * kv[0][3] * kv[0][1])


def bn_kernels(device):
    """N1 and N2 against their plain versions, on both paths, at each
    distinct map of the flagship train step (bf16, timed), again in f32 (a
    compute_dtype float32 run takes the same kernels), and at edge shapes
    (C of 1, odd sizes, pointers 2 bytes off 16: one-element loads). Times
    are launch-weighted means over the step's layers (per_shape beside)."""
    rows, problems = [], []
    shapes = bn_shapes(device)
    for (n, c, h, w), layers in shapes:
        row = bn_check(n, c, h, w, torch.bfloat16, device, seed=len(rows), timed=True)
        row["layers"] = layers
        log(f"kernel fused_bn {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()
    checks = []
    for (n, c, h, w), _ in shapes:
        checks.append(bn_check(n, c, h, w, torch.float32, device, seed=len(checks)))
        torch.cuda.empty_cache()
    for n, c, h, w, offset in BN_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            checks.append(bn_check(n, c, h, w, dtype, device, seed=len(checks), offset=offset))
    for row in rows + checks:
        if not row["ok"]:
            problems.append(row)
    log(f"kernel fused_bn checks (f32 and edges): {json.dumps(checks)}")
    if problems:
        raise AssertionError(f"N1/N2 depart from their plain versions: {problems}")
    weight = sum(r["layers"] for r in rows)

    def mean(key):  # a bound is null in every row or in none (one card)
        return None if rows[0][key] is None else sum(r[key] * r["layers"] for r in rows) / weight

    common = dict(route="cuda", source="iv2019_tpu_torch/csrc/fused_bn.cu", launches=None,
                  per_shape=rows, checks=checks)
    out = []
    for name, pre, err in (("fused_bn_fwd", "", "y_max_abs_err"),
                           ("fused_bn_bwd", "bwd_", "dx_max_abs_err")):
        bounds = {k: mean(pre + k) for k in ("bound_ms", "two_pass_bound_ms", "device_ms")}
        out.append(dict(
            name=name, replaces=REPLACES[name], max_abs_err=max(r[err] for r in rows),
            ms=mean(pre + "ms"), device_ms=bounds["device_ms"], host_ms=mean(pre + "host_ms"),
            split_device_ms=mean(pre + "split_device_ms"), plain_ms=mean(pre + "plain_ms"),
            library_ms=mean(pre + "library_ms"), bound_ms=bounds["bound_ms"], bound_by="bytes",
            two_pass_bound_ms=bounds["two_pass_bound_ms"],
            bound_share=_share(bounds["bound_ms"], bounds["device_ms"]),
            two_pass_share=_share(bounds["two_pass_bound_ms"], bounds["device_ms"]),
            path=sorted({r["path"][1 if pre else 0] for r in rows}),
            under_library=all(r[pre + "ms"] <= r[pre + "library_ms"] for r in rows), **common))
    for r in out:
        log(f"kernel {r['name']} ms {r['ms']:.4f} device {r['device_ms']:.4f} host "
            f"{r['host_ms']:.4f} split path device {r['split_device_ms']:.4f} plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound {_fmt(r['bound_ms'])} "
            f"(two passes {_fmt(r['two_pass_bound_ms'])}; shares {_fmt(r['bound_share'], 3)} / "
            f"{_fmt(r['two_pass_share'], 3)}), paths {r['path']}, under the library at every map "
            f"{r['under_library']}, launch-weighted over {weight} layers")
    return out


def eval_norm_calls(fields):
    """({(x shape, residual given, relu): calls} of the eval-mode batch
    norms of one forward of a model built from ``fields`` on the card, and
    (N3's launches, its layout copies) in one eval step of that model
    (``make_eval_step``, as evaluate_cli and the benchmark's eval cells run
    it), counted from zero after a first step."""
    import collections
    import inspect

    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_bn as fbn
    from iv2019_tpu_torch.train.step import make_eval_step

    problem = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iv2019_tpu_torch",
                           "problem_definitions", fields["per_pixel_dataset_name"],
                           "problem01.json")
    settings = Settings(device="cuda", mode="eval", training_problem_def_path=problem, **fields)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    calls = collections.Counter()

    def record(module, args, kwargs):
        bound = inspect.signature(Norm.forward).bind(module, *args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        calls[(tuple(a["x"].shape), a["residual"] is not None, bool(a["relu"]))] += 1

    handles = [m.register_forward_pre_hook(record, with_kwargs=True) for m in model.modules()
               if isinstance(m, Norm) and m.norm_type == "batch"]
    h, w, n = fields["height_feature_extractor"], fields["width_feature_extractor"], fields["Nb"]
    images = torch.rand(n, h, w, 3, device="cuda") * 2 - 1
    with torch.inference_mode():
        model(images)
    for handle in handles:
        handle.remove()
    step = make_eval_step(settings, model=model)
    labels = torch.zeros(n, h, w, dtype=torch.int32, device="cuda")
    step(images, labels)
    torch.cuda.synchronize()
    fbn.fused_bn_eval.launches = fbn.fused_bn_eval.layout_copies = 0
    step(images, labels)
    torch.cuda.synchronize()
    counted = fbn.fused_bn_eval.launches, fbn.fused_bn_eval.layout_copies
    del model, step, images
    torch.cuda.empty_cache()
    return calls, counted


def bn_eval_inputs(n, c, h, w, residual, dtype, seed):
    """x (and a residual) NCHW in channels_last memory, x around a
    per-channel mean in [-1, 1) with a per-channel variance in [0.1, 3.1)
    that the running statistics hold; f32 scale in [0.5, 1.5), bias in
    [-0.5, 0.5)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    mean = torch.rand(c, generator=gen, device="cuda") * 2 - 1
    var = torch.rand(c, generator=gen, device="cuda") * 3 + 0.1

    def nhwc(sd, mu):
        values = torch.randn((n, h, w, c), generator=gen, device="cuda") * sd + mu
        return values.to(dtype).permute(0, 3, 1, 2)

    x = nhwc(var.sqrt(), mean)
    r = nhwc(1.0, 0.0) if residual else None
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.rand(c, generator=gen, device="cuda") - 0.5
    return x, r, (mean, var, scale, bias)


def bn_eval_check(n, c, h, w, residual, relu, dtype, seed=0, timed=False):
    """N3 at one eval-norm call against the plain chain on the same inputs,
    in both of its forms (the eager operator, the exported program's
    ``bn_eval.folded`` on the table export folds): the largest distance in
    units in the last place, the share of elements not bit for bit, one
    launch counted; with ``timed`` its times beside the plain chain's and
    the bound of one pass, (x + y [+ residual]) bytes at the card's peak."""
    from iv2019_tpu_torch.ops import fused_bn as fbn

    x, r, params = bn_eval_inputs(n, c, h, w, residual, dtype, seed)
    args = (*params, BN_EPS, r, relu)
    before = fbn.fused_bn_eval.launches
    got = fbn.fused_bn_eval(x, *args)
    launches = fbn.fused_bn_eval.launches - before
    want = fbn.batch_norm_eval_plain(x, *args)
    mean, var, scale, bias = params
    table = torch.stack([mean, torch.rsqrt(var + BN_EPS) * scale, bias])
    folded = torch.ops.iv2019.bn_eval.folded(x, table, r, relu)
    torch.cuda.synchronize()
    row = dict(n=n, C=c, h=h, w=w, residual=residual, relu=relu, dtype=str(dtype).split(".")[1],
               launches=launches, layout_equal=got.stride() == x.stride())
    for key, out in (("", got), ("folded_", folded)):
        row[key + "ulps_max"] = float(ulps_off(out, want).max())
        row[key + "not_bitwise"] = float((out != want).float().mean())
    del got, want, folded
    row["ok"] = (launches == 1 and row["layout_equal"]
                 and max(row["ulps_max"], row["folded_ulps_max"]) <= N3_MAX_ULPS
                 and max(row["not_bitwise"], row["folded_not_bitwise"]) <= N3_MAX_NOT_BITWISE)
    if timed:
        runs = 10 if x.numel() > 2 ** 26 else 30
        tensors = 3 if residual else 2
        row.update(ms=time_ms(lambda: fbn.fused_bn_eval(x, *args), runs=runs),
                   device_ms=device_ms(lambda: fbn.fused_bn_eval(x, *args), runs=runs),
                   plain_ms=time_ms(lambda: fbn.batch_norm_eval_plain(x, *args), runs=runs),
                   bound_ms=least_ms(tensors * x.numel() * x.element_size())[0])
        row["bound_share"] = _share(row["bound_ms"], row["device_ms"])
    return row


def bn_eval_kernels():
    """N3 (phase 2): at every distinct eval-norm call of one forward of
    each eval cell's model (``N3_EVAL_CELLS``), in bf16 and timed, again in
    f32, both forms against the plain chain (``N3_MAX_ULPS``,
    ``N3_MAX_NOT_BITWISE``); N3's launches in an eval step of each, which
    must be ``N3_STEP_LAUNCHES`` with no layout copy. Returns the kernel
    line's N3 entry: times launch-weighted over both cells' calls."""
    rows, checks, launches, problems = [], [], {}, []
    for cell, fields in N3_EVAL_CELLS:
        calls, (launched, copies) = eval_norm_calls(fields)
        launches[cell] = launched
        if launched != N3_STEP_LAUNCHES[cell] or launched != sum(calls.values()) or copies:
            problems.append(f"{cell}: {launched} N3 launches and {copies} layout copies in an "
                            f"eval step, expected {N3_STEP_LAUNCHES[cell]} and 0 "
                            f"({sum(calls.values())} eval norms in a forward)")
        for (shape, residual, relu), count in sorted(calls.items()):
            row = bn_eval_check(*shape, residual, relu, torch.bfloat16, seed=len(rows),
                                timed=True)
            row.update(cell=cell, calls=count)
            log(f"kernel fused_bn_eval {json.dumps(row)}")
            rows.append(row)
            checks.append(bn_eval_check(*shape, residual, relu, torch.float32,
                                        seed=len(checks)))
            torch.cuda.empty_cache()
    log(f"kernel fused_bn_eval checks (f32): {json.dumps(checks)}")
    problems.extend(r for r in rows + checks if not r["ok"])
    if problems:
        raise AssertionError(f"N3 departs from the plain chain or its counts: {problems}")
    weight = sum(r["calls"] for r in rows)

    def mean(key):  # a bound is null in every row or in none (one card)
        return None if rows[0][key] is None else sum(r[key] * r["calls"] for r in rows) / weight

    out = dict(name="fused_bn_eval", replaces=N3_REPLACES, route="cuda",
               source="iv2019_tpu_torch/csrc/fused_bn.cu", launches=launches,
               ulps_max=max(r[k] for r in rows + checks for k in ("ulps_max", "folded_ulps_max")),
               not_bitwise_max=max(r[k] for r in rows + checks
                                   for k in ("not_bitwise", "folded_not_bitwise")),
               ms=mean("ms"), device_ms=mean("device_ms"), plain_ms=mean("plain_ms"),
               bound_ms=mean("bound_ms"), bound_by="bytes",
               bound_share=_share(mean("bound_ms"), mean("device_ms")),
               under_plain=all(r["ms"] <= r["plain_ms"] for r in rows),
               per_shape=rows, checks=checks)
    log(f"kernel fused_bn_eval ms {out['ms']:.4f} device {out['device_ms']:.4f} plain "
        f"{out['plain_ms']:.4f} bound {_fmt(out['bound_ms'])} "
        f"(share {_fmt(out['bound_share'], 3)}), "
        f"ulps {out['ulps_max']}, not bit for bit {out['not_bitwise_max']:.2e}, eval-step "
        f"launches {launches}, launch-weighted over {weight} calls")
    return out


def fused_wrapper(n, h, w, c, m, rate):
    """The wrapper the JAX dispatch rule picks for an identity unit, or None."""
    from iv2019_tpu_torch.ops import fused_block as fb

    if fb.fused_bottleneck_supported(n, h, w, c, m, rate):
        return "fused_bottleneck"
    if fb.pick_ct_config(n, h, w, c, m, rate) is not None:
        return "fused_bottleneck_ct"
    return None


def spatial_band_units(ranks=None, n=None, hw=None):
    """(wrapper, unit, n, h, w, C, M, rate) of every trunk unit the rule
    fuses on the haloed bands that the ranks of phase 12's eval give it
    (``fused_band_rows``): at 1024x2048 the stride-8 map's 128 rows split
    in bands of 64, each grown by its halo to a multiple of 8."""
    from iv2019_tpu_torch.models.layers import fused_band_rows

    ranks = ranks or SPATIAL_RANKS
    n = n or EVAL_NB
    h, w = (d // 8 for d in (hw or SPATIAL_EVAL_SIZE))
    cases = []
    for unit, c, m, rate, _ in TRUNK_UNITS:
        need = fused_band_rows(h // ranks, rate, ranks)
        for q in range(ranks):
            a, b = need(q)
            case = (fused_wrapper(n, b - a, w, c, m, rate), unit, n, b - a, w, c, m, rate)
            if case[0] is not None and case not in cases:
                cases.append(case)
    return cases


def spatial_launches_per_forward(ranks=None, n=None, hw=None):
    """B4 and B5 launches of one forward on each rank of phase 12's eval: a
    unit runs fused where the rule admits every rank's haloed band."""
    from iv2019_tpu_torch.models.layers import fused_band_rows

    ranks = ranks or SPATIAL_RANKS
    n = n or EVAL_NB
    h, w = (d // 8 for d in (hw or SPATIAL_EVAL_SIZE))
    out = {"fused_bottleneck": 0, "fused_bottleneck_ct": 0}
    for _, c, m, rate, units in TRUNK_UNITS:
        need = fused_band_rows(h // ranks, rate, ranks)
        names = [fused_wrapper(n, b - a, w, c, m, rate) for a, b in map(need, range(ranks))]
        if all(names):
            # this rank's wrapper (rank 0's; the counts are checked per rank)
            out[names[0]] += units
    return out


def launches_per_forward(n, h, w):
    """B4 and B5 launches of one forward whose trunk feature map is
    (n, h, w), by the dispatch rule: 8 and 2 at 64x128; at larger maps the
    rule sends block3 units to B5 and leaves block4 units unfused."""
    out = {"fused_bottleneck": 0, "fused_bottleneck_ct": 0}
    for _, c, m, rate, count in TRUNK_UNITS:
        name = fused_wrapper(n, h, w, c, m, rate)
        if name is not None:
            out[name] += count
    return out


def add_launches(total, n, h, w, forwards=1):
    for k, v in launches_per_forward(n, h, w).items():
        total[k] = total.get(k, 0) + v * forwards
    return total


def unfused_cudnn(x, u, rate):
    """The same unit as three cuDNN convs + bias + relu (channels_last bf16).

    Returns a function of no arguments; the weights are laid out for cuDNN
    here, outside it, so that timing it times the convs.
    """
    xc = x.permute(0, 3, 1, 2)
    bf = torch.bfloat16
    w1 = u["w1"].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
    w2 = u["w2"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    w3 = u["w3"].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
    b1, b2, b3 = (u[k].to(bf) for k in ("b1", "b2", "b3"))

    def run():
        y = torch.relu(F.conv2d(xc, w1, b1))
        y = torch.relu(F.conv2d(y, w2, b2, padding=rate, dilation=rate))
        return torch.relu(F.conv2d(y, w3, b3) + xc)

    return run


def kernel_phase(device):
    """Each kernel against its plain version at the path's shapes.

    Returns one entry per kernel; its times and bound are per launch,
    averaged over the path's mix of shapes (per_shape has each shape).
    A fused unit's entry also has the device times of the wrapper's two
    kernels apart (conv1, and conv2 + conv3), its achieved TFLOP/s and its
    share of the bound, from ``ms`` and from ``device_ms``.
    """
    from iv2019_tpu_torch.ops import fused_block as fb

    rng = np.random.RandomState(0)
    h, w = 64, 128
    results = []
    for name, shapes in UNIT_SHAPES.items():
        wrapper = getattr(fb, name)
        rows = []
        for unit, c, m, rate, per_request in shapes:
            u = random_unit(rng, c, m, device)
            x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.bfloat16, device=device)
            args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
            got = wrapper(*args, rate=rate).float()
            want = fb.bottleneck_plain(*args, rate=rate).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            rel = float((diff / want.abs().clamp_min(1.0)).max())
            flops = 2 * h * w * (c * m + 9 * m * m + m * c)
            nbytes = 2 * x.numel() * 2 + sum(t.numel() * t.element_size() for t in args[1:])
            b = least_ms(nbytes, flops)
            y1 = torch.empty((1, h, w, m), dtype=torch.bfloat16, device=device)
            symbol = f"iv_{name}"
            row = dict(
                unit=unit, C=c, M=m, rate=rate, per_request=per_request,
                max_abs_err=float(diff.max()), max_rel_err=rel,
                ms=time_ms(lambda: wrapper(*args, rate=rate)),
                ctypes_ms=time_ms(lambda: fb._run(symbol, *args, rate)),
                device_ms=device_ms(lambda: wrapper(*args, rate=rate)),
                kernel1_ms=device_ms(lambda: fb._run(symbol, *args, rate, kernels=1, y1=y1)),
                kernel2_ms=device_ms(lambda: fb._run(symbol, *args, rate, kernels=2, y1=y1)),
                plain_ms=time_ms(lambda: fb.bottleneck_plain(*args, rate=rate)),
                library_ms=time_ms(unfused_cudnn(x, u, rate)),
                library_device_ms=device_ms(unfused_cudnn(x, u, rate)),
                bound_ms=b[0], bound_by=b[1],
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
            )
            row.update(tflops=flops / row["ms"] / 1e9,
                       bound_share=_share(row["bound_ms"], row["ms"]),
                       device_tflops=flops / row["device_ms"] / 1e9,
                       device_bound_share=_share(row["bound_ms"], row["device_ms"]))
            log(f"kernel {name} {unit}: {row['ms']:.4f} ms by the registered operator, "
                f"{row['ctypes_ms']:.4f} by ctypes ({row['tflops']:.1f} TFLOP/s, "
                f"{_fmt(row['bound_share'], 3)} of the bound), device {row['device_ms']:.4f} ms "
                f"= conv1 {row['kernel1_ms']:.4f} + conv2/3 {row['kernel2_ms']:.4f} "
                f"({row['device_tflops']:.1f} TFLOP/s, {_fmt(row['device_bound_share'], 3)}); "
                f"cuDNN unit {row['library_ms']:.4f} ms, device {row['library_device_ms']:.4f}; "
                f"bound {_fmt(row['bound_ms'])} ({row['bound_by']})")
            log(f"kernel {name} {json.dumps(row)}")
            if not rel < KERNEL_REL_TOL:
                raise AssertionError(f"{name} {unit}: max rel err {rel} >= {KERNEL_REL_TOL}")
            rows.append(row)
        weight = sum(r["per_request"] for r in rows)

        def mean(key):  # a bound is null in every row or in none (one card)
            return None if rows[0][key] is None else sum(
                r[key] * r["per_request"] for r in rows) / weight

        bound_by = {r["bound_by"] for r in rows}
        results.append(dict(
            name=name, route="cuda", source="iv2019_tpu_torch/csrc/fused_bottleneck.cu",
            replaces=REPLACES[name], launches=None,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            max_rel_err=max(r["max_rel_err"] for r in rows),
            ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=bound_by.pop() if len(bound_by) == 1 else "operations",
            library_ms=mean("library_ms"), device_ms=mean("device_ms"),
            ctypes_ms=mean("ctypes_ms"),
            kernel1_ms=mean("kernel1_ms"), kernel2_ms=mean("kernel2_ms"),
            library_device_ms=mean("library_device_ms"), per_shape=rows,
        ))
    for r in results:
        r["eval_shapes"], r["spatial_band_shapes"] = [], []
    by_name = {r["name"]: r for r in results}
    for row in eval_unit_checks(device):
        key = "spatial_band_shapes" if row["spatial_band"] else "eval_shapes"
        by_name[row["wrapper"]][key].append(row)
    results.extend(train_kernels(device))
    results.append(wgrad_kernel(device))
    results.extend(bn_kernels(device))
    return results


def eval_unit_checks(device):
    """B4/B5 against their plain version at the feature maps evaluation
    gives them (EVAL_MAPS) and at phase 12's haloed bands
    (``spatial_band_units``, rows marked ``spatial_band``), on each trunk
    unit the rule fuses there, with ``ms``, ``device_ms`` and the bound."""
    from iv2019_tpu_torch.ops import fused_block as fb

    rng = np.random.RandomState(5)
    cases = []
    for n, h, w in EVAL_MAPS:
        for unit, c, m, rate, _ in TRUNK_UNITS:
            name = fused_wrapper(n, h, w, c, m, rate)
            if name is None:
                log(f"kernel eval shape {unit} at {n}x{h}x{w}: not fused by the rule")
            else:
                cases.append((name, unit, n, h, w, c, m, rate, False))
    cases += [case + (True,) for case in spatial_band_units()]
    rows = []
    for name, unit, n, h, w, c, m, rate, band in cases:
        wrapper = getattr(fb, name)
        u = random_unit(rng, c, m, device)
        x = torch.tensor(rng.normal(0, 1, (n, h, w, c)), dtype=torch.bfloat16, device=device)
        args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
        got = wrapper(*args, rate=rate).float()
        want = fb.bottleneck_plain(*args, rate=rate).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = float((diff / want.abs().clamp_min(1.0)).max())
        flops = 2 * n * h * w * (c * m + 9 * m * m + m * c)
        nbytes = 2 * x.numel() * 2 + sum(t.numel() * t.element_size() for t in args[1:])
        b = least_ms(nbytes, flops)
        row = dict(wrapper=name, unit=unit, n=n, h=h, w=w, C=c, M=m, rate=rate,
                   spatial_band=band, max_abs_err=float(diff.max()), max_rel_err=rel,
                   ms=time_ms(lambda: wrapper(*args, rate=rate)),
                   device_ms=device_ms(lambda: wrapper(*args, rate=rate)),
                   bound_ms=b[0], bound_by=b[1])
        log(f"kernel eval shape {json.dumps(row)}")
        if not rel < KERNEL_REL_TOL:
            raise AssertionError(f"{name} {unit} at {n}x{h}x{w}: max rel err {rel} >= "
                                 f"{KERNEL_REL_TOL}")
        rows.append(row)
        del x, got, want, args, u
    return rows


def wgrad_inputs(x_shape, cout, k, channels_last, seed=0, pad_rows=None):
    """x (NCHW view of NHWC bf16 memory, images in [-1, 1)) and dy (bf16,
    NHWC memory or, with ``channels_last`` False, NCHW contiguous); with
    ``pad_rows`` (top, bottom) dy has the rows of that padding."""
    gen = torch.Generator("cuda").manual_seed(seed)
    n, c, h, w = x_shape
    x = (torch.rand(x_shape, generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    oh = h // 2 if pad_rows is None else (h + sum(pad_rows) - k) // 2 + 1
    dy = torch.randn((n, cout, oh, w // 2), generator=gen, device="cuda").to(torch.bfloat16)
    if channels_last:
        dy = dy.contiguous(memory_format=torch.channels_last)
    return x, dy


def compare_wgrad(x_shape, cout, k, channels_last, seed=0, pad_rows=None):
    """B6 against its plain version (both with ``pad_rows``): the largest
    error, absolute and relative to the largest |dW|, and the launches of
    the call."""
    from iv2019_tpu_torch.ops import root_wgrad as rw

    x, dy = wgrad_inputs(x_shape, cout, k, channels_last, seed, pad_rows)
    before = rw.root_conv_wgrad.launches
    got = rw.root_conv_wgrad(x, dy, k, 2, pad_rows=pad_rows)
    launches = rw.root_conv_wgrad.launches - before
    want = rw.root_conv_wgrad_reference(x, dy, k, 2, pad_rows=pad_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    return dict(shape=list(x_shape), cout=cout, k=k, channels_last_dy=channels_last,
                pad_rows=pad_rows, max_abs_err=err, rel_err=err / float(want.abs().max()),
                launches=launches)


def wgrad_times(x_shape, cout, k, check, pad_rows=None):
    """B6 at one train shape: two launches bit for bit, and its times
    beside its bound, its plain version's and cuDNN's wgrad of the same conv
    (``torch.nn.grad.conv2d_weight``, the library call). ``pad_rows`` (top,
    bottom) must be equal: cuDNN pads both sides alike."""
    from iv2019_tpu_torch.ops import root_wgrad as rw

    x, dy = wgrad_inputs(x_shape, cout, k, True, pad_rows=pad_rows)
    first = rw.root_conv_wgrad(x, dy, k, 2, pad_rows=pad_rows)
    second = rw.root_conv_wgrad(x, dy, k, 2, pad_rows=pad_rows)
    if not torch.equal(first, second):
        raise AssertionError(f"root_conv_wgrad: two launches on the same inputs differ at {x_shape}")
    del first, second
    n, c = x_shape[:2]
    pixels = n * dy.shape[2] * dy.shape[3]
    nbytes = x.numel() * 2 + dy.numel() * 2 + cout * c * k * k * 4
    b = least_ms(nbytes, 2 * k * k * c * cout * pixels)
    w_shape = (cout, c, k, k)
    pad = (k - 1) // 2
    padding = pad if pad_rows is None else (pad_rows[0], pad)
    row = dict(
        shape=list(x_shape), pad_rows=pad_rows, max_abs_err=check["max_abs_err"],
        rel_err=check["rel_err"],
        ms=time_ms(lambda: rw.root_conv_wgrad(x, dy, k, 2, pad_rows=pad_rows)),
        device_ms=device_ms(lambda: rw.root_conv_wgrad(x, dy, k, 2, pad_rows=pad_rows)),
        bit_equal=True,
        plain_ms=time_ms(lambda: rw.root_conv_wgrad_reference(x, dy, k, 2, pad_rows=pad_rows),
                         runs=5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(x, w_shape, dy, 2, padding)),
        mbytes=nbytes / 1e6, gflop=2 * k * k * c * cout * pixels / 1e9)
    log(f"kernel root_conv_wgrad {x_shape} pad_rows {pad_rows} ms {row['ms']:.4f} "
        f"device {row['device_ms']:.4f} plain {row['plain_ms']:.4f} "
        f"cudnn {row['library_ms']:.4f} bound {_fmt(row['bound_ms'])} ({row['bound_by']})")
    return row


def wgrad_kernel(device):
    """B6 at one real-format microbatch's shape (the kernel line's numbers)
    and at the flagship step's (``train_run_shape``), on the root kernel's
    ragged edge (a 200-pixel row fills no 128-pixel chunk; dy in NCHW
    memory), and on the general kernel (W = 70 is no multiple of 8), dy in
    NHWC and in NCHW memory; with pad rows at WGRAD_BAND_SHAPES (phase 12's
    haloed band, ``spatial_band_shape``, and two edge cases); bit-equality
    and times at the two train shapes and at phase 12's band."""
    x_shape, cout, k = WGRAD_SHAPE
    checks = [compare_wgrad(MICRO_WGRAD_SHAPE[0], cout, k, True),
              compare_wgrad(x_shape, cout, k, True),
              compare_wgrad((2, 3, 20, 400), cout, k, False),
              compare_wgrad((2, 3, 36, 70), cout, k, True),
              compare_wgrad((2, 3, 36, 70), cout, k, False)]
    band_checks = [compare_wgrad(*case[:4], pad_rows=case[4]) for case in WGRAD_BAND_SHAPES]
    for check in checks + band_checks:
        log(f"kernel root_conv_wgrad {json.dumps(check)}")
        if not (check["rel_err"] <= WGRAD_REL_TOL and check["launches"] == 1):
            raise AssertionError(f"root_conv_wgrad departs from its plain version: {check}")
    band_shape, _, _, _, band_pad = WGRAD_BAND_SHAPES[0]
    return dict(name="root_conv_wgrad", route="cuda", source="iv2019_tpu_torch/csrc/root_wgrad.cu",
                replaces=REPLACES["root_conv_wgrad"], launches=None,
                **wgrad_times(MICRO_WGRAD_SHAPE[0], cout, k, checks[0]),
                train_run_shape=wgrad_times(x_shape, cout, k, checks[1]),
                spatial_band_shape=wgrad_times(band_shape, cout, k, band_checks[0], band_pad),
                per_shape=checks + band_checks)


def least_ms(nbytes, ops=0, peak="bf16"):
    """(ms, what bounds it) of a call that moves ``nbytes`` and does
    ``ops`` operations at the card's ``peak`` ("bf16" on the tensor cores,
    "f32" outside them): ``benchmark/counts.py``'s peaks and ``bound_s``,
    "bytes" or "operations". (None, None) on a card that table lacks."""
    card = peaks(torch.cuda.get_device_name())
    if card is None:
        return None, None
    ms = bound_s(nbytes, ops, card[peak], card["bytes"]) * 1e3
    return ms, "bytes" if nbytes / card["bytes"] >= ops / card[peak] else "operations"


def _share(bound_ms, ms):
    return None if bound_ms is None else bound_ms / ms


def _fmt(value, digits=4):
    return "null" if value is None else f"{value:.{digits}f}"


def _scratch(fn):
    """Device memory one call takes besides its outputs (the caching
    allocator hands out a cached block whole when less than 1 MiB of it
    would be left over, so up to 1 MiB per output shows here as rounding),
    and whether it gave the bits of the call before it."""
    first = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    second = fn()
    torch.cuda.synchronize()
    nbytes = (torch.cuda.max_memory_allocated() - before
              - sum(t.numel() * t.element_size() for t in second))
    return nbytes, all(torch.equal(a, b) for a, b in zip(first, second))


def loss_shape(tax, n_pp, n_weak, device):
    """B1 and B2 on n_pp per-pixel and n_weak weak images at 64x128 ->
    512x1024: against their plain versions (also with labels 3 elements off
    16 bytes), two launches bit for bit, the scratch each takes, and their
    times beside their bounds. Returns the fwd and bwd rows' fields."""
    from iv2019_tpu_torch.ops import fused_loss as fl

    in_hw, out_hw = (TRAIN_HW[0] // 8, TRAIN_HW[1] // 8), TRAIN_HW
    args = loss_inputs(np.random.RandomState(3), tax, n_pp, n_weak, in_hw, out_hw, device)
    # cotangents of the sums at the scale of 1 / (labelled pixels)
    g3 = torch.tensor([1 / 1e6, 0.1 / 1e6, 0.1 / 1e6], device=device)
    shape = dict(n_pp=n_pp, n_weak=n_weak, in_hw=list(in_hw), out_hw=list(out_hw))
    checks = []
    for offset in (0, 3):
        check = compare_loss(tax, unaligned_labels(args, offset) if offset else args, out_hw, g3)
        check.update(shape, label_offset=offset)
        log(f"kernel fused_loss {json.dumps(check)}")
        if not loss_ok(check):
            raise AssertionError(f"fused loss departs from its plain version: {check}")
        checks.append(check)
    # B1's per-block partial sums are its only scratch (6 floats a block); the
    # B2 scratch this guards against was N x H x w x C floats, 100 MB at 16
    # images
    fwd_scratch, fwd_equal = _scratch(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw))
    bwd_scratch, bwd_equal = _scratch(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw))
    if not (fwd_equal and bwd_equal):
        raise AssertionError(f"two launches on the same inputs differ at {shape}: "
                             f"B1 {not fwd_equal}, B2 {not bwd_equal}")
    if max(bwd_scratch, fwd_scratch) > 8 * 2**20:
        raise AssertionError(f"fused loss scratch at {shape}: B1 {fwd_scratch}, "
                             f"B2 {bwd_scratch} bytes")
    heads = (tax.num_l1_classes, tax.num_vehicle_classes, tax.num_human_classes)
    plan = fl._bwd_plan(*in_hw, *out_hw, heads)
    fplan = fl._fwd_plan(*in_hw, *out_hw, heads)
    n = n_pp + n_weak
    pixels = n * out_hw[0] * out_hw[1]
    c_tot = sum(heads)
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    logit_bytes = sum(t.numel() * t.element_size() for t in args[:3])
    fwd_bytes, bwd_bytes = in_bytes + 2 * pixels * 4, in_bytes + logit_bytes
    fwd_bound = least_ms(fwd_bytes,
                         pixels * (LOSS_FWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL), "f32")
    bwd_bound = least_ms(bwd_bytes,
                         pixels * (LOSS_BWD_OPS_PER_LOGIT * c_tot + LOSS_OPS_PER_PIXEL), "f32")
    fwd = dict(
        shape, max_abs_err=checks[0]["sums_max_abs_err"],
        ms=time_ms(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)),
        device_ms=device_ms(lambda: fl.fused_loss_fwd(*args, tax=tax, out_hw=out_hw)),
        bit_equal=True, scratch_bytes=fwd_scratch, smem_bytes=fplan.smem_bytes,
        blocks=fplan.slots(n), threads=fplan.threads,
        plain_ms=time_ms(lambda: fl.fused_loss_fwd_plain(*args, tax=tax, out_hw=out_hw), runs=5),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], mbytes=fwd_bytes / 1e6,
        sums_rel_err=checks[0]["sums_rel_err"], decisions_equal=checks[0]["decisions_equal"],
        l1_decisions_equal=checks[0]["l1_decisions_equal"],
        tap_decisions_equal=checks[0]["tap_decisions_equal"])
    bwd = dict(
        shape, max_abs_err=checks[0]["grad_max_abs_err"],
        ms=time_ms(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)),
        device_ms=device_ms(lambda: fl.fused_loss_bwd(g3, *args, tax=tax, out_hw=out_hw)),
        bit_equal=True, scratch_bytes=bwd_scratch, smem_bytes=plan.smem_bytes,
        blocks=len(plan.chunks) * len(plan.bands) * n, threads=plan.threads,
        plain_ms=time_ms(lambda: fl.fused_loss_bwd_plain(g3, *args, tax=tax, out_hw=out_hw),
                         runs=5),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1], mbytes=bwd_bytes / 1e6,
        grad_rel_err=checks[0]["grad_rel_err"])
    for name, r in (("fused_loss_fwd", fwd), ("fused_loss_bwd", bwd)):
        log(f"kernel {name} {n_pp}+{n_weak} images ms {r['ms']:.4f} device {r['device_ms']:.4f} "
            f"plain {r['plain_ms']:.4f} bound {_fmt(r['bound_ms'])} ({r['bound_by']})")
    return fwd, bwd


def train_kernels(device):
    """B1, B2 and B3 against their plain versions at the train paths'
    shapes, Cityscapes heads, one-hot weak labels: B1 and B2 on one
    microbatch of the real-format run (2 + 6 images at 64x128 -> 512x1024,
    the kernel line's numbers) and on the synthetic run's whole batch (4 +
    12 images, ``train_run_shape``), and at ragged edge shapes; the update
    over the full model's parameter count. No single PyTorch call computes
    any of them, so library_ms is null."""
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    tax = get_taxonomy("cityscapes")
    path = loss_shape(tax, MICRO_NB[0], MICRO_NB[1] + MICRO_NB[2], device)
    flagship = loss_shape(tax, TRAIN_NB[0], TRAIN_NB[1] + TRAIN_NB[2], device)
    edge_checks = []
    # the edge shapes, then label views that start 1-3 elements off 16 bytes
    # (B1 and B2 copy label rows from the address rounded down to 16 bytes)
    unaligned = [(shape, offset) for shape in (LOSS_EDGE_SHAPES[0], LOSS_EDGE_SHAPES[2])
                 for offset in (1, 2, 3)]
    for (dataset, e_pp, e_weak, e_in, e_out), offset in [(s, 0) for s in LOSS_EDGE_SHAPES] + unaligned:
        e_tax = get_taxonomy(dataset)
        e_args = loss_inputs(np.random.RandomState(0), e_tax, e_pp, e_weak, e_in, e_out, device)
        if offset:
            e_args = unaligned_labels(e_args, offset)
        e_check = compare_loss(e_tax, e_args, e_out, torch.tensor([0.5, 0.07, 0.11], device=device))
        e_check.update(dataset=dataset, n_pp=e_pp, n_weak=e_weak, in_hw=e_in, out_hw=e_out,
                       label_offset=offset)
        log(f"kernel fused_loss {json.dumps(e_check)}")
        if not loss_ok(e_check):
            raise AssertionError(f"fused loss departs from its plain version: {e_check}")
        edge_checks.append(e_check)
    common = dict(route="cuda", source="iv2019_tpu_torch/csrc/fused_loss.cu", launches=None,
                  library_ms=None, per_shape=edge_checks)
    results = [
        dict(name="fused_loss_fwd", replaces=REPLACES["fused_loss_fwd"], **common, **path[0],
             train_run_shape=flagship[0]),
        dict(name="fused_loss_bwd", replaces=REPLACES["fused_loss_bwd"], **common, **path[1],
             train_run_shape=flagship[1]),
    ]

    num_params = sum(p.numel() for p in HierarchicalSegmentationModel(tax).parameters())
    uargs = update_inputs(num_params, device)
    kw = dict(momentum=0.9, weight_decay=0.00017)
    check = compare_update(uargs, nesterov=False)
    log(f"kernel fused_update n={num_params} {json.dumps(check)}")
    if not update_ok(check):
        raise AssertionError(f"fused update departs from its plain version: {check}")
    upd_bound = least_ms(32 * num_params, UPDATE_OPS_PER_PARAM * num_params, "f32")
    results.append(dict(
        name="fused_update", route="cuda", source="iv2019_tpu_torch/csrc/fused_update.cu",
        replaces=REPLACES["fused_update"], launches=None, max_abs_err=check["vec_max_abs_err"],
        ms=time_ms(lambda: fu.fused_update(*uargs, **kw)),
        plain_ms=time_ms(lambda: fu.fused_update_plain(*uargs, **kw)),
        bound_ms=upd_bound[0], bound_by=upd_bound[1], library_ms=None,
        num_params=num_params, mbytes=32 * num_params / 1e6, vec_rel_err=check["vec_rel_err"],
        reg_rel_err=check["reg_rel_err"]))
    for r in results:
        log(f"kernel {r['name']} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"bound {_fmt(r['bound_ms'])} ({r['bound_by']})")
    return results


_BN_INV = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def tf_name(path):
    """The reference's variable name of a flax path (the inverse of the
    port's name mapping, written independently of it)."""
    col, module, *rest = path

    def cnr(prefix, tail):
        if list(tail) == ["conv", "kernel"]:
            return f"{prefix}/weights"
        return f"{prefix}/BatchNorm/{_BN_INV[tail[-1]]}"

    if module == "feature_extractor/base":
        if rest[0] == "conv1":
            return "feature_extractor/resnet_v1_50/conv1/weights"
        if rest[0] == "conv1_norm":
            return "feature_extractor/resnet_v1_50/conv1/BatchNorm/" + _BN_INV[rest[-1]]
        return cnr(f"feature_extractor/resnet_v1_50/{rest[0]}/bottleneck_v1/{rest[1]}", rest[2:])
    if module.startswith("adaptation_module/"):
        return cnr(f"{module}/bottleneck_v1/{rest[0]}", rest[1:])
    return cnr(module, rest)


@torch.no_grad()
def calibrate_bn(model, images, rng):
    """Randomize every BatchNorm around the statistics of its own input on
    ``images`` (one unfused forward), as trained running statistics are:
    activations stay at unit scale through all 50+ layers."""
    from iv2019_tpu_torch.models.layers import Norm

    def draw(lo, hi, like):
        return torch.tensor(rng.uniform(lo, hi, like.shape), dtype=torch.float32, device=like.device)

    def hook(norm, args):
        x = args[0].float()
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        if norm.norm_type == "batch":
            norm.mean.copy_(mean + 0.1 * var.sqrt() * draw(-1, 1, mean))
            norm.var.copy_(var * draw(0.8, 1.25, var))
        norm.scale.copy_(draw(0.8, 1.2, var))
        norm.bias.copy_(draw(-0.2, 0.2, var))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Norm) and m.norm_type != "none"]
    model(images)
    for h in handles:
        h.remove()


# device-time groups of the fused predict request's profile
PREDICT_GROUPS = (
    ("port kernels B4/B5", ("conv1_kernel", "conv23_kernel")),
    ("conv and gemm", ("xmma", "nvjet", "gemm", "conv", "cutlass")),
    ("copies and casts", ("copy", "convert")),
)
# B6's kernels, the root conv's weight gradient when it runs there
B6_KERNELS = ("wgrad_root_kernel", "wgrad_root_reduce_kernel", "wgrad_general_kernel",
              "wgrad_general_reduce_kernel")
# device-time groups of the train step's profile, first match wins
STEP_GROUPS = (
    ("port kernels B1-B3, B6", ("fwd_walk_kernel", "bwd_walk_kernel", "update_kernel", "sum_partials",
                                *B6_KERNELS)),
    ("batchnorm", ("batchnorm", "batch_norm", "bn_fwd_kernel", "bn_bwd_kernel")),
    ("conv and gemm", ("xmma", "nvjet", "gemm", "conv", "cutlass")),
    ("copies and casts", ("copy", "convert")),
)


def profile_call(fn, label, p50_ms, top=8, groups=(), root_shape=None, host_waits=True):
    """Device time of one call of ``fn``, read as the benchmark reads a
    trace (``benchmark/trace.py``): ``device_busy_ms`` is the union of the
    device events' intervals, so work on two streams at once counts once,
    and ``idle_share`` is 1 - busy over the traced window, from the first
    device event's start to the last one's end. ``p50_ms``: the call's
    unprofiled p50, logged beside them. ``groups``: (name, key substrings)
    to sum device time by name; the rest is "other". ``root_shape``: the
    images' NCHW shape, to report the device time of B6's kernels, the root
    conv's weight gradient (``root_wgrad_ms``; null where cuDNN computes it,
    since a trace by name cannot tell its kernels from the other convs').
    ``host_waits``: also count, in a second call, where the host waits for
    the device (not in a gloo rank, whose every collective does). Returns
    the numbers."""
    timed = {}

    def run(_steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timed["wall_ms"] = (time.perf_counter() - t0) * 1e3

    trace = capture(run, 1)
    wall_ms, busy_ms, window_ms = timed["wall_ms"], trace.busy_s * 1e3, trace.window_s * 1e3
    rows = collections.defaultdict(lambda: [0, 0.0])
    for name, _, dur in trace.device:
        rows[name][0] += 1
        rows[name][1] += dur / 1e3
    syncs = []
    if host_waits:
        # points where the host waits for the device (blocking copies, syncs)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            fn()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    out = dict(wall_ms_profiled=wall_ms, device_busy_ms=busy_ms, kernels=len(trace.device),
               idle_share=1 - busy_ms / window_ms if window_ms else None, host_waits=len(syncs))
    if groups:
        def group(name):
            return next((g for g, keys in groups if any(k in name for k in keys)), "other")

        out["device_ms_by_group"] = {g: trace.device_ms(lambda name, g=g: group(name) == g)
                                     for g in [name for name, _ in groups] + ["other"]}
        out["port_kernels"] = [(name[:60], count, ms) for name, (count, ms) in rows.items()
                               if group(name) == groups[0][0]]
    if root_shape is not None:
        b6_ms = trace.device_ms(lambda name: any(k in name for k in B6_KERNELS))
        out["root_wgrad_ms"] = b6_ms if b6_ms else None
    log(f"profile {label}: wall {wall_ms:.3f} ms under the profiler (p50 {p50_ms:.3f} "
        f"unprofiled), device busy {busy_ms:.3f} ms of a {window_ms:.3f} ms window, "
        f"{out['kernels']} device events, idle share {_fmt(out['idle_share'], 3)}, "
        f"{len(syncs)} host waits for the device")
    for name, (count, ms) in sorted(rows.items(), key=lambda r: -r[1][1])[:top]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return out


def predict_phase(device, requests):
    """The flagship predict path, fused, on seeded weights; returns the
    unfused model's state dict for the CLI phase and the launch counts."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import fused_block as fb
    from iv2019_tpu_torch.train.step import make_predict_step

    h, w, out_hw = 512, 1024, (1024, 2048)
    settings = Settings(device=device.type, height_feature_extractor=h, width_feature_extractor=w)
    rng = np.random.RandomState(1)
    images = [torch.tensor(rng.uniform(-1, 1, (1, h, w, 3)), dtype=torch.float32, device=device)
              for _ in range(requests)]
    unfused = init_model(build_model(settings), torch.Generator().manual_seed(0))
    calibrate_bn(unfused, images[0], rng)
    fused = build_model(settings.replace(fused_block=True))
    fused.load_state_dict(unfused.state_dict())

    predict = make_predict_step(settings.replace(fused_block=True), output_size=out_hw, model=fused)
    predict_unfused = make_predict_step(settings, output_size=out_hw, model=unfused)
    ref = predict_unfused(images[0])  # warm-ups: cuDNN algorithm choice,
    predict(images[0])                # kernel library load
    torch.cuda.synchronize()
    # the two paths take turns, in alternating order, so that a change in
    # the host's load during the run falls on both (the latency is host-bound)
    steps = {"fused": predict, "unfused": predict_unfused}
    lat = {"fused": [], "unfused": []}
    first = None
    fb.fused_bottleneck.launches = 0
    fb.fused_bottleneck_ct.launches = 0
    for i, img in enumerate(images):
        for key in ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused"):
            t0 = time.perf_counter()
            out = steps[key](img)
            torch.cuda.synchronize()
            lat[key].append((time.perf_counter() - t0) * 1e3)
            if key == "fused" and first is None:
                first = out
    launches = {"fused_bottleneck": fb.fused_bottleneck.launches,
                "fused_bottleneck_ct": fb.fused_bottleneck_ct.launches}
    log(f"predict: {requests} requests 1x{h}x{w} -> {out_hw}: launches {launches}")
    want = {"fused_bottleneck": 8 * requests, "fused_bottleneck_ct": 2 * requests}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    tax_widths = {"l1_probabilities": 14, "l2_vehicle_probabilities": 7,
                  "l2_human_probabilities": 3}
    for key, c in tax_widths.items():
        p = first[key]
        if tuple(p.shape) != (1, *out_hw, c) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{key}: shape {tuple(p.shape)} or non-finite values")
        if float((p.sum(-1) - 1).abs().max()) > 1e-3:
            raise AssertionError(f"{key}: probabilities do not sum to 1")
    if tuple(first["decisions"].shape) != (1, *out_hw):
        raise AssertionError(f"decisions shape {tuple(first['decisions'].shape)}")

    # the same weights unfused in bf16, and unfused in f32 (no TF32) as truth
    truth_model = build_model(settings.replace(compute_dtype="float32"))
    truth_model.load_state_dict(unfused.state_dict())
    truth = make_predict_step(settings, output_size=out_hw, model=truth_model)(images[0])

    def compare(a, b):
        d = (a["l1_probabilities"] - b["l1_probabilities"]).abs()
        return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                    decisions_equal=float((a["decisions"] == b["decisions"]).float().mean()))

    stats = {"fused_vs_unfused": compare(first, ref), "fused_vs_f32": compare(first, truth),
             "unfused_vs_f32": compare(ref, truth)}
    for key, values in lat.items():
        ordered = sorted(values)
        stats[f"{key}_p50_ms"] = ordered[len(ordered) // 2]
        stats[f"{key}_p90_ms"] = ordered[min(len(ordered) - 1, int(len(ordered) * 0.9))]
        stats[f"{key}_ms"] = values
    log("predict: " + json.dumps(stats))
    profile = profile_call(lambda: predict(images[0]), "fused", stats["fused_p50_ms"],
                           groups=PREDICT_GROUPS)
    log("predict profile (fused): " + json.dumps(profile))
    profile_call(lambda: predict_unfused(images[0]), "unfused", stats["unfused_p50_ms"])
    fu, ff, uf = stats["fused_vs_unfused"], stats["fused_vs_f32"], stats["unfused_vs_f32"]
    if not fu["mean_abs"] < PREDICT_MEAN_ABS_TOL:
        raise AssertionError(f"fused path departs from the unfused path: {fu}")
    if not (ff["mean_abs"] <= PREDICT_TRUTH_RATIO * uf["mean_abs"]
            and ff["decisions_equal"] >= uf["decisions_equal"] - PREDICT_TRUTH_DECISIONS_SLACK):
        raise AssertionError(f"fused path is further from f32 than the unfused bf16 path: {stats}")
    return unfused.state_dict(), launches


def cli_phase(state, work):
    """The port's predict CLI over two synthetic PNGs and an .npz of the
    predict phase's weights under the reference's variable names, in
    ``work/predict_cli``; returns (log dir, the .npz, the problem definition), which
    phase 13 exports from."""
    import os

    from PIL import Image

    from iv2019_tpu_torch import predict_cli
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.utils.convert import flax_from_state_dict

    params, batch_stats = flax_from_state_dict(state)
    arrays = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        stack = [((col,), tree)]
        while stack:
            path, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((path + (k,), v))
                else:
                    arrays[tf_name(path + (k,))] = v
    problem = os.path.join(os.path.dirname(os.path.abspath(predict_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    lids = set(load_problem_def(problem).cids2lids)
    rng = np.random.RandomState(2)
    tmp = os.path.join(work, "predict_cli")
    npz = os.path.join(tmp, "model.npz")
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    np.savez(npz, **arrays)
    sizes = {"a": (512, 1024), "b": (600, 800)}
    for stem, hw in sizes.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}.png"))
    log_dir = os.path.join(tmp, "log")
    n = predict_cli.main([log_dir, problem, img_dir, "--ckpt_path", npz,
                          "--fused_block", "--export_lids_images"])
    if n != len(sizes):
        raise AssertionError(f"predicted {n} images, expected {len(sizes)}")
    for stem, hw in sizes.items():
        with Image.open(os.path.join(log_dir, "predictions", f"{stem}_result_lids.png")) as im:
            got = np.asarray(im)
        if got.shape != hw or not set(np.unique(got).tolist()) <= lids:
            raise AssertionError(f"{stem}: lids export {got.shape} {np.unique(got)}")
    log(f"cli: {n} images exported at raw size, {len(arrays)} variables in the npz")
    return log_dir, npz, problem


def train_batch(rng, device):
    """The constant synthetic batch of bench.py:80-93 at the flagship sizes,
    on the device: uniform images, per-pixel labels in [0, 20), one-hot weak
    labels of random weak classes."""
    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW

    def img(n):
        return rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)

    eye = np.eye(15, dtype=np.float32)
    batch = {
        "proimages_per_pixel": img(npp),
        "proimages_per_bbox": img(npb),
        "proimages_per_image": img(npi),
        "prolabels_per_pixel": rng.randint(0, 20, (npp, h, w)).astype(np.int32),
        "prolabels_per_bbox": eye[rng.randint(0, 15, (npb, h, w))],
        "prolabels_per_image": eye[rng.randint(0, 15, (npi, h, w))],
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _counts():
    """The launch counts of the train path's kernels."""
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.ops import root_wgrad as rw

    return {"fused_loss_fwd": fl.fused_loss_fwd.launches,
            "fused_loss_bwd": fl.fused_loss_bwd.launches,
            "fused_update": fu.fused_update.launches,
            "root_conv_wgrad": rw.root_conv_wgrad.launches}


def _bn_counts():
    """The launch counts of N1 and N2 (bn_impl="fused")."""
    from iv2019_tpu_torch.ops import fused_bn as fbn

    return {"fused_bn_fwd": fbn.fused_bn_fwd.launches, "fused_bn_bwd": fbn.fused_bn_bwd.launches}


def _reset_bn():
    from iv2019_tpu_torch.ops import fused_bn as fbn

    fbn.fused_bn_fwd.launches = fbn.fused_bn_bwd.launches = 0
    fbn.batch_norm_train.layout_copies = 0


def batch_norm_layers(model) -> int:
    """The model's train-mode batch-norm layers: under the default
    ``bn_impl="fused"`` N1 and N2 launch once each per layer a microbatch."""
    from iv2019_tpu_torch.models.layers import Norm

    return sum(1 for m in model.modules()
               if isinstance(m, Norm) and m.norm_type == "batch" and m.training)


def _reset_counts():
    from iv2019_tpu_torch.ops import fused_loss as fl
    from iv2019_tpu_torch.ops import fused_update as fu
    from iv2019_tpu_torch.ops import root_wgrad as rw

    fl.fused_loss_fwd.launches = fl.fused_loss_bwd.launches = 0
    fu.fused_update.launches = rw.root_conv_wgrad.launches = 0


def _p50_p90(values):
    ordered = sorted(values)
    return ordered[len(ordered) // 2], ordered[min(len(ordered) - 1, int(len(ordered) * 0.9))]


def capture_root_grads(model):
    """Hooks that keep the root conv's bf16 input and the gradient of its
    output from the next backward; returns (dict, remove)."""
    captured = {}
    conv1 = model.get_submodule("feature_extractor/base").conv1

    def hook(module, inputs, output):
        captured["x"] = inputs[0].detach().to(module.dtype)
        output.register_hook(lambda g: captured.__setitem__("dy", g.detach()))

    return captured, conv1.register_forward_hook(hook).remove


def check_step_wgrad(captured):
    """B6's dW of a train step's root conv against cuDNN's for the same x
    and dy: both rounded to bf16 (what each path hands the optimizer), within
    one bf16 ulp of the largest |dW|; and B6's f32 dW against cuDNN's in f32
    (TF32 off) on the same bf16 operands."""
    from iv2019_tpu_torch.ops.root_wgrad import root_conv_wgrad

    x, dy = captured["x"], captured["dy"]
    shape = (dy.shape[1], x.shape[1], 7, 7)
    b6 = root_conv_wgrad(x, dy, 7, 2)
    cudnn = torch.nn.grad.conv2d_weight(x, shape, dy, 2, 3)
    cudnn_f32 = torch.nn.grad.conv2d_weight(x.float(), shape, dy.float(), 2, 3)
    torch.cuda.synchronize()
    top = float(cudnn.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    out = dict(max_abs_dw=top, bf16_ulp=ulp,
               bf16_max_abs_diff=float((b6.to(torch.bfloat16).float() - cudnn.float()).abs().max()),
               f32_rel_err=float((b6 - cudnn_f32).abs().max()) / float(cudnn_f32.abs().max()))
    log("train: root dW, B6 against cuDNN on the same step: " + json.dumps(out))
    if not (out["bf16_max_abs_diff"] <= ulp and out["f32_rel_err"] <= WGRAD_REL_TOL):
        raise AssertionError(f"B6's dW departs from cuDNN's on the train step: {out}")
    return out


def train_phase(device, steps=TRAIN_STEPS):
    """The flagship train step: full-width ResNet-50, the default fused loss
    and fused optimizer, the root conv's wgrad from cuDNN and from B6 in
    turns (two models from the same seeded weights), one warm-up step and
    ``steps`` timed steps each on one constant batch. Returns the device
    busy time of the B6 step."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.ops import root_wgrad as rw
    from iv2019_tpu_torch.ops.fused_bn import batch_norm_train
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    settings = Settings(device=device.type, mode="train", height_feature_extractor=h,
                        width_feature_extractor=w, Nb_per_pixel=npp, Nb_per_bbox=npb,
                        Nb_per_image=npi).finalize()
    if not (settings.fused_loss and settings.fused_optimizer and settings.pallas_update):
        raise AssertionError("the train phase drives the default fused loss and update")
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for flag in (False, True):
        s = settings.replace(root_wgrad_pallas=flag)
        model = init_model(build_model(s), torch.Generator().manual_seed(0))
        opt = FusedSGDM(s, model)
        runs[flag] = dict(opt=opt, state=create_fused_train_state(opt),
                          step=make_train_step(s, fused_opt=opt), history=[], times=[], b6=[])
    batch = train_batch(np.random.RandomState(0), device)
    images = sum(TRAIN_NB)
    log(f"train: {runs[True]['opt'].num_params} parameters, batch {TRAIN_NB} x {h}x{w}, "
        f"{settings.compute_dtype}, two models (root_wgrad_pallas off/on), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with the batch")
    captured, remove_hooks = capture_root_grads(runs[True]["opt"].model)

    _reset_counts()
    _reset_bn()
    for i in range(steps + 1):
        # the two paths take turns, in alternating order
        for flag in (False, True) if i % 2 == 0 else (True, False):
            r = runs[flag]
            before = rw.root_conv_wgrad.launches
            t0 = time.perf_counter()
            r["state"], metrics = r["step"](r["state"], batch)
            torch.cuda.synchronize()
            r["times"].append((time.perf_counter() - t0) * 1e3)
            r["b6"].append(rw.root_conv_wgrad.launches - before)
            r["history"].append({k: float(v) for k, v in metrics.items() if k != "weight_masks"})
            if flag:
                remove_hooks()
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"fused_loss_fwd": 2 * (steps + 1), "fused_loss_bwd": 2 * (steps + 1),
            "fused_update": 2 * (steps + 1), "root_conv_wgrad": steps + 1}
    log(f"train: launches {launches}")
    norms = batch_norm_layers(runs[True]["opt"].model)
    bn_want = dict.fromkeys(_bn_counts(), 2 * (steps + 1) * norms)
    if _bn_counts() != bn_want or batch_norm_train.layout_copies:
        raise AssertionError(f"N1/N2 on the default train step: {_bn_counts()}, expected "
                             f"{bn_want}; {batch_norm_train.layout_copies} layout copies")
    if launches != want or runs[True]["b6"] != [1] * (steps + 1) or any(runs[False]["b6"]):
        raise AssertionError(f"launches {launches}, expected {want}; B6 per step with the flag "
                             f"{runs[True]['b6']}, without {runs[False]['b6']}")
    wgrad_check = check_step_wgrad(captured)
    del captured
    prod = float(np.prod([min(0.9, (1 + t) / (10 + t)) for t in range(steps + 1)]))
    stats = {}
    for flag, r in runs.items():
        key = "b6" if flag else "cudnn"
        history = r["history"]
        for i, m in enumerate(history):
            log(f"train step {i} ({key}): {r['times'][i]:.1f} ms " + json.dumps(m))
        if not all(np.isfinite(v) for m in history for v in m.values()):
            raise AssertionError(f"{key}: non-finite loss or metric")
        if not history[-1]["total"] < history[0]["total"]:
            raise AssertionError(f"{key}: total did not fall on a constant batch: "
                                 f"{history[0]['total']} -> {history[-1]['total']}")
        got = float(r["state"].opt_state.ema_decay_product)
        if abs(got - prod) > 1e-6 * prod:
            raise AssertionError(f"{key}: ema_decay_product {got}, expected {prod}")
        p50, p90 = _p50_p90(r["times"][1:])
        stats[key] = dict(p50_ms=p50, p90_ms=p90, images_per_s=images / p50 * 1e3,
                          warmup_ms=r["times"][0], first_total=history[0]["total"],
                          last_total=history[-1]["total"], ema_decay_product=got)
    stats.update(steps=steps, peak_memory_gib=peak_gib, launches=launches,
                 root_dw_check=wgrad_check)
    log("train: " + json.dumps(stats))
    busy = {}
    for flag, r in runs.items():
        key = "b6" if flag else "cudnn"
        profile = profile_call(lambda: r["step"](r["state"], batch), f"train step ({key})",
                               stats[key]["p50_ms"], top=12, groups=STEP_GROUPS,
                               root_shape=(images, 3, h, w))
        log(f"train profile ({key}): " + json.dumps(profile))
        busy[key] = profile["device_busy_ms"]
    return busy["b6"]


def _waits_by_file(syncs):
    """Host waits for the device (sync debug warnings) by the port's source
    file that triggered them."""
    import collections
    import os

    out = collections.Counter(os.path.basename(w.filename) for w in syncs)
    return dict(out.most_common())


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_run_phase(device, step_busy_ms, tmp):
    """The training run through its entry points (see the module
    docstring), in the directory ``tmp``. ``step_busy_ms``: the device time
    of one B6 train step (train phase profile), logged beside the run's.
    Returns the launch counts of the two SemanticSegmentation runs, those of
    the ``--eval_all_ckpts`` sweep, and the sweep (log dir, problem, the
    evaluate_cli argv, [(step, matrix)])."""
    import os

    from iv2019_tpu_torch import train_cli
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.system import SemanticSegmentation

    problem = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    images = sum(TRAIN_NB)
    log_dir = os.path.join(tmp, "run")
    settings = Settings(
        device=device.type, mode="train", log_dir=log_dir, training_problem_def_path=problem,
        synthetic_data=True, input_seed=0, root_wgrad_pallas=True,
        save_checkpoints_steps=RUN_SAVE_EVERY, save_summaries_steps=RUN_SAVE_EVERY,
        height_feature_extractor=h, width_feature_extractor=w, Nb=npp, Nb_per_pixel=npp,
        Nb_per_bbox=npb, Nb_per_image=npi)
    # the host input alone, one thread, as the loop's prefetcher runs it
    batches = train_input(settings.finalize(), load_problem_def(problem))
    next(batches)
    t0 = time.perf_counter()
    for _ in range(3):
        next(batches)
    input_ms = (time.perf_counter() - t0) / 3 * 1e3
    del batches

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    SemanticSegmentation({"train": train_input}, settings=settings).train(
        max_steps=RUN_STEPS, log_every=1)
    first_s = time.perf_counter() - t0
    # a rerun on the same directory: the user moves settings.txt aside
    os.rename(os.path.join(log_dir, "settings.txt"), os.path.join(log_dir, "settings.0.txt"))
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        SemanticSegmentation({"train": train_input}, settings=settings).train(
            max_steps=RESUME_STEPS, log_every=1)
        resume_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    records = _read_jsonl(os.path.join(log_dir, "train_metrics.jsonl"))
    steps = [r["step"] for r in records]
    ckpts = sorted(int(d) for d in os.listdir(os.path.join(log_dir, "checkpoints")))
    tb = os.listdir(os.path.join(log_dir, "tb"))
    traces = sorted(os.listdir(os.path.join(log_dir, "profile")))
    want = {k: RESUME_STEPS for k in launches}
    log(f"train run: steps {steps}, checkpoints {ckpts}, tb {tb}, traces {traces}, "
        f"launches {launches}")
    problems = []
    if steps != list(range(1, RESUME_STEPS + 1)):
        problems.append(f"metrics steps {steps}: the rerun did not resume at {RUN_STEPS}")
    if not all(np.isfinite(v) for r in records for v in r.values()):
        problems.append("non-finite metrics")
    if ckpts != [3, 6, 8]:
        problems.append(f"checkpoints {ckpts}")
    if len(tb) != 2 or not all(t.startswith("events.out.tfevents.") for t in tb):
        problems.append(f"tb event files {tb}")
    if not set(os.listdir(log_dir)) >= {"settings.txt", "all_code.zip", "train_metrics.jsonl"}:
        problems.append(f"log dir holds {sorted(os.listdir(log_dir))}")
    if launches != want:
        problems.append(f"launches {launches}, expected one of each per step {want}")
    if problems:
        raise AssertionError("train run: " + "; ".join(problems))
    # per-step wall time from the loop's own records (it reads the
    # metrics back every step here); left out: the first step of each
    # run (warm-up) and each step the loop traced with torch.profiler
    # (every RUN_SAVE_EVERY steps, the reference's cadence)
    skipped = {1, RUN_STEPS + 1} | set(range(RUN_SAVE_EVERY + 1, RESUME_STEPS + 1,
                                             RUN_SAVE_EVERY))
    step_ms = [images / r["images_per_sec"] * 1e3 for r in records
               if r["step"] not in skipped]
    p50, p90 = _p50_p90(step_ms)
    stats = dict(steps=RESUME_STEPS, p50_ms=p50, p90_ms=p90, images_per_s=images / p50 * 1e3,
                 input_ms_per_batch=input_ms, device_busy_ms_per_step=step_busy_ms,
                 peak_memory_gib=peak_gib,
                 first_run_s=first_s, resumed_run_s=resume_s,
                 host_waits_resumed_run=_waits_by_file(syncs), launches=launches,
                 last_total=records[-1]["total"])
    log("train run: " + json.dumps(stats))
    torch.cuda.empty_cache()
    eval_launches, sweep = eval_phase(log_dir, problem)
    torch.cuda.empty_cache()

    cli_dir = os.path.join(tmp, "cli")
    _reset_counts()
    cli_state = train_cli.main([cli_dir, "cityscapes", "--synthetic_data", "--height_feature_extractor",
                    "256", "--width_feature_extractor", "512", "--Nb_per_pixel", "1",
                    "--Nb_per_bbox", "2", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
                    "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
                    "--input_seed", "1"])
    cli_launches = _counts()
    cli_records = _read_jsonl(os.path.join(cli_dir, "train_metrics.jsonl"))
    listing = sorted(os.listdir(cli_dir))
    log(f"train cli: {listing}, records {cli_records}, launches {cli_launches}")
    if ([r["step"] for r in cli_records] != [2]
            or not os.path.isfile(os.path.join(cli_dir, "checkpoints", "2", "state.pt"))
            or not {"settings.txt", "all_code.zip", "tb"} <= set(listing)
            or cli_launches != {"fused_loss_fwd": 2, "fused_loss_bwd": 2, "fused_update": 2,
                                "root_conv_wgrad": 0}):
        raise AssertionError(f"train cli: {listing} {cli_records} {cli_launches}")
    predict_from_run_phase(cli_dir, cli_state, problem)
    return launches, eval_launches, sweep


def _fb_counts():
    from iv2019_tpu_torch.ops import fused_block as fb

    return {"fused_bottleneck": fb.fused_bottleneck.launches,
            "fused_bottleneck_ct": fb.fused_bottleneck_ct.launches}


def _reset_fb():
    from iv2019_tpu_torch.ops import fused_block as fb

    fb.fused_bottleneck.launches = fb.fused_bottleneck_ct.launches = 0


def tta_maps(h, w, scales, flip):
    """The trunk feature maps of the TTA members of an h x w image: each
    scale rounded to a multiple of 8 pixels, twice with the flip."""
    maps = [(max(int(round(h * s / 8)) * 8, 8) // 8, max(int(round(w * s / 8)) * 8, 8) // 8)
            for s in scales]
    return [m for m in maps for _ in range(2 if flip else 1)]


def _eval_settings(argv):
    """The settings evaluate_cli builds from ``argv``, finalized."""
    from iv2019_tpu_torch.config import (EVAL, build_argparser, resolve_dataset_name,
                                         resolve_trained_model, settings_from_args)

    args = build_argparser(EVAL).parse_args(argv)
    return resolve_trained_model(resolve_dataset_name(settings_from_args(args, EVAL), None),
                                 argv).finalize()


def _run_evaluate(argv):
    """evaluate_cli.main(argv) with the B4/B5 counts set to 0 just before and
    read just after; the metrics and the run's numbers."""
    from iv2019_tpu_torch import evaluate_cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_fb()
    t0 = time.perf_counter()
    metrics = evaluate_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = _fb_counts()
    torch.cuda.synchronize()
    return metrics, dict(wall_s=wall_s, launches=launches,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         left_allocated_mib=(torch.cuda.memory_allocated() - before) / 2**20)


def _checkpoint_model(settings, log_dir, step):
    """A fresh model of ``settings`` holding checkpoint ``step``'s weights,
    read from its state.pt (not through the restore code)."""
    import os

    from iv2019_tpu_torch.models.model import build_model

    snap = torch.load(os.path.join(log_dir, "checkpoints", str(step), "state.pt"),
                      map_location="cpu", weights_only=True)
    model = build_model(settings)
    model.load_state_dict(snap["model"])
    return model


def _eval_batches(settings, problem):
    from iv2019_tpu_torch.input.cityscapes import synthetic_eval_batches
    from iv2019_tpu_torch.problem.problem_def import load_problem_def

    n = max(settings.Neval // max(settings.Nb, 1), 1)
    for _, b in zip(range(n), synthetic_eval_batches(settings, load_problem_def(problem))):
        yield (torch.as_tensor(b["proimages"], device="cuda"),
               torch.as_tensor(b["prolabels"], device="cuda"))


def _step_matrix(settings, model, problem, one_by_one=False):
    """The untrimmed matrix of make_eval_step over the run's eval batches;
    with ``one_by_one`` an image a step."""
    from iv2019_tpu_torch.train.step import make_eval_step

    step = make_eval_step(settings, model=model)
    cm = 0
    for x, lab in _eval_batches(settings, problem):
        for xi, li in zip(x.split(1), lab.split(1)) if one_by_one else [(x, lab)]:
            cm = cm + step(xi, li)
    return cm.cpu().numpy()


def _common_argmax_matrix(settings, model, problem, flip):
    """By hand on the card: the eval argmax of one forward's common-space
    probabilities (with ``flip``, their mean with the flipped forward's),
    untrimmed, summed over the run's eval batches."""
    from iv2019_tpu_torch.models.model import hierarchical_common_probabilities
    from iv2019_tpu_torch.ops.confusion import confusion_matrix
    from iv2019_tpu_torch.ops.segment_ops import remap_probabilities
    from iv2019_tpu_torch.problem.problem_def import replace_voids
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.train.step import settings_eval_map

    tax = get_taxonomy(settings.per_pixel_dataset_name)
    tcids2ecids = replace_voids(settings_eval_map(settings))
    cm = 0
    for x, lab in _eval_batches(settings, problem):
        with torch.inference_mode():
            p = hierarchical_common_probabilities(model(x), tax)
            if flip:
                pf = hierarchical_common_probabilities(model(torch.flip(x, dims=(2,))), tax)
                p = (p + torch.flip(pf, dims=(2,))) / 2
            decs = torch.argmax(remap_probabilities(p, tcids2ecids), -1).int()
            cm = cm + confusion_matrix(lab, decs, max(tcids2ecids) + 1)
    return cm.cpu().numpy()


def _eval_step_numbers(argv, log_dir, problem, label, runs):
    """ms per image (p50 over ``runs`` steps on one device batch), device
    busy ms and idle share of one step (profile_call), and the step's peak
    memory beyond what was allocated before it."""
    from iv2019_tpu_torch.train.step import make_eval_step

    settings = _eval_settings(argv)
    model = _checkpoint_model(settings, log_dir, 8)
    step = make_eval_step(settings, model=model)
    x, lab = next(_eval_batches(settings, problem))
    step(x, lab)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step(x, lab)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = _p50_p90(times)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(x, lab)
    torch.cuda.synchronize()
    peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    profile = profile_call(lambda: step(x, lab), f"eval step ({label})", p50,
                           groups=PREDICT_GROUPS)
    n = x.shape[0]
    out = dict(images_per_step=n, input_hw=list(x.shape[1:3]), step_p50_ms=p50, step_p90_ms=p90,
               ms_per_image=p50 / n, images_per_s=n / p50 * 1e3,
               device_busy_ms=profile["device_busy_ms"], idle_share=profile["idle_share"],
               kernels=profile["kernels"], device_ms_by_group=profile["device_ms_by_group"],
               host_waits=profile["host_waits"], step_peak_gib=peak_gib)
    log(f"eval step ({label}): " + json.dumps(out))
    return out


def eval_phase(log_dir, problem):
    """evaluate_cli on the full-width run's checkpoints 3, 6 and 8 (see the
    module docstring); every check fails the run on its own."""
    import os

    hw = ["--height_feature_extractor", "512", "--width_feature_extractor", "1024"]
    base = [log_dir, str(EVAL_NEVAL), problem, "--synthetic_data", "--fused_block", *hw]
    problems = []
    out = {}

    # the --eval_all_ckpts sweep, and checkpoint 8 alone for the peak memory
    sweep_argv = base + ["--Nb", str(EVAL_NB), "--eval_all_ckpts"]
    metrics, run = _run_evaluate(sweep_argv)
    _, alone = _run_evaluate(base + ["--Nb", str(EVAL_NB), "--ckpt_path", "8"])
    settings = _eval_settings(sweep_argv)
    steps = [m["global_step"] for m in metrics]
    batches = EVAL_NEVAL // EVAL_NB
    want = add_launches({}, EVAL_NB, 64, 128, forwards=len(steps) * batches)
    pixels = EVAL_NEVAL * 512 * 1024
    matrices = []
    for m in metrics:
        full = _step_matrix(settings, _checkpoint_model(settings, log_dir, m["global_step"]),
                            problem)
        labels = sum(int(((lab >= 0) & (lab < full.shape[0])).sum())
                     for _, lab in _eval_batches(settings, problem))
        diff = int(np.abs(m["confusion_matrix"] - full[:-1, :-1]).sum())
        matrices.append(dict(step=m["global_step"], mean_iou=float(m["mean_iou"]),
                             diff_entries=diff, fresh_sum=int(full.sum()), labels=labels))
        if full.sum() != labels or diff > 2 * EVAL_CM_TOL * pixels:
            problems.append(f"checkpoint {m['global_step']}: matrix sums to {full.sum()} of "
                            f"{labels} labels, differs from a fresh model by {diff} entries")
    eval_dir = os.path.join(log_dir, "eval_00")
    if steps != [3, 6, 8]:
        problems.append(f"--eval_all_ckpts evaluated steps {steps}")
    if not all(os.path.isfile(os.path.join(eval_dir, f)) for f in (
            "settings.txt", "all_metrics.txt", "all_metrics.p")):
        problems.append(f"eval_00 holds {sorted(os.listdir(eval_dir))}")
    if run["launches"] != want:
        problems.append(f"sweep launches {run['launches']}, expected {want}")
    if run["peak_gib"] - alone["peak_gib"] > EVAL_PEAK_GROWTH_GIB:
        problems.append(f"peak memory of three restores {run['peak_gib']:.3f} GiB against "
                        f"{alone['peak_gib']:.3f} GiB for one")
    out["eval_all_ckpts"] = dict(run, steps=steps, matrices=matrices, one_checkpoint=alone)
    sweep = dict(log_dir=log_dir, problem=problem, argv=sweep_argv,
                 matrices=[(m["global_step"], m["confusion_matrix"]) for m in metrics])

    # test-time augmentation: 6 forwards a batch
    tta_argv = [log_dir, "4", problem, "--synthetic_data", "--fused_block", *hw, "--Nb", "1",
                "--ckpt_path", "8", "--eval_scales", *map(str, TTA_SCALES), "--eval_flip"]
    metrics, run = _run_evaluate(tta_argv)
    want = {}
    for h, w in tta_maps(512, 1024, TTA_SCALES, True):
        add_launches(want, 1, h, w, forwards=4)
    if run["launches"] != want:
        problems.append(f"TTA launches {run['launches']}, expected {want}")
    out["tta"] = dict(run, mean_iou=float(metrics[0]["mean_iou"]))

    # the flip alone against the by-hand mean of two forwards
    flip_argv = [log_dir, "4", problem, "--synthetic_data", "--fused_block", *hw, "--Nb", "1",
                 "--ckpt_path", "8", "--eval_scales", "1.0", "--eval_flip"]
    metrics, run = _run_evaluate(flip_argv)
    flip_settings = _eval_settings(flip_argv)
    full = _common_argmax_matrix(flip_settings, _checkpoint_model(flip_settings, log_dir, 8),
                                 problem, flip=True)
    diff = int(np.abs(metrics[0]["confusion_matrix"] - full[:-1, :-1]).sum())
    if diff > 2 * EVAL_CM_TOL * 4 * 512 * 1024 or run["launches"] != add_launches({}, 1, 64, 128, 8):
        problems.append(f"flip: {diff} entries off the by-hand mean, launches {run['launches']}")
    out["flip"] = dict(run, diff_entries=diff)

    # sliding windows over 1024x2048, uniform and gaussian
    win_argv = [log_dir, "2", problem, "--synthetic_data", "--fused_block", *hw, "--Nb", "1",
                "--ckpt_path", "8", "--eval_size", *map(str, WINDOW_EVAL_SIZE), "--sliding_window"]
    for blend in ("uniform", "gaussian"):
        metrics, run = _run_evaluate(win_argv + ["--window_blend", blend])
        want = add_launches({}, 1, 64, 128, forwards=2 * 9)
        if run["launches"] != want:
            problems.append(f"windows ({blend}) launches {run['launches']}, expected {want}")
        out[f"windows_{blend}"] = dict(run, mean_iou=float(metrics[0]["mean_iou"]))

    # one window the size of the image: one forward's common-space argmax
    one_argv = [log_dir, "2", problem, "--synthetic_data", "--fused_block", *hw, "--Nb", "1",
                "--ckpt_path", "8", "--eval_size", "512", "1024", "--sliding_window"]
    metrics, run = _run_evaluate(one_argv)
    one_settings = _eval_settings(one_argv)
    model = _checkpoint_model(one_settings, log_dir, 8)
    full = _common_argmax_matrix(one_settings, model, problem, flip=False)
    plain = _step_matrix(_eval_settings(one_argv[:-4]), model, problem)
    diff = int(np.abs(metrics[0]["confusion_matrix"] - full[:-1, :-1]).sum())
    if diff > 2 * EVAL_CM_TOL * 2 * 512 * 1024:
        problems.append(f"one window: {diff} entries off one forward's common-space argmax")
    # the plain step's fused decisions: not expected equal (near-ties of the heads)
    out["one_window"] = dict(run, diff_entries=diff, diff_entries_plain_step=int(
        np.abs(metrics[0]["confusion_matrix"] - plain[:-1, :-1]).sum()))
    del model
    log("eval from the train run: " + json.dumps(out))
    if problems:
        raise AssertionError("eval: " + "; ".join(problems))

    # per image, device busy and idle share of one step of each kind
    torch.cuda.empty_cache()
    steps_out = {
        "plain": _eval_step_numbers(sweep_argv[:-1] + ["--ckpt_path", "8"], log_dir, problem,
                                    "plain", 10),
        "tta": _eval_step_numbers(tta_argv, log_dir, problem, "TTA", 5),
        "windows": _eval_step_numbers(win_argv, log_dir, problem, "windows", 5),
    }
    log("eval steps: " + json.dumps(steps_out))
    return out["eval_all_ckpts"]["launches"], sweep


def predict_from_run_phase(log_dir, state, problem, device="cuda"):
    """``predict_cli`` on the checkpoint ``train_cli`` wrote in ``log_dir``
    (256x512, step 2), with and without ``--restore_emas``: the exports, and
    the predictions against those of a model holding the run's final
    weights (or their unbiased EMA shadows, taken from the optimizer state
    and the checkpoint's layout, not through the restore code)."""
    import os

    from PIL import Image

    from iv2019_tpu_torch import predict_cli
    from iv2019_tpu_torch.config import (PREDICT, build_argparser, resolve_dataset_name,
                                         resolve_trained_model, settings_from_args)
    from iv2019_tpu_torch.input.predict_input import predict_input
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.system import SemanticSegmentation

    img_dir = os.path.join(log_dir, "images")
    os.makedirs(img_dir)
    sizes = {"a": (256, 512), "b": (300, 400)}
    rng = np.random.RandomState(4)
    for stem, hw in sizes.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}.png"))
    lids = set(load_problem_def(problem).cids2lids)
    opt = state.opt_state
    raw = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    layout = torch.load(os.path.join(log_dir, "checkpoints", "2", "state.pt"),
                        weights_only=True)["layout"]
    ema = dict(raw)
    flat = opt.ema_biased / (1.0 - opt.ema_decay_product)
    for name, shape, stride, offset in layout:
        ema[name] = torch.as_strided(flat, shape, stride, offset)
    out = {}
    for flags, weights in (((), raw), (("--restore_emas",), ema)):
        results = os.path.join(log_dir, "predictions" + "".join(flags))
        argv = [log_dir, problem, img_dir, "--height_feature_extractor", "256",
                "--width_feature_extractor", "512", "--fused_block", "--export_lids_images",
                "--results_dir", results, "--device", str(device), *flags]
        n = predict_cli.main(argv)
        for stem, hw in sizes.items():
            with Image.open(os.path.join(results, f"{stem}_result_lids.png")) as im:
                got = np.asarray(im)
            if got.shape != hw or not set(np.unique(got).tolist()) <= lids:
                raise AssertionError(f"predict from the run {flags}: {stem} {got.shape}")
        # the same images through SemanticSegmentation.predict (the CLI's
        # path) and through a model that holds the weights
        args = build_argparser(PREDICT).parse_args(argv)
        settings = resolve_trained_model(resolve_dataset_name(
            settings_from_args(args, PREDICT, predict_keys=predict_cli.PREDICT_KEYS), None), argv)
        system = SemanticSegmentation({"predict": lambda s, _pd: predict_input(s)},
                                      model_fn=build_model, settings=settings)
        got = list(system.predict())
        model = build_model(system.settings)
        model.load_state_dict(weights)
        want = list(predict_cli.predict(system.settings, model))
        diff = max(float(np.abs(g[k] - w[k]).max()) for g, w in zip(got, want)
                   for k in ("l1_probabilities", "l2_vehicle_probabilities"))
        same = min(float((g["decisions"] == w["decisions"]).mean()) for g, w in zip(got, want))
        out["restore_emas" if flags else "weights"] = dict(
            images=n, max_abs_prob_diff=diff, decisions_equal=same)
        if n != len(sizes) or len(got) != len(sizes) or diff > 1e-6 or same < 0.9999:
            raise AssertionError(f"predict from the run {flags}: {n} images, "
                                 f"probabilities differ by {diff}, decisions equal {same}")
    # the ensembles: TTA at 256x512, and 3 x 3 windows of 256x512 over the
    # images resized to 512x1024; each run's launches by the dispatch rule
    ensembles = {"tta": ["--eval_scales", *map(str, TTA_SCALES), "--eval_flip"],
                 "windows": ["--eval_size", "512", "1024", "--sliding_window"]}
    for name, flags in ensembles.items():
        results = os.path.join(log_dir, f"predictions_{name}")
        argv = [log_dir, problem, img_dir, "--height_feature_extractor", "256",
                "--width_feature_extractor", "512", "--fused_block", "--export_lids_images",
                "--results_dir", results, "--device", str(device), *flags]
        _reset_fb()
        n = predict_cli.main(argv)
        launches = _fb_counts()
        want = {}
        maps = tta_maps(256, 512, TTA_SCALES, True) if name == "tta" else [(32, 64)] * 9
        for h, w in maps:
            add_launches(want, 1, h, w, forwards=len(sizes))
        for stem, hw in sizes.items():
            with Image.open(os.path.join(results, f"{stem}_result_lids.png")) as im:
                got = np.asarray(im)
            if got.shape != hw or not set(np.unique(got).tolist()) <= lids:
                raise AssertionError(f"predict {name}: {stem} {got.shape} {np.unique(got)}")
        out[name] = dict(images=n, launches=launches)
        if n != len(sizes) or launches != want:
            raise AssertionError(f"predict {name}: {n} images, launches {launches}, "
                                 f"expected {want}")
    log("predict from the train run's checkpoint: " + json.dumps(out))
    return out


def _batch_bytes(batch):
    return sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray))


def _real_settings(data, problem, device, log_dir="", **kw):
    """The flagship train settings on the scenes' files with the slice's
    four options and B6."""
    from iv2019_tpu_torch.config import Settings

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    base = dict(
        device=device.type, mode="train", log_dir=log_dir, training_problem_def_path=problem,
        tfrecords_path_per_pixel=data["tfrecords_train"],
        openimages_image_dir=data["openimages_image_dir"],
        openimages_bboxes_path=data["openimages_bboxes_path"],
        openimages_image_labels_path=data["openimages_image_labels_path"], input_seed=0,
        rasterize_on_device=True, compact_image_labels=True, augmentations=REAL_AUGMENTATIONS,
        grad_accum_steps=REAL_ACCUM, root_wgrad_pallas=True, height_feature_extractor=h,
        width_feature_extractor=w, Nb=npp, Nb_per_pixel=npp, Nb_per_bbox=npb, Nb_per_image=npi)
    return Settings(**dict(base, **kw)).finalize()


def host_input_turns(data, problem, device):
    """ms per batch of the host input alone (one consumer thread, as the
    loop's prefetcher runs it) with dense host labels and with
    rasterize_on_device + compact_image_labels, in turns; bytes a batch
    ships to the card."""
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.problem.problem_def import load_problem_def

    pd = load_problem_def(problem)
    configs = {"dense": dict(rasterize_on_device=False, compact_image_labels=False),
               "on_device": dict(rasterize_on_device=True, compact_image_labels=True)}
    iters = {k: train_input(_real_settings(data, problem, device, **kw), pd)
             for k, kw in configs.items()}
    out = {k: dict(ms=[], bytes=_batch_bytes(next(it))) for k, it in iters.items()}
    for turn in range(2):
        for k in ("dense", "on_device") if turn == 0 else ("on_device", "dense"):
            t0 = time.perf_counter()
            for _ in range(REAL_INPUT_BATCHES):
                next(iters[k])
            out[k]["ms"].append((time.perf_counter() - t0) / REAL_INPUT_BATCHES * 1e3)
    for it in iters.values():
        it.close()
    stats = {k: dict(ms_per_batch=float(np.mean(v["ms"])), ms_per_turn=v["ms"],
                     mb_per_batch=v["bytes"] / 1e6) for k, v in out.items()}
    log("real-format host input: " + json.dumps(stats))
    return stats


def decode_turns(data):
    """Decode + u8 -> f32 + resize of one weak JPEG (512x1024) to 256x512
    (the train CLI's size: at the run's own 512x1024 both rules skip the
    resize), native helpers against PIL + numpy, in turns; fails if g++
    exists and fastops did not build."""
    import os
    import shutil

    from PIL import Image

    from iv2019_tpu_torch import native
    from iv2019_tpu_torch.input.core import _INV_255, decode_image
    from iv2019_tpu_torch.ops.resize import resize_bilinear

    built = native.available()
    native.decode_available()
    status = native.status()
    log(f"native helpers: {status}; g++ {shutil.which('g++')}")
    if not built:
        if shutil.which("g++"):
            raise AssertionError(f"g++ is here but fastops did not build: {status}")
        return dict(native_status=status)
    image_dir = data["openimages_image_dir"]
    names = sorted(os.listdir(image_dir))[:REAL_DECODE_IMAGES]
    hw = (TRAIN_HW[0] // 2, TRAIN_HW[1] // 2)

    def with_native(buf):
        raw = decode_image(buf, force_rgb=True)
        return native.resize_bilinear_f32(native.u8_to_f32(raw), hw)

    def with_numpy(buf):
        with Image.open(io.BytesIO(buf)) as img:
            raw = np.asarray(img.convert("RGB"))
        return resize_bilinear(raw.astype(np.float32) * _INV_255, hw)

    times = {"native": [], "numpy": []}
    worst = 0.0
    for i, name in enumerate(names):
        with open(os.path.join(image_dir, name), "rb") as f:
            buf = f.read()
        results = {}
        for key in ("native", "numpy") if i % 2 == 0 else ("numpy", "native"):
            fn = with_native if key == "native" else with_numpy
            t0 = time.perf_counter()
            results[key] = fn(buf)
            times[key].append((time.perf_counter() - t0) * 1e3)
        worst = max(worst, float(np.abs(results["native"] - results["numpy"]).max()))
    stats = {k: dict(p50_ms=_p50_p90(v)[0], mean_ms=float(np.mean(v))) for k, v in times.items()}
    stats.update(native_status=status, images=len(names), max_abs_diff=worst)
    log("real-format decode + resize per image: " + json.dumps(stats))
    if worst > 1e-6:
        raise AssertionError(f"native decode + resize departs from PIL + numpy by {worst}")
    return stats


def _device_batch(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def rasterize_check(batch):
    """The device rasterizer on the run's boxes: bit-equal on two launches
    and to its CPU run."""
    from iv2019_tpu_torch.ops.rasterize import rasterize_bboxes

    h, w = TRAIN_HW
    cids, coords = batch["bbox_cids"], batch["bbox_coords"]
    a = rasterize_bboxes(cids, coords, h, w)
    b = rasterize_bboxes(cids, coords, h, w)
    cpu = rasterize_bboxes(cids.cpu(), coords.cpu(), h, w)
    torch.cuda.synchronize()
    ms = time_ms(lambda: rasterize_bboxes(cids, coords, h, w), runs=10)
    out = dict(boxes=int((cids >= 0).sum()), relaunch_equal=bool(torch.equal(a, b)),
               cpu_equal=bool(torch.equal(a.cpu(), cpu)), ms=ms, shape=list(a.shape))
    log("real-format rasterizer: " + json.dumps(out))
    if not (out["relaunch_equal"] and out["cpu_equal"]):
        raise AssertionError(f"device rasterizer: {out}")
    return out


def augment_checks(batch):
    """Each augmentation's apply on the card against the same apply on the
    CPU with the same draws, at the run's per-pixel shapes; the color and
    blur branches each forced in turn."""
    from iv2019_tpu_torch.ops import augment
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    unlabeled = len(get_taxonomy("cityscapes").per_pixel_cids2l1_cids) - 1
    images, labels = batch["proimages_per_pixel"], batch["prolabels_per_pixel"]
    n, h, w = images.shape[:3]
    base = augment.draw_augmentations(0, 0, REAL_AUGMENTATIONS, n, h, w)
    cases = [("color", dict(col_r=k)) for k in range(4)] + [
        ("blur", dict(blu_r=0)), ("blur", dict(blu_r=1)), ("flip", {}), ("scale", {})]
    results = []
    for name, forced in cases:
        draws = dict(base, **forced)
        t0 = time.perf_counter()
        gi, gl = augment.apply_augmentations(images, labels, (name,), draws, unlabeled)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        ci, cl = augment.apply_augmentations(images.cpu(), labels.cpu(), (name,), draws,
                                             unlabeled)
        err = float((gi.cpu() - ci).abs().max())
        same = bool(torch.equal(gl.cpu(), cl))
        results.append(dict(name=name, **forced, max_abs_err=err, labels_equal=same,
                            card_ms=card_ms))
    log("real-format augmentations, card against CPU: " + json.dumps(results))
    bad = [r for r in results if not (r["labels_equal"] and r["max_abs_err"] <= AUGMENT_IMAGE_ATOL)]
    if bad:
        raise AssertionError(f"augmentations on the card depart from the CPU: {bad}")
    return results


def halves_check(data, problem, batch, device):
    """accum=2 steps against accum=1 steps from the same weights, without
    augmentations (their draws differ per microbatch): on a batch of two
    identical halves against one accum=1 step on that half, and on the
    run's batch against the mean of two accum=1 steps, one on each of its
    halves (a step that trained on one microbatch alone, or on one twice,
    passes the first and fails the second). BatchNorm normalizes per
    microbatch, so each half is the same computation in both: the averaged
    gradients and the losses."""
    from iv2019_tpu_torch.system import build_initialized_model
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    keys = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation")
    sizes = {f"Nb_per_{k}": n for k, n in zip(("pixel", "bbox", "image"), MICRO_NB)}

    def step(accum, b):
        kw = {} if accum == REAL_ACCUM else dict(sizes, Nb=sizes["Nb_per_pixel"])
        s = _real_settings(data, problem, device, augmentations=(), grad_accum_steps=accum, **kw)
        model = build_initialized_model(s)
        opt = FusedSGDM(s, model)
        _, m = make_train_step(s, fused_opt=opt)(create_fused_train_state(opt), b)
        torch.cuda.synchronize()
        out = opt.grads.detach().clone(), {k: float(m[k]) for k in keys}
        del model, opt
        torch.cuda.empty_cache()
        return out

    halves = [{k: v.chunk(REAL_ACCUM)[i] for k, v in batch.items()} for i in range(REAL_ACCUM)]
    singles = [step(1, half) for half in halves]
    # the mean as the step takes it: the microbatches' gradients summed in
    # order, divided once
    mean_grad = sum(g for g, _ in singles) / REAL_ACCUM
    mean_losses = {k: sum(m[k] for _, m in singles) / REAL_ACCUM for k in keys}
    cases = {
        "identical_halves": (step(REAL_ACCUM, {k: torch.cat([v] * REAL_ACCUM)
                                               for k, v in halves[0].items()}), singles[0]),
        "two_halves": (step(REAL_ACCUM, batch), (mean_grad, mean_losses)),
    }
    res = {}
    for name, ((g2, m2), (g1, m1)) in cases.items():
        top = float(g1.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        res[name] = dict(
            max_abs_grad=top, bf16_ulp=ulp, grad_max_abs_diff=float((g1 - g2).abs().max()),
            loss_rel_err={k: abs(m1[k] - m2[k]) / max(abs(m1[k]), 1e-12) for k in keys})
    # a step on the first half alone would be this far from the mean
    res["first_half_from_mean_max_abs_diff"] = float((singles[0][0] - mean_grad).abs().max())
    log("real-format accum=2 against accum=1 on each half: " + json.dumps(res))
    bad = [name for name in cases
           if not (res[name]["grad_max_abs_diff"] <= res[name]["bf16_ulp"]
                   and max(res[name]["loss_rel_err"].values()) <= HALVES_LOSS_REL_TOL)]
    if bad or res["first_half_from_mean_max_abs_diff"] <= res["two_halves"]["bf16_ulp"]:
        raise AssertionError(f"accum=2 departs from accum=1 on its halves ({bad}), or the "
                             f"two halves do not tell microbatches apart: {res}")
    return res


def real_format_phase(device):
    """The training run on real-format input (see the module docstring).
    Returns the run's launch counts."""
    import os
    import tempfile

    from iv2019_tpu_torch import train_cli
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.problem.problem_def import load_problem_def
    from iv2019_tpu_torch.system import SemanticSegmentation, build_initialized_model
    from iv2019_tpu_torch.tools.synthetic_scenes import generate
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    problem = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    (h, w), images = TRAIN_HW, sum(TRAIN_NB)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = generate(os.path.join(tmp, "data"), n_train=REAL_TRAIN_IMAGES, n_val=0,
                        n_weak=REAL_WEAK_IMAGES, h=h, w=w)
        log(f"real-format data: {REAL_TRAIN_IMAGES} per-pixel and {REAL_WEAK_IMAGES} weak "
            f"scenes at {h}x{w} in {time.perf_counter() - t0:.1f} s")
        decode = decode_turns(data)
        host = host_input_turns(data, problem, device)

        # the run through its entry point, with the four options and B6
        settings = _real_settings(data, problem, device, os.path.join(tmp, "run"),
                                  save_checkpoints_steps=REAL_STEPS,
                                  save_summaries_steps=REAL_STEPS)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        state = SemanticSegmentation({"train": train_input}, settings=settings).train(
            max_steps=REAL_STEPS, log_every=1)
        run_s = time.perf_counter() - t0
        launches = _counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        records = _read_jsonl(os.path.join(settings.log_dir, "train_metrics.jsonl"))
        want = {"fused_loss_fwd": REAL_ACCUM * REAL_STEPS, "fused_loss_bwd": REAL_ACCUM * REAL_STEPS,
                "fused_update": REAL_STEPS, "root_conv_wgrad": REAL_ACCUM * REAL_STEPS}
        log(f"real-format run: launches {launches}, steps {[r['step'] for r in records]}")
        if launches != want:
            raise AssertionError(f"real-format run: launches {launches}, expected {want}")
        if ([r["step"] for r in records] != list(range(1, REAL_STEPS + 1))
                or not all(np.isfinite(v) for r in records for v in r.values())
                or int(state.step) != REAL_STEPS
                or not os.path.isfile(os.path.join(settings.log_dir, "checkpoints",
                                                   str(REAL_STEPS), "state.pt"))):
            raise AssertionError(f"real-format run: records {records}")
        del state
        torch.cuda.empty_cache()

        # the same step on one batch of the run's input: steady step time,
        # device busy and idle share, then the card checks
        host_batch = next(train_input(settings, load_problem_def(problem)))
        batch = _device_batch(host_batch, device)
        model = build_initialized_model(settings)
        opt = FusedSGDM(settings, model)
        holder = {"state": create_fused_train_state(opt)}
        step = make_train_step(settings, fused_opt=opt)

        def one_step():
            holder["state"], metrics = step(holder["state"], batch)
            return metrics

        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        const_p50, const_p90 = _p50_p90(times[1:])
        profile = profile_call(one_step, "real-format accum=2 step", const_p50, top=12,
                               groups=STEP_GROUPS)
        log("real-format step profile: " + json.dumps(profile))
        del model, opt, holder, step
        torch.cuda.empty_cache()
        raster = rasterize_check(batch)
        augment = augment_checks(batch)
        halves = halves_check(data, problem, batch, device)

        step_ms = [images / r["images_per_sec"] * 1e3 for r in records if r["step"] > 1]
        p50, p90 = _p50_p90(step_ms)
        stats = dict(steps=REAL_STEPS, grad_accum_steps=REAL_ACCUM, p50_ms=p50, p90_ms=p90,
                     images_per_s=images / p50 * 1e3,
                     host_input_ms_per_batch=host["on_device"]["ms_per_batch"],
                     dense_host_input_ms_per_batch=host["dense"]["ms_per_batch"],
                     device_busy_ms_per_step=profile["device_busy_ms"],
                     idle_share=profile["idle_share"],
                     constant_batch_p50_ms=const_p50, constant_batch_p90_ms=const_p90,
                     peak_memory_gib=peak_gib, run_s=run_s, launches=launches,
                     last_total=records[-1]["total"])
        log("real-format run: " + json.dumps(stats))

        # train_cli at 256x512 on the same files, 2 steps
        cli_dir = os.path.join(tmp, "cli")
        _reset_counts()
        train_cli.main([cli_dir, "cityscapes", "--tfrecords_path_per_pixel",
                        data["tfrecords_train"], "--openimages_image_dir",
                        data["openimages_image_dir"], "--openimages_bboxes_path",
                        data["openimages_bboxes_path"], "--openimages_image_labels_path",
                        data["openimages_image_labels_path"], "--height_feature_extractor", "256",
                        "--width_feature_extractor", "512", "--Ntrain", "8", "--Ne", "1",
                        "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
                        "--input_seed", "1", "--augmentations", ",".join(REAL_AUGMENTATIONS),
                        "--grad_accum_steps", str(REAL_ACCUM)])
        cli_launches = _counts()
        cli_records = _read_jsonl(os.path.join(cli_dir, "train_metrics.jsonl"))
        log(f"real-format train cli: records {cli_records}, launches {cli_launches}")
        if ([r["step"] for r in cli_records] != [2]
                or not all(np.isfinite(v) for v in cli_records[0].values())
                or cli_launches != {"fused_loss_fwd": 4, "fused_loss_bwd": 4, "fused_update": 2,
                                    "root_conv_wgrad": 0}):
            raise AssertionError(f"real-format train cli: {cli_records} {cli_launches}")
    return launches, dict(stats, decode=decode, host_input=host, rasterizer=raster,
                          augmentations=augment, halves=halves)


# the variants phase: (name, dataset, Settings fields), each at full width
VARIANTS = [
    ("psp", "cityscapes", dict(psp_module=True)),
    ("psp_vistas", "vistas", dict(psp_module=True)),
    ("fov", "cityscapes", dict(fov_expansion_kernel_size=3, fov_expansion_kernel_rate=2)),
    ("hybrid", "cityscapes", dict(upsampling_method="hybrid")),
    ("group_norm", "cityscapes", dict(norm_layer="group")),
    ("fused_heads", "cityscapes", dict(fuse_adaptation=True)),
    # train-mode BatchNorm as N1/N2 (its own runs: bn_fused_variant)
    ("bn_fused", "cityscapes", dict(bn_impl="fused")),
]
# predict requests and train steps of each variant; the optax run's steps
# and its resume; train steps of the optax-against-fused and remat checks
VARIANT_REQUESTS, VARIANT_STEPS = 2, 2
OPTAX_RUN_STEPS, OPTAX_RESUME_STEPS, OPTAX_SAVE_EVERY = 4, 6, 2
COMPARE_STEPS, REMAT_STEPS = 3, 2
# the optax path against the fused optimizer from the same weights on one
# batch: the same forward, so the step-1 losses agree to the last bits
# (reg is a sum of 26M squares in f32 here and in f64 in B3)
COMPARE_LOSS_REL_TOL, COMPARE_REG_REL_TOL = 1e-6, 1e-5


def _train_settings(device, **kw):
    from iv2019_tpu_torch.config import Settings

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    return Settings(device=device.type, mode="train", height_feature_extractor=h,
                    width_feature_extractor=w, Nb_per_pixel=npp, Nb_per_bbox=npb,
                    Nb_per_image=npi, **kw).finalize()


def _fused_train(settings):
    """(model, step fn, holder of the state) of the fused optimizer from
    seeded weights."""
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    opt = FusedSGDM(settings, model)
    return model, make_train_step(settings, fused_opt=opt), {"state": create_fused_train_state(opt)}


def _optax_train(settings):
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.optimizer import make_optimizer
    from iv2019_tpu_torch.train.state import create_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    tx, _ = make_optimizer(settings, model)
    return (model, make_train_step(settings, model=model),
            {"state": create_train_state(model, tx, settings.ema_decay)})


def _steps(step, holder, batch, n):
    """n steps; per step (ms, host copies of the metrics)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        holder["state"], metrics = step(holder["state"], batch)
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3,
                    {k: float(v) for k, v in metrics.items() if k != "weight_masks"}))
    return out


def variant_predict(settings, images, rng):
    """VARIANT_REQUESTS fused predict requests of the variant on seeded,
    calibrated weights: B4/B5 launches, and the fused path against an f32
    truth as the predict phase holds the default model."""
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.step import make_predict_step

    out_hw = (1024, 2048)
    unfused = init_model(build_model(settings), torch.Generator().manual_seed(0))
    calibrate_bn(unfused, images[0], rng)
    fused = build_model(settings.replace(fused_block=True))
    fused.load_state_dict(unfused.state_dict())
    predict = make_predict_step(settings.replace(fused_block=True), output_size=out_hw,
                                model=fused)
    predict(images[0])  # warm-up
    torch.cuda.synchronize()
    _reset_fb()
    lat, outs = [], []
    for img in images:
        t0 = time.perf_counter()
        outs.append(predict(img))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = _fb_counts()
    ref = make_predict_step(settings, output_size=out_hw, model=unfused)(images[0])
    truth_model = build_model(settings.replace(compute_dtype="float32"))
    truth_model.load_state_dict(unfused.state_dict())
    truth = make_predict_step(settings, output_size=out_hw, model=truth_model)(images[0])

    def compare(a, b):
        d = (a["l1_probabilities"] - b["l1_probabilities"]).abs()
        return dict(mean_abs=float(d.mean()),
                    decisions_equal=float((a["decisions"] == b["decisions"]).float().mean()))

    ff, uf = compare(outs[0], truth), compare(ref, truth)
    finite = all(bool(torch.isfinite(o[k]).all()) for o in outs for k in o)
    if not (finite and ff["mean_abs"] <= PREDICT_TRUTH_RATIO * uf["mean_abs"]
            and ff["decisions_equal"] >= uf["decisions_equal"] - PREDICT_TRUTH_DECISIONS_SLACK):
        raise AssertionError(f"fused predict departs from f32 more than unfused bf16: "
                             f"fused {ff}, unfused {uf}, finite {finite}")
    return launches, dict(latency_ms=lat, fused_vs_f32=ff, unfused_vs_f32=uf)


def variants_phase(device):
    """Each of ``VARIANTS`` at full width: VARIANT_REQUESTS predict requests
    with --fused_block held to an f32 truth, and VARIANT_STEPS fused
    optimizer train steps on the constant 4 + 8 + 4 batch; launch counts
    exact by the JAX rules (B4/B5 only under batch norm, B1/B2 only with
    bilinear upsampling); then B1/B2 at the Vistas heads against their
    plain versions. Returns (the phase's launches, the Vistas loss rows)."""
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    rng = np.random.RandomState(5)
    h, w = TRAIN_HW
    images = [torch.tensor(rng.uniform(-1, 1, (1, h, w, 3)), dtype=torch.float32, device=device)
              for _ in range(VARIANT_REQUESTS)]
    batch = train_batch(np.random.RandomState(0), device)
    totals = {k: 0 for k in REPLACES}
    stats = {}
    for name, dataset, fields in VARIANTS:
        settings = _train_settings(device, per_pixel_dataset_name=dataset, **fields)
        if name == "bn_fused":
            stats[name], launches = bn_fused_variant(settings, batch)
            for k, v in launches.items():
                totals[k] += v
            continue
        fb_launches, pred = variant_predict(settings.replace(mode="predict"), images, rng)
        torch.cuda.empty_cache()
        batch_norm = settings.norm_layer == "batch"
        want_fb = {"fused_bottleneck": 8 * VARIANT_REQUESTS * batch_norm,
                   "fused_bottleneck_ct": 2 * VARIANT_REQUESTS * batch_norm}

        model, step, holder = _fused_train(settings)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        _reset_bn()
        runs = _steps(step, holder, batch, VARIANT_STEPS)
        launches = {**_counts(), **_bn_counts()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        bilinear = settings.upsampling_method == "bilinear"
        norms = VARIANT_STEPS * batch_norm_layers(model)
        want = {"fused_loss_fwd": VARIANT_STEPS * bilinear, "fused_loss_bwd": VARIANT_STEPS * bilinear,
                "fused_update": VARIANT_STEPS, "root_conv_wgrad": 0, "fused_bn_fwd": norms,
                "fused_bn_bwd": norms}
        losses = [m for _, m in runs]
        profile = profile_call(lambda: step(holder["state"], batch), f"variant {name} step",
                               runs[-1][0], top=6, groups=STEP_GROUPS)
        stats[name] = dict(dataset=dataset, fields=fields, predict=pred, predict_launches=fb_launches,
                           step_ms=[t for t, _ in runs], device_busy_ms=profile["device_busy_ms"],
                           peak_memory_gib=peak_gib, launches=launches,
                           num_params=sum(p.numel() for p in model.parameters()),
                           totals=[m["total"] for m in losses])
        log(f"variant {name}: " + json.dumps(stats[name]))
        if fb_launches != want_fb or launches != want:
            raise AssertionError(f"variant {name}: launches predict {fb_launches} train "
                                 f"{launches}, expected {want_fb} {want}")
        if not all(np.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"variant {name}: non-finite losses {losses}")
        for counts in (fb_launches, launches):
            for k, v in counts.items():
                totals[k] += v
        del model, step, holder
        torch.cuda.empty_cache()
    vistas = loss_shape(get_taxonomy("vistas"), TRAIN_NB[0], TRAIN_NB[1] + TRAIN_NB[2], device)
    log("variants: " + json.dumps(dict(launches=totals, **{
        k: dict(step_ms=v["step_ms"], device_busy_ms=v["device_busy_ms"],
                peak_memory_gib=v["peak_memory_gib"]) for k, v in stats.items()})))
    return totals, vistas, {k: stats["bn_fused"]["fused"]["launches"][k]
                            for k in ("fused_bn_fwd", "fused_bn_bwd")}


# the bn_fused variant's step-1 losses against the f32 step's: within
# BAR_FACTOR times the largest distance that reordering the same sums shows
# on the card (floored at 1e-6 relative; 1e-3 for the mIoU), as phase 11
# holds its ranks: over the constant batch and BN_PERMUTATIONS row orders of
# it, the default bf16 step's distance to the f32 step on the same rows, and
# the fused step's distance to its own step on the constant batch
# (step1_rows), and the fused step moved by a permutation no farther than
# BAR_FACTOR times what the default step shows. One reading of the default's
# distance alone (the bar before) is a poor sample: the gated human loss's
# was 0.00039, while N1's own distance to f32 has been 0.00004, 0.0039 and
# 0.00062 for three versions of its summation, none of them wrong. Beside
# it, the fused step in f32 against the default in f32 on the same row
# orders (f32_step1_rows), whose noise is f32's reordering alone. Basis (the
# H100, seed 0): the bf16 noise reaches 0.00188 on the total and 0.00414 on
# the gated human loss (bars 0.0075, 0.0166; the fused step 0.000784,
# 0.000619 from f32); the f32 bars 3.26e-5 and 7.3e-5 (the fused step
# 1.91e-6, 3.7e-6 from the default). N1 summing half its rows over the
# whole count fails the bf16 bar 37x on the total; N1 taking the first half
# of the batch's statistics passes the bf16 bar (0.35) and fails the f32
# order check 46x on the total, 172x on the L1 loss.
BN_TRUTH_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
                 "miou")
# the row orders of each sub-batch besides the constant batch's: reversed,
# and rolled by one and by two rows (BatchNorm's statistics and the losses do
# not depend on the order of the images, their sums do)
BN_PERMUTATIONS = ("flip", 1, 2)


def permuted(batch, how):
    """``batch`` with the rows of each sub-batch reversed (``how`` "flip") or
    rolled by ``how`` rows."""
    if how == "flip":
        return {k: torch.flip(v, dims=(0,)) for k, v in batch.items()}
    return {k: torch.roll(v, how, dims=0) for k, v in batch.items()}


def step1_rows(f32, default, fused, keys=BN_TRUTH_KEYS):
    """Phase 9's step-1 checks on plain numbers. Each argument is a list of
    step-1 metrics (dicts): [0] on the constant batch, [i] on its i-th row
    permutation. A key's noise is the largest of the default step's
    distances to the f32 step on the same rows and the fused step's
    distances to its [0]; the fused [0] must stand within ``spread_bar`` of
    it from the f32 [0]. A correct BatchNorm moves with the order of the
    images only as far as its sums do, so the fused step's distances to its
    [0] must also stand within ``spread_bar`` of what the default step shows
    (its distances to f32 and to its own [0]): a fault whose statistics
    depend on the order of the rows would otherwise widen its own bar.
    Returns ({key: row}, [problems])."""
    rows, problems = {}, []
    for k in keys:
        floor = 1e-3 if k == "miou" else 1e-6 * abs(f32[0][k])
        to_f32 = [abs(d[k] - t[k]) for d, t in zip(default, f32)]
        moved = [abs(x[k] - fused[0][k]) for x in fused[1:]]
        bar = spread_bar(to_f32 + moved, floor)
        order_bar = spread_bar(to_f32 + [abs(d[k] - default[0][k]) for d in default[1:]], floor)
        dist = abs(fused[0][k] - f32[0][k])
        rows[k] = dict(f32=f32[0][k], default=default[0][k], fused=fused[0][k],
                       noise=max(to_f32 + moved), bar=bar, ratio=dist / bar,
                       moved=max(moved, default=0.0), order_bar=order_bar,
                       order_ratio=max(moved, default=0.0) / order_bar)
        if dist > bar:
            problems.append(f"step-1 {k}: the fused step {dist} from f32, over the bar: "
                            f"{rows[k]}")
        if rows[k]["order_ratio"] > 1:
            problems.append(f"step-1 {k}: a row permutation moved the fused step "
                            f"{rows[k]['moved']}, over what it moves the default step: "
                            f"{rows[k]}")
    return rows, problems


def f32_step1_rows(flax, fused, keys=BN_TRUTH_KEYS):
    """Phase 9's f32 check on plain numbers: step 1 of ``bn_impl="fused"``
    in f32 against the default step in f32, each a list as in
    ``step1_rows``. In f32 the steps differ only in the order of their sums,
    so a key's noise is the largest distance a row permutation moves either
    step from its [0]; the fused [0] must stand within ``spread_bar`` of it
    from the default [0], and no permutation may move the fused step
    farther than ``spread_bar`` of what it moves the default step
    (statistics that follow the row order would otherwise widen their own
    bar). Far below bf16's rounding, this bar sees faults that bf16's
    distance to f32 hides. Returns ({key: row}, [problems])."""
    rows, problems = {}, []
    for k in keys:
        floor = 1e-3 if k == "miou" else 1e-6 * abs(flax[0][k])
        ref_moved = [abs(x[k] - flax[0][k]) for x in flax[1:]]
        moved = [abs(x[k] - fused[0][k]) for x in fused[1:]]
        bar = spread_bar(ref_moved + moved, floor)
        order_bar = spread_bar(ref_moved, floor)
        dist = abs(fused[0][k] - flax[0][k])
        rows[k] = dict(flax=flax[0][k], fused=fused[0][k], noise=max(ref_moved + moved),
                       bar=bar, ratio=dist / bar, moved=max(moved), order_bar=order_bar,
                       order_ratio=max(moved) / order_bar)
        if dist > bar:
            problems.append(f"f32 step-1 {k}: the fused step {dist} from the default, over "
                            f"the bar: {rows[k]}")
        if rows[k]["order_ratio"] > 1:
            problems.append(f"f32 step-1 {k}: a row permutation moved the fused step "
                            f"{rows[k]['moved']}, over what it moves the default step: "
                            f"{rows[k]}")
    return rows, problems


def bn_fused_variant(settings, batch):
    """The bn_fused variant: VARIANT_STEPS steps of ``bn_impl="flax"``
    (the JAX package's default, key ``default``) and of ``bn_impl="fused"``
    from the same seeded weights on the constant batch, one after the
    other, and an f32 flax step 1 as the truth. N1 and N2 exactly FLAGSHIP_BATCH_NORMS times a step
    under fused and never under flax; B1-B3 once a step in both; finite
    losses, falling under fused; fused's step-1 losses within the bar of
    ``step1_rows``, for which each path first takes step 1 on each of
    ``BN_PERMUTATIONS``, from the same weights; and ``bn_impl="fused"``'s
    f32 step 1 against the f32 default's on the same row orders, within the
    bar of ``f32_step1_rows`` (N1/N2 once a layer). Per run the step ms,
    device busy, the BatchNorm and copies-and-casts groups, and the peak.
    Returns (the runs, the fused run's launches)."""
    from iv2019_tpu_torch.bench import train_norm_launches
    from iv2019_tpu_torch.ops import fused_bn as fbn
    from iv2019_tpu_torch.train.state import create_fused_train_state

    runs, orders = {}, {}
    for key, s in (("default", settings.replace(bn_impl="flax")), ("fused", settings),
                   ("f32", settings.replace(bn_impl="flax", compute_dtype="float32")),
                   ("fused_f32", settings.replace(compute_dtype="float32"))):
        opt, state, step = _fused_run(s)
        model, holder = opt.model, {"state": state}
        # step 1 on each row order, each from the seeded weights (the
        # update writes them in place; the running statistics it also moves
        # do not enter a train-mode step's losses)
        params = opt.params.clone()
        orders[key] = []
        for how in BN_PERMUTATIONS:
            _, m = step(create_fused_train_state(opt), permuted(batch, how))
            orders[key].append(_metrics(m))
            opt.params.copy_(params)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        _reset_bn()
        copies = fbn.batch_norm_train.layout_copies
        steps = _steps(step, holder, batch, VARIANT_STEPS if key in ("default", "fused") else 1)
        row = dict(launches={**_counts(), **_bn_counts()}, step_ms=[t for t, _ in steps],
                   layout_copies=fbn.batch_norm_train.layout_copies - copies,
                   totals=[m["total"] for _, m in steps], step1=steps[0][1],
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   batch_norms=train_norm_launches(model),
                   finite=all(np.isfinite(v) for _, m in steps for v in m.values()))
        if key in ("default", "fused"):
            profile = profile_call(lambda: step(holder["state"], batch),
                                   f"variant bn_fused ({key} step)", steps[-1][0], top=6,
                                   groups=STEP_GROUPS)
            groups = profile["device_ms_by_group"]
            row.update(device_busy_ms=profile["device_busy_ms"], batchnorm_ms=groups["batchnorm"],
                       copies_and_casts_ms=groups["copies and casts"],
                       idle_share=profile["idle_share"])
        runs[key] = row
        del opt, state, model, step, holder
        torch.cuda.empty_cache()
    truth, problems = step1_rows(*([runs[k]["step1"]] + orders[k] for k in ("f32", "default",
                                                                            "fused")))
    truth_f32, f32_problems = f32_step1_rows(*([runs[k]["step1"]] + orders[k]
                                               for k in ("f32", "fused_f32")))
    problems += f32_problems
    per_step = VARIANT_STEPS * FLAGSHIP_BATCH_NORMS
    want = {"fused_loss_fwd": VARIANT_STEPS, "fused_loss_bwd": VARIANT_STEPS,
            "fused_update": VARIANT_STEPS, "root_conv_wgrad": 0}
    if runs["fused"]["launches"] != {**want, "fused_bn_fwd": per_step, "fused_bn_bwd": per_step}:
        problems.append(f"fused launches {runs['fused']['launches']}, expected N1/N2 {per_step}")
    if runs["fused_f32"]["launches"] != {"fused_loss_fwd": 1, "fused_loss_bwd": 1,
                                         "fused_update": 1, "root_conv_wgrad": 0,
                                         "fused_bn_fwd": FLAGSHIP_BATCH_NORMS,
                                         "fused_bn_bwd": FLAGSHIP_BATCH_NORMS}:
        problems.append(f"fused f32 launches {runs['fused_f32']['launches']}, expected N1/N2 "
                        f"{FLAGSHIP_BATCH_NORMS}")
    if runs["default"]["launches"] != {**want, "fused_bn_fwd": 0, "fused_bn_bwd": 0}:
        problems.append(f"default launches {runs['default']['launches']}")
    if runs["fused"]["batch_norms"] != FLAGSHIP_BATCH_NORMS:
        problems.append(f"{runs['fused']['batch_norms']} train-mode batch norms")
    if not all(r["finite"] for r in runs.values()):
        problems.append("non-finite losses")
    if not runs["fused"]["totals"][-1] < runs["fused"]["totals"][0]:
        problems.append(f"fused total did not fall: {runs['fused']['totals']}")
    # the last step of each run: wall (its p50 here), device busy, idle share
    steps = {k: dict(wall_ms=runs[k]["step_ms"][-1], busy_ms=runs[k]["device_busy_ms"],
                     idle_share=runs[k]["idle_share"]) for k in ("default", "fused")}
    out = dict(runs, step1_against_f32=truth, f32_step1=truth_f32,
               step_ms=runs["fused"]["step_ms"],
               device_busy_ms=runs["fused"]["device_busy_ms"],
               peak_memory_gib=runs["fused"]["peak_memory_gib"], step_vs_default=steps)
    log("variant bn_fused: " + json.dumps(out))
    log("variant bn_fused step 1, fused against f32 (distance / bar, noise; moved by a "
        "permutation / bar): " + ", ".join(
            f"{k} {abs(r['fused'] - r['f32']):.3g} / {r['bar']:.3g}, {r['noise']:.3g}; "
            f"{r['moved']:.3g} / {r['order_bar']:.3g}" for k, r in truth.items()))
    log("variant bn_fused step 1 in f32, fused against default (distance / bar, noise; moved "
        "by a permutation / bar): " + ", ".join(
            f"{k} {abs(r['fused'] - r['flax']):.3g} / {r['bar']:.3g}, {r['noise']:.3g}; "
            f"{r['moved']:.3g} / {r['order_bar']:.3g}" for k, r in truth_f32.items()))
    log("variant bn_fused step (wall, busy ms, idle share): fused "
        + " / ".join(f"{steps['fused'][k]:.4f}" for k in steps["fused"]) + " against default "
        + " / ".join(f"{steps['default'][k]:.4f}" for k in steps["default"]))
    if problems:
        raise AssertionError("variant bn_fused: " + "; ".join(problems))
    return out, runs["fused"]["launches"]


def optax_run(device, tmp, problem):
    """SemanticSegmentation.train on the optax path with B6, to
    OPTAX_RUN_STEPS and resumed to OPTAX_RESUME_STEPS, then predict_cli from
    its checkpoint with and without --restore_emas against a model holding
    the run's weights (or the EMA shadow unbiased by hand). Returns the
    run's launches and numbers."""
    import os

    from PIL import Image

    from iv2019_tpu_torch import predict_cli
    from iv2019_tpu_torch.config import (PREDICT, build_argparser, resolve_dataset_name,
                                         resolve_trained_model, settings_from_args)
    from iv2019_tpu_torch.input.heterogeneous import train_input
    from iv2019_tpu_torch.input.predict_input import predict_input
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import SemanticSegmentation
    from iv2019_tpu_torch.utils.checkpoint import CheckpointManager

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    log_dir = os.path.join(tmp, "optax")
    settings = _train_settings(device, log_dir=log_dir, training_problem_def_path=problem,
                               synthetic_data=True, input_seed=0, root_wgrad_pallas=True,
                               fused_optimizer=False, save_checkpoints_steps=OPTAX_SAVE_EVERY,
                               save_summaries_steps=OPTAX_SAVE_EVERY, Nb=npp)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    SemanticSegmentation({"train": train_input}, settings=settings).train(
        max_steps=OPTAX_RUN_STEPS, log_every=1)
    os.rename(os.path.join(log_dir, "settings.txt"), os.path.join(log_dir, "settings.0.txt"))
    state = SemanticSegmentation({"train": train_input}, settings=settings).train(
        max_steps=OPTAX_RESUME_STEPS, log_every=1)
    run_s = time.perf_counter() - t0
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = _read_jsonl(os.path.join(log_dir, "train_metrics.jsonl"))
    snap = CheckpointManager(log_dir).load(OPTAX_RESUME_STEPS)
    n = OPTAX_RESUME_STEPS
    want = {"fused_loss_fwd": n, "fused_loss_bwd": n, "fused_update": 0, "root_conv_wgrad": n}
    log(f"optax run: steps {[r['step'] for r in records]}, launches {launches}, "
        f"checkpoint kind {snap['kind']} count {snap['count']}")
    if (launches != want or [r["step"] for r in records] != list(range(1, n + 1))
            or not all(np.isfinite(v) for r in records for v in r.values())
            or snap["kind"] != "optax" or snap["count"] != n or int(state.step) != n):
        raise AssertionError(f"optax run: launches {launches} (expected {want}), records "
                             f"{records}, checkpoint {snap['kind']} {snap['count']}")
    del snap

    img_dir = os.path.join(log_dir, "images")
    os.makedirs(img_dir)
    sizes = {"a": (h, w), "b": (600, 800)}
    rng = np.random.RandomState(6)
    for stem, hw in sizes.items():
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}.png"))
    raw = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    ema = dict(raw)
    denom = 1.0 - state.ema.decay_product
    for name, s in state.ema.biased.items():
        ema[name] = s / denom
    del state
    torch.cuda.empty_cache()
    out = dict(steps=n, run_s=run_s, peak_memory_gib=peak_gib, launches=launches,
               step_ms_p50=_p50_p90([sum(TRAIN_NB) / r["images_per_sec"] * 1e3
                                     for r in records if r["step"] not in (1, OPTAX_RUN_STEPS + 1)])[0],
               last_total=records[-1]["total"])
    for flags, weights in (((), raw), (("--restore_emas",), ema)):
        results = os.path.join(log_dir, "predictions" + "".join(flags))
        argv = [log_dir, problem, img_dir, "--height_feature_extractor", str(h),
                "--width_feature_extractor", str(w), "--fused_block", "--export_lids_images",
                "--results_dir", results, *flags]
        _reset_fb()
        count = predict_cli.main(argv)
        fb_launches = _fb_counts()
        args = build_argparser(PREDICT).parse_args(argv)
        psettings = resolve_trained_model(resolve_dataset_name(
            settings_from_args(args, PREDICT, predict_keys=predict_cli.PREDICT_KEYS), None), argv)
        system = SemanticSegmentation({"predict": lambda s, _pd: predict_input(s)},
                                      model_fn=build_model, settings=psettings)
        got = list(system.predict())
        model = build_model(system.settings)
        model.load_state_dict(weights)
        want_items = list(predict_cli.predict(system.settings, model))
        diff = max(float(np.abs(g[k] - x[k]).max()) for g, x in zip(got, want_items)
                   for k in ("l1_probabilities", "l2_vehicle_probabilities"))
        same = min(float((g["decisions"] == x["decisions"]).mean())
                   for g, x in zip(got, want_items))
        key = "restore_emas" if flags else "weights"
        out[key] = dict(images=count, launches=fb_launches, max_abs_prob_diff=diff,
                        decisions_equal=same)
        want_fb = {"fused_bottleneck": 8 * len(sizes), "fused_bottleneck_ct": 2 * len(sizes)}
        if count != len(sizes) or fb_launches != want_fb or diff > 1e-6 or same < 0.9999:
            raise AssertionError(f"predict from the optax run {flags}: {out[key]}")
        del model, system
        torch.cuda.empty_cache()
    log("optax run: " + json.dumps(out))
    return launches, out


def optax_phase(device):
    """The optax path (see the module docstring): the training run with its
    resume and predict, the optax path against FusedSGDM from the same
    weights, and remat against no remat. Returns the launches of each and
    the numbers."""
    import os
    import tempfile

    from iv2019_tpu_torch import train_cli

    problem = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)),
                           "problem_definitions", "cityscapes", "problem01.json")
    with tempfile.TemporaryDirectory() as tmp:
        run_launches, run = optax_run(device, tmp, problem)
    torch.cuda.empty_cache()
    batch = train_batch(np.random.RandomState(0), device)

    # the optax path against the fused optimizer, same weights, same batch
    runs = {}
    for key, build in (("optax", _optax_train), ("fused", _fused_train)):
        settings = _train_settings(device, fused_optimizer=key == "fused")
        model, step, holder = build(settings)
        initial = {k: p.detach().clone() for k, p in model.named_parameters()}
        history = _steps(step, holder, batch, COMPARE_STEPS)
        runs[key] = dict(history=history, initial=initial,
                         params={k: p.detach().clone() for k, p in model.named_parameters()})
        # one more step under the profiler (after the parameters are read)
        runs[key]["busy"] = profile_call(lambda: _steps(step, holder, batch, 1),
                                         f"{key} step", history[-1][0], top=6,
                                         groups=STEP_GROUPS)["device_busy_ms"]
        del model, step, holder
        torch.cuda.empty_cache()
    (_, m_optax), (_, m_fused) = runs["optax"]["history"][0], runs["fused"]["history"][0]
    rel = {k: abs(m_optax[k] - m_fused[k]) / abs(m_fused[k]) for k in m_fused if k != "miou"}
    # per leaf: the largest |difference| over the leaf's largest |value|, and
    # the difference's norm over the norm of the leaf's update; then all
    # parameters as one vector
    worst_rel, per_leaf, diff_sq, update_sq = 0.0, [], 0.0, 0.0
    for k, p in runs["fused"]["params"].items():
        d = runs["optax"]["params"][k] - p
        update = p - runs["fused"]["initial"][k]
        worst_rel = max(worst_rel, float(d.abs().max()) / max(float(p.abs().max()), 1e-30))
        per_leaf.append(float(d.norm()) / max(float(update.norm()), 1e-30))
        diff_sq += float(d.norm()) ** 2
        update_sq += float(update.norm()) ** 2
    compare = dict(steps=COMPARE_STEPS, step1_rel_diff=rel, params_max_rel_diff=worst_rel,
                   leaf_diff_over_update_max=max(per_leaf),
                   leaf_diff_over_update_median=float(np.median(per_leaf)),
                   all_params_diff_over_update=(diff_sq / max(update_sq, 1e-30)) ** 0.5,
                   totals={k: [m["total"] for _, m in v["history"]] for k, v in runs.items()},
                   step_ms={k: [t for t, _ in v["history"]] for k, v in runs.items()},
                   device_busy_ms={k: v["busy"] for k, v in runs.items()})
    log("optax against fused: " + json.dumps(compare))
    finite = all(np.isfinite(v) for r in runs.values() for _, m in r["history"]
                 for v in m.values())
    if not (finite and max(v for k, v in rel.items() if k not in ("total", "regularization"))
            <= COMPARE_LOSS_REL_TOL and rel["regularization"] <= COMPARE_REG_REL_TOL):
        raise AssertionError(f"optax path departs from the fused optimizer: {compare}")
    del runs
    torch.cuda.empty_cache()

    # remat against no remat, with B6
    remat = {}
    remat_launches = {k: 0 for k in _counts()}
    for flag in (False, True):
        settings = _train_settings(device, remat=flag, root_wgrad_pallas=True)
        model, step, holder = _fused_train(settings)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts()
        first = _steps(step, holder, batch, 1)
        stats1 = {k: b.detach().clone() for k, b in model.named_buffers()}
        rest = _steps(step, holder, batch, REMAT_STEPS - 1)
        for k, v in _counts().items():
            remat_launches[k] += v
        remat[flag] = dict(step_ms=[t for t, _ in first + rest],
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           activations_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                           totals=[m["total"] for _, m in first + rest], stats1=stats1,
                           stats=[{k: b.detach().clone() for k, b in model.named_buffers()}])
        remat[flag]["device_busy_ms"] = profile_call(
            lambda: _steps(step, holder, batch, 1), f"remat={flag} step", rest[-1][0], top=6,
            groups=STEP_GROUPS)["device_busy_ms"]
        del model, step, holder
        torch.cuda.empty_cache()
    n = 2 * REMAT_STEPS
    want = {"fused_loss_fwd": n, "fused_loss_bwd": n, "fused_update": n, "root_conv_wgrad": n}
    stats1_diff = max(float((remat[True]["stats1"][k] - v).abs().max())
                      for k, v in remat[False]["stats1"].items())
    stats_diff = max(float((remat[True]["stats"][0][k] - v).abs().max())
                     for k, v in remat[False]["stats"][0].items())
    out = dict(launches=remat_launches, stats_max_abs_diff_step1=stats1_diff,
               stats_max_abs_diff=stats_diff, **{
                   ("remat" if k else "plain"): {x: v[x] for x in (
                       "step_ms", "device_busy_ms", "peak_gib", "activations_gib", "totals")}
                   for k, v in remat.items()})
    log("remat: " + json.dumps(out))
    if (remat_launches != want or stats1_diff != 0.0
            or not remat[True]["peak_gib"] < remat[False]["peak_gib"]
            or not all(np.isfinite(t) for v in remat.values() for t in v["totals"])):
        raise AssertionError(f"remat: {out}, expected launches {want}, equal statistics after "
                             "one step and a lower peak")
    return dict(run=run_launches, remat=remat_launches), dict(run=run, compare=compare, remat=out)


# ------------------------------------------------------- 11. multi-rank

RANKS = 2
RANK_TIMEOUT_S = 300
# the 2-rank step-1 losses and gradient against the single-process step on
# the global batch: within BAR_FACTOR times what permuting the rows of each
# sub-batch does to the single-process step (the same function, its
# reductions in another order: the floor of what the card can repeat). The
# f32 gradient is held as a whole and parameter by parameter: a fault in
# few parameters hides in the whole vector's norm. Basis (tools/
# probe_multirank.py on the H100): the ranks come to 1.18 times the
# permutation's distance over the whole vector and at most 1.87 times for a
# parameter; BatchNorm's backward on one rank's rows (a planted fault that
# moves only the gradient) comes to 1.39 over the whole vector, under the
# bar, and to 24.6 on the L1 logits' conv weight, 6 times over it.
BAR_FACTOR = 4.0


def spread_bar(noise, floor):
    """BAR_FACTOR times the largest of ``noise``, the distances that
    reordering the same sums showed on the card, floored at ``floor``."""
    return BAR_FACTOR * max(max(noise), floor)

# below this relative distance a parameter's gradient is held to the floor
# (the heads' 3 to 14 element norm parameters move by 1e-6 to 7e-6 under
# the permutation)
PARAM_FLOOR = 1e-5
# all-reduces a step at one rank: the fused loss's sums, the gradient and
# the confusion matrix (BatchNorm takes the single-device path there)
WORLD1_ALL_REDUCES = 3


def _digest(tensors):
    """sha256 of the bytes of ``tensors`` (bit-equality across processes)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _train_settings_full(**kw):
    from iv2019_tpu_torch.config import Settings

    (npp, npb, npi), (h, w) = TRAIN_NB, TRAIN_HW
    return Settings(device="cuda", mode="train", height_feature_extractor=h,
                    width_feature_extractor=w, Nb_per_pixel=npp, Nb_per_bbox=npb,
                    Nb_per_image=npi, root_wgrad_pallas=True, **kw).finalize()


def _fused_run(settings, mesh=None):
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.state import create_fused_train_state
    from iv2019_tpu_torch.train.step import make_train_step

    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    opt = FusedSGDM(settings, model)
    return opt, create_fused_train_state(opt), make_train_step(settings, fused_opt=opt,
                                                               mesh=mesh)


def _metrics(m):
    return {k: float(v) for k, v in m.items() if k != "weight_masks"}


def _state_digest(opt, state):
    o = state.opt_state
    return {"params": _digest([opt.params]), "momentum": _digest([o.momentum]),
            "ema": _digest([o.ema_biased, o.ema_decay_product]),
            "statistics": _digest(list(opt.model.buffers()))}


def nccl_world_one(device):
    """(a): two full-width train steps through the distributed code path on
    an NCCL group of one rank, against the non-distributed step from the
    same weights on the same batch: bit-equal; 3 all-reduces a step."""
    from iv2019_tpu_torch.parallel import mesh as pmesh
    from iv2019_tpu_torch.parallel import multihost

    settings = _train_settings_full(num_devices=1)
    # built before the group starts: the step of no mesh
    plain_opt, plain_state, plain_step = _fused_run(settings)
    mesh = multihost.initialize(settings, backend="nccl")
    try:
        if mesh is None or mesh.world != 1:
            raise AssertionError(f"NCCL group of one rank: {mesh}")
        opt, state, step = _fused_run(settings, mesh)
        batch = train_batch(np.random.RandomState(0), device)
        rows, launches = [], {}
        for i in range(2):
            _reset_counts()
            pmesh.reset_collective_stats()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            counts, colls = _counts(), pmesh.collective_stats()
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            plain_state, pm = plain_step(plain_state, batch)
            rows.append(dict(step=i + 1, collectives=colls, launches=counts,
                             equal_metrics=_metrics(m) == _metrics(pm)))
        equal_state = _state_digest(opt, state) == _state_digest(plain_opt, plain_state)
    finally:
        multihost.shutdown()
    out = dict(backend="nccl", world=1, steps=rows, equal_state=equal_state, launches=launches)
    log("multirank (a) NCCL at one rank: " + json.dumps(out))
    bad = [r for r in rows if r["collectives"]["all_reduce"] != WORLD1_ALL_REDUCES
           or r["collectives"]["broadcast"] or not r["equal_metrics"]
           or any(v != 1 for v in r["launches"].values())]
    if bad or not equal_state:
        raise AssertionError(f"NCCL at one rank: {out}")
    return launches


def _timed_collectives(group=None):
    """Wrap ``torch.distributed``'s all_reduce and broadcast, which the
    port's collectives call, so that each is timed alone: the device is
    synchronized before and after it (the step loses its overlap, so steps
    are timed without this). With ``group``, the collectives over that
    process group are also summed apart (``group_seconds``). Returns the
    totals and the restore function."""
    import torch.distributed as dist

    timed = {"seconds": 0.0, "group_seconds": 0.0, "largest_bytes": 0, "largest_seconds": 0.0}
    originals = dist.all_reduce, dist.broadcast

    def wrap(fn):
        def collective(t, *args, **kw):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            out = fn(t, *args, **kw)
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            seconds = time.perf_counter() - t0
            timed["seconds"] += seconds
            if group is not None and kw.get("group") is group:
                timed["group_seconds"] += seconds
            if t.numel() * t.element_size() > timed["largest_bytes"]:
                timed.update(largest_bytes=t.numel() * t.element_size(),
                             largest_seconds=seconds)
            return out
        return collective

    dist.all_reduce, dist.broadcast = wrap(dist.all_reduce), wrap(dist.broadcast)

    def restore():
        dist.all_reduce, dist.broadcast = originals

    return timed, restore


def _gloo_train_rank(rank, port, tmp):
    """One of the two gloo ranks of (b), on cuda:0 with the other."""
    from iv2019_tpu_torch.parallel import mesh as pmesh
    from iv2019_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    settings = _train_settings_full(num_processes=RANKS, process_id=rank, num_devices=1,
                                    coordinator_address=f"localhost:{port}")
    mesh = multihost.initialize(settings, backend="gloo")
    try:
        batch = multihost.put_sharded(train_batch(np.random.RandomState(0), torch.device("cpu")),
                                      mesh)
        # step 1 in f32 (no B6 there), whose gradient is not drowned in bf16
        # rounding, with the f32 BatchNorm's all-reduce (bn_impl="flax")
        opt, state, step = _fused_run(settings.replace(compute_dtype="float32", bn_impl="flax"),
                                      mesh)
        _, m = step(state, batch)
        f32 = dict(history=[_metrics(m)], grads_digest=_digest([opt.grads]))
        f32_grads = opt.grads.detach().cpu().clone()
        del opt, state, step, m
        torch.cuda.empty_cache()
        # the same step 1 with bn_impl="fused": N1/N2 over both ranks' rows
        _reset_bn()
        opt, state, step = _fused_run(settings.replace(compute_dtype="float32", bn_impl="fused"),
                                      mesh)
        _, m = step(state, batch)
        bn_fused = dict(history=[_metrics(m)], grads_digest=_digest([opt.grads]),
                        launches=_bn_counts())
        bn_fused_grads = opt.grads.detach().cpu().clone()
        del opt, state, step, m
        torch.cuda.empty_cache()

        opt, state, step = _fused_run(settings, mesh)
        # as the training loop does after its init
        pmesh.replicate([opt.params] + list(opt.model.buffers()), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        history, times, colls = [], [], []
        for i in range(2):
            pmesh.reset_collective_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            colls.append(pmesh.collective_stats())
            history.append(_metrics(m))
            if i == 0:
                grads = opt.grads.detach().cpu().clone()
        digests = _state_digest(opt, state)
        # a third step with every collective timed alone (synchronized)
        pmesh.reset_collective_stats()
        timed, restore = _timed_collectives()
        t0 = time.perf_counter()
        try:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            restore()
        timed_ms = (time.perf_counter() - t0) * 1e3
        timed["bytes"] = pmesh.collective_stats()["bytes"]
        out = dict(rank=rank, rows={k: int(v.shape[0]) for k, v in batch.items()}, f32=f32,
                   bn_fused=bn_fused,
                   history=history, step_ms=times, timed_step_ms=timed_ms,
                   collective_ms=timed["seconds"] * 1e3, collectives=colls,
                   collective_mb=timed["bytes"] / 1e6,
                   largest_collective_ms=timed["largest_seconds"] * 1e3,
                   largest_collective_mb=timed["largest_bytes"] / 1e6,
                   launches=_counts(), digests=digests,
                   grads_digest=_digest([grads]),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        torch.save({"out": out, "grads": grads if rank == 0 else None,
                    "f32_grads": f32_grads if rank == 0 else None,
                    "bn_fused_grads": bn_fused_grads if rank == 0 else None},
                   _rank_file(tmp, "train", rank))
    finally:
        multihost.shutdown()


def _gloo_eval_rank(rank, port, argv, tmp):
    """One of the two gloo processes of (c): evaluate_cli's sweep."""
    from iv2019_tpu_torch import evaluate_cli
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.parallel import multihost

    coordinator = ["--num_processes", str(RANKS), "--coordinator_address", f"localhost:{port}",
                   "--process_id", str(rank)]
    multihost.initialize(Settings(device="cuda", num_processes=RANKS, process_id=rank,
                                  coordinator_address=f"localhost:{port}", num_devices=1),
                         backend="gloo")
    try:
        _reset_fb()
        t0 = time.perf_counter()
        metrics = evaluate_cli.main(argv + coordinator)
        torch.save(dict(matrices=[(m["global_step"], m["confusion_matrix"]) for m in metrics],
                        launches=_fb_counts(), wall_s=time.perf_counter() - t0,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30),
                   _rank_file(tmp, "eval", rank))
    finally:
        multihost.shutdown()


def _spawn_ranks(fn, args, label):
    """``fn(rank, *args)`` in RANKS spawned processes; a rank that fails, or
    a join past RANK_TIMEOUT_S, fails the run (the others are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise AssertionError(f"{label}: the ranks did not end in {RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _worst_param(got, want, permuted, layout):
    """The parameter whose gradient in ``got`` is farthest from ``want``
    over what the row permutation does to it (floored at PARAM_FLOOR)."""
    worst = None
    for name, shape, _, offset in layout:
        part = slice(offset, offset + int(np.prod(shape)))
        dist, noise = _rel_norm(got[part], want[part]), _rel_norm(permuted[part], want[part])
        ratio = dist / max(noise, PARAM_FLOOR)
        if worst is None or ratio > worst["ratio"]:
            worst = dict(param=name, ratio=ratio, ranks=dist, permuted=noise)
    return worst


def gloo_train(device, tmp):
    """(b): two gloo ranks on cuda:0, 2 + 4 + 2 images each of the global
    4 + 8 + 4, full width: step 1 in f32 and in bf16 against the
    single-process step on the global batch, under the bar of a row
    permutation (in bf16 also of the single-process step's distance to the
    f32 one); then 3 bf16 steps with B6: the state bit-equal on both ranks
    after 2, B1/B2/B3/B6 once a step on each rank."""
    from iv2019_tpu_torch.parallel.multihost import free_port

    settings = _train_settings_full()
    batch = train_batch(np.random.RandomState(0), device)
    # the rows of each sub-batch reversed: the same function
    permuted = {k: torch.flip(v, dims=(0,)) for k, v in batch.items()}
    ref = {}
    for dtype in ("float32", "bfloat16"):
        # f32 names flax, as the ranks' f32 step does; bf16 the default (N1/N2)
        s = settings.replace(compute_dtype=dtype, **({"bn_impl": "flax"} if dtype == "float32"
                                                      else {}))
        for name, b in (("global", batch), ("permuted", permuted)):
            opt, state, step = _fused_run(s)
            _, m = step(state, b)
            ref[dtype, name] = (_metrics(m), opt.grads.detach().cpu().clone())
            layout = opt.layout
            del opt, state, step, m
            torch.cuda.empty_cache()
    # the single-process f32 step 1 with bn_impl="fused" (N1/N2 on one
    # rank), on the global batch and on its permutation
    for name, b in (("global", batch), ("permuted", permuted)):
        _reset_bn()
        opt, state, step = _fused_run(settings.replace(compute_dtype="float32",
                                                       bn_impl="fused"))
        _, m = step(state, b)
        ref["bn_fused", name] = (_metrics(m), opt.grads.detach().cpu().clone(), _bn_counts())
        del opt, state, step, m
        torch.cuda.empty_cache()
    del batch, permuted
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _spawn_ranks(_gloo_train_rank, (free_port(), tmp), "gloo train")
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(_rank_file(tmp, "train", r), weights_only=False) for r in range(RANKS)]
    outs = [r["out"] for r in ranks]
    keys = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
            "regularization", "miou")
    step1, problems = {}, []
    for dtype, got_g, history in (
            ("float32", ranks[0]["f32_grads"], [o["f32"]["history"][0] for o in outs]),
            ("bfloat16", ranks[0]["grads"], [o["history"][0] for o in outs])):
        (want, want_g), (perm, perm_g) = ref[dtype, "global"], ref[dtype, "permuted"]
        rows = {}
        for k in keys:
            floor = 1e-3 if k == "miou" else 1e-6 * abs(want[k])
            noise = [abs(perm[k] - want[k])]
            if dtype == "bfloat16":
                # a bf16 step is as far from the f32 one as bf16 rounds
                noise.append(abs(want[k] - ref["float32", "global"][0][k]))
            rows[k] = dict(single=want[k], ranks=[h[k] for h in history], permuted=perm[k],
                           bar=spread_bar(noise, floor))
            if any(abs(h[k] - want[k]) > rows[k]["bar"] for h in history):
                problems.append(f"{dtype} step-1 {k}: {rows[k]}")
        grad = dict(ranks=_rel_norm(got_g, want_g), permuted=_rel_norm(perm_g, want_g))
        if dtype == "bfloat16":
            grad["single_vs_f32"] = _rel_norm(want_g, ref["float32", "global"][1])
        else:
            grad["bar"] = spread_bar([grad["permuted"]], 1e-7)
            grad["worst_param"] = _worst_param(got_g, want_g, perm_g, layout)
            if grad["ranks"] > grad["bar"] or grad["worst_param"]["ratio"] > BAR_FACTOR:
                problems.append(f"f32 step-1 gradient {grad}")
        step1[dtype] = dict(losses=rows, grad_rel_norm=grad)
    step1["bn_fused"] = bn_fused_ranks(ref, ranks, layout, problems)
    want_all_reduces = 2 * _batch_norms(settings) + 3
    summary = dict(
        ranks=RANKS, backend="gloo", device="cuda:0 (shared)", wall_s=wall_s,
        rows=outs[0]["rows"], step1=step1,
        per_rank=[{k: o[k] for k in ("step_ms", "timed_step_ms", "collective_ms",
                                     "collective_mb", "largest_collective_ms",
                                     "largest_collective_mb", "peak_gib", "launches",
                                     "collectives")}
                  for o in outs],
        equal_state=outs[0]["digests"] == outs[1]["digests"],
        equal_grads=(outs[0]["grads_digest"] == outs[1]["grads_digest"]
                     and outs[0]["f32"]["grads_digest"] == outs[1]["f32"]["grads_digest"]
                     and outs[0]["bn_fused"]["grads_digest"]
                     == outs[1]["bn_fused"]["grads_digest"]))
    log("multirank (b) two gloo ranks, train: " + json.dumps(summary))
    if not (summary["equal_state"] and summary["equal_grads"]):
        problems.append("the ranks' state or gradient differ")
    for o in outs:
        if any(v != 3 for v in o["launches"].values()):
            problems.append(f"rank {o['rank']} launches {o['launches']}, expected 3 each")
        if not all(np.isfinite(v) for m in o["history"] for v in m.values()):
            problems.append(f"rank {o['rank']}: non-finite metrics")
    if any(c["all_reduce"] != want_all_reduces or c["broadcast"]
           for o in outs for c in o["collectives"]):
        problems.append(f"collectives {[o['collectives'] for o in outs]}, expected "
                        f"{want_all_reduces} all-reduces a step (2 a train-mode BatchNorm, the "
                        "loss sums, the gradient, the confusion matrix)")
    if problems:
        raise AssertionError("two gloo ranks, train: " + "; ".join(problems))
    out = {k: [o["launches"][k] for o in outs] for k in outs[0]["launches"]}
    out.update({k: [o["bn_fused"]["launches"][k] for o in outs] for k in _bn_counts()})
    return out


def bn_fused_ranks(ref, ranks, layout, problems):
    """(b)'s f32 step 1 with bn_impl="fused" on the two ranks against the
    single-process one on the global batch: the losses and the gradient
    (whole and parameter by parameter) within BAR_FACTOR times the largest
    distance a reordering of the same sums shows on the card, as the
    default step is held: permuting the rows of the fused step, of the
    default step, and the default step's own two ranks against its single
    process (one permutation alone is a poor sample: a near-tie of an L1
    decision that flips moves a gated weak loss, and the L2 human head's
    3-element norm gradient with it, by a pixel's share). N1/N2 once a
    layer on each rank and in each single-process step. Appends to
    ``problems``; returns the numbers."""
    (want, want_g, single), (perm, perm_g, permuted) = (ref["bn_fused", "global"],
                                                        ref["bn_fused", "permuted"])
    (flax, flax_g), (flax_perm, flax_perm_g) = (ref["float32", "global"],
                                                ref["float32", "permuted"])
    flax_ranks, flax_ranks_g = ranks[0]["out"]["f32"]["history"][0], ranks[0]["f32_grads"]
    got_g = ranks[0]["bn_fused_grads"]
    rows = {}
    for k in want:
        floor = 1e-3 if k == "miou" else 1e-6 * abs(want[k])
        got = [r["out"]["bn_fused"]["history"][0][k] for r in ranks]
        noise = [abs(perm[k] - want[k]), abs(flax_perm[k] - flax[k]),
                 abs(flax_ranks[k] - flax[k])]
        rows[k] = dict(single=want[k], ranks=got, permuted=perm[k],
                       bar=spread_bar(noise, floor))
        if any(abs(g - want[k]) > rows[k]["bar"] for g in got):
            problems.append(f"bn_fused step-1 {k}: {rows[k]}")

    def noise_of(part):
        return max(_rel_norm(perm_g[part], want_g[part]),
                   _rel_norm(flax_perm_g[part], flax_g[part]),
                   _rel_norm(flax_ranks_g[part], flax_g[part]))

    whole = slice(0, len(want_g))
    grad = dict(ranks=_rel_norm(got_g, want_g), noise=noise_of(whole))
    grad["bar"] = spread_bar([grad["noise"]], 1e-7)
    worst = None
    for name, shape, _, offset in layout:
        part = slice(offset, offset + int(np.prod(shape)))
        dist, noise = _rel_norm(got_g[part], want_g[part]), noise_of(part)
        ratio = dist / max(noise, PARAM_FLOOR)
        if worst is None or ratio > worst["ratio"]:
            worst = dict(param=name, ratio=ratio, ranks=dist, noise=noise)
    grad["worst_param"] = worst
    if grad["ranks"] > grad["bar"] or worst["ratio"] > BAR_FACTOR:
        problems.append(f"bn_fused step-1 gradient {grad}")
    launches = [r["out"]["bn_fused"]["launches"] for r in ranks] + [single, permuted]
    if any(v != FLAGSHIP_BATCH_NORMS for counts in launches for v in counts.values()):
        problems.append(f"bn_fused launches {launches}, expected {FLAGSHIP_BATCH_NORMS} each")
    return dict(losses=rows, grad_rel_norm=grad, launches=launches)


def _batch_norms(settings):
    """The model's train-mode BatchNorm layers (two all-reduces each a step)."""
    from iv2019_tpu_torch.models.model import build_model

    model = build_model(settings.replace(device="cpu"))
    return sum(1 for m in model.modules()
               if type(m).__name__ == "Norm" and m.norm_type == "batch")


def _rank_file(tmp, what, rank):
    import os

    return os.path.join(tmp, f"multirank_{what}_{rank}.pt")


def gloo_eval(tmp, sweep):
    """(c): evaluate_cli --eval_all_ckpts --fused_block as a sweep of two
    gloo processes on cuda:0 over the train run's checkpoints 3, 6 and 8:
    the merged matrices equal, integer for integer, to phase 7's; B4/B5
    launches per process by the dispatch rule (checkpoints 3 and 8 on
    process 0, 6 on process 1)."""
    from iv2019_tpu_torch.parallel.multihost import free_port

    t0 = time.perf_counter()
    _spawn_ranks(_gloo_eval_rank, (free_port(), sweep["argv"], tmp), "gloo eval")
    wall_s = time.perf_counter() - t0
    outs = [torch.load(_rank_file(tmp, "eval", r), weights_only=False) for r in range(RANKS)]
    want_steps = [step for step, _ in sweep["matrices"]]
    per_ckpt = add_launches({}, EVAL_NB, 64, 128, forwards=EVAL_NEVAL // EVAL_NB)
    owned = [len(range(r, len(want_steps), RANKS)) for r in range(RANKS)]
    problems = []
    for r, o in enumerate(outs):
        steps = [step for step, _ in o["matrices"]]
        equal = steps == want_steps and all(
            np.array_equal(cm, want) and cm.dtype == np.int64
            for (_, cm), (_, want) in zip(o["matrices"], sweep["matrices"]))
        want_launches = {k: v * owned[r] for k, v in per_ckpt.items()}
        if not equal:
            problems.append(f"process {r}: merged matrices differ from phase 7's")
        if o["launches"] != want_launches:
            problems.append(f"process {r}: launches {o['launches']}, expected {want_launches}")
    out = dict(processes=RANKS, wall_s=wall_s, steps=want_steps, checkpoints_owned=owned,
               per_process=[{k: o[k] for k in ("launches", "wall_s", "peak_gib")} for o in outs],
               equal_to_phase7=not problems)
    log("multirank (c) two gloo processes, eval sweep: " + json.dumps(out))
    if problems:
        raise AssertionError("two gloo processes, eval: " + "; ".join(problems))
    return {k: [o["launches"][k] for o in outs] for k in per_ckpt}


# ---------------------------------------------------------------- phase 12

# a spatial rank's peak memory against the single-process step's at the same
# batch (tests/test_spatial_memory.py holds JAX's temp memory under 0.75x at
# 4 partitions; at 2 the activations halve)
SPATIAL_PEAK_RATIO = 0.75
# bf16 steps a spatial rank takes with B6 (the first warms cuDNN up)
SPATIAL_STEPS = 4
def _spatial_settings(rank, port, **kw):
    return _train_settings_full(num_processes=SPATIAL_RANKS, process_id=rank, num_devices=1,
                                coordinator_address=f"localhost:{port}",
                                spatial_partitions=SPATIAL_RANKS, **kw)


def _spatial_train_rank(rank, port, tmp):
    """One of the two gloo ranks of phase 12(a): one spatial group on
    cuda:0, each rank the band of 256 rows of the 16 images."""
    from iv2019_tpu_torch.parallel import mesh as pmesh
    from iv2019_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    settings = _spatial_settings(rank, port)
    mesh = multihost.initialize(settings, backend="gloo")
    try:
        batch = multihost.put_sharded(train_batch(np.random.RandomState(0), torch.device("cpu")),
                                      mesh)
        opt, state, step = _fused_run(settings.replace(compute_dtype="float32"), mesh)
        _, m = step(state, batch)
        f32 = dict(history=[_metrics(m)], grads_digest=_digest([opt.grads]))
        f32_grads = opt.grads.detach().cpu().clone()
        del opt, state, step, m
        torch.cuda.empty_cache()

        opt, state, step = _fused_run(settings, mesh)
        pmesh.replicate([opt.params] + list(opt.model.buffers()), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _reset_counts()
        history, times, colls = [], [], []
        for _ in range(SPATIAL_STEPS):
            pmesh.reset_collective_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            colls.append(pmesh.collective_stats())
            history.append(_metrics(m))
        launches = _counts()
        digests = _state_digest(opt, state)
        peak = torch.cuda.max_memory_allocated()
        # one step with every collective timed alone, those over the spatial
        # group apart: the halo exchanges and, where the model has group norm
        # or PSP (this one has neither), their spatial sums
        timed, restore = _timed_collectives(mesh.spatial_group)
        t0 = time.perf_counter()
        try:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            restore()
        timed_ms = (time.perf_counter() - t0) * 1e3
        profile = profile_call(lambda: step(state, batch), f"spatial rank {rank} step",
                               float(np.median(times[1:])), top=6, groups=STEP_GROUPS,
                               host_waits=False)
        out = dict(rank=rank, band_rows=TRAIN_HW[0] // SPATIAL_RANKS, f32=f32, history=history,
                   step_ms=times, step_p50_ms=float(np.median(times[1:])),
                   timed_step_ms=timed_ms, spatial_group_ms=timed["group_seconds"] * 1e3,
                   other_collective_ms=(timed["seconds"] - timed["group_seconds"]) * 1e3,
                   collectives=colls,
                   launches=launches, digests=digests, peak_gib=peak / 2**30,
                   step_peak_gib=(peak - before) / 2**30,
                   device_busy_ms=profile["device_busy_ms"], idle_share=profile["idle_share"])
        torch.save({"out": out, "f32_grads": f32_grads if rank == 0 else None},
                   _rank_file(tmp, "spatial_train", rank))
    finally:
        multihost.shutdown()


def _spatial_references(device):
    """The single-process steps phase 12(a) is held to, on the global batch:
    f32 step 1 with the unfused loss (the spatial step's), on the batch and
    on its rows permuted; and the default bf16 step (fused loss, B6) for the
    peak memory at the same batch."""
    settings = _train_settings_full()
    batch = train_batch(np.random.RandomState(0), device)
    permuted = {k: torch.flip(v, dims=(0,)) for k, v in batch.items()}
    ref = {}
    for name, b in (("global", batch), ("permuted", permuted)):
        opt, state, step = _fused_run(settings.replace(compute_dtype="float32", fused_loss=False))
        _, m = step(state, b)
        ref[name] = (_metrics(m), opt.grads.detach().cpu().clone())
        ref["layout"] = opt.layout
        del opt, state, step, m
        torch.cuda.empty_cache()
    del permuted
    opt, state, step = _fused_run(settings)
    state, _ = step(state, batch)  # a warm-up, as the ranks' first step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ref["single_peak_gib"], ref["single_step_peak_gib"] = peak / 2**30, (peak - before) / 2**30
    del opt, state, step, batch
    torch.cuda.empty_cache()
    return ref


def spatial_train(device, tmp):
    """(a): two gloo ranks, one spatial group, on the train cell at full
    width: step 1 in f32 against the single-process step (the unfused loss,
    as the spatial step runs) under BAR_FACTOR times a row permutation's
    distance, losses and the gradient parameter by parameter; then 3 bf16
    steps with B6: the state bit-equal on both ranks, B3 and B6 once a step,
    B1/B2 never; per rank step ms, device busy, peak memory, halo exchanges
    (count, bytes, ms) against the single-process peak."""
    from iv2019_tpu_torch.parallel.multihost import free_port

    ref = _spatial_references(device)
    t0 = time.perf_counter()
    _spawn_ranks(_spatial_train_rank, (free_port(), tmp), "spatial train")
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(_rank_file(tmp, "spatial_train", r), weights_only=False)
             for r in range(SPATIAL_RANKS)]
    outs = [r["out"] for r in ranks]
    (want, want_g), (perm, perm_g) = ref["global"], ref["permuted"]
    problems, losses = [], {}
    for k in ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation",
              "regularization", "miou"):
        floor = 1e-3 if k == "miou" else 1e-6 * abs(want[k])
        bar = spread_bar([abs(perm[k] - want[k])], floor)
        got = [o["f32"]["history"][0][k] for o in outs]
        losses[k] = dict(single=want[k], ranks=got, permuted=perm[k], bar=bar)
        if any(abs(g - want[k]) > bar for g in got):
            problems.append(f"f32 step-1 {k}: {losses[k]}")
    got_g = ranks[0]["f32_grads"]
    grad = dict(ranks=_rel_norm(got_g, want_g), permuted=_rel_norm(perm_g, want_g))
    grad["bar"] = spread_bar([grad["permuted"]], 1e-7)
    grad["worst_param"] = _worst_param(got_g, want_g, perm_g, ref["layout"])
    if grad["ranks"] > grad["bar"] or grad["worst_param"]["ratio"] > BAR_FACTOR:
        problems.append(f"f32 step-1 gradient {grad}")
    summary = dict(
        ranks=SPATIAL_RANKS, layout="spatial 2 x data 1", backend="gloo",
        device="cuda:0 (shared)", wall_s=wall_s, band_rows=outs[0]["band_rows"],
        step1_f32=dict(losses=losses, grad_rel_norm=grad),
        single_peak_gib=ref["single_peak_gib"], single_step_peak_gib=ref["single_step_peak_gib"],
        per_rank=[{k: o[k] for k in ("step_ms", "step_p50_ms", "timed_step_ms", "spatial_group_ms",
                                     "other_collective_ms", "device_busy_ms", "idle_share",
                                     "peak_gib", "step_peak_gib", "launches", "collectives")}
                  for o in outs],
        equal_state=outs[0]["digests"] == outs[1]["digests"],
        equal_f32_grads=outs[0]["f32"]["grads_digest"] == outs[1]["f32"]["grads_digest"])
    log("spatial (a) two gloo ranks, one spatial group, train: " + json.dumps(summary))
    if not (summary["equal_state"] and summary["equal_f32_grads"]):
        problems.append("the ranks' state or gradient differ")
    for o in outs:
        want_launches = {"fused_loss_fwd": 0, "fused_loss_bwd": 0,
                         "fused_update": SPATIAL_STEPS, "root_conv_wgrad": SPATIAL_STEPS}
        if o["launches"] != want_launches:
            problems.append(f"rank {o['rank']} launches {o['launches']}, expected {want_launches}")
        if not all(np.isfinite(v) for m in o["history"] for v in m.values()):
            problems.append(f"rank {o['rank']}: non-finite metrics")
        if not all(c["halo"] > 0 for c in o["collectives"]):
            problems.append(f"rank {o['rank']}: a step without halo exchanges")
        if not o["peak_gib"] < SPATIAL_PEAK_RATIO * ref["single_peak_gib"]:
            problems.append(f"rank {o['rank']} peak {o['peak_gib']:.2f} GiB, not below "
                            f"{SPATIAL_PEAK_RATIO} x the single process's "
                            f"{ref['single_peak_gib']:.2f}")
    if outs[0]["collectives"] != outs[1]["collectives"]:
        problems.append("the ranks issued different collectives")
    if problems:
        raise AssertionError("spatial train: " + "; ".join(problems))
    return {k: [o["launches"][k] for o in outs] for k in outs[0]["launches"]}


def _spatial_eval_argv(sweep):
    """evaluate_cli on the train run's checkpoint 8 at SPATIAL_EVAL_SIZE
    (the model runs there), from phase 7's arguments."""
    argv = [a for a in sweep["argv"] if a != "--eval_all_ckpts"]
    return argv + ["--ckpt_path", "8", "--eval_size", *map(str, SPATIAL_EVAL_SIZE)]


def _eval_decisions(argv, band_mesh=None, one_by_one=False):
    """The model's decisions on every eval batch, from checkpoint 8, in
    order: a rank's band under a spatial mesh; with ``one_by_one`` an image
    a forward."""
    from iv2019_tpu_torch.parallel import mesh as pmesh

    settings = _eval_settings(argv)
    model = _checkpoint_model(settings, settings.log_dir, 8)
    out = []
    with torch.inference_mode():
        for x, _ in _eval_batches(settings, argv[2]):
            if band_mesh is not None:
                x = pmesh.shard_height(x, band_mesh)
            if one_by_one:
                out += [model(x[i:i + 1])["decisions"].cpu() for i in range(len(x))]
            else:
                out.append(model(x)["decisions"].cpu())
    return torch.cat(out)


def _spatial_eval_rank(rank, port, argv, tmp):
    """One of the two ranks of phase 12(b): evaluate_cli --num_devices 2
    --spatial_partitions 2, the ranks of one process's devices sharing
    cuda:0 over gloo."""
    from iv2019_tpu_torch import evaluate_cli
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = multihost.initialize(
        Settings(device="cuda", num_devices=SPATIAL_RANKS, spatial_partitions=SPATIAL_RANKS,
                 coordinator_address=f"localhost:{port}"),
        backend="gloo", local_rank=rank, device="cuda:0")
    try:
        _reset_fb()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = evaluate_cli.main(argv)
        wall_s = time.perf_counter() - t0
        launches = _fb_counts()
        decisions = _eval_decisions(argv, mesh)
        torch.save(dict(matrices=[(m["global_step"], m["confusion_matrix"]) for m in metrics],
                        mean_iou=metrics[0]["mean_iou"], launches=launches, wall_s=wall_s,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        decisions=decisions),
                   _rank_file(tmp, "spatial_eval", rank))
    finally:
        multihost.shutdown()


def spatial_eval(tmp, sweep):
    """(b): evaluate_cli --num_devices 2 --spatial_partitions 2 --fused_block
    on checkpoint 8 at 1024x2048: B4/B5 launches per rank exact and > 0;
    each rank's matrix equal integer for integer to the eval step's in one
    process over the same batches an image at a time, from a fresh model
    holding the checkpoint, and the decisions of every eval batch equal on
    every pixel to that model's, an image a forward. That reference, and not phase 7's batch of 2 in one
    forward, because cuDNN picks its bf16 conv algorithms by problem size,
    and a band of both images is the size of one whole image: the batch of
    2 differs from its own images one at a time on 5961 of the first
    batch's 4.19M pixels at this checkpoint (on the H100, near-ties at the
    images' tops and bottoms, none at the cut). The distances to the batch
    of 2 (differing pixels, matrix entries, mIoU) are printed."""
    from iv2019_tpu_torch.parallel.multihost import free_port

    argv = _spatial_eval_argv(sweep)
    metrics, single = _run_evaluate(argv)
    batch_cm, batch_miou = metrics[0]["confusion_matrix"], metrics[0]["mean_iou"]
    settings = _eval_settings(argv)
    want_cm = _step_matrix(settings, _checkpoint_model(settings, settings.log_dir, 8), argv[2],
                           one_by_one=True)[:-1, :-1]
    batch_decisions = _eval_decisions(argv)
    want_decisions = _eval_decisions(argv, one_by_one=True)
    torch.cuda.empty_cache()
    spatial_argv = argv + ["--num_devices", str(SPATIAL_RANKS), "--spatial_partitions",
                           str(SPATIAL_RANKS)]
    t0 = time.perf_counter()
    _spawn_ranks(_spatial_eval_rank, (free_port(), spatial_argv, tmp), "spatial eval")
    wall_s = time.perf_counter() - t0
    outs = [torch.load(_rank_file(tmp, "spatial_eval", r), weights_only=False)
            for r in range(SPATIAL_RANKS)]
    per_forward = spatial_launches_per_forward()
    forwards = EVAL_NEVAL // EVAL_NB
    want_launches = {k: v * forwards for k, v in per_forward.items()}
    decisions = torch.cat([o["decisions"] for o in outs], dim=1)
    if decisions.shape != want_decisions.shape:
        raise AssertionError(f"spatial eval: decisions of shape {tuple(decisions.shape)}, "
                             f"expected {tuple(want_decisions.shape)}")
    differ = (decisions != want_decisions).flatten(1).sum(1).tolist()
    problems = []
    if sum(differ):
        problems.append(f"decisions differ from one image a forward on {differ} pixels an image")
    for r, o in enumerate(outs):
        (_, cm), = o["matrices"]
        if o["launches"] != want_launches or min(o["launches"].values()) <= 0:
            problems.append(f"rank {r}: launches {o['launches']}, expected {want_launches}")
        if cm.dtype != np.int64 or not np.array_equal(cm, want_cm):
            problems.append(f"rank {r}: a {cm.dtype} matrix {int(np.abs(cm - want_cm).sum())} "
                            f"entries off one process's, an image a step")
    (_, cm0), = outs[0]["matrices"]
    out = dict(ranks=SPATIAL_RANKS, eval_size=list(SPATIAL_EVAL_SIZE), wall_s=wall_s,
               single=single, single_mean_iou=batch_miou,
               per_rank=[{k: o[k] for k in ("launches", "wall_s", "peak_gib", "mean_iou")}
                         for o in outs],
               launches_expected=want_launches, pixels=want_decisions.numel(),
               differing_pixels_per_image=differ,
               matrices_equal_one_by_one=bool(np.array_equal(cm0, want_cm)),
               differing_from_the_batch_of_2=int((decisions != batch_decisions).sum()),
               batch_of_2_differing_from_one_by_one=int((batch_decisions != want_decisions).sum()),
               matrix_entries_from_the_batch_of_2=int(np.abs(cm0 - batch_cm).sum()),
               mean_iou_from_the_batch_of_2=float(outs[0]["mean_iou"] - batch_miou))
    log("spatial (b) evaluate_cli --num_devices 2 --spatial_partitions 2: " + json.dumps(out))
    if problems:
        raise AssertionError("spatial eval: " + "; ".join(problems))
    return {k: [o["launches"][k] for o in outs] for k in per_forward}


def spatial_phase(device, tmp, sweep):
    """Phase 12 (see the module docstring); returns each kernel's launches
    per rank on the spatial train and eval paths."""
    torch.cuda.empty_cache()
    train = spatial_train(device, tmp)
    torch.cuda.empty_cache()
    evaluation = spatial_eval(tmp, sweep)
    out = {k: {"train_ranks": v} for k, v in train.items()}
    out.update({k: {"eval_ranks": v} for k, v in evaluation.items()})
    return out


def multirank_phase(device, tmp, sweep):
    """Phase 11 (see the module docstring); returns the launches of each
    kernel per run and rank."""
    torch.cuda.empty_cache()
    world1 = nccl_world_one(device)
    torch.cuda.empty_cache()
    train = gloo_train(device, tmp)
    torch.cuda.empty_cache()
    evaluation = gloo_eval(tmp, sweep)
    out = {k: {"nccl_world1": world1[k], "gloo_ranks": train[k]} for k in world1}
    out.update({k: {"gloo_eval_processes": v} for k, v in evaluation.items()})
    out.update({k: {"gloo_ranks_bn_fused_step1": train[k]} for k in _bn_counts()})
    return out


SERVE_HW = (512, 1024)
SERVE_ITERS = 20  # timed executes of serve(), after its warm-up
# served u8 decisions against the eager --fused_block forward on the same
# frames (the same operations; the package rounds to bf16 where it does)
SERVE_DECISIONS_MIN = 0.999
SERVE_UNITS = {"fused_bottleneck": 8, "fused_bottleneck_ct": 2}  # per request at 1x512x1024
EXPORT_TIMEOUT_S = 900  # the export CLIs' runs, counted from phase 13's start


def build_serving():
    """Phase 1, second part: the operator library (``csrc/torch_ops.cpp``
    with its CUDA implementation, linked against the kernels' library) and
    the C++ loader (``serving/aoti_loader.cc``), both with ``g++`` at once,
    then the library loaded here, which the wrappers call on the card."""
    from concurrent.futures import ThreadPoolExecutor

    from iv2019_tpu_torch import serving
    from iv2019_tpu_torch.ops import _build
    from iv2019_tpu_torch.ops import fused_block as fb

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        ops, loader = pool.submit(_build.build_ops), pool.submit(serving.build)
        ops, loader = ops.result(), loader.result()
    fb.ops_library()
    log(f"built {ops.name} and {os.path.basename(loader)} in {time.time() - t0:.1f}s")


def _stream_log(path):
    """(requests served, op launches after the warm-up, op launches at the
    end) from a StreamServer's diagnostics."""
    lines = open(path).read().splitlines()
    warm = json.loads(next(x for x in lines if x.startswith('{"metric"')))["detail"]
    done = next(x for x in lines if x.startswith("streaming done:"))
    return (int(done.split()[2]), warm["op_launches"],
            json.loads(done.split("op_launches ", 1)[1]))


def _served_model(cli, device, fused, dtype):
    """The eager port's served forward (u8 wire) with the weights of
    ``cli``'s .npz."""
    from iv2019_tpu_torch.config import Settings
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import restore_variables
    from iv2019_tpu_torch.tools.export_model import ServedForward

    log_dir, npz, problem = cli
    settings = Settings(mode="predict", log_dir=log_dir, training_problem_def_path=problem,
                        height_feature_extractor=SERVE_HW[0], width_feature_extractor=SERVE_HW[1],
                        fused_block=fused, compute_dtype=dtype, ckpt_path=npz).finalize()
    model = build_model(settings, device)
    restore_variables(model, settings)
    return ServedForward(model.eval(), None, True)


def _eager_decisions(forward, frames, device):
    """``forward``'s u8 decisions on ``frames`` (the served signature)."""
    with torch.inference_mode():
        out = [forward(torch.from_numpy(f).to(device))[0].cpu().numpy() for f in frames]
    return np.stack(out)


def start_export(cli):
    """Phase 13's export CLI as a user runs it on phase 4's log dir and
    .npz, once ``--fused_block --wire_u8`` and once with its defaults
    (unfused, f32 signature), each with its AOTInductor compile: started as
    processes right after phase 9, so that their ~2 min of host work runs
    beside phases 10-12 (whose times no record holds as a measurement), and
    collected by ``export_serve_phase``. Returns {key: (process, its log
    file)}."""
    log_dir, npz, problem = cli
    procs = {}
    for key, flags in (("fused", ["--fused_block", "--wire_u8"]), ("unfused", [])):
        out_dir = os.path.join(log_dir, f"export_{key}")
        os.makedirs(out_dir)
        out = open(os.path.join(out_dir, "export_model.log"), "w")
        procs[key] = (subprocess.Popen(
            [sys.executable, "-m", "iv2019_tpu_torch.tools.export_model", log_dir, problem,
             out_dir, *flags, "--height", str(SERVE_HW[0]), "--width", str(SERVE_HW[1]),
             "--ckpt_path", npz],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
            stderr=subprocess.STDOUT, text=True), out)
    return procs


def stop_export(export):
    """Kill ``start_export``'s processes that still run."""
    for proc, out in export.values():
        stop(proc)
        out.close()


def collect_export(export, key, t_phase):
    """Waits for ``start_export``'s ``key`` process; returns its paths."""
    proc, out = export[key]
    proc.wait(timeout=max(1, EXPORT_TIMEOUT_S - (time.time() - t_phase)))
    out.close()
    text = open(out.name).read()
    if proc.returncode != 0:
        raise AssertionError(f"export_model {key} failed rc={proc.returncode}:\n{text[-3000:]}")
    log(f"export/serve {key}: the export CLI collected {time.time() - t_phase:.1f} s into "
        f"the phase")
    return json.loads(next(line for line in reversed(text.splitlines())
                           if line.startswith('{"program"')))


def stop(proc):
    """Kill ``proc`` if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _program_check(key, paths, want):
    """The exported program's operator nodes (``want``: the fused units and
    ``bn_eval``, one a norm they leave), no arithmetic on the weights alone,
    no ``rsqrt`` in its graph."""
    from iv2019_tpu_torch.tools import export_model as em

    program = torch.export.load(paths["program"])
    nodes, left = em.op_nodes(program), em.weight_only_nodes(program)
    del program
    text = open(paths["graph"]).read()
    if nodes != want or left or "rsqrt" in text:
        raise AssertionError(f"{key} program: operator nodes {nodes} (expected {want}), "
                             f"weight arithmetic per request {left[:3]}")
    return text


def export_serve_phase(cli, device, export):
    """Phase 13 (see the module docstring); ``export`` is ``start_export``'s.
    Returns B4/B5's launches in the served runs."""
    from iv2019_tpu_torch import serving

    t_phase = time.time()
    shape = (1, *SERVE_HW, 3)
    # the predict phase's request count, as seeded u8 frames
    frames = np.random.RandomState(13).randint(0, 256, (REQUESTS, *shape)).astype(np.uint8)
    # while the programs may still compile: the eager unfused decisions
    unfused = _eager_decisions(_served_model(cli, device, False, "bfloat16"), frames, device)
    torch.cuda.empty_cache()
    # both compiles done before anything is timed
    exported = {key: collect_export(export, key, t_phase) for key in ("fused", "unfused")}
    out = {}
    for key, dtype, units in (("fused", "uint8", SERVE_UNITS),
                              ("unfused", "float32", dict.fromkeys(SERVE_UNITS, 0))):
        paths = exported[key]
        norms = FLAGSHIP_BATCH_NORMS - 3 * sum(units.values())
        graph = _program_check(key, paths, {**units, "bn_eval": norms})
        report = serving.serve(paths["package"], shape, iters=SERVE_ITERS, input_dtype=dtype)
        runs = SERVE_ITERS + 1  # the warm-up too
        launched = report["detail"]["op_launches"]  # the loader counts the fused units'
        if launched != {k: v * runs for k, v in units.items()}:
            raise AssertionError(f"{key}: the loader launched {launched} in {runs} executes, "
                                 f"expected {units} each")
        out[key] = dict(export_s=paths["seconds"]["export"],
                        compile_s=paths["seconds"]["compile"],
                        package_mb=os.path.getsize(paths["package"]) / 1e6,
                        graph_ops=graph.count(" = torch.ops."), serve_p50_ms=report["value"],
                        serve_p90_ms=report["detail"]["p90_ms"], serve_launches=launched,
                        output0_bytes=report["detail"]["output0_bytes"],
                        package=paths["package"])
        log(f"export/serve {key}: " + json.dumps(out[key]))

    # the frames one at a time and then pipelined, through one serving process
    server = serving.StreamServer(out["fused"]["package"], shape, input_dtype="uint8")
    try:
        server.infer(frames[0])  # waits for the load and the loader's warm-up
        one, one_ms = [], []
        for f in frames:
            t0 = time.perf_counter()
            one.append(server.infer(f))
            one_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        piped = server.infer_many(frames)
        piped_s = time.perf_counter() - t0
    finally:
        rc = server.close()
    if rc != 0:
        raise AssertionError(f"the serving process ended with rc {rc}")
    served, warm, final = _stream_log(server.stderr_path)
    per_request = {k: (final[k] - warm[k]) / served for k in final}
    if served != 2 * REQUESTS + 1 or per_request != {k: float(v) for k, v in SERVE_UNITS.items()}:
        raise AssertionError(f"stream: {served} requests, launches per request {per_request}")

    def decisions(outputs):
        return np.stack([np.frombuffer(b, np.uint8).reshape(shape[:3]) for b in outputs])

    one, piped = decisions(one), decisions(piped)
    fused = _eager_decisions(_served_model(cli, device, True, "bfloat16"), frames, device)
    truth = _eager_decisions(_served_model(cli, device, False, "float32"), frames, device)
    torch.cuda.empty_cache()
    stats = dict(
        one_vs_eager_fused=float((one == fused).mean()),
        piped_vs_eager_fused=float((piped == fused).mean()),
        piped_vs_one=float((piped == one).mean()),
        served_vs_f32=float((one == truth).mean()),
        eager_unfused_vs_f32=float((unfused == truth).mean()),
        eager_fused_vs_f32=float((fused == truth).mean()),
        stream_ms=one_ms, stream_p50_ms=_p50_p90(one_ms)[0], stream_p90_ms=_p50_p90(one_ms)[1],
        pipelined_ms_per_request=piped_s * 1e3 / REQUESTS,
        pipelined_requests_per_s=REQUESTS / piped_s,
        launches_per_request=per_request, requests_served=served,
        phase_s=time.time() - t_phase,
    )
    log("export/serve stream: " + json.dumps(stats))
    if not (stats["one_vs_eager_fused"] >= SERVE_DECISIONS_MIN
            and stats["piped_vs_eager_fused"] >= SERVE_DECISIONS_MIN):
        raise AssertionError(f"served decisions depart from eager --fused_block predict: {stats}")
    if not stats["served_vs_f32"] >= stats["eager_unfused_vs_f32"] - PREDICT_TRUTH_DECISIONS_SLACK:
        raise AssertionError(f"served decisions further from f32 than the unfused path: {stats}")
    return {k: dict(serve_runs=out["fused"]["serve_launches"][k], stream_per_request=v,
                    stream_requests=served) for k, v in per_request.items()}


# phase 14: the bench's runs, (label, arguments, knobs): each of its five
# modes once and each kernel knob once (B6 on and N1/N2 off, as
# IV_BN_IMPL=flax, in one train run; predict and eval only fused: unfused they launch no port
# kernel); step counts cut from the bench's defaults (20 train steps, 30
# requests, 12 eval steps and input batches, 20 e2e steps) to the fewest that
# exercise each mode's timed part. Each run is a process (~8 s to reach the
# card, then its model and cuDNN's choices), which sets the phase's time.
BENCH_RUNS = [
    ("train", ["train", "3"], {}),
    ("train_b6_bn_flax", ["train", "3"], {"IV_ROOT_WGRAD_PALLAS": "1", "IV_BN_IMPL": "flax"}),
    ("predict_fused", ["predict", "5"], {"IV_FUSED_BLOCK": "1"}),
    ("eval_fused", ["eval", "2"], {"IV_FUSED_BLOCK": "1"}),
    ("input", ["input", "2"], {}),
    ("e2e", ["e2e", "2"], {}),
]
BENCH_METRICS = {"train": "train_images_per_sec_per_chip", "predict": "predict_p50_latency_ms",
                 "eval": "eval_images_per_sec_per_chip", "input": "input_pipeline_images_per_sec",
                 "e2e": "e2e_train_images_per_sec_per_chip"}
BENCH_TIMEOUT_S = 300


def _bench_want(argv, knobs):
    """The launches each kernel must make in a bench run's timed part."""
    want = dict.fromkeys(REPLACES, 0)
    steps = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 0
    if argv[0] in ("train", "e2e"):
        want.update(fused_loss_fwd=steps, fused_loss_bwd=steps, fused_update=steps)
        if knobs.get("IV_ROOT_WGRAD_PALLAS") == "1":
            want["root_conv_wgrad"] = steps
        if knobs.get("IV_BN_IMPL") != "flax":
            want.update(fused_bn_fwd=steps * FLAGSHIP_BATCH_NORMS,
                        fused_bn_bwd=steps * FLAGSHIP_BATCH_NORMS)
    elif argv[0] == "predict" and knobs.get("IV_FUSED_BLOCK") == "1":
        want.update(add_launches({}, 1, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, steps))
    elif argv[0] == "eval" and knobs.get("IV_FUSED_BLOCK") == "1":
        want.update(add_launches({}, 8, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, steps))
    return want


def bench_phase():
    """Phase 14 (see the module docstring); returns each kernel's launches
    by bench run."""
    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items() if not k.startswith("IV_")}
    launches = {name: {} for name in REPLACES}
    for label, argv, knobs in BENCH_RUNS:
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "iv2019_tpu_torch.bench", *argv],
                              cwd=root, env={**base, **knobs}, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"bench {label} failed rc={proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1])
        log(f"bench {label} ({time.time() - t0:.1f} s): {lines[-1]}")
        metric = BENCH_METRICS[argv[0]]
        value = line.get("value")
        if (len(lines) != 1 or line.get("metric") != metric
                or not isinstance(value, (int, float)) or not np.isfinite(value) or value <= 0):
            raise AssertionError(f"bench {label}: expected one line of {metric} with a finite, "
                                 f"positive value, got {proc.stdout[-2000:]}")
        got = line["detail"].get("launches", dict.fromkeys(REPLACES, 0))
        want = _bench_want(argv, knobs)
        if got != want:
            raise AssertionError(f"bench {label}: launches {got}, expected {want}")
        for name in REPLACES:
            launches[name][label] = got[name]
    log(f"bench: phase took {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 15
PROBE_STEPS = 300
PROBE_HW = (128, 256)
WARM_HW, WARM_NB = (128, 256), (2, 2, 2)
WEAK_AB_CUT = ["--seeds", "1", "--n_pp", "8", "--n_weak", "32", "--n_val", "8", "--ne", "4"]
QUALITY_AB_CUT = ["--seeds", "1", "--ne", "1", "--n_train", "16", "--n_val", "8"]
TOOL_TIMEOUT_S = 600
TF_CKPT_DIR = os.path.join("tests", "data", "tf_ckpt")
# (fixture, {mode: expected file}); a mode left out is not held
TF_FIXTURES = [("v1.ckpt", {"warm": "expected_v1_warm.npz", "full": "expected_v1_full.npz"}),
               ("v1_sliced.ckpt", {"warm": "expected_v1_sliced.npz"}),
               ("v2", {"warm": "expected_v2_warm.npz", "full": "expected_v2_full.npz"})]
# the main kernel of each of B1, B2, B3 in a torch.profiler trace
TRACE_KERNELS = {"fused_loss_fwd": "fwd_walk_kernel<", "fused_loss_bwd": "bwd_walk_kernel<",
                 "fused_update": "update_kernel<"}


def _npz_equal(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    if sorted(got.files) != sorted(want.files):
        return f"keys {sorted(got.files)} != {sorted(want.files)}"
    for k in want.files:
        g, w = got[k], want[k]
        if (g.dtype, g.shape) != (w.dtype, w.shape) or g.tobytes() != w.tobytes():
            return f"{k}: {g.dtype}{g.shape} differs from {w.dtype}{w.shape}"
    return None


def converter_check(tmp):
    """Phase 15(a); returns the warm-started step's launches."""
    from iv2019_tpu_torch import native
    from iv2019_tpu_torch.bench import make_train, train_batch, train_settings
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.utils import tf_checkpoint
    from iv2019_tpu_torch.utils.checkpoint import (convert_tf_checkpoint_to_npz,
                                                   warm_start_from_npz)

    root = os.path.dirname(os.path.abspath(__file__))
    probe = subprocess.run([sys.executable, "-c", "import tensorflow"], capture_output=True,
                           text=True, timeout=120)
    log(f"quality: `import tensorflow` {'fails' if probe.returncode else 'succeeds'} here"
        + (f" ({probe.stderr.strip().splitlines()[-1][:120]})" if probe.returncode else ""))
    data = os.path.join(root, TF_CKPT_DIR)
    converted = {}
    for fixture, modes in TF_FIXTURES:
        for mode, expected in modes.items():
            out = os.path.join(tmp, f"{fixture}_{mode}.npz")
            t0 = time.perf_counter()
            n = convert_tf_checkpoint_to_npz(os.path.join(data, fixture), out,
                                             full=mode == "full")
            ms = (time.perf_counter() - t0) * 1e3
            problem = _npz_equal(out, os.path.join(data, expected))
            if problem:
                raise AssertionError(f"converter: {fixture} {mode}: {problem}")
            log(f"quality: converted {fixture} ({mode}): {n} variables in {ms:.1f} ms, "
                f"bit-equal to {expected}")
            converted[(fixture, mode)] = out
    log(f"quality: native helpers {native.status()['fastops']}")
    buf = np.random.RandomState(0).randint(0, 256, 64 << 20).astype(np.uint8).tobytes()
    t0 = time.perf_counter()
    crc = native.crc32c(buf)
    native_s = time.perf_counter() - t0
    if crc is None:
        raise AssertionError(f"converter: the native CRC-32C is unavailable: {native.status()}")
    t0 = time.perf_counter()
    plain = tf_checkpoint.crc32c_py(buf[:1 << 20])
    plain_s = time.perf_counter() - t0
    if native.crc32c(buf[:1 << 20]) != plain:
        raise AssertionError("converter: native and plain CRC-32C differ")
    log(f"quality: CRC-32C on this host: native {64 / native_s:.1f} MB/s over 64 MB, plain "
        f"Python {1 / plain_s:.2f} MB/s over 1 MB")

    settings = train_settings(*WARM_HW, *WARM_NB)
    model = init_model(build_model(settings), torch.Generator().manual_seed(0))
    restored = sum(warm_start_from_npz(model, converted[(f, "warm")])
                   for f in ("v1.ckpt", "v1_sliced.ckpt"))
    want = np.load(os.path.join(data, "expected_v1.npz"))
    sliced = np.load(os.path.join(data, "expected_v1_sliced.npz"))
    state_dict = model.state_dict()
    checks = [("feature_extractor/base.conv1.conv.weight",
               want["resnet_v1_50/conv1/weights"].transpose(3, 2, 0, 1)),
              ("feature_extractor/base.conv1_norm.var",
               want["resnet_v1_50/conv1/BatchNorm/moving_variance"]),
              ("feature_extractor/base.block1/unit_1.conv1.conv.weight",
               sliced["resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/weights"]
               .transpose(3, 2, 0, 1))]
    for key, value in checks:
        if not np.array_equal(state_dict[key].float().cpu().numpy(), value):
            raise AssertionError(f"warm start: {key} is not the converted value")
    if restored != 6:
        raise AssertionError(f"warm start restored {restored} variables, expected 6")
    state, step = make_train(settings, model)
    batch = train_batch(*WARM_HW, *WARM_NB)
    _reset_counts()
    state, metrics = step(state, batch)
    loss = float(metrics["total"])
    counts = _counts()
    want_counts = dict(fused_loss_fwd=1, fused_loss_bwd=1, fused_update=1, root_conv_wgrad=0)
    if counts != want_counts or not np.isfinite(loss):
        raise AssertionError(f"warm-started step: loss {loss}, launches {counts}")
    log(f"quality: warm start restored {restored} variables (bit-equal); one train step "
        f"at {WARM_NB} x {WARM_HW}: loss {loss:.4f}, launches {counts}")
    del model, state, step
    return counts


def probe_check():
    """Phase 15(b); returns the run's launches."""
    from iv2019_tpu_torch.models.model import build_model, init_model
    from iv2019_tpu_torch.tools import overfit_probe

    settings = overfit_probe.probe_settings(*PROBE_HW, device="cuda")
    model = init_model(build_model(settings.replace(mode="train")),
                       torch.Generator().manual_seed(0))
    _reset_counts()
    t0 = time.perf_counter()
    result = overfit_probe.run(settings, model, PROBE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"quality: overfit probe, {PROBE_STEPS} steps at {PROBE_HW}: {wall:.2f} s "
        f"({wall / PROBE_STEPS * 1e3:.2f} ms a step with its readbacks), launches {counts}")
    log(f"quality: overfit probe {json.dumps(result)}")
    want = dict(fused_loss_fwd=PROBE_STEPS, fused_loss_bwd=PROBE_STEPS,
                fused_update=PROBE_STEPS, root_conv_wgrad=0)
    if counts != want:
        raise AssertionError(f"overfit probe: launches {counts}, expected {want}")
    if not result["learned"]:
        raise AssertionError(f"overfit probe did not learn: {result}")
    del model
    return counts


def _trace_counts(trace):
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(v in n for n in names) for k, v in TRACE_KERNELS.items()}


def start_tools(tmp):
    """Phase 15 (c) and (d): each tool its own process, both started at
    once; returns {name: (process, log file, workdir)} and their start time
    under "t0"."""
    root = os.path.dirname(os.path.abspath(__file__))
    tools = {"t0": time.time()}
    for name, cut in (("weak_ab", WEAK_AB_CUT), ("quality_ab", QUALITY_AB_CUT)):
        workdir = os.path.join(tmp, name)
        out = open(os.path.join(tmp, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", f"iv2019_tpu_torch.tools.{name}", workdir, *cut],
            cwd=root, stdout=out, stderr=subprocess.STDOUT, text=True)
        tools[name] = (proc, out, workdir)
    return tools


def stop_tools(tools):
    for name in ("weak_ab", "quality_ab"):
        stop(tools[name][0])
        tools[name][1].close()


def tools_check(tools):
    """Phase 15 (c) and (d), ``start_tools``' processes: waits for both and
    checks what they wrote; returns the weak and per-pixel arms' traced
    counts."""
    runs = ("weak_ab", "quality_ab")
    outputs = {}
    try:
        for name in runs:
            proc, out, _ = tools[name]
            proc.wait(timeout=max(1, TOOL_TIMEOUT_S - (time.time() - tools["t0"])))
            out.close()
            with open(out.name) as f:
                outputs[name] = f.read()
            if proc.returncode != 0:
                raise AssertionError(f"{name} failed rc={proc.returncode}:\n"
                                     f"{outputs[name][-3000:]}")
    finally:
        stop_tools(tools)
    # a tool's last line goes to its log as it ends
    walls = {name: os.path.getmtime(tools[name][1].name) - tools["t0"] for name in runs}
    for name in runs:
        log(f"quality: {name} done after {walls[name]:.1f} s (both started together)")
        for line in outputs[name].strip().splitlines()[-14:]:
            log(f"  {line[:200]}")

    with open(os.path.join(tools["weak_ab"][2], "weak_ab.json")) as f:
        weak = json.load(f)
    mious = weak["mean_iou_pp"] + weak["mean_iou_weak"]
    if len(mious) != 2 or not np.all(np.isfinite(mious)) or "| **mean IoU** |" not in \
            outputs["weak_ab"]:
        raise AssertionError(f"weak_ab: expected a finite mIoU in both arms and the table, "
                             f"got {weak}")
    with open(os.path.join(tools["quality_ab"][2], "quality_ab.json")) as f:
        quality = json.load(f)
    keys = {f"{a}_s0_{m}" for a, m in (("base", "raw"), ("base", "ema"), ("flip", "raw"),
                                          ("flip", "ema"), ("base", "sw_uniform"),
                                          ("base", "sw_gauss"))}
    if set(quality["mious"]) != keys or not np.all(np.isfinite(list(quality["mious"].values()))):
        raise AssertionError(f"quality_ab: expected finite mIoUs for {sorted(keys)}, got "
                             f"{quality['mious']}")

    traced = {}
    for arm, want in (("weak", dict.fromkeys(TRACE_KERNELS, 1)),
                      ("pp", dict(fused_loss_fwd=0, fused_loss_bwd=0, fused_update=1))):
        log_dir = next(os.path.join(tools["weak_ab"][2], d)
                       for d in sorted(os.listdir(tools["weak_ab"][2]))
                       if d.startswith(f"{arm}_s0_"))
        traces = sorted(glob.glob(os.path.join(log_dir, "profile", "step_*", "trace.json")))
        if not traces:
            raise AssertionError(f"weak_ab {arm} arm: train_cli wrote no trace")
        for trace in traces:
            got = _trace_counts(trace)
            if got != want:
                raise AssertionError(f"weak_ab {arm} arm, {trace}: kernels {got}, "
                                     f"expected {want} a step")
        traced[arm] = {"traced_steps": len(traces), "per_step": want}
        log(f"quality: weak_ab {arm} arm: {len(traces)} traced train_cli steps, each "
            f"{want}")
    return traced


def quality_phase(tmp):
    """Phases 15 and 16 (see the module docstring) at once: 15's tools (c)
    and (d) start first, as processes, and run beside 15 (a) and (b) in this
    process and then beside 16's three checks, which run at once too, each
    row's ranks processes of their own. What 16 holds is bytes and launch
    counts, and what the tools hold mIoUs and traced launches: none of it
    moves with the host's load. Returns (15's launches, 16's launches)."""
    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="quality_", dir=tmp)
    tools = start_tools(tmp)
    try:
        warm = _part("quality: (a) converter and warm start", converter_check, tmp)
        torch.cuda.empty_cache()
        probe = _part("quality: (b) overfit probe", probe_check)
        torch.cuda.empty_cache()
        memory = memory_phase()
        traced = _part("quality: (c)-(d) weak_ab and quality_ab collected", tools_check, tools)
    finally:
        stop_tools(tools)
    log(f"quality and memory: phases took {time.time() - t_phase:.1f} s")
    out = {}
    for name in REPLACES:
        out[name] = {"warm_started_step": warm.get(name, 0), "overfit_probe": probe.get(name, 0)}
        for arm, t in traced.items():
            out[name][f"weak_ab_{arm}_traced_step"] = t["per_step"].get(name, 0)
    return out, memory


# ---------------------------------------------------------------- phase 16
# temp memory at factor 4 against factor 1 at the same load per data shard:
# the JAX package's own bar (tests/test_spatial_memory.py:40-42)
MEMORY_TEMP_RATIO = 0.75
# one spatial group against every rank of its mesh: the largest per-rank peak
MEMORY_GROUP_REL_TOL = 0.02
MEMORY_GROUP_ROW = dict(h=256, w=512, spatial=2, remat=False, accum=1, ndev=4, nb=2)
MEMORY_TIMEOUT_S = 600


def _memory_row_summary(row):
    """A row without its per-rank detail, for the log."""
    return {k: v for k, v in row.items() if k != "per_rank"}


def memory_quick_check():
    """(a): the CLI's --quick rows in a child process; returns their launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "iv2019_tpu_torch.tools.spatial_memory_table",
                           "--quick"], cwd=root, capture_output=True, text=True,
                          timeout=MEMORY_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"spatial_memory_table --quick failed rc={proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log("memory (a) " + line)
    line = json.loads(lines[-1])
    rows = {r["spatial"]: r for r in line["detail"]["rows"]}
    log(f"memory (a) --quick ({time.time() - t0:.1f} s): " + json.dumps(
        dict(line, detail=dict(line["detail"], rows=[_memory_row_summary(r)
                                                     for r in rows.values()]))))
    if sorted(rows) != [1, 4] or any("error" in r for r in rows.values()):
        raise AssertionError(f"memory (a): rows {[_memory_row_summary(r) for r in rows.values()]}")
    f1, f4 = rows[1], rows[4]
    want = {1: {"fused_loss_fwd": [1], "fused_loss_bwd": [1], "fused_update": [1],
                "root_conv_wgrad": [0]},
            4: {"fused_loss_fwd": [0] * 4, "fused_loss_bwd": [0] * 4, "fused_update": [1] * 4,
                "root_conv_wgrad": [0] * 4}}
    problems = []
    for f, row in rows.items():
        if row["launches"] != want[f]:
            problems.append(f"f {f}: launches {row['launches']}, expected {want[f]}")
        if not row["finite"]:
            problems.append(f"f {f}: non-finite metrics")
    if not all(r["halo"] > 0 for r in f4["per_rank"]):
        problems.append("f 4: a rank without halo exchanges")
    ratio = f4["temp_gb"] / f1["temp_gb"]
    log(f"memory (a): temp f 4 / f 1 = {ratio:.4f} (bar {MEMORY_TEMP_RATIO})")
    if not ratio < MEMORY_TEMP_RATIO:
        problems.append(f"temp at f 4 {f4['temp_gb']} GB not under {MEMORY_TEMP_RATIO} x f 1's "
                        f"{f1['temp_gb']}")
    if problems:
        raise AssertionError("memory (a): " + "; ".join(problems))
    return {"quick_f1": f1["launches"], "quick_f4_ranks": f4["launches"]}


def memory_group_check():
    """(b): one spatial group against every rank of its mesh, both at once
    (each rank a process with an allocator of its own)."""
    from concurrent.futures import ThreadPoolExecutor

    from iv2019_tpu_torch.tools import spatial_memory_table as smt

    with ThreadPoolExecutor(2) as pool:
        futures = {label: pool.submit(smt.run_row, MEMORY_GROUP_ROW, "cuda", full_mesh=full_mesh,
                                      timeout=MEMORY_TIMEOUT_S)
                   for label, full_mesh in (("group", False), ("mesh", True))}
        runs = {label: f.result() for label, f in futures.items()}
    for label, row in runs.items():
        if "error" in row or not row["finite"]:
            raise AssertionError(f"memory (b) {label}: {_memory_row_summary(row)}")
    peaks = {k: [r["total_bytes"] for r in row["per_rank"]] for k, row in runs.items()}
    gap = abs(max(peaks["group"]) - max(peaks["mesh"])) / max(peaks["mesh"])
    log("memory (b) group against mesh: " + json.dumps(dict(
        row=MEMORY_GROUP_ROW, peaks_bytes=peaks, rel_gap=gap,
        group=_memory_row_summary(runs["group"]), mesh=_memory_row_summary(runs["mesh"]))))
    if gap > MEMORY_GROUP_REL_TOL:
        raise AssertionError(f"memory (b): the group's peak is {gap:.4f} off the mesh's "
                             f"(bar {MEMORY_GROUP_REL_TOL})")
    return {"group_ranks": runs["group"]["launches"], "mesh_ranks": runs["mesh"]["launches"]}


def memory_counter_check():
    """(c): (a)'s f 1 row with LiveBytes beside the allocator on the card."""
    from iv2019_tpu_torch.tools import spatial_memory_table as smt

    plan = [r for r in smt.row_plan(smt.parse_args(["--quick"])) if r["spatial"] == 1][0]
    row = smt.run_row(plan, "cuda", count_live=True, timeout=MEMORY_TIMEOUT_S)
    if "error" in row:
        raise AssertionError(f"memory (c): {_memory_row_summary(row)}")
    rank = row["per_rank"][0]
    live = rank["live"]
    out = {k: dict(allocator=rank[f"{k}_bytes"], live=live[f"{k}_bytes"],
                   gap=rank[f"{k}_bytes"] - live[f"{k}_bytes"])
           for k in ("args", "temp", "total", "output")}
    log("memory (c) live bytes against the allocator, " + f"{plan['h']}x{plan['w']} f 1: "
        + json.dumps(out))
    if live["args_bytes"] > rank["args_bytes"] or live["total_bytes"] > rank["total_bytes"]:
        raise AssertionError(f"memory (c): the count exceeds the allocator: {out}")
    want = {"fused_loss_fwd": [1], "fused_loss_bwd": [1], "fused_update": [1],
            "root_conv_wgrad": [0]}
    if row["launches"] != want or not row["finite"]:
        raise AssertionError(f"memory (c): launches {row['launches']}, expected {want}; "
                             f"finite {row['finite']}")
    return {"counted_f1": row["launches"]}


def memory_phase():
    """Phase 16 (see the module docstring): (a), (b) and (c) at once;
    returns each kernel's launches by row and rank."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.time()
    parts = (("memory: (a) --quick", memory_quick_check),
             ("memory: (b) group against mesh", memory_group_check),
             ("memory: (c) live bytes", memory_counter_check))
    launches = {}
    with ThreadPoolExecutor(len(parts)) as pool:
        for future in [pool.submit(_part, label, fn) for label, fn in parts]:
            launches.update(future.result())
    log(f"memory: phase took {time.time() - t_phase:.1f} s")
    names = launches["quick_f1"]
    return {name: {label: counts[name] for label, counts in launches.items()} for name in names}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    # the training run's directory, which phase 11 evaluates again
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _phases(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _part(label, fn, *args):
    """``fn(*args)``, its wall time logged under ``label``."""
    t0 = time.time()
    out = fn(*args)
    log(f"{label}: {time.time() - t0:.1f} s")
    return out


def _timed(times, name, fn, *args):
    """``fn(*args)``, its wall time recorded under ``name``."""
    t0 = time.time()
    out = fn(*args)
    times[name] = round(time.time() - t0, 1)
    torch.cuda.empty_cache()
    return out


def _phases(work):
    from iv2019_tpu_torch.ops import _build

    t0 = time.time()
    times = {}
    for stem, report in _build.build_all().items():
        log(f"built {stem} in {time.time() - t0:.1f}s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  " + line.strip())
    build_serving()
    times["1 build"] = round(time.time() - t0, 1)
    # the plain versions are the references: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    results = _timed(times, "2 kernels", kernel_phase, device)
    # N3 runs in eval forwards alone: its launches are its own phase's eval steps
    n3 = _timed(times, "2 eval norms", bn_eval_kernels)
    state, launches = _timed(times, "3 predict", predict_phase, device, REQUESTS)
    cli = _timed(times, "4 cli", cli_phase, state, work)
    del state
    torch.cuda.empty_cache()
    step_busy_ms = _timed(times, "5 train", train_phase, device)
    # the train path's kernels report the launches of the training run (the
    # train phase's are printed above), B4/B5 those of the predict requests
    # and, as eval_launches, those of the --eval_all_ckpts sweep
    run_launches, eval_launches, sweep = _timed(times, "6-7 train run and eval",
                                                train_run_phase, device, step_busy_ms, work)
    # the real-format training run with grad_accum_steps=2
    real_launches, _ = _timed(times, "8 real-format train", real_format_phase, device)
    launches.update(real_launches)
    # the model variants, then the optax path and remat
    variant_launches, vistas, bn_launches = _timed(times, "9 variants", variants_phase, device)
    # N1/N2's main path: the bn_fused variant's steps
    launches.update(bn_launches)
    # phase 13's two export CLIs and their compiles, processes beside phases 10-12
    # (whose times no record holds as a measurement; the GPU work of the
    # quality tools beside them moved phase 11's f32 step off its bar)
    export = start_export(cli)
    try:
        optax_launches, _ = _timed(times, "10 optax and remat", optax_phase, device)
        # data parallelism (NCCL at one rank, two gloo ranks on the card for
        # training and for the evaluation sweep)
        multirank_launches = _timed(times, "11 multi-rank", multirank_phase, device, work, sweep)
        # spatial partitioning (one spatial group of two gloo ranks on the
        # card, training and evaluate_cli)
        spatial_launches = _timed(times, "12 spatial", spatial_phase, device, work, sweep)
        # the flagship exported with the fused units as operators, served by
        # the C++ loader with no Python in its process
        serve_launches = _timed(times, "13 export and serve", export_serve_phase, cli, device,
                                export)
    finally:
        stop_export(export)
    # the bench entry point, each mode its own process
    bench_launches = _timed(times, "14 bench", bench_phase)
    # the TF checkpoint converter and the quality tools, and beside the
    # tools the spatial memory table (each row's ranks gloo processes on
    # the card)
    quality_launches, memory_launches = _timed(times, "15-16 quality and memory table",
                                               quality_phase, work)
    for r in results:
        if r["name"] in memory_launches:
            r["memory_launches"] = memory_launches[r["name"]]
        r["quality_launches"] = quality_launches[r["name"]]
        r["bench_launches"] = bench_launches[r["name"]]
        if r["name"] in serve_launches:
            r["serve_launches"] = serve_launches[r["name"]]
        r["multirank_launches"] = multirank_launches[r["name"]]
        if r["name"] in spatial_launches:
            r["spatial_launches"] = spatial_launches[r["name"]]
        if r["name"] == "fused_loss_fwd":
            r["vistas_shape"] = vistas[0]
        if r["name"] == "fused_loss_bwd":
            r["vistas_shape"] = vistas[1]
        r["variants_launches"] = variant_launches[r["name"]]
        for key, counts in optax_launches.items():
            if r["name"] in counts:
                r[f"optax_{key}_launches"] = counts[r["name"]]
        r["launches"] = launches[r["name"]]
        if r["name"] in run_launches:
            # the synthetic-input training run of the earlier slice
            r["train_run_launches"] = run_launches[r["name"]]
        if r["name"] in eval_launches:
            # B4/B5 on the evaluation path: the --eval_all_ckpts sweep
            r["eval_launches"] = eval_launches[r["name"]]
    results.append(n3)
    log("chip_smoke: phase times (s) " + json.dumps(times))
    log(f"chip_smoke: {time.time() - t0:.1f} s from the build to the end")
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

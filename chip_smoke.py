#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``adlm_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + hold the kernels, then stop

It drives the port's main path — full-resolution ProtoSeg evaluation
of the flagship ``cityscapes_kld_imnet`` model (PPNet, 190 prototypes x
64 channels, 19 classes, DeepLabV2-ResNet101 at full depth) on
1024x2048 frames — and holds every hand-written kernel against its
plain PyTorch version on the card.  Phases, in order; any failure exits
non-zero and prints no result:

1. the card (``nvidia-smi``) and the kernel build (``nvcc``, sm_90a,
   from ``adlm_tpu_torch/csrc``);
2. kernel 1 (prototype head) vs ``prototype_head_reference`` at the
   flagship shape (N = 2·129·257 rows, C=64, P=190, K=19), f32 and
   bf16, with and without distances, log and linear; then the batch-8
   bf16 rows the eval runs, every other preset's (C, P, K) and a ragged
   shape (``HEAD_CASES``, all on the persistent kernel), and the shapes
   that take the general path (``GENERAL_CASES``: P = 257, C = 20, the
   classification preset's C = 128, P = 2000, K = 200, Stanford Cars'
   P = 1960, K = 196, the preset's 98 rows of a served batch of 2, and
   a pruned classifier's P = 1337 at 1 and 4,900 rows), each through both of its routes: logits, whose limit
   must refuse logits products of TF32- and bf16-rounded operands, and
   distances only, whose d must equal the logits route's bit for bit;
3. kernel 2 (upsample + argmin) vs the plain exact-f32 scan:
   (2,129,257,190) → (2,1024,2048) in f32 and bf16, the batch-8 bf16
   map the eval runs, an all-equal tie map, a map quantised to three
   levels (ties across chunk and tile edges), ragged, downsampling (4x
   too, whose tile the launcher shrinks), small-factor and
   integer-scale shapes, each through ``upsampled_nearest`` (which must
   launch the kernel); then output-row windows of five of those maps,
   as spatial eval's ranks cut them, on the slab of map rows each reads,
   bit-equal to the whole-frame launch's rows; 0 mismatches; and the
   kernel's winning-value output on those maps (``with_value``): the
   index unchanged, the value equal to the plain version's running min
   (``UA_VALUE_ULPS``), on a row window too, and the prototypes cut into
   2 and 3 contiguous slices as a tensor-parallel head's ranks hold
   them, each slice's pair equal to the plain version's and the combined
   (value, index) equal to the whole-bank launch's;
4. the slice: ``SegEvaluator(with_stats=True, stats_upsampled=True)``
   on uint8 batches normalized on the device, in f32 and bf16, plus one
   ``make_overlay_fn`` call, with the launch counts reset just before
   and read just after; then the same batches once more with the plain
   versions patched in, compared within a tie budget;
5. timings (CUDA events for the kernels: the upsample-argmin with and
   without its value output, alternated, and the head on a tensor-
   parallel rank's 95-prototype slice; host clock + synchronize for
   eval images/s at batch 2 and 8);
6. a ``torch.profiler`` window over eval batches: device time by kernel
   and the device's busy share;
7. the training slice: three flagship joint steps (batch 2 x iter_size
   5 windows of 513x513, f32, IEEE) through ``make_train_step`` with
   the head kernel, then the same three from the same start with the
   head's forward patched to its plain version (the backward is the
   same code in both), compared step by step and gradient by gradient;
   exactly 5 head launches per step and none of the upsample-argmin;
   then seconds per joint step in f32, bf16 and bf16 with fused
   accumulation under cuDNN's defaults, and in f32 and bf16 under its
   deterministic algorithms (the training commands' own setting), the
   head's forward and plain backward at the training rows, and a
   ``torch.profiler`` window over one f32 and one bf16 step;
8. the interpretation slice: ``push_prototypes`` (batch 2, raw uint8,
   dedup) over five 1024x2048 frames with block labels, then
   ``find_k_nearest_patches`` (k = 6) and ``prune_by_purity``, each with
   the head kernel and again with the head's forward patched to its
   plain version, compared under the near-tie rule (``compare_push``,
   ``compare_scan``), with 3 head launches per pass; then push and scan
   images/s in f32 and bf16 over 40 frames (the five cycled, 20 full
   batches), a ``torch.profiler`` window over one push and one scan
   batch in each dtype, and the head's general path timed at the
   classification shape;
9. the data slice: twelve seeded 1024x2048 Cityscapes-layout frames
   written in the preprocessed layout to a temporary directory; the
   host C++ augment against its numpy version on 16 draws (two padded
   with the mean); ``superbatch_iterator`` in thread and process mode
   (8 jobs each) and with ``start_window = 2`` against the serial
   stream, bit for bit, and each mode's samples/s; every window
   ``device_prefetch`` delivers against its host window, f32 and bf16
   wires; the flagship from the port's own initializers calibrated from
   scratch (``calibrate_frozen_bn`` on 4 windows, checked against the
   stop rule, then ``standardize_presigmoid`` and
   ``init_prototypes_from_data`` on 8 items); three f32 joint windows
   fed through ``BatchLoader`` -> ``device_prefetch`` against the same
   windows preloaded on the card (equal metrics under cuDNN
   deterministic, 5 head launches per window); then seconds per window
   loader-fed against preloaded in f32, bf16 and bf16 fused, and a
   ``torch.profiler`` window over one loader-fed bf16 window;
10. a training run through ``adlm_tpu_torch.cli`` (train unbroken, and
   halted and resumed; eval-valid, prune, train --pruned, eval-test) on
   the flagship with its schedule cut to 3 + 3 + 2 windows, from cuDNN's
   default flags: ``train`` sets its deterministic algorithms itself;
11. U-Noise at the shipped width (U-Net depth 5, channel factor 6, for
   both models; batch 8 of 256x256 slices): 200 seeded Pancreas-like
   slices written to a temporary directory; the host remap and blur
   bindings against their numpy versions; the U-Net forward (train and
   eval mode) and one utility and one noise step (a fixed eps) on the
   card against the port on the CPU, each gradient tensor held to an f64
   step, with a TF32 step and planted gradient faults as controls that
   must be refused; ``device_prefetch`` of (images, masks) batches
   against the host's; ``unoise-train-util`` and ``unoise-train-noise
   --pretrained --bf16`` for 2 epochs, ``unoise-visualize
   --occlusion-stride 16`` and ``unoise-figures --save-pickle`` through
   the CLI, their files, losses, mean B and dice@50% checked and the
   importance map held against a direct call; both training commands
   once more for one epoch, their validation rows bit-equal to the first
   runs'; then ms per step in f32
   and bf16, a profiled utility step per dtype, the loader's slices/s
   and a loader-fed bf16 epoch against a preloaded one.  No kernel of
   the port lies on this path.
12. the ProtoPNet classifier at the default preset's full width
   (``ClassificationConfig``: VGG19 at 224x224, P = 2000, C = 128,
   K = 200, batch 80) on 600 seeded PNGs in a temporary image folder:
   one warm, joint and last step with the head kernel's general path
   (one distances-only launch each) and from the same start with its
   plain forward,
   min-pooled at the kernel step's cells, compared metric by metric and
   gradient by gradient; the f32 joint
   step's gradients against an f64 step on the card, with a TF32 step
   that must be refused; a bf16 joint step; push over the training set,
   each winner held to f64 distances under phase 8's near-tie rule;
   ``cls-train`` (3 epochs, a push, 2 last-layer iterations),
   ``cls-prune`` and ``import-protopnet`` through the CLI, the imported
   model's test accuracy equal to the trained one's; then seconds per
   step per phase and dtype, eval and push images/s, both routes of the
   head's general path at 3,920 and 4,900 rows in f32 and bf16 (beside
   the plain version, the bound and one cuBLAS product) and its plain
   backward, and a profile of one f32 and one bf16 joint step;
13. windowed eval, checkpoint interop and the analyses on the flagship
   at full width (f32 IEEE, cuDNN deterministic), over four train and
   two val frames written as phase 10 writes them: a
   ``WindowedSegEvaluator`` with statistics in 513x513 windows at
   overlap 0.25 (15 per frame, fused in chunks of 8 and 7: 2 head
   launches per batch of 2, and 1 for the auto rule's memory probe)
   against the same with the plain head (phase 4's tie budget and
   near-tie rule), against the per-window driver with a device canvas
   (identical counters, also under cuDNN's default settings), the
   per-window driver's host canvas on the frames and on 384x1024 crops
   smaller than the window, and a deferred queue mixing both canvases
   (identical counters, agree_counts and purity), and a frame-sized
   window against whole-frame eval (the tie budget), with the interior
   argmax agreement printed as a reading; then through the CLI
   ``eval-valid --windowed 513,513 --stats`` (counters equal to the
   direct run's) and ``eval-test --windowed`` (PNGs against a direct
   run), ``import-protoseg`` of a reference-layout state_dict and of a
   pickled module (bit-equal), ``eval-valid`` on the imported run
   (counters equal), ``export-torch`` and a second import (bit-equal),
   ``analyze-local --top-k 10 --per-class-top 1`` against the plain
   head (ranks moved only on a near-tie of the minimum distances) and
   ``analyze-global --k 5`` over the four train frames against
   ``find_k_nearest_patches``; then windowed and whole-frame img/s at
   batch 2 in f32 and bf16, a fused window batch's peak memory against
   the auto rule's reservation, and the head at a fused chunk's 67,600
   rows;
14. deployment: ``precompile`` twice (the second call builds nothing);
   ``export`` of the flagship at 1024x2048, batch 2, in f32 and bf16,
   ``cls-export`` of the classifier preset and ``unoise-export`` of the
   shipped U-Net (batch 8 of 256x256) through the CLI for the card, from
   run directories written here; the four artifacts served by
   ``InferenceServer`` in a fresh process that imports only the port's
   ops and deploy modules (``serve_child``) at the default coalescing
   window: single-item and full-batch requests one after another, then
   a sustained window of single items from several client threads;
   every answer held to the eager model on this card (values within
   the head check's d tolerance, f32 and bf16 alike; a choice moved
   only on a near-tie, within phase 4's budget), head launches equal to
   the served batches of the flagship and the classifier and none for
   the U-Net; export seconds, artifact MB, latency per request at fill
   1 and a full batch, and the sustained window's requests/s and
   latency over all of its requests;
15. dataset preparation on the card's machine: a raw Cityscapes tree at
   2048x1024 (2 cities per split, 6 train and 4 val frames: leftImg8bit
   RGB, 8-bit labelIds of raw ids 0..33, 16-bit instanceIds with one
   frame holding no instance) and 3 Pancreas volumes of 512x512x8 with
   unannotated slices, written by the phase's own PNG encoder (scanline
   filters 0-4) and NIfTI writer; ``preprocess-cityscapes``,
   ``gen-image-list``, ``img-to-numpy`` and ``preprocess-pancreas`` in
   subprocesses of ``python -m adlm_tpu_torch.cli``, as a user runs
   them, the function at ``n_jobs=1`` on one city and
   ``preprocess_cityscapes_obj_masks``, every output held to the source
   arrays; then ``import-protoseg`` of the seeded flagship and
   ``eval-valid --stats --stats-upsampled`` on the prepared val split
   (batch 2, f32 IEEE, cuDNN deterministic), whose mIoU, per-class IoU
   and nearest-prototype counts must equal bit for bit a
   ``SegEvaluator`` fed the source arrays, with one head and one
   upsample-argmin launch per batch; host seconds per frame, volume and
   slice, and one frame's split between PNG decoding, writing and
   ``np.save`` (the prepared frames and run stay for phase 17);
16. data parallelism: two gloo ranks sharing the card run the flagship's
   joint window (plain and fused), eval, push and a U-Noise step
   against this process; the NCCL world of one through ``torchrun``;
   more ranks than cards refused (``check_parallel``);
17. spatial eval: two gloo ranks sharing the card as a (data 1, model 2)
   mesh, each holding half of image H, run the flagship's eval with
   upsampled statistics at batch 2 of 1024x2048, against this process:
   f32 within phase 4's tie budget; bf16 against this process's bf16
   eval, no further than twice a control (the same batch one image at
   a time on the same sample pixels: cuDNN's bf16 algorithms depend on
   the shape) plus phase 4's budget; one head and one upsample-argmin
   launch per rank; each rank's row-window kernel answer bit-equal to
   the whole-frame kernel on the ranks' own distance map; then
   ``eval-valid --mesh-model 2`` through the CLI's rank entry on phase
   15's prepared frames, its mIoU and per-class IoU equal to the
   one-process command's; each rank's seconds, a gloo figure.  The same
   ranks then run (a) the tensor-parallel prototype head on the
   flagship's batch (``prototype_parallel_params``, 95 of the 190
   prototypes each; ``make_sharded_inference_fn(spatial=False,
   prototype_parallel=True)``) with grid and upsampled statistics in f32
   and bf16, against the whole-bank eval in this process: counters
   within phase 4's tie budget (the logits are a sum of two partial
   products; the pixels whose class moved are printed),
   ``nearest_proto`` bit-equal, agree counts apart by no more than the
   statistic classes that moved,
   purity at rtol 1e-5 / atol 1e-6, one head launch per batch (and one
   upsample-argmin with upsampled statistics), every rank the same
   outputs; and one f32 batch with ``spatial=True`` as well (the bank
   gathered), bit-equal to spatial eval with the whole bank; (b) spatial
   eval of the MSC model ``pascal_kld_imnet`` (PPNet, 210 prototypes x
   64 channels, 21 classes, DeepLabV2-ResNet101 at full depth, scales
   1, 0.5 and 0.75) at batch 2 of 513x513 uint8 frames with a void band:
   f32 0 apart from this process on every counter, agree count, sampled
   distance and purity, bf16 by the rule above, the row windows, one
   head and one upsample-argmin launch per rank; then ``eval-valid
   --mesh-model 2`` of that experiment through the CLI's rank entry on
   4 PASCAL-sized frames (375x500, resized to 513x513 as its eval does)
   that the phase writes in the prepared ``.npy`` layout, against the
   one-process command (mIoU and per-class IoU equal).  On a machine
   with two cards or more, the same checks on two NCCL ranks, one card
   each, and ``python -m adlm_tpu_torch.cli eval-valid --mesh-model 2``
   (its own NCCL ranks, one card each) for both experiments.
18. JPEG: (a) the host library built afresh by this host's ``g++``
   decodes every fixture of ``tests/fixtures/torch_jpeg`` to the pixels
   of its manifest (shape and SHA-256 of PIL's ``convert("RGB")``,
   written where PIL runs), with ms per PASCAL-sized frame; (b) a VOC
   tree of the four PASCAL-sized fixtures (SBD's two-column split files,
   8-bit labels 0..20 and 255) through ``preprocess-pascal`` in its own
   process, every image array and PNG equal to the manifest's pixels and
   every label to the one written, then the function in this process
   (byte-equal files), host seconds per frame; (c) ``import-protoseg`` of
   the seeded ``pascal_kld_imnet`` and ``eval-valid --stats
   --stats-upsampled`` on the prepared val split (batch 1, its 513x513
   eval resize): every count and sampled distance bit-equal to the same
   frames evaluated in this process, and within phase 4's tie budget of
   them through the plain versions, one head and one upsample-argmin
   launch per batch; (d) a JPEG class folder of the fixtures (2 classes)
   whose batches at 224x224 equal its ``.npy`` twin's bit for bit, and a
   warm epoch of ``cls-train`` on it at phase 12's preset (P = 2000,
   K = 200), with its head launches (the general path).
19. the classifier's offline augmentation: (a) ``data/img_aug.py``'s
   ``augment_directory`` (the host library's PIL warp and JPEG encoder)
   on the tree of ``tests/fixtures/torch_img_aug``'s manifest (the four
   PASCAL-sized frames, small variants, a JPEG with a COM marker and a
   palette PNG with a comment), every output's name, size and SHA-256
   equal to the manifest of the JAX function's files (PIL's bytes,
   written where PIL runs), with the host ms per PASCAL-sized output
   split into warp and encode; (b) a warm epoch of ``cls-train`` on the
   augmented folder at phase 12's preset (P = 2000, K = 200), with its
   head launches (the general path).
20. PNG and BMP: (a) every fixture of ``tests/fixtures/torch_png_bmp``
   (PNGs of every bit depth and colour type, plain and Adam7; BMPs of
   every header size, depth, bitfields layout, RLE8 and RLE4, both row
   orders) through ``read_png``/``read_bmp`` and ``load_rgb``, dtype,
   shape and digest equal to the manifest of PIL's readings (written
   where PIL runs); (b) a PASCAL-sized interlaced PNG, RLE8 BMP and
   24-bit BMP written by the fixtures' encoders, each read back to the
   encoder's input, with the host ms per read (median of 5); (c) a warm
   epoch of ``cls-train`` on a 2-class folder of those files at phase
   12's preset (P = 2000, K = 200), with its head launches (the general
   path).

Precision: f32 runs with TF32 off for convolutions and matmuls (the
entry points' ``ieee_f32`` scope; the comparisons here run in the same
scope).  The last two lines of standard output are the ``kernels`` JSON
line and ``{"ok": true, "device": {...}}``.

The weights are random from a seeded ``torch.Generator``: the port's
own initializers with the frozen-BN statistics drawn away from
identity.  (The value range of ``bench.py``'s random weights,
uniform(0.01, 0.1) for everything, drives every activation of the
full-depth backbone to +inf, so every pixel would be alike and the
comparison empty.)
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import re
import subprocess
import sys
import time
import traceback

SEED = 0
H, W = 1024, 2048
# tie budget of the slice comparison (see compare_eval): a share of
# the pixels
TIE_SHARE = 1e-5
# the head check's tolerance on d, which the sampled distances inherit
D_RTOL, D_ATOL = 1e-5, 1e-4
N_RANDOM = 100  # sampled pixels per image for the purity statistic
# H100 SXM data-sheet peak of HBM3 bytes/s
PEAK_HBM_BYTES = 3.35e12
# f32 lane-instructions per second: one per FP32 lane per clock, 132 SMs
# x 128 lanes x 1.98 GHz boost (H100 SXM data sheet and Hopper
# architecture white paper); the data sheet's 67 TFLOP/s counts each of
# them, an FMA, as two.  Both kernels' bounds count lane-instructions.
PEAK_F32_OPS = 33.5e12
# f32 lane-instructions per (row, prototype) pair of the head besides
# its C + K FMAs, a count of the function's own work, not of any kernel:
# 3 for d = max(x2 - 2·dot + p2, 0) (FFMA, FADD, FMNMX), then for the
# log activation 2 adds, CUDA's IEEE f32 division and logf, whose
# fast paths are DIV_SASS and LOGF_SASS instructions (cuobjdump -sass of
# one-line probe kernels for sm_90a: tools/epilogue_sass.py).  The
# linear activation is the d update and a negation.
DIV_SASS, LOGF_SASS = 10, 26
HEAD_EPILOGUE_OPS = {"log": 3 + 2 + DIV_SASS + LOGF_SASS, "linear": 4}
# the distances alone (the general path's distances-only route): C FMAs
# and the d update, per (row, prototype) pair
HEAD_DIST_OPS = 3
# a tensor-parallel rank's slice of the flagship's 190 prototypes over 2
# model ranks (phase 5 times the head on it)
TP_SLICE_P = 95
# the port's first kernels (head: one (row, prototype) pair per thread
# step; upsample-argmin: direct 4-tap blend), f32 batch 2, on "NVIDIA
# H100 80GB HBM3, 700.00 W" (PERF.md)
PR1_HEAD_MS = 0.3992
PR1_UPSAMPLE_MS = 0.7077
# phase 7: the flagship's training windows, and the tolerances of the
# kernel-vs-plain-forward comparison.  The two runs differ only in the
# head's forward (d within D_ATOL), so the metrics agree to about 1e-6
# and the gradients to about 1e-5; Adam moves every entry by about ±lr
# from step 1, and an entry whose gradient sits at rounding noise may
# step the other way, which reaches steps 2 and 3 as tiny metric changes
TRAIN_ITER, TRAIN_BS, TRAIN_HW, TRAIN_STEPS = 5, 2, 513, 3
TRAIN_RTOL = 1e-4        # loss, cross_entropy, kld_loss, l1, grad_norm
TRAIN_GRAD_REL = 1e-3    # each step-1 gradient tensor, relative L2
TRAIN_TIE_SHARE = 1e-4   # n_correct, a share of the valid patches
# the head's kernels in a profile: the persistent kernel, and the
# general path's distances-only route, logits route and partials' sum
HEAD_KERNELS = ("head_kernel", "dist_tile_kernel", "logits_tile_kernel",
                "sum_partials_kernel")
REPLACES = {
    "prototype_head": "adlm_tpu/ops/prototype.py:110",
    "upsample_argmin": "adlm_tpu/ops/upsample_argmin.py:79",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float, peak_ops: float):
    """(least ms on the card, what bounds it) from the data-sheet peaks:
    ``ops`` at ``peak_ops`` per second, ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: prototype head
# ---------------------------------------------------------------------------

# phase 2 cases: (name, N, C, P, K, dtypes, activations, huge).  The
# flagship rows at batch 2 and the batch-8 bf16 rows the eval runs;
# every other preset's (C, P, K) (core/config.py: pascal_*, mds_new,
# cells, smoke); N off the 64-row tile with P and K off their thread
# tiles; and (huge) every 7th row at 1e10, d ~ 6e21 > 2^60, whose
# quotients leave the kernel's fast division: the threads holding them
# redo their activations with "/", their ordinary rows too.
_DTYPES, _ACTS = ("float32", "bfloat16"), ("log", "linear")
HEAD_CASES = [
    ("flagship b2", 2 * 129 * 257, 64, 190, 19, _DTYPES, _ACTS, False),
    ("flagship b8", 8 * 129 * 257, 64, 190, 19, ("bfloat16",), ("log",), False),
    ("pascal P=210", 2 * 129 * 257, 64, 210, 21, _DTYPES, _ACTS, False),
    ("ragged P=97", 1001, 64, 97, 7, _DTYPES, _ACTS, False),
    ("mds_new P=30", 3001, 64, 30, 3, _DTYPES, _ACTS, False),
    ("cells P=50", 3001, 64, 50, 5, _DTYPES, _ACTS, False),
    ("smoke C=8", 3001, 8, 6, 3, _DTYPES, _ACTS, False),
    ("huge d rows", 3001, 64, 190, 19, _DTYPES, ("log",), True),
]
# shapes the persistent kernel does not take (P > 256, C % 8 != 0, and
# the classification preset at batch 80 of 7x7 grids, P = 2000 > 256,
# K = 200 > 64; Stanford Cars' 1,960 prototypes of 196 classes; a
# pruned classifier's 1,337 prototypes at one row and at eval batch 100;
# the preset at 98 rows, the served batch of 2 of cls-export in phase 14):
# the general path of the same .cu file, each through both routes
CLS_N, CLS_C, CLS_P, CLS_K = 80 * 7 * 7, 128, 2000, 200
GENERAL_CASES = [
    ("P=257 K=3", 3001, 64, 257, 3, _DTYPES, _ACTS, False),
    ("C=20", 3001, 20, 190, 19, _DTYPES, _ACTS, False),
    ("classification", CLS_N, CLS_C, CLS_P, CLS_K, _DTYPES, _ACTS, False),
    ("cars", CLS_N, CLS_C, 1960, 196, _DTYPES, _ACTS, False),
    ("classification b2", 2 * 7 * 7, CLS_C, CLS_P, CLS_K, _DTYPES, _ACTS, False),
    ("pruned N=1", 1, CLS_C, 1337, CLS_K, _DTYPES, _ACTS, False),
    ("pruned", 100 * 7 * 7, CLS_C, 1337, CLS_K, _DTYPES, _ACTS, False),
]
# the general path's logits tolerance, relative to the sum's magnitude
# sum_p |act·w|: its linear logits sum up to 2,000 terms of ~±21 that
# cancel, so no tolerance relative to |logit| holds them.  The f32
# summation-order error reads ~3e-7 of the sum; products of act and W
# rounded to TF32 or bf16 (the controls) must fail the limit
GENERAL_LOGITS_RTOL = 1e-6
ROUNDED_BITS = {"tf32": 10, "bf16": 7}  # mantissa bits kept by the controls


def check_head(report) -> None:
    import torch
    from adlm_tpu_torch.ops.prototype import _lib

    smem = {dt: _lib().adlm_prototype_head_smem(64, 190, 19, int(dt == "bfloat16"))
            for dt in _DTYPES}
    log(f"  shared memory per CTA at C=64, P=190, K=19: {smem} B")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = check_head_cases(HEAD_CASES, "persistent", g)
    log(f"  tolerance: logits rtol 1e-4 atol 1e-3, d rtol {D_RTOL:g} atol {D_ATOL:g}, "
        "0 f32 argmin mismatches")
    check_head_cases(GENERAL_CASES, "general", g)
    log(f"  tolerance: logits {GENERAL_LOGITS_RTOL:g} of sum_p |act·w| (of_tol <= 1; "
        "the TF32- and bf16-rounded controls must exceed it), d and argmin as above")
    report["prototype_head"]["max_abs_err"] = worst
    torch.cuda.empty_cache()


def round_mantissa(t, bits: int):
    """``t`` in f32 rounded to ``bits`` mantissa bits, to nearest (ties
    away from zero), as a TF32 (10) or bf16 (7) operand holds it."""
    import torch

    drop = 23 - bits
    i = t.float().contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def check_head_cases(cases, route: str, g) -> float:
    """Each case through ``prototype_head_cuda`` against the plain
    version; every case must take ``route`` (the flagship and every
    earlier case stay on the persistent kernel).  The persistent cases
    hold logits to rtol 1e-4, atol 1e-3; the general ones to
    ``GENERAL_LOGITS_RTOL`` of sum_p |act·w|, which logits products of
    rounded operands must exceed.  Returns the largest f32 logits error
    of the flagship batch-2 case."""
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.prototype import (
        distance_to_similarity,
        head_route,
        prototype_head_cuda,
        prototype_head_reference,
    )

    worst = 0.0
    for name, N, C, P, K, dtypes, acts, huge in cases:
        x = torch.rand(N, C, device="cuda", generator=g)
        protos = torch.rand(P, C, device="cuda", generator=g)
        w = torch.randn(P, K, device="cuda", generator=g)
        if huge:
            x[::7] = 1e10
        for dt in dtypes:
            dtype = getattr(torch, dt)
            took = head_route(C, P, K, dtype)
            if took != route:
                raise AssertionError(f"head case {name} {dt} takes the {took} "
                                     f"kernel, expected the {route} one")
            xd, pd, wd = x.to(dtype), protos.to(dtype), w.to(dtype)
            for act in acts:
                with torch.inference_mode(), ieee_f32():
                    want_l, want_d = prototype_head_reference(xd, pd, wd, act)
                    general = route == "general"
                    if general:
                        sim = distance_to_similarity(want_d, act)
                        limit = GENERAL_LOGITS_RTOL * torch.matmul(sim.abs(),
                                                                   wd.float().abs())
                        for ctl, bits in ROUNDED_BITS.items():
                            rounded = torch.matmul(round_mantissa(sim, bits),
                                                   round_mantissa(wd, bits))
                            c_tol = ((rounded - want_l).abs() / limit).max().item()
                            log(f"  head {name:14s} [control   ] {dt:8s} {act:6s} logits "
                                f"from {ctl}-rounded act·W: of_tol={c_tol:.3f}")
                            if c_tol <= 1.0:
                                raise AssertionError(
                                    f"the {ctl}-rounded control passes the general "
                                    f"logits limit ({name}): it cannot tell f32 apart")
                        del sim, rounded
                    for emit in (True, False):
                        before = _build.LAUNCHES["prototype_head"]
                        got_l, got_d = prototype_head_cuda(xd, pd, wd, act,
                                                           return_distances=emit)
                        torch.cuda.synchronize()
                        if _build.LAUNCHES["prototype_head"] != before + 1:
                            raise AssertionError("prototype_head_cuda did not "
                                                 f"launch the kernel ({name})")
                        err = (got_l - want_l).abs()
                        rel = (err / want_l.abs().clamp_min(1e-3)).max().item()
                        line = (f"  head {name:14s} [{took:10s}] {dt:8s} {act:6s} "
                                f"dist={emit!s:5s} logits max_abs={err.max().item():.3e} "
                                f"max_rel={rel:.3e}")
                        if general:
                            share = (err / limit).max().item()
                            line += f" of_tol={share:.3f}"
                            ok = share <= 1.0
                        else:
                            ok = torch.allclose(got_l, want_l, rtol=1e-4, atol=1e-3)
                        if emit:
                            derr = (got_d - want_d).abs().max().item()
                            flips = int((got_d.argmin(-1) != want_d.argmin(-1)).sum())
                            line += f" d max_abs={derr:.3e} argmin_mismatch_rows={flips}"
                            ok &= torch.allclose(got_d, want_d, rtol=D_RTOL, atol=D_ATOL)
                            if dtype == torch.float32:
                                ok &= flips == 0
                        else:
                            ok &= got_d is None
                        log(line)
                        if not ok:
                            raise AssertionError("prototype head kernel disagrees "
                                                 f"with its plain version ({name})")
                        if dtype == torch.float32 and name == "flagship b2":
                            worst = max(worst, err.max().item())
                        if emit:
                            logits_route_d = got_d
                    if general:  # the distances-only route: the same d, bit for bit
                        before = _build.LAUNCHES["prototype_head"]
                        none_l, only_d = prototype_head_cuda(xd, pd, wd, act,
                                                             return_logits=False)
                        torch.cuda.synchronize()
                        if _build.LAUNCHES["prototype_head"] != before + 1:
                            raise AssertionError("prototype_head_cuda did not "
                                                 f"launch the kernel ({name})")
                        derr = (only_d - want_d).abs().max().item()
                        flips = int((only_d.argmin(-1) != want_d.argmin(-1)).sum())
                        same = torch.equal(only_d, logits_route_d)
                        log(f"  head {name:14s} [d only    ] {dt:8s} {act:6s} d max_abs="
                            f"{derr:.3e} argmin_mismatch_rows={flips} bit-equal to the "
                            f"logits route's d: {same}")
                        ok = (none_l is None and same
                              and torch.allclose(only_d, want_d, rtol=D_RTOL, atol=D_ATOL)
                              and (dtype != torch.float32 or flips == 0))
                        if not ok:
                            raise AssertionError("the head's distances-only route disagrees "
                                                 f"with its plain version or the logits "
                                                 f"route ({name})")
                        del only_d, logits_route_d
                del want_l, want_d, got_l, got_d
        del x, protos, w
    return worst


# ---------------------------------------------------------------------------
# phase 3: upsample + argmin
# ---------------------------------------------------------------------------

def check_upsample(report) -> None:
    import torch
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.upsample_argmin import (
        upsampled_argmin_reference,
        upsampled_nearest,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [
        ("flagship f32", torch.rand(2, 129, 257, 190, device="cuda", generator=g) * 10, (H, W)),
        ("flagship bf16", (torch.rand(2, 129, 257, 190, device="cuda", generator=g) * 10
                           ).to(torch.bfloat16), (H, W)),
        ("all-equal tie", torch.ones(1, 33, 65, 7, device="cuda"), (257, 513)),
        ("ragged P=37", torch.rand(1, 37, 71, 37, device="cuda", generator=g), (300, 555)),
        ("downsample P=19", torch.rand(1, 65, 97, 19, device="cuda", generator=g), (33, 47)),
        ("integer x8 P=19", torch.rand(2, 16, 32, 19, device="cuda", generator=g), (128, 256)),
        ("flagship b8 bf16", (torch.rand(8, 129, 257, 190, device="cuda", generator=g) * 10
                              ).to(torch.bfloat16), (H, W)),
        # three levels: most outputs tie with several prototypes, across
        # prototype chunks and output tiles
        ("near-tie 3 levels", torch.randint(0, 3, (2, 33, 65, 70), device="cuda",
                                            generator=g).float(), (257, 513)),
        # H, W off the 64x32 output tile, P off the prototype chunk (64)
        ("ragged P=97", torch.rand(3, 41, 83, 97, device="cuda", generator=g), (333, 679)),
        # x3: thread rows that span three tap pairs; odd h*w*P puts bf16
        # images at odd element offsets
        ("x3 bf16 P=37", torch.rand(2, 23, 45, 37, device="cuda", generator=g
                                    ).to(torch.bfloat16), (70, 134)),
        # 4x down: a whole 64x32 tile's source (255 x 127 pixels) does not
        # fit shared memory, so the launcher shrinks the tile
        ("downsample x4 P=19", torch.rand(1, 132, 196, 19, device="cuda", generator=g),
         (33, 49)),
    ]
    for name, d, size in cases:
        with torch.inference_mode():
            before = _build.LAUNCHES["upsample_argmin"]
            got = upsampled_nearest(d, size)  # the dispatch: a CUDA map
            if _build.LAUNCHES["upsample_argmin"] != before + 1:
                raise AssertionError(f"upsampled_nearest did not take the kernel ({name})")
            want = upsampled_argmin_reference(d, size, chunk=16, exact=True)
            torch.cuda.synchronize()
        bad = int((got != want).sum())
        log(f"  upsample_argmin {name:17s} {tuple(d.shape)} -> {size}: "
            f"mismatches={bad} of {got.numel()}")
        if bad:
            raise AssertionError(f"upsample_argmin kernel disagrees ({name})")
        if name == "all-equal tie" and int(got.abs().sum()):
            raise AssertionError("tie case: every index must be 0")
    check_upsample_windows([c for c in cases if c[0] in UPSAMPLE_WINDOW_CASES])
    check_upsample_value([c for c in cases if c[0] in UPSAMPLE_WINDOW_CASES])
    report["upsample_argmin"]["max_abs_err"] = 0


# the maps of phase 3 whose output-row windows are checked: each split of
# the label rows over 2 and 3 ranks (spatial eval's windows), and a window
# off the 64-row tile
UPSAMPLE_WINDOW_CASES = ("flagship f32", "flagship bf16", "near-tie 3 levels",
                         "ragged P=97", "downsample x4 P=19")


def check_upsample_windows(cases) -> None:
    """The kernel on output-row windows of a slab of the map (the rows
    the window reads, as spatial eval passes them): each window bit-equal
    to the same rows of the whole-frame launch and to the plain version's
    window; one launch per call."""
    import torch
    from adlm_tpu_torch.core.mesh import row_range
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.upsample_argmin import (
        tap_rows,
        upsampled_argmin_cuda,
        upsampled_argmin_reference,
    )

    n = 0
    for name, d, size in cases:
        H = size[0]
        h = d.shape[1]
        windows = [row_range(r, H, m) for m in (2, 3) for r in range(m)]
        windows.append((H // 3 + 5, min(H, H // 3 + 5 + 101)))
        with torch.inference_mode():
            whole = upsampled_argmin_cuda(d, size)
            for lo, hi in windows:
                first, last = tap_rows(H, h, lo, hi)
                slab = d[:, first:last].contiguous()
                before = _build.LAUNCHES["upsample_argmin"]
                got = upsampled_argmin_cuda(slab, size, out_rows=(lo, hi - lo),
                                            map_rows=(first, h))
                if _build.LAUNCHES["upsample_argmin"] != before + 1:
                    raise AssertionError(f"window {lo}:{hi} of {name}: not one launch")
                want = upsampled_argmin_reference(slab, size, exact=True,
                                                  out_rows=(lo, hi - lo), map_rows=(first, h))
                torch.cuda.synchronize()
                if not (torch.equal(got, whole[:, lo:hi]) and torch.equal(got, want)):
                    raise AssertionError(f"upsample_argmin window {lo}:{hi} of {name}: "
                                         f"{int((got != whole[:, lo:hi]).sum())} mismatches "
                                         f"with the whole frame, {int((got != want).sum())} "
                                         f"with the plain version")
                n += 1
        log(f"  upsample_argmin {name:17s} windows {windows} (map rows fetched as "
            f"tap_rows gives them): bit-equal to the whole frame's rows and the plain "
            f"version's")
    log(f"  {n} row windows: 0 mismatches")


# the winning value's limit against the plain version's, in f32 units in
# the last place: both blend separably (x pass, then y pass), every
# product and sum rounded on its own, so they agree bit for bit
UA_VALUE_ULPS = 0


def f32_ulps(a, b) -> int:
    """Largest distance in f32 units in the last place between two f32
    tensors of finite values (their bit patterns on one ordered line)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def check_upsample_value(cases) -> None:
    """The kernel's winning-value output (``with_value=True``): the index
    equal to the call without it and to the plain version's, the value
    within UA_VALUE_ULPS of the plain version's running min, on the whole
    frame and on a row window; then the prototypes split into contiguous
    slices (2 and 3, as a tensor-parallel head's ranks hold them), each
    slice's values bit-equal to the plain version's on that slice, and
    the (value, index) combine over the slices (least value, then least
    global index) bit-equal to the whole-bank launch's pair."""
    import torch
    from adlm_tpu_torch.core.mesh import row_range
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.upsample_argmin import (
        tap_rows,
        upsampled_argmin_cuda,
        upsampled_argmin_reference,
    )

    for name, d, size in cases:
        Hs, P, h = size[0], d.shape[-1], d.shape[1]
        with torch.inference_mode():
            idx0 = upsampled_argmin_cuda(d, size)
            before = _build.LAUNCHES["upsample_argmin"]
            idx, val = upsampled_argmin_cuda(d, size, with_value=True)
            if _build.LAUNCHES["upsample_argmin"] != before + 1:
                raise AssertionError(f"value output of {name}: not one launch")
            ridx, rval = upsampled_argmin_reference(d, size, exact=True, with_value=True)
            lo, hi = row_range(1, Hs, 2)
            first, last = tap_rows(Hs, h, lo, hi)
            widx, wval = upsampled_argmin_cuda(d[:, first:last].contiguous(), size,
                                               out_rows=(lo, hi - lo), map_rows=(first, h),
                                               with_value=True)
            combos = []
            for m in (2, 3):
                best_v = best_i = None
                for q in range(m):
                    a, b = row_range(q, P, m)
                    part = d[..., a:b].contiguous()
                    si, sv = upsampled_argmin_cuda(part, size, with_value=True)
                    pi, pv = upsampled_argmin_reference(part, size, exact=True,
                                                        with_value=True)
                    if not (torch.equal(si, pi) and torch.equal(sv, pv)):
                        raise AssertionError(f"{name}: slice [{a}, {b}) of {m} differs from "
                                             "the plain version's")
                    si = si + a
                    if best_v is None:
                        best_v, best_i = sv, si
                    else:   # earlier slices hold lower indices: strict < keeps them
                        take = sv < best_v
                        best_v, best_i = torch.where(take, sv, best_v), torch.where(take, si,
                                                                                     best_i)
                combos.append((m, torch.equal(best_i, idx), torch.equal(best_v, val)))
            torch.cuda.synchronize()
        ulps = f32_ulps(val, rval)
        log(f"  upsample_argmin {name:17s} value output: index equal to the call without "
            f"it {torch.equal(idx, idx0)}, to the plain version's {torch.equal(idx, ridx)}; "
            f"value vs the plain version's {ulps} ulps (limit {UA_VALUE_ULPS}); row window "
            f"[{lo}, {hi}) equal {torch.equal(widx, idx[:, lo:hi])}/"
            f"{torch.equal(wval, val[:, lo:hi])}; P split into contiguous slices, combined "
            "(index, value) equal to the whole bank's: "
            + ", ".join(f"{m} slices {ci}/{cv}" for m, ci, cv in combos))
        if not (torch.equal(idx, idx0) and torch.equal(idx, ridx) and ulps <= UA_VALUE_ULPS
                and torch.equal(widx, idx[:, lo:hi]) and torch.equal(wval, val[:, lo:hi])
                and all(ci and cv for _, ci, cv in combos)):
            raise AssertionError(f"upsample_argmin value output of {name} disagrees")


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def random_model(cfg, seed: int):
    import torch
    from adlm_tpu_torch.models.layers import FrozenBatchNorm
    from adlm_tpu_torch.models.ppnet import PPNet

    g = torch.Generator().manual_seed(seed)
    model = PPNet(cfg, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.0, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def make_batches(n: int, B: int, seed: int, size=(H, W), n_labels: int = 20):
    """uint8 frames of ``size`` with structure at several scales (a random
    coarse image upsampled, plus noise) and random labels (training ids
    below ``n_labels``, 0 void) with a void band."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        coarse = torch.rand(B, 3, 16, 32, device="cuda", generator=g)
        img = F.interpolate(coarse, size=size, mode="bilinear",
                            align_corners=False) * 200
        img = img + torch.rand(B, 3, *size, device="cuda", generator=g) * 55
        img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        lab = torch.randint(0, n_labels, (B,) + tuple(size), device="cuda", generator=g,
                            dtype=torch.uint8)
        lab[:, :64] = 0
        out.append((img, lab))
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the slice through the kernels' plain versions (the oracle)."""
    import adlm_tpu_torch.interpret.evaluate as ev
    import adlm_tpu_torch.models.ppnet as pp
    from adlm_tpu_torch.ops.prototype import prototype_head_reference
    from adlm_tpu_torch.ops.upsample_argmin import upsampled_argmin_reference

    def head(x, p, w, act, eps, return_distances=True, return_logits=True):
        logits, d = prototype_head_reference(x, p, w, act, eps)
        return (logits if return_logits else None), (d if return_distances else None)

    def nearest(dist, size, chunk=16, exact=False):
        return upsampled_argmin_reference(dist, size, chunk, exact=True)

    saved = (pp.prototype_head, ev.upsampled_nearest)
    pp.prototype_head, ev.upsampled_nearest = head, nearest
    try:
        yield
    finally:
        pp.prototype_head, ev.upsampled_nearest = saved


@contextlib.contextmanager
def purity_inputs():
    """Keep what each ``_topk_purity`` call sorts (the sampled distances
    and predicted classes), so that the comparison can name the near-tie
    behind every purity cell that changed."""
    import adlm_tpu_torch.interpret.evaluate as ev

    seen = []
    orig = ev._topk_purity

    def record(sample_d, sample_pred, proto_class):
        seen.append((sample_d.cpu(), sample_pred.cpu()))
        return orig(sample_d, sample_pred, proto_class)

    ev._topk_purity = record
    try:
        yield seen
    finally:
        ev._topk_purity = orig


def run_eval(model, batches, pc, mean_std):
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator

    ev = SegEvaluator(model, 19, with_stats=True, stats_upsampled=True,
                      normalize=mean_std, n_random_pixels=N_RANDOM, seed=SEED)
    outs = []
    for img, lab in batches:
        with purity_inputs() as seen:
            o = ev.update(pc, img, lab)
        outs.append({k: v.cpu() for k, v in o.items()
                     if k not in ("pred", "stat_pred", "nearest_proto")})
        outs[-1]["sample_d"], outs[-1]["sample_pred"] = seen[0]
        P = pc.numel()
        near = o["nearest_proto"]
        if (o["pred"].shape != lab.shape or near.shape != lab.shape
                or int(near.min()) < 0 or int(near.max()) >= P
                or not bool(o["topk_purity"].isfinite().all())):
            raise AssertionError("eval outputs out of shape or range")
        # the comparison means something only if the maps vary
        n_cls, n_near = len(o["pred"].unique()), len(near.unique())
        log(f"    batch: {n_cls} predicted classes, {n_near} nearest prototypes")
        if n_cls < 2 or n_near < 2:
            raise AssertionError("eval maps are constant: the random model "
                                 "is saturated")
    return ev.results(), outs


def purity_cells(a, b, proto_class):
    """The (pixel, K) purity cells of one batch that differ between two
    runs, and those of them that no near-tie explains.

    Cell (pixel, K) counts the pixel's predicted class among its K
    nearest sampled prototypes.  With the same predicted class, a cell
    differs only if the two top-K sets do: some a is in run 1's set but
    not run 2's and some b the other way round, so d1(a) ≤ d1(b) and
    d2(b) ≤ d2(a), and run 1's sorted gap between places K and K + 1 is
    at most d1(b) − d1(a) ≤ |d1(a) − d2(a)| + |d1(b) − d2(b)|.  A changed
    cell whose gap is wider than twice the head check's d tolerance
    (D_ATOL + D_RTOL·|d|, at the pixel's largest |d|) is unexplained.
    Pixels whose predicted class differs count against the pixel budget
    instead.

    Returns (changed cells, unexplained cells, pixels whose class
    differs, largest gap of a changed cell).
    """
    import torch

    d1, d2 = a["sample_d"], b["sample_d"]
    pred_flip = a["sample_pred"] != b["sample_pred"]                # (B, n)
    o1 = torch.argsort(d1, dim=-1, stable=True)
    o2 = torch.argsort(d2, dim=-1, stable=True)
    c1 = (proto_class[o1] == a["sample_pred"][..., None]).cumsum(-1)
    c2 = (proto_class[o2] == b["sample_pred"][..., None]).cumsum(-1)
    changed = (c1 != c2) & ~pred_flip[..., None]                    # (B, n, P)
    s1 = d1.gather(-1, o1)
    gap = torch.cat([s1[..., 1:] - s1[..., :-1],
                     torch.full_like(s1[..., :1], math.inf)], dim=-1)
    tie = 2 * (D_ATOL + D_RTOL * d1.abs().amax(-1, keepdim=True))   # (B, n, 1)
    worst = gap[changed].max().item() if bool(changed.any()) else 0.0
    unexplained = int((changed & (gap > tie)).sum())
    return int(changed.sum()), unexplained, int(pred_flip.sum()), worst


def compare_eval(tag, got, want, n_pixels, proto_class=None) -> None:
    """Kernels vs plain versions on the same batches.  The two heads sum
    in other orders (d differs by ~1e-5), so near-ties may flip:

    * a pixel whose prediction or nearest prototype flips moves
      ``correct``/``intersection`` by at most 1 and ``union``/
      ``agree_counts`` by at most 2: budgets TIE_SHARE of the pixels,
      twice that for the latter two; ``total`` must be equal;
    * ``topk_purity``: the sampled distances it sorts must agree within
      the head check's d tolerance, and every (pixel, K) cell that
      changed must sit on a near-tie of them (``purity_cells``); sampled
      pixels whose predicted class flipped count against the pixel
      budget.
    """
    import torch
    from adlm_tpu_torch.models.ppnet import default_proto_class

    budget = math.ceil(TIE_SHARE * n_pixels)
    limits = {"intersection": budget, "correct": budget, "total": 0,
              "union": 2 * budget, "agree_counts": 2 * budget}
    pc = (default_proto_class(190, 19, device="cpu") if proto_class is None
          else proto_class.cpu())
    (res_k, outs_k), (res_p, outs_p) = got, want
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        diffs = {k: int((a[k].long() - b[k].long()).abs().sum()) for k in limits}
        dp = (a["topk_purity"] - b["topk_purity"]).abs()
        cells, unexplained, flips, gap = purity_cells(a, b, pc)
        d_err = (a["sample_d"] - b["sample_d"]).abs().max().item()
        d_ok = bool(torch.allclose(a["sample_d"], b["sample_d"],
                                   rtol=D_RTOL, atol=D_ATOL))
        log(f"  slice {tag} batch {i}: |diff| {diffs} (budget {budget} px, "
            f"x2 for union/agree_counts), sampled d max_abs={d_err:.2e}, "
            f"topk_purity max_abs={dp.max().item():.2e}: {cells} of "
            f"{a['sample_d'].numel()} cells changed (largest gap {gap:.2e}), "
            f"{unexplained} not on a near-tie, sampled class flips {flips}")
        if (any(diffs[k] > v for k, v in limits.items()) or not d_ok
                or unexplained or flips > budget):
            raise AssertionError(f"slice {tag}: kernels and plain versions "
                                 "disagree beyond the tie budget")
    log(f"  slice {tag}: mIoU kernels={res_k['mean_iou']:.6f} "
        f"plain={res_p['mean_iou']:.6f} pixel_acc={res_k['pixel_accuracy']:.4f}")
    if not math.isfinite(res_k["mean_iou"]):
        raise AssertionError("mIoU is not finite")


def check_slice(report) -> None:
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import cast_params
    from adlm_tpu_torch.interpret.evaluate import make_overlay_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.ops import _build

    cfg = get_experiment("cityscapes_kld_imnet")
    mean_std = (cfg.data.mean, cfg.data.std)
    m32 = random_model(cfg.model, SEED)
    m16 = cast_params(copy.deepcopy(m32), torch.bfloat16)
    pc = default_proto_class(190, 19, device="cuda")
    batches = make_batches(2, 2, SEED + 2)
    n_pixels = 2 * H * W
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # same features in both runs
    try:
        _build.reset_launches()
        got32 = run_eval(m32, batches, pc, mean_std)
        got16 = run_eval(m16, batches, pc, mean_std)
        with torch.inference_mode():
            img = batches[0][0][:1].float()
            mean = torch.tensor(cfg.data.mean, device="cuda")
            std = torch.tensor(cfg.data.std, device="cuda")
            pred, nearest = make_overlay_fn(m32)((img / 255.0 - mean) / std)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        log(f"  main-path launches: {launches}")
        for name in _build.KERNELS:
            report[name]["launches"] = launches[name]
            if launches[name] == 0:
                raise AssertionError(f"the main path never launched {name}")
        if pred.shape != (1, H, W) or nearest.shape != (1, H, W):
            raise AssertionError("overlay maps have the wrong shape")

        with plain_versions():
            want32 = run_eval(m32, batches, pc, mean_std)
            want16 = run_eval(m16, batches, pc, mean_std)
        if any(_build.LAUNCHES[k] != launches[k] for k in _build.KERNELS):
            raise AssertionError("the plain run launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = saved_det
    compare_eval("f32", got32, want32, n_pixels)
    compare_eval("bf16", got16, want16, n_pixels)
    return m32


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------

def time_kernels(report, card: str) -> None:
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops.prototype import (
        prototype_head_cuda,
        prototype_head_reference,
    )
    from adlm_tpu_torch.ops.upsample_argmin import (
        upsampled_argmin_cuda,
        upsampled_argmin_reference,
    )

    B, h, w, C, P, K = 2, 129, 257, 64, 190, 19
    N = B * h * w
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.rand(N, C, device="cuda", generator=g)
    protos = torch.rand(P, C, device="cuda", generator=g)
    wt = torch.randn(P, K, device="cuda", generator=g)
    dist = torch.rand(B, h, w, P, device="cuda", generator=g) * 10
    rows = []
    with torch.inference_mode(), ieee_f32():
        # context for the distance product alone (never called by the port)
        mm = cuda_ms(lambda: torch.matmul(x, protos.t()), 50)
        log(f"  torch.matmul(x, P.T) f32 IEEE ({N}x{C} . {C}x{P}) {mm:.4f} ms  [{card}]")
        for dtype in (torch.float32, torch.bfloat16):
            xd, pd, wd = x.to(dtype), protos.to(dtype), wt.to(dtype)
            for emit in (True, False):
                ms = cuda_ms(lambda: prototype_head_cuda(xd, pd, wd, "log", 1e-4, emit), 50)
                plain = cuda_ms(lambda: prototype_head_reference(xd, pd, wd, "log"), 20)
                # f32 lane-instructions: C + K FMAs and the epilogue per pair
                ops = N * P * (C + K + HEAD_EPILOGUE_OPS["log"])
                nbytes = (N * C * xd.element_size() + 4 * (P * C + P * K + N * K)
                          + (4 * N * P if emit else 0))
                b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
                rows.append(("prototype_head", str(dtype)[6:], emit, ms, plain, b_ms, b_by))
            # one rank of the tensor-parallel head (P = 190 over 2 model
            # ranks): its 95-prototype slice of the bank, d written
            Ps = TP_SLICE_P
            ps, ws = pd[:Ps].contiguous(), wd[:Ps].contiguous()
            ms = cuda_ms(lambda: prototype_head_cuda(xd, ps, ws, "log", 1e-4, True), 50)
            plain = cuda_ms(lambda: prototype_head_reference(xd, ps, ws, "log"), 20)
            ops = N * Ps * (C + K + HEAD_EPILOGUE_OPS["log"])
            nbytes = N * C * xd.element_size() + 4 * (Ps * C + Ps * K + N * K + N * Ps)
            b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
            rows.append((f"head P={Ps} slice", str(dtype)[6:], True, ms, plain, b_ms, b_by))
            dd = dist.to(dtype)
            # with and without the winning value, alternated in one process
            plain_ms, value_ms = [], []
            for _ in range(2):
                plain_ms.append(cuda_ms(lambda: upsampled_argmin_cuda(dd, (H, W)), 20))
                value_ms.append(cuda_ms(
                    lambda: upsampled_argmin_cuda(dd, (H, W), with_value=True), 20))
            ms = min(plain_ms)
            plain = cuda_ms(lambda: upsampled_argmin_reference(dd, (H, W), 16, True), 3, 1)
            # separable blend (x pass over h rows, y pass over H) and
            # compares: single f32 instructions, none fuses
            ops = B * (3.0 * P * W * (h + H) + P * H * W)
            nbytes = B * (h * w * P * dd.element_size() + 4 * H * W)
            b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
            rows.append(("upsample_argmin", str(dtype)[6:], None, ms, plain, b_ms, b_by))
            b_ms, b_by = bound(ops, nbytes + B * 4 * H * W, PEAK_F32_OPS)
            rows.append(("ua +value", str(dtype)[6:], None, min(value_ms), plain, b_ms, b_by))
            log(f"  upsample_argmin {str(dtype)[6:]} whole frame, alternated: without the "
                f"value {', '.join(f'{t:.4f}' for t in plain_ms)} ms, with it "
                f"{', '.join(f'{t:.4f}' for t in value_ms)} ms (PR 17: 0.3083-0.3114 ms f32)"
                f"  [{card}]")
    for name, dt, emit, ms, plain, b_ms, b_by in rows:
        extra = "" if emit is None else f" dist={emit!s:5s}"
        was = {"prototype_head": PR1_HEAD_MS, "upsample_argmin": PR1_UPSAMPLE_MS}.get(name)
        was = f"  (first kernel {was} ms f32)" if was else ""
        log(f"  {name:16s} {dt:8s}{extra} kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}){was}  [{card}]")
    # the kernels line reports the f32 shape the stats eval runs
    for name, dt, emit, ms, plain, b_ms, b_by in rows:
        if name in report and dt == "float32" and emit in (True, None):
            report[name].update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def time_eval(model32, card: str) -> None:
    import torch
    from adlm_tpu_torch.core.device import cast_params
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class

    mean_std = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    pc = default_proto_class(190, 19, device="cuda")
    models = {"float32": model32,
              "bfloat16": cast_params(copy.deepcopy(model32), torch.bfloat16)}
    for B in (2, 8):
        img, lab = make_batches(1, B, SEED + 4)[0]
        uv = (torch.rand(B, N_RANDOM, device="cuda"),
              torch.rand(B, N_RANDOM, device="cuda"))
        for dt, model in models.items():
            for stats in (False, True):
                fn = make_inference_fn(model, 19, with_stats=stats,
                                       stats_upsampled=stats, normalize=mean_std)
                args = (pc, img, lab) + (uv if stats else ())
                fn(*args)
                torch.cuda.synchronize()
                iters = 3
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                torch.cuda.synchronize()
                dt_s = (time.perf_counter() - t0) / iters
                mode = "stats_upsampled" if stats else "no_stats"
                log(f"  eval batch {B} {dt:8s} {mode:15s} {B / dt_s:8.3f} img/s "
                    f"({dt_s * 1e3:.1f} ms/batch)  [{card}]")
        del img, lab
        torch.cuda.empty_cache()


def device_profile(fn, iters: int):
    """One ``torch.profiler`` window over ``iters`` calls of ``fn``:
    (rows of (device ms per call, launches per call, kernel name), most
    time first; host ms per call; busy device ms per call, the union of
    the device events' intervals, which counts kernels that overlap on
    several streams once).  The rows are empty when the profiler
    recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e) -> float:
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = sorted(((device_us(e) / 1e3 / iters, e.count / iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return rows, wall_ms, busy_us / 1e3 / iters


def profile_line(rows, wall_ms: float, busy_ms: float) -> str:
    """Device time summed over kernels, busy share (the union of the
    device intervals over the window's host time, which includes the
    profiler's own overhead) and the kernel groups."""
    def group(*keys):
        return sum(r[0] for r in rows if any(k in r[2].lower() for k in keys))

    total = sum(r[0] for r in rows)
    # cuDNN's IEEE-f32 backward kernels are dgrad_engine / wgrad_alg0_engine
    convs = group("conv", "xmma", "gemm", "cutlass", "nvjet", "dgrad", "wgrad")
    elementwise = group("elementwise")
    layout = group("nhwctonchw", "nchwtonhwc")
    return (f"device {total:.2f} ms/batch summed, {busy_ms:.2f} ms busy, of {wall_ms:.2f} "
            f"ms host (busy {busy_ms / wall_ms:.1%}); conv/gemm {convs:.2f} ms ({convs / total:.1%}), "
            f"elementwise {elementwise:.2f} ms ({elementwise / total:.1%}), "
            f"layout transposes {layout:.2f} ms ({layout / total:.1%}), "
            f"prototype head {group(*HEAD_KERNELS):.3f} ms, upsample-argmin "
            f"{group('upsample_argmin_kernel'):.3f} ms")


def log_rows(rows, n: int = 12) -> None:
    total = sum(r[0] for r in rows)
    for ms, cnt, name in rows[:n]:
        log(f"    {ms:9.3f} ms {ms / total:6.1%} x{cnt:5.1f}  {name[:100]}")


def profile_eval(model32, card: str, B: int = 8, iters: int = 2) -> None:
    """Where an eval batch spends its device time: one ``torch.profiler``
    window over ``iters`` upsampled-stats batches per dtype.  A profiler
    that records no device time is reported, not fatal: the kernels are
    held by the phases before."""
    import torch
    from adlm_tpu_torch.core.device import cast_params
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class

    mean_std = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    pc = default_proto_class(190, 19, device="cuda")
    img, lab = make_batches(1, B, SEED + 5)[0]
    uv = (torch.rand(B, N_RANDOM, device="cuda"),
          torch.rand(B, N_RANDOM, device="cuda"))
    models = {"float32": model32,
              "bfloat16": cast_params(copy.deepcopy(model32), torch.bfloat16)}
    for dt, model in models.items():
        fn = make_inference_fn(model, 19, with_stats=True, stats_upsampled=True,
                               normalize=mean_std)
        fn(pc, img, lab, *uv)
        torch.cuda.synchronize()
        rows, wall_ms, busy_ms = device_profile(lambda: fn(pc, img, lab, *uv), iters)
        if not rows:
            log(f"  profile {dt}: the profiler recorded no device time "
                "(not measured)")
            continue
        log(f"  profile {dt} batch {B} stats_upsampled: {profile_line(rows, wall_ms, busy_ms)}"
            f"  [{card}]")
        log_rows(rows)
    del img, lab
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the training slice
# ---------------------------------------------------------------------------

def make_train_batch(cfg, seed: int):
    """One joint window: (TRAIN_ITER, TRAIN_BS, 513, 513, 3) images
    normalized on the device from seeded uint8 frames (structure at
    several scales plus noise), and (TRAIN_ITER, TRAIN_BS, 513, 513)
    labels in 0..19 (0 = void) drawn as blocks of about 30 pixels, so
    that every class present covers at least 2 patches of the 65x65
    output grid (the KLD term's pairs need 2)."""
    import torch
    import torch.nn.functional as F
    from adlm_tpu_torch.ops.normalize import normalize

    n, hw = TRAIN_ITER * TRAIN_BS, TRAIN_HW
    g = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(n, 3, 12, 12, device="cuda", generator=g)
    img = F.interpolate(coarse, size=(hw, hw), mode="bilinear",
                        align_corners=False) * 200
    img = img + torch.rand(n, 3, hw, hw, device="cuda", generator=g) * 55
    img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    images = normalize(img, (cfg.data.mean, cfg.data.std))
    blocks = torch.randint(0, 20, (n, 1, 17, 17), device="cuda", generator=g)
    labels = F.interpolate(blocks.float(), size=(hw, hw), mode="nearest")
    labels = labels[:, 0].to(torch.uint8)
    return (images.reshape(TRAIN_ITER, TRAIN_BS, hw, hw, 3),
            labels.reshape(TRAIN_ITER, TRAIN_BS, hw, hw))


@contextlib.contextmanager
def plain_head_forward():
    """Route the head's forward, with or without a gradient, through its
    plain version; the backward (``prototype_head_backward``) is the
    same code either way."""
    import adlm_tpu_torch.ops.prototype as pm

    def head(x, p, w, act="log", eps=1e-4, return_distances=True, return_logits=True):
        logits, d = pm.prototype_head_reference(x, p, w, act, eps)
        return (logits if return_logits else None), (d if return_distances else None)

    saved = pm.prototype_head_cuda
    pm.prototype_head_cuda = head
    try:
        yield
    finally:
        pm.prototype_head_cuda = saved


def run_training(model, cfg, images, labels, steps: int):
    """``steps`` joint steps through the user's entry points: per-step
    metrics (floats) and the step-1 gradients."""
    import torch
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    max_steps = cfg.train.joint_steps
    state = init_protoseg_state(model, cfg, 1, max_steps)
    step = make_train_step(model, cfg, 1, max_steps)
    metrics, grads1 = [], None
    for i in range(steps):
        state, m = step(state, images, labels)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return metrics, grads1


def compare_training(got, want, n_patches: int) -> None:
    """Kernel run vs plain-forward run, step by step (TRAIN_RTOL, the
    n_correct tie budget) and step-1 gradient by gradient
    (TRAIN_GRAD_REL)."""
    (mk, gk), (mp, gp) = got, want
    budget = math.ceil(TRAIN_TIE_SHARE * n_patches)
    bad = []
    for i, (a, b) in enumerate(zip(mk, mp)):
        errs = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for k in ("loss", "cross_entropy", "kld_loss", "l1", "grad_norm")}
        dn = abs(a["n_correct"] - b["n_correct"])
        log(f"  train step {i + 1}: loss {a['loss']:.6f} (plain {b['loss']:.6f}), "
            f"ce {a['cross_entropy']:.6f}, kld {a['kld_loss']:.6f}, l1 {a['l1']:.4f}, "
            f"grad_norm {a['grad_norm']:.6f}; rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tolerance {TRAIN_RTOL:g}); n_correct {a['n_correct']:.0f} vs "
            f"{b['n_correct']:.0f} of {a['n_patches']:.0f} (budget {budget})")
        if any(v > TRAIN_RTOL for v in errs.values()) or dn > budget:
            bad.append(f"step {i + 1}")
        if not all(math.isfinite(v) for v in a.values()):
            bad.append(f"step {i + 1} not finite")
    rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)).item()
           for n in gp}
    worst = max(rel, key=rel.get)
    log(f"  step-1 gradients: {len(rel)} tensors, largest relative L2 error "
        f"{rel[worst]:.2e} ({worst}), tolerance {TRAIN_GRAD_REL:g}")
    if rel[worst] > TRAIN_GRAD_REL:
        bad.append("step-1 gradients")
    if bad:
        raise AssertionError("training with the head kernel disagrees with the "
                             f"plain-forward run: {bad}")


def check_training(report, model) -> None:
    """Three flagship joint steps with the kernel, three from the same
    start with the plain head forward; launch counts of each run."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.ops import _build

    cfg = get_experiment("cityscapes_kld_imnet")
    images, labels = make_train_batch(cfg, SEED + 6)
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same backbone in both runs
    try:
        _build.reset_launches()
        got = run_training(copy.deepcopy(model), cfg, images, labels, TRAIN_STEPS)
        launches = dict(_build.LAUNCHES)
        log(f"  training launches ({TRAIN_STEPS} steps): {launches}")
        if (launches["prototype_head"] != TRAIN_ITER * TRAIN_STEPS
                or launches["upsample_argmin"] != 0):
            raise AssertionError(f"expected {TRAIN_ITER} head launches per step "
                                 "and no upsample-argmin launch")
        for name in _build.KERNELS:
            report[name]["launches"] += launches[name]
        _build.reset_launches()
        with plain_head_forward():
            want = run_training(copy.deepcopy(model), cfg, images, labels, TRAIN_STEPS)
        if any(_build.LAUNCHES.values()):
            raise AssertionError("the plain-forward run launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = saved_det
    compare_training(got, want, int(got[0][0]["n_patches"]))
    del images, labels
    torch.cuda.empty_cache()


def train_variants(cfg):
    import dataclasses

    def variant(**kw):
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **kw))

    return {"float32": variant(),
            "bfloat16": variant(compute_dtype="bfloat16"),
            "bfloat16 fused": variant(compute_dtype="bfloat16",
                                      fused_accumulation=True)}


def time_training(model, card: str, iters: int = 3) -> None:
    """Seconds per joint step (host clock + synchronize, after one warm
    step) in f32, bf16 and bf16 with fused accumulation, and in f32 and
    bf16 under cuDNN's deterministic algorithms; then the head's forward
    kernel and its plain backward at the training rows."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import deterministic_cudnn, ieee_f32
    from adlm_tpu_torch.ops.prototype import (
        prototype_head_backward,
        prototype_head_cuda,
        prototype_head_reference,
    )
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    cfg = get_experiment("cityscapes_kld_imnet")
    images, labels = make_train_batch(cfg, SEED + 7)
    # cuDNN's defaults, then for f32 and bf16 its deterministic algorithms,
    # which the training commands run (cli._deterministic)
    variants = [(name, vcfg, False) for name, vcfg in train_variants(cfg).items()]
    variants += [(name + " det", vcfg, True) for name, vcfg, _ in variants[:2]]
    secs = {}
    for name, vcfg, det in variants:
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, vcfg, 1, vcfg.train.joint_steps)
        step = make_train_step(m, vcfg, 1, vcfg.train.joint_steps)
        torch.cuda.reset_peak_memory_stats()
        with deterministic_cudnn() if det else contextlib.nullcontext():
            step(state, images, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                _, metrics = step(state, images, labels)
            torch.cuda.synchronize()
        s = secs[name] = (time.perf_counter() - t0) / iters
        log(f"  joint step {name:18s} (2 x 5 x 513^2): {s:.4f} s/step, "
            f"{TRAIN_ITER * TRAIN_BS / s:.2f} windows/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"loss {float(metrics['loss']):.4f}  [{card}]")
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"joint step {name}: loss not finite")
        del m, state, step
        torch.cuda.empty_cache()
    del images, labels
    log("  cuDNN's deterministic algorithms (the training commands' setting) against its "
        "defaults: " + ", ".join(f"{n} {secs[n + ' det'] / secs[n]:.3f}x"
                                 for n in ("float32", "bfloat16")) + f"  [{card}]")

    # the head at the training rows: one microbatch, 2 x 65 x 65
    N, C, P, K = TRAIN_BS * 65 * 65, 64, 190, 19
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.rand(N, C, device="cuda", generator=g)
    protos = torch.rand(P, C, device="cuda", generator=g)
    w = torch.randn(P, K, device="cuda", generator=g)
    g_logits = torch.randn(N, K, device="cuda", generator=g)
    g_dist = torch.randn(N, P, device="cuda", generator=g)
    with torch.inference_mode(), ieee_f32():
        fwd = cuda_ms(lambda: prototype_head_cuda(x, protos, w, "log", 1e-4, True), 200)
        plain = cuda_ms(lambda: prototype_head_reference(x, protos, w, "log"), 100)
        bwd = cuda_ms(lambda: prototype_head_backward(x, protos, w, g_logits, g_dist,
                                                      "log", 1e-4), 100)
    ops = N * P * (C + K + HEAD_EPILOGUE_OPS["log"])
    nbytes = N * C * 4 + 4 * (P * C + P * K + N * K + N * P)
    b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
    log(f"  head at N={N} ({-(-N // 64)} row tiles over 132 CTAs): kernel forward "
        f"{fwd:.4f} ms, plain forward {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"plain backward {bwd:.4f} ms  [{card}]")


def profile_training(model, card: str) -> None:
    """Device time of one f32 and one bf16 joint step, by kernel group,
    and the device's busy share."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    cfg = get_experiment("cityscapes_kld_imnet")
    images, labels = make_train_batch(cfg, SEED + 9)
    variants = train_variants(cfg)
    for name in ("float32", "bfloat16"):
        vcfg = variants[name]
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, vcfg, 1, vcfg.train.joint_steps)
        step = make_train_step(m, vcfg, 1, vcfg.train.joint_steps)
        step(state, images, labels)
        torch.cuda.synchronize()
        rows, wall_ms, busy_ms = device_profile(lambda: step(state, images, labels), 1)
        if not rows:
            log(f"  profile joint step {name}: the profiler recorded no device "
                "time (not measured)")
            continue
        adam = sum(r[0] for r in rows if "adam" in r[2].lower()
                   or "multi_tensor" in r[2].lower())
        log(f"  profile joint step {name} (2 x 5 x 513^2): "
            f"{profile_line(rows, wall_ms, busy_ms).replace('/batch', '/step')}, "
            f"optimizer {adam:.2f} ms  [{card}]")
        log_rows(rows)
        del m, state, step
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the interpretation slice
# ---------------------------------------------------------------------------

# five frames at batch 2: two full batches and one padded with a void
# frame.  k = 6 (the reference's) over five frames leaves each
# prototype's sixth slot empty (a frame gives one candidate per
# prototype).  The weights are random, so a nearest patch holds the
# prototype's class about as often as chance: the reference's threshold
# of 3 would prune every prototype, and 1 splits them.
INTERP_FRAMES, INTERP_BS, NEAREST_K, PRUNE_THRESHOLD = 5, 2, 6, 1
INTERP_LAUNCHES = -(-INTERP_FRAMES // INTERP_BS)
# the timings cycle the checked frames into 20 full batches, so that
# neither the padded batch nor the pipeline's fill sets the rate
TIME_FRAMES = 40


def make_push_frames(n: int, seed: int):
    """The dataset's items: ``n`` seeded uint8 frames (1, H, W, 3) with
    structure at several scales, and (1, H, W) uint8 labels in 0..19
    (0 = void) drawn as blocks of about 30 pixels, as phase 7's, so that
    eligibility masks a real share of the 129x257 patches (per-pixel
    random labels would make every class eligible everywhere)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        coarse = torch.rand(1, 3, 16, 32, device="cuda", generator=g)
        img = F.interpolate(coarse, size=(H, W), mode="bilinear",
                            align_corners=False) * 200
        img = img + torch.rand(1, 3, H, W, device="cuda", generator=g) * 55
        img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        blocks = torch.randint(0, 20, (1, 1, H // 30 + 1, W // 30 + 1),
                               device="cuda", generator=g)
        lab = F.interpolate(blocks.float(), size=(H, W), mode="nearest")
        out.append((img.cpu().numpy(), lab[:, 0].to(torch.uint8).cpu().numpy()))
    return out


@contextlib.contextmanager
def push_winner_rows():
    """Keep the winners' feature rows each push hands to its tail
    (``_finalize_push``), so that the comparison can compute the plain
    ``d`` of both runs' candidates."""
    import adlm_tpu_torch.interpret.push as push_mod

    seen = []
    orig = push_mod._finalize_push

    def record(sd, proto_class, global_min, global_fmap, *args):
        seen.append(global_fmap.copy())
        return orig(sd, proto_class, global_min, global_fmap, *args)

    push_mod._finalize_push = record
    try:
        yield seen
    finally:
        push_mod._finalize_push = orig


def run_interpretation(model, frames, mean_std, report):
    """Push, scan and prune through the user's entry points, the launch
    counts reset before and read after each (``report`` None: a plain
    run, which must launch nothing)."""
    import torch
    from adlm_tpu_torch.interpret.nearest import find_k_nearest_patches
    from adlm_tpu_torch.interpret.prune import prune_by_purity
    from adlm_tpu_torch.interpret.push import push_prototypes
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.ops import _build

    pc = default_proto_class(190, 19, device="cuda")
    kw = dict(batch_size=INTERP_BS, raw_normalize=mean_std)
    out = {}

    def counted(name, fn):
        _build.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = INTERP_LAUNCHES if report is not None else 0
        log(f"    {name}: launches {launches}")
        if launches["prototype_head"] != want or launches["upsample_argmin"]:
            raise AssertionError(f"{name}: expected {want} head launches and no "
                                 f"upsample-argmin launch, got {launches}")
        if report is not None:
            report["prototype_head"]["launches"] += launches["prototype_head"]
        return result

    with push_winner_rows() as rows:
        out["push"] = counted("push", lambda: push_prototypes(
            model, pc, frames, 19, raw_uint8=True, log=lambda m: log(f"    {m}"), **kw))
    out["push_rows"] = rows[0]
    out["scan"] = counted("scan", lambda: find_k_nearest_patches(
        model, pc, frames, 19, k=NEAREST_K, return_info=True, **kw))
    out["prune"] = counted("prune", lambda: prune_by_purity(
        model, pc, frames, 19, k=NEAREST_K, prune_threshold=PRUNE_THRESHOLD,
        log=lambda m: log(f"    {m}"), **kw))
    return out


def _tie_tol(d):
    return D_ATOL + D_RTOL * abs(d)


def compare_push(got, want, protos) -> set:
    """Kernel vs plain push.  ``min_distances`` within the head check's
    d tolerance; winners (image, patch) equal except at a near-tie: a
    winner that differs must have both candidates' plain d (from the two
    runs' winning feature rows) within D_ATOL + D_RTOL·d of each other.
    Dedup equal unless a difference involves such a prototype.  Returns
    the near-tied prototypes."""
    import numpy as np
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops.prototype import l2_distances

    (sd_k, pc_k, info_k), (sd_p, pc_p, info_p) = got["push"], want["push"]
    mk, mp = info_k["min_distances"], info_p["min_distances"]
    seen = np.isfinite(mk)
    if not np.array_equal(seen, np.isfinite(mp)) or not seen.any():
        raise AssertionError("push: the runs saw different prototypes, or none")
    d_ok = np.allclose(mk[seen], mp[seen], rtol=D_RTOL, atol=D_ATOL)
    wk, wp = info_k["proto_rf_boxes"][:, :5], info_p["proto_rf_boxes"][:, :5]
    differ = np.where((wk != wp).any(axis=1))[0]
    rows_k, rows_p = got["push_rows"], want["push_rows"]
    tied, unexplained = set(), []
    for j in differ:
        feats = torch.from_numpy(np.stack([rows_k[j], rows_p[j]])).cuda()
        with ieee_f32():
            dk, dp = l2_distances(feats, protos[j:j + 1])[:, 0].tolist()
        if abs(dk - dp) <= _tie_tol(max(dk, dp)):
            tied.add(int(j))
        else:
            unexplained.append((int(j), dk, dp))
    uk, up = set(info_k["unique_index"]), set(info_p["unique_index"])
    dedup_diff = uk ^ up
    if dedup_diff:
        # a dedup difference must involve a near-tied prototype: its
        # vector, or one equal to it in either run
        old = protos.float().cpu().numpy()
        allowed = set()
        for rows, info in ((rows_k, info_k), (rows_p, info_p)):
            merged = np.where(np.isfinite(info["min_distances"])[:, None], rows, old)
            for j in tied:
                allowed |= set(np.where((merged == merged[j]).all(axis=1))[0].tolist())
        bad_dedup = dedup_diff - allowed
    else:
        bad_dedup = set()
    n_kept = sd_k["prototype_vectors"].shape[0]
    log(f"  push: {int(seen.sum())}/190 prototypes seen, min_distances max_abs "
        f"{np.abs(mk[seen] - mp[seen]).max():.3e} (d tolerance), {len(differ)} winners "
        f"differ ({len(tied)} on a near-tie, unexplained {unexplained}), dedup keeps "
        f"{n_kept} (plain {sd_p['prototype_vectors'].shape[0]}), dedup differences "
        f"{sorted(dedup_diff)}, unexplained {sorted(bad_dedup)}")
    if not d_ok or unexplained or bad_dedup:
        raise AssertionError("push with the head kernel disagrees with the plain run "
                             "beyond a near-tie")
    if (len(info_k["unique_index"]) != n_kept or pc_k.numel() != n_kept
            or not bool(torch.isfinite(sd_k["prototype_vectors"]).all())):
        raise AssertionError("push: the pushed state is inconsistent")
    return tied


def compare_scan(got, want) -> set:
    """Kernel vs plain k-nearest scan: the sorted distances agree within
    the d tolerance at every rank; an entry whose patch differs must sit
    on a near-tie: within twice the tolerance of another rank of the
    same prototype, or, where there are more frames than k, at rank k,
    whose swap partner may be the unrecorded next candidate.  Returns
    the prototypes that differ."""
    import numpy as np

    (ids_k, info_k), (ids_p, info_p) = got["scan"], want["scan"]
    filled = info_k["image_idx"] >= 0
    if (not np.array_equal(filled, info_p["image_idx"] >= 0)
            or not (filled.sum(axis=1) == min(NEAREST_K, INTERP_FRAMES)).all()):
        raise AssertionError("scan: a prototype has the wrong number of candidates")
    dk, dp = info_k["distances"][filled], info_p["distances"][filled]
    d_ok = np.allclose(dk, dp, rtol=D_RTOL, atol=D_ATOL)
    moved = np.zeros(ids_k.shape, bool)
    for key in ("image_idx", "patch_i", "patch_j"):
        moved |= info_k[key] != info_p[key]
    label_only = (ids_k != ids_p) & ~moved
    unexplained = []
    for j, r in zip(*np.where(moved)):
        row = info_k["distances"][j, filled[j]]
        tol = 2 * _tie_tol(row[r])
        near = np.abs(np.delete(row, r) - row[r]).min(initial=np.inf) <= tol
        if not (near or (INTERP_FRAMES > NEAREST_K and r == NEAREST_K - 1)):
            unexplained.append((int(j), int(r)))
    differ = set(np.where(moved.any(axis=1) | (ids_k != ids_p).any(axis=1))[0].tolist())
    log(f"  scan: k={ids_k.shape[1]}, {int(filled.sum())} candidates, distances "
        f"max_abs {np.abs(dk - dp).max():.3e} (d tolerance), {int(moved.sum())} "
        f"moved on {len(differ)} prototypes, unexplained {unexplained}, label-only "
        f"differences {int(label_only.sum())}")
    if not d_ok or unexplained or label_only.any():
        raise AssertionError("the scan with the head kernel disagrees with the plain run "
                             "beyond a near-tie")
    if (ids_k[filled] < -1).any() or (ids_k[filled] >= 19).any():
        raise AssertionError("scan: class ids out of range")
    return differ


def compare_prune(got, want, scan_differ: set) -> None:
    """Pruned prototypes equal, except ones whose nearest ids moved."""
    import numpy as np

    (sd_k, pc_k, info_k), (sd_p, pc_p, info_p) = got["prune"], want["prune"]
    pk, pp = set(info_k[:, 0].tolist()), set(info_p[:, 0].tolist())
    bad = (pk ^ pp) - scan_differ
    log(f"  prune: {len(pk)} of 190 pruned (plain {len(pp)}), differences "
        f"{sorted(pk ^ pp)}, unexplained {sorted(bad)}")
    if bad:
        raise AssertionError("prune with the head kernel disagrees with the plain run")
    if sd_k["prototype_vectors"].shape[0] != 190 - len(pk) or pc_k.numel() != 190 - len(pk):
        raise AssertionError("prune: the pruned state is inconsistent")
    if not np.array_equal(info_k[:, 1], (info_k[:, 0] // 10)):
        raise AssertionError("prune: prune_info classes are not the prototypes' classes")


def check_interpretation(report, model) -> None:
    """Push, scan and prune on the flagship at 1024x2048 with the head
    kernel, then from the same model with the head's forward patched to
    its plain version; the pushed state loads strictly into a PPNet with
    the kept prototype count."""
    import dataclasses

    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.models.ppnet import PPNet

    cfg = get_experiment("cityscapes_kld_imnet")
    mean_std = (cfg.data.mean, cfg.data.std)
    frames = make_push_frames(INTERP_FRAMES, SEED + 10)
    protos = model.prototypes().detach().clone()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same features in both runs
    try:
        log("  with the head kernel:")
        got = run_interpretation(model, frames, mean_std, report)
        log("  with the head's plain forward:")
        with plain_head_forward():
            want = run_interpretation(model, frames, mean_std, None)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    compare_push(got, want, protos)
    compare_prune(got, want, compare_scan(got, want))
    sd = got["push"][0]
    n_kept = sd["prototype_vectors"].shape[0]
    pushed = PPNet(dataclasses.replace(cfg.model, num_prototypes=n_kept))
    pushed.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
    log(f"  the pushed state dict loads strictly into PPNet(num_prototypes={n_kept})")
    return frames


def time_interpretation(model, frames, card: str, iters: int = 2) -> None:
    """Push and scan images/s over ``TIME_FRAMES`` frames (the checked
    frames cycled) at batch 2, full batches only (host clock +
    synchronize, after a warm call over the checked frames), f32 and
    bf16; a ``torch.profiler`` window over one push batch step and one
    scan batch step in each dtype; the head's general path at the
    classification shape (CUDA events)."""
    import numpy as np
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import cast_params, ieee_f32
    from adlm_tpu_torch.interpret.nearest import (
        find_k_nearest_patches,
        make_nearest_batched_fn,
    )
    from adlm_tpu_torch.interpret.push import make_push_batched_fn, push_prototypes
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.ops.prototype import prototype_head_cuda, prototype_head_reference

    cfg = get_experiment("cityscapes_kld_imnet")
    mean_std = (cfg.data.mean, cfg.data.std)
    pc = default_proto_class(190, 19, device="cuda")
    timed = [frames[i % len(frames)] for i in range(TIME_FRAMES)]
    images = np.concatenate([f[0] for f in frames[:INTERP_BS]])
    labels = np.concatenate([f[1] for f in frames[:INTERP_BS]])
    models = {"float32": model,
              "bfloat16": cast_params(copy.deepcopy(model), torch.bfloat16)}
    for dt, m in models.items():
        runs = {
            "push": lambda data: push_prototypes(
                m, pc, data, 19, batch_size=INTERP_BS, raw_uint8=True,
                raw_normalize=mean_std, log=lambda _: None),
            "scan": lambda data: find_k_nearest_patches(
                m, pc, data, 19, k=NEAREST_K, batch_size=INTERP_BS,
                raw_normalize=mean_std),
        }
        for name, fn in runs.items():
            fn(frames)
            torch.cuda.synchronize()
            secs = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(timed)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            log(f"  {name} {dt:8s} batch {INTERP_BS}, {TIME_FRAMES} frames 1024x2048: "
                + ", ".join(f"{TIME_FRAMES / t:.3f} img/s ({t * 1e3:.1f} ms)"
                            for t in secs) + f"  [{card}]")
        steps = {"push": make_push_batched_fn(m, 19, normalize=mean_std),
                 "scan": make_nearest_batched_fn(m, 19, normalize=mean_std)}
        for name, step in steps.items():
            step(pc, images, labels)
            torch.cuda.synchronize()
            rows, wall_ms, busy_ms = device_profile(lambda: step(pc, images, labels), 2)
            if not rows:
                log(f"  profile {name} {dt}: the profiler recorded no device "
                    "time (not measured)")
                continue
            log(f"  profile {name} batch {INTERP_BS} {dt} (uint8 upload included): "
                f"{profile_line(rows, wall_ms, busy_ms)}  [{card}]")
            log_rows(rows, 8)
    del models, steps
    torch.cuda.empty_cache()

    N, C, P, K = CLS_N, CLS_C, CLS_P, CLS_K
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    x = torch.rand(N, C, device="cuda", generator=g)
    protos = torch.rand(P, C, device="cuda", generator=g)
    w = torch.randn(P, K, device="cuda", generator=g)
    with torch.inference_mode(), ieee_f32():
        for emit in (True, False):
            ms = cuda_ms(lambda: prototype_head_cuda(x, protos, w, "log", 1e-4, emit), 50)
            plain = cuda_ms(lambda: prototype_head_reference(x, protos, w, "log"), 20)
            ops = N * P * (C + K + HEAD_EPILOGUE_OPS["log"])
            nbytes = 4 * (N * C + P * C + P * K + N * K + (N * P if emit else 0))
            b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
            log(f"  head general path (logits route), classification shape N={N} C={C} P={P} K={K} "
                f"f32 dist={emit!s:5s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})  [{card}]")


# ---------------------------------------------------------------------------
# phase 9: the data slice
# ---------------------------------------------------------------------------

# twelve seeded Cityscapes-layout frames in the preprocessed layout
# (~100 MB in a temporary directory), read through the flagship's
# DataConfig into its joint windows (TRAIN_ITER x TRAIN_BS x 513^2)
DATA_FRAMES, DATA_JOBS = 12, 8
AUGMENT_DRAWS = 16        # the last two scale the frame below the window
AUGMENT_ATOL = 1e-6       # image tolerance of tests/test_torch_data.py
LOADER_WINDOWS = 6        # per loader mode; the rate counts windows 2..6
PREFETCH_WINDOWS = 6      # per wire dtype
CAL_WINDOWS, PROTO_ITEMS = 4, 8
BN_LIVE_VAR = 1e-3        # a BN channel with a larger output var is live
PRESIGMOID_TOL = 1e-2     # |mean| and |std - 1| of the folded tensor
FED_STEPS = 3             # loader-fed windows held against preloaded ones
FED_TIME_WINDOWS = 8      # timed windows per variant and feed: more than
                          # the loader and the prefetch hold ahead (2 + 2)


def write_dataset(root: str, n: int, seed: int, n_val: int = 0) -> None:
    """``n`` seeded frames in the preprocessed layout (``all_images.json``,
    ``img_with_margin_0/train/*.npy``, ``annotations/train/*.npy``), and
    ``n_val`` more in a ``val`` split: (H, W, 3) uint8 images with
    structure at two scales (64-pixel blocks plus noise) and (H, W) uint8
    raw Cityscapes ids 0..33 in 30-pixel blocks, so that the class table
    maps a real share of the pixels to void."""
    import json
    import os

    import numpy as np

    rng = np.random.RandomState(seed)
    ids = {}
    for split, count in (("train", n), ("val", n_val)):
        if not count:
            continue
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        ids[split] = [f"{'frame' if split == 'train' else split}{i:02d}"
                      for i in range(count)]
        for name in ids[split]:
            coarse = rng.randint(0, 200, (H // 64, W // 64, 3)).astype(np.uint8)
            img = np.repeat(np.repeat(coarse, 64, 0), 64, 1)
            img += rng.randint(0, 56, (H, W, 3)).astype(np.uint8)
            np.save(os.path.join(img_dir, name + ".npy"), img)
            blocks = rng.randint(0, 34, (-(-H // 30), -(-W // 30))).astype(np.uint8)
            np.save(os.path.join(ann_dir, name + ".npy"),
                    np.repeat(np.repeat(blocks, 30, 0), 30, 1)[:H, :W])
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(ids, f)


def check_augment(ds) -> None:
    """The host C++ augment against its numpy version on one frame
    (memory-mapped, raw ids through the class LUT) over AUGMENT_DRAWS
    draws of scale, crop and flip; labels exact, images within
    AUGMENT_ATOL."""
    import random

    import numpy as np
    from adlm_tpu_torch import native

    cfg = ds.cfg
    image, label = ds._load_raw(ds.img_ids[0], convert=False, mmap=True)
    lut = ds.table.convert_lut()
    wh, ww = cfg.window_size
    rng = random.Random(SEED)
    worst, secs, n_pad, void = 0.0, [0.0, 0.0], 0, 0.0
    for k in range(AUGMENT_DRAWS):
        s = (rng.uniform(*cfg.scales) if k < AUGMENT_DRAWS - 2
             else (0.4, 0.2)[k - AUGMENT_DRAWS + 2])
        nh, nw = int(H * s), int(W * s)
        start = (rng.randint(0, max(nh - wh, 0)), rng.randint(0, max(nw - ww, 0)))
        args = (image, label, s, (wh, ww), start, rng.random() < 0.5,
                cfg.mean, cfg.std)
        outs = []
        for i, fn in enumerate((native.augment_sample, native.augment_sample_plain)):
            t0 = time.perf_counter()
            outs.append(fn(*args, label_lut=lut))
            secs[i] += time.perf_counter() - t0
        (img, lab), (img_p, lab_p) = outs
        if not np.array_equal(lab, lab_p):
            raise AssertionError(f"augment draw {k} (scale {s:.3f}): labels differ "
                                 f"at {int((lab != lab_p).sum())} pixels")
        err = float(np.abs(img - img_p).max())
        if err > AUGMENT_ATOL:
            raise AssertionError(f"augment draw {k} (scale {s:.3f}): images differ "
                                 f"by {err:.3e} > {AUGMENT_ATOL:g}")
        worst = max(worst, err)
        n_pad += nh < wh or nw < ww
        void += float((lab == 0).mean()) / AUGMENT_DRAWS
    if n_pad < 2:
        raise AssertionError("no augment draw padded the window")
    log(f"  augment: {AUGMENT_DRAWS} draws ({n_pad} padded with the mean) C++ vs numpy: "
        f"labels equal, images max abs err {worst:.2e} (tolerance {AUGMENT_ATOL:g}); "
        f"void share {void:.3f}; C++ {secs[0] / AUGMENT_DRAWS * 1e3:.2f} ms, numpy "
        f"{secs[1] / AUGMENT_DRAWS * 1e3:.2f} ms per {wh}x{ww} window  [host CPU]")


def loader_windows(ds, cfg, n_jobs: int, mode: str, steps: int,
                   start_window: int = 0):
    """The windows of ``superbatch_iterator`` and the seconds spent
    producing windows 2.. (the first includes the pool's start)."""
    from adlm_tpu_torch.data.pipeline import superbatch_iterator

    it = superbatch_iterator(ds, TRAIN_ITER, TRAIN_BS, steps, seed=cfg.train.random_seed,
                             n_jobs=n_jobs, start_window=start_window, mode=mode)
    out, secs = [], 0.0
    try:
        for _ in range(start_window, steps):
            t0 = time.perf_counter()
            window = next(it)
            if out:
                secs += time.perf_counter() - t0
            out.append(window)
    finally:
        it.close()
    return out, secs


def same_windows(got, want, what: str) -> None:
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} windows, expected {len(want)}")
    for i, ((gi, gl), (wi, wl)) in enumerate(zip(got, want)):
        if not (gi.dtype == wi.dtype and np.array_equal(gi, wi)
                and np.array_equal(gl, wl)):
            raise AssertionError(f"{what}: window {i} differs from the serial stream")


def check_loader(ds, cfg) -> None:
    """Thread and process modes against the serial stream, bit for bit,
    and ``start_window`` against its windows; the loader alone in
    samples/s per mode."""
    import os

    per = TRAIN_ITER * TRAIN_BS
    serial, secs = loader_windows(ds, cfg, 1, "thread", LOADER_WINDOWS)
    rates = {"serial": (LOADER_WINDOWS - 1) * per / secs}
    for mode in ("thread", "process"):
        got, secs = loader_windows(ds, cfg, DATA_JOBS, mode, LOADER_WINDOWS)
        same_windows(got, serial, f"{mode} x{DATA_JOBS}")
        rates[f"{mode} x{DATA_JOBS}"] = (LOADER_WINDOWS - 1) * per / secs
    resumed, _ = loader_windows(ds, cfg, DATA_JOBS, "thread", 4, start_window=2)
    same_windows(resumed, serial[2:4], "start_window=2")
    wh, ww = ds.cfg.window_size
    log(f"  loader: thread x{DATA_JOBS} and process x{DATA_JOBS} equal the serial stream "
        f"over {LOADER_WINDOWS} windows of {TRAIN_ITER} x {TRAIN_BS} x {wh}x{ww}, "
        "start_window=2 equals its windows 2-3")
    log("  loader alone, samples/s over windows 2.." + str(LOADER_WINDOWS) + ": "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f"  (os.cpu_count() {os.cpu_count()})  [host CPU]")


def check_prefetch(ds, cfg) -> None:
    """Every window ``device_prefetch`` delivers, with the loader (thread
    x8 behind a BatchLoader) and the prefetch running ahead at depth 2,
    equals its host window on the card, for the f32 and bf16 wires."""
    import torch
    from adlm_tpu_torch.data.pipeline import BatchLoader, device_prefetch, superbatch_iterator
    from adlm_tpu_torch.train.pipeline import ship_dtypes

    for name, vcfg in train_variants(cfg).items():
        if name == "bfloat16 fused":
            continue   # the same wire as bfloat16
        dtypes = ship_dtypes(vcfg)
        host = []

        def recorded(it):
            for window in it:
                host.append(window)
                yield window

        loader = BatchLoader(superbatch_iterator(
            ds, TRAIN_ITER, TRAIN_BS, PREFETCH_WINDOWS, seed=cfg.train.random_seed,
            n_jobs=DATA_JOBS))
        try:
            n = ahead = 0
            for i, (img, lab) in enumerate(device_prefetch(recorded(loader), depth=2,
                                                           dtypes=dtypes)):
                ahead = max(ahead, len(host) - i - 1)
                hi, hl = host[i]
                if not (img.dtype == dtypes[0] and lab.dtype == dtypes[1]
                        and torch.equal(img, torch.from_numpy(hi).to("cuda").to(dtypes[0]))
                        and torch.equal(lab, torch.from_numpy(hl).to("cuda").to(dtypes[1]))):
                    raise AssertionError(f"device_prefetch window {i} ({name} wire) "
                                         "differs from its host window")
                n += 1
        finally:
            loader.close()
        if n != PREFETCH_WINDOWS or ahead != 2:
            raise AssertionError(f"device_prefetch gave {n} windows, {ahead} ahead")
        log(f"  device_prefetch ({name} wire: {dtypes[0]}, {dtypes[1]}): {n} windows, "
            f"{ahead} staged ahead of the consumer, each equal to its host window")


def calibrated_flagship(ds, cfg, card: str):
    """The flagship from the port's own initializers (identity frozen BNs,
    as from scratch), calibrated on CAL_WINDOWS training windows, its
    pre-sigmoid tensor standardized, and its prototypes drawn from
    PROTO_ITEMS items; each step held to its rule."""
    import numpy as np
    import torch
    from adlm_tpu_torch.models.calibrate import (
        STOP_MEAN,
        STOP_VAR,
        bn_output_moments,
        calibrate_frozen_bn,
        init_prototypes_from_data,
        standardize_presigmoid,
    )
    from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class

    seed = cfg.train.random_seed
    model = PPNet(cfg.model, generator=torch.Generator().manual_seed(SEED + 13)).cuda()
    cal = np.stack([ds.get_train_item(i, sample_seed=seed + i)[0]
                    for i in range(CAL_WINDOWS)])
    sub = lambda m: log("    " + m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = calibrate_frozen_bn(model, cal, log=sub)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  bn-calibrate: {info['sweeps']} sweeps, {info['forwards']} forwards of "
        f"{CAL_WINDOWS} x 513^2 (f32 IEEE) in {secs:.2f} s, "
        f"{secs / info['forwards'] * 1e3:.1f} ms per update  [{card}]")
    moments = bn_output_moments(model, cal)
    worst_m = worst_v = 0.0
    dead = live_bns = 0
    for name, (mean, var) in moments.items():
        live = var > BN_LIVE_VAR
        dead += int((~live).sum())
        if live.any():
            live_bns += 1
            worst_m = max(worst_m, float(np.abs(mean[live]).max()))
            worst_v = max(worst_v, float(np.abs(var[live] - 1).max()))
    log(f"  after calibration: {len(moments)} BNs ({live_bns} with live channels, "
        f"{dead} dead channels), live outputs max |mean| {worst_m:.2e}, max |var-1| "
        f"{worst_v:.2e} (stop rule {STOP_MEAN}, {STOP_VAR})")
    if worst_m >= STOP_MEAN or worst_v >= STOP_VAR or live_bns != len(moments):
        raise AssertionError("a calibrated BN output breaks the stop rule")
    pre = standardize_presigmoid(model, cal, log=sub)
    if max(pre["post_abs_mean"], pre["post_abs_std_minus_1"]) > PRESIGMOID_TOL:
        raise AssertionError(f"pre-sigmoid tensor not standardized: {pre}")
    items = [ds.get_train_item(i, sample_seed=seed + i) for i in range(PROTO_ITEMS)]
    pc = default_proto_class(cfg.model.num_prototypes, cfg.model.num_classes, device="cuda")
    before = model.prototypes().detach().clone()
    pv = init_prototypes_from_data(model, pc, np.stack([im for im, _ in items]),
                                   np.stack([lb for _, lb in items]), seed=seed, log=sub)
    n_set = int((pv != before).any(1).sum())
    if not bool(torch.isfinite(pv).all()) or n_set == 0:
        raise AssertionError("prototype init from data failed")
    log(f"  init: pre-sigmoid folded (tolerance {PRESIGMOID_TOL:g}), {n_set} of "
        f"{pv.shape[0]} prototypes drawn from feature cells  [{card}]")
    return model


def preloaded_windows(windows, dtypes):
    import torch

    return [(torch.from_numpy(img).to("cuda", dtypes[0]),
             torch.from_numpy(lab).to("cuda", dtypes[1])) for img, lab in windows]


def fed_loader(ds, cfg, steps: int, dtypes):
    """(BatchLoader over thread x8 windows, its device_prefetch)."""
    from adlm_tpu_torch.data.pipeline import BatchLoader, device_prefetch, superbatch_iterator

    loader = BatchLoader(superbatch_iterator(ds, TRAIN_ITER, TRAIN_BS, steps,
                                             seed=cfg.train.random_seed, n_jobs=DATA_JOBS))
    return loader, device_prefetch(loader, depth=2, dtypes=dtypes)


def check_fed_training(report, model, ds, cfg) -> None:
    """FED_STEPS f32 joint windows from the calibrated state fed through
    BatchLoader -> device_prefetch, against the same windows preloaded
    as tensors on the card: the same metrics, bit for bit, under cuDNN
    deterministic; 5 head launches per window in the fed run."""
    import torch
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.train.pipeline import ship_dtypes
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    dtypes = ship_dtypes(cfg)

    def run(feed):
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, cfg, 1, cfg.train.joint_steps)
        step = make_train_step(m, cfg, 1, cfg.train.joint_steps)
        out = []
        for img, lab in feed:
            state, metrics = step(state, img, lab)
            out.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        return out

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loader, feed = fed_loader(ds, cfg, FED_STEPS, dtypes)
        try:
            _build.reset_launches()
            fed = run(feed)
            launches = dict(_build.LAUNCHES)
        finally:
            loader.close()
        windows, _ = loader_windows(ds, cfg, DATA_JOBS, "thread", FED_STEPS)
        want = run(preloaded_windows(windows, dtypes))
    finally:
        torch.backends.cudnn.deterministic = saved_det
    log(f"  loader-fed training launches ({FED_STEPS} windows): {launches}")
    if (launches["prototype_head"] != TRAIN_ITER * FED_STEPS
            or launches["upsample_argmin"] != 0 or len(fed) != FED_STEPS):
        raise AssertionError(f"expected {TRAIN_ITER} head launches per window and no "
                             "upsample-argmin launch")
    for name in _build.KERNELS:
        report[name]["launches"] += launches[name]
    for i, (a, b) in enumerate(zip(fed, want)):
        log(f"  fed window {i + 1}: loss {a['loss']:.6f}, ce {a['cross_entropy']:.6f}, "
            f"kld {a['kld_loss']:.6f}, n_correct {a['n_correct']:.0f} of "
            f"{a['n_patches']:.0f}, grad_norm {a['grad_norm']:.6f}; preloaded "
            + ("equal in every metric" if a == b else f"DIFFERS: {b}"))
        if a != b or not all(math.isfinite(v) for v in a.values()):
            raise AssertionError(f"loader-fed window {i + 1} differs from the preloaded one")


def time_fed_training(model, ds, cfg, card: str) -> None:
    """Seconds per joint window fed by the loader (thread x8 ->
    device_prefetch) against the same windows preloaded on the card, in
    f32, bf16 and bf16 fused (host clock + synchronize over
    FED_TIME_WINDOWS windows after one warm window each); a
    ``torch.profiler`` window over one loader-fed bf16 window."""
    import torch
    from adlm_tpu_torch.train.pipeline import ship_dtypes
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    n = FED_TIME_WINDOWS
    for name, vcfg in train_variants(cfg).items():
        dtypes = ship_dtypes(vcfg)
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, vcfg, 1, vcfg.train.joint_steps)
        step = make_train_step(m, vcfg, 1, vcfg.train.joint_steps)

        def timed(windows):
            """(seconds per window, of which waiting for the next one)"""
            step(state, *next(windows))
            torch.cuda.synchronize()
            wait = 0.0
            t0 = time.perf_counter()
            for _ in range(n):
                t1 = time.perf_counter()
                window = next(windows)
                wait += time.perf_counter() - t1
                step(state, *window)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n, wait / n

        host, _ = loader_windows(ds, vcfg, DATA_JOBS, "thread", n + 1)
        s_pre, _ = timed(iter(preloaded_windows(host, dtypes)))
        del host
        profiled = name == "bfloat16"
        loader, feed = fed_loader(ds, vcfg, n + 1 + profiled, dtypes)
        try:
            s_fed, s_wait = timed(feed)
            if profiled:
                rows, wall_ms, busy_ms = device_profile(lambda: step(state, *next(feed)), 1)
        finally:
            loader.close()
        log(f"  joint window {name:15s} (2 x 5 x 513^2): loader-fed {s_fed:.4f} s "
            f"({s_wait:.4f} s of it waiting for the window), preloaded {s_pre:.4f} s "
            f"({s_fed / s_pre:.3f}x), {TRAIN_ITER * TRAIN_BS / s_fed:.1f} samples/s fed  "
            f"[{card}]")
        if profiled:
            log(f"  profile of one loader-fed {name} window: "
                + (profile_line(rows, wall_ms, busy_ms).replace("/batch", "/window") if rows else
                   "the profiler recorded no device time (not measured)") + f"  [{card}]")
            if rows:
                log_rows(rows, 6)
        del m, state, step
        torch.cuda.empty_cache()


def check_data_slice(report, card: str) -> None:
    """Phase 9: write the dataset, hold the augment, the loader modes and
    the prefetch, calibrate the flagship from scratch, and train it on
    loader-fed windows."""
    import shutil
    import tempfile

    from adlm_tpu_torch import native
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.data.dataset import SegmentationDataset

    cfg = get_experiment("cityscapes_kld_imnet")
    root = tempfile.mkdtemp(prefix="adlm_data_")
    try:
        t0 = time.perf_counter()
        write_dataset(root, DATA_FRAMES, SEED + 12)
        t1 = time.perf_counter()
        native.build()
        log(f"  wrote {DATA_FRAMES} frames {H}x{W} in {t1 - t0:.1f} s; host library "
            f"{native.library_path()[len(native.BUILD_DIR) + 1:]} ready in "
            f"{time.perf_counter() - t1:.1f} s (g++)")
        ds = SegmentationDataset(cfg.data, "train", data_path=root)
        check_augment(ds)
        check_loader(ds, cfg)
        check_prefetch(ds, cfg)
        t0 = time.perf_counter()
        model = calibrated_flagship(ds, cfg, card)
        log(f"  init phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_fed_training(report, model, ds, cfg)
        log(f"  fed training check {time.perf_counter() - t0:.1f} s")
        time_fed_training(model, ds, cfg, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: a training run through the command line
# ---------------------------------------------------------------------------

# the flagship (cityscapes_kld_imnet) with its schedule cut to 3 warmup,
# 3 joint and 2 last-layer windows of 2 x 5 x 513^2, from the port's own
# initializers calibrated from scratch, on seeded Cityscapes-layout frames
RUN_TRAIN_FRAMES, RUN_VAL_FRAMES = 12, 2
RUN_SCHEDULE = dict(warmup_steps=15, joint_steps=15, finetune_steps=10)
RUN_HALT = 4              # windows before the halt: the joint phase's first
RUN_PRUNE = ("--k", "6", "--threshold", "1")   # threshold 1, as phase 8
RUN_TEST_IMAGES = 2
RUN_EVAL_BS = 2


@contextlib.contextmanager
def run_probes():
    """Seconds of every training stage, bn-calibrate/proto-init and push,
    seconds and bytes of every checkpoint save, and the time the first
    window of each train command started, recorded around the pipeline's
    own functions (each closed by a synchronize)."""
    import os

    import torch
    import adlm_tpu_torch.core.checkpoint as ck
    import adlm_tpu_torch.interpret.push as push_mod
    import adlm_tpu_torch.models.calibrate as cal
    import adlm_tpu_torch.train.pipeline as pipe
    import adlm_tpu_torch.train.protoseg as ps

    rec = {"stages": [], "saves": [], "first_window": None}

    def timed(fn, name_of):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["stages"].append((name_of(*args, **kwargs), time.perf_counter() - t0))
            return out
        return wrapper

    def save(self, stage, kind, payload):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = saved["save"](self, stage, kind, payload)
        rec["saves"].append((stage, kind, time.perf_counter() - t0,
                             os.path.getsize(os.path.join(path, ck.PAYLOAD))))
        return path

    def make_train_step(*args, **kwargs):
        step = saved["make_train_step"](*args, **kwargs)

        def first(state, images, labels):
            if rec["first_window"] is None:
                torch.cuda.synchronize()
                rec["first_window"] = time.perf_counter()
            return step(state, images, labels)
        return first

    saved = {"save": ck.CheckpointStore.save, "_run_phase": pipe._run_phase,
             "push_prototypes": push_mod.push_prototypes,
             "make_train_step": ps.make_train_step,
             **{n: getattr(cal, n) for n in ("calibrate_frozen_bn", "standardize_presigmoid",
                                             "init_prototypes_from_data")}}
    ck.CheckpointStore.save = save
    pipe._run_phase = timed(saved["_run_phase"], lambda m, c, phase, *a, **kw:
                            kw.get("stage_key") or pipe.STAGE_BY_PHASE[phase])
    push_mod.push_prototypes = timed(saved["push_prototypes"], lambda *a, **kw: "push event")
    ps.make_train_step = make_train_step
    for n in ("calibrate_frozen_bn", "standardize_presigmoid", "init_prototypes_from_data"):
        setattr(cal, n, timed(saved[n], lambda *a, **kw: "init (bn-calibrate, proto-init)"))
    try:
        yield rec
    finally:
        ck.CheckpointStore.save = saved["save"]
        pipe._run_phase = saved["_run_phase"]
        push_mod.push_prototypes = saved["push_prototypes"]
        ps.make_train_step = saved["make_train_step"]
        for n in ("calibrate_frozen_bn", "standardize_presigmoid", "init_prototypes_from_data"):
            setattr(cal, n, saved[n])


def run_command(argv, rec, launches_by_cmd):
    """One CLI command in-process, its launches counted from 0; its
    standard output is kept in ``rec["stdout"]``."""
    import torch
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.ops import _build

    tag = " ".join([argv[0]] + [a for a in argv[1:] if a in (
        "U", "H", "push", "pruned", "--halt-after", "--resume", "--pruned", "--windowed")])
    torch.cuda.synchronize()
    _build.reset_launches()
    rec["first_window"] = None
    out = io.StringIO()   # the run's own log lines; their tail on a failure
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(argv))
    except BaseException:
        log("\n".join(out.getvalue().splitlines()[-40:]))
        raise
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec["stdout"] = out.getvalue()
    launches = dict(_build.LAUNCHES)
    launches_by_cmd.append((tag, launches))
    start = (rec["first_window"] - t0) if rec["first_window"] is not None else None
    log(f"  {tag}: {secs:.2f} s, launches {launches}"
        + (f", first window started {start:.2f} s after the call" if start is not None else ""))
    return secs, start


def same_payload(a, b):
    """The entries in which two checkpoint payloads differ (bit for bit)."""
    import torch

    bad = [k for k in ("step", "phase", "max_steps") if a.get(k) != b.get(k)]
    if not torch.equal(a["proto_class"], b["proto_class"]):
        bad.append("proto_class")
    sa, sb = a["state_dict"], b["state_dict"]
    bad += [k for k in sorted(set(sa) | set(sb))
            if k not in sa or k not in sb or not torch.equal(sa[k], sb[k])]
    oa, ob = a.get("opt", {}), b.get("opt", {})
    bad += [f"opt {n}.{k}" for n in sorted(set(oa) | set(ob))
            for k in ("step", "exp_avg", "exp_avg_sq")
            if n not in oa or n not in ob or not torch.equal(oa[n][k], ob[n][k])]
    return bad


def read_png(path: str):
    """The (H, W) or (H, W, 3) pixels of an 8-bit greyscale or RGB PNG
    whose scanlines use filter 0 (what ``data/image_folder.py::write_png``
    writes)."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head
    if depth != 8 or color not in (0, 2):
        raise AssertionError(f"{path}: depth {depth}, color type {color}")
    c = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a scanline filter other than 0")
    return rows[:, 1:] if c == 1 else rows[:, 1:].reshape(h, w, 3)


class _RecordedEvaluators:
    """Patch ``SegEvaluator`` so that every update keeps what
    ``compare_eval`` holds (counts, purity and its sampled inputs)."""

    def __enter__(self):
        import adlm_tpu_torch.interpret.evaluate as ev

        self.module, self.orig = ev, ev.SegEvaluator
        self.instances, self.outs = [], []
        rec = self

        class Recording(ev.SegEvaluator):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rec.instances.append(self)

            def update(self, proto_class, images, labels):
                with purity_inputs() as seen:
                    o = super().update(proto_class, images, labels)
                out = {k: v.cpu() for k, v in o.items()
                       if k not in ("pred", "stat_pred", "nearest_proto")}
                out["sample_d"], out["sample_pred"] = seen[0]
                rec.outs.append(out)
                return o

        ev.SegEvaluator = Recording
        return self

    def __exit__(self, *exc):
        self.module.SegEvaluator = self.orig


def check_run_eval(run_dir: str, data_root: str, cli_eval) -> None:
    """eval-valid's counts and statistics against a direct SegEvaluator
    over the same checkpoint with the plain versions patched in, within
    phase 4's tie budget (``compare_eval``); its files against its own
    results."""
    import json
    import os

    import numpy as np
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret.stats import ProtoStatsAccumulator

    cfg, payload, model = cli._load_stage(run_dir, "push", "last", "cuda")
    pc = payload["proto_class"]
    K = cfg.model.num_classes
    ds = SegmentationDataset(cfg.data, "val", data_path=data_root, is_eval=True)
    with _RecordedEvaluators() as plain, plain_versions():
        ev = plain.module.SegEvaluator(model, K, with_stats=True, stats_upsampled=True,
                                       normalize=(cfg.data.mean, cfg.data.std))
        acc = ProtoStatsAccumulator(pc.numel(), K, pc.cpu().numpy())
        for img, lab, n_real in ds.eval_batches(RUN_EVAL_BS, with_counts=True, raw=True):
            o = ev.update(pc, img, lab)
            acc.update_counts(o["agree_counts"][:n_real], o["topk_purity"][:n_real],
                              n_images=n_real)
    recorded, plots = cli_eval
    (cli_ev,) = recorded.instances
    res = cli_ev.results()
    out_dir = os.path.join(run_dir, "evaluation", "push")
    with open(os.path.join(out_dir, "mean_iou.txt")) as f:
        miou = float(f.read())
    with open(os.path.join(out_dir, "iou_scores.json")) as f:
        ious = json.load(f)
    if miou != res["mean_iou"] or ious != {str(k): v for k, v in res["iou_per_class"].items()}:
        raise AssertionError("eval-valid's files differ from its evaluator's results")
    n_pixels = RUN_VAL_FRAMES * H * W
    compare_eval("run eval-valid", (res, recorded.outs), (ev.results(), plain.outs),
                 n_pixels, proto_class=pc)
    got = plots[0]["stats"]["nearest_proto_counts"]
    want = acc.results()["nearest_proto_counts"]
    diff = int(np.abs(got - want).sum())
    budget = 2 * math.ceil(TIE_SHARE * n_pixels)
    log(f"  eval-valid vs plain versions: mIoU {miou:.6f} (plain "
        f"{ev.results()['mean_iou']:.6f}), nearest-prototype counts |diff| {diff} "
        f"(budget {budget}), {int(want.sum())} agreeing pixels, top-K purity at K=1 "
        f"{plots[0]['stats']['mean_top_k_purity'][0]:.3f}")
    if diff > budget or not np.isfinite(miou):
        raise AssertionError("eval-valid's statistics disagree with the plain versions")


def check_run(report, card: str) -> None:
    """Phase 10: train (unbroken U; halted and resumed H), eval-valid with
    upsampled statistics, prune, train --pruned and eval-test through
    ``adlm_tpu_torch.cli`` on the flagship at full width, in f32 IEEE.
    The training commands set cuDNN's deterministic algorithms
    themselves; eval-valid and eval-test run under them here, beside the
    direct runs they are held to."""
    import csv
    import dataclasses
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from adlm_tpu_torch.core import config as config_mod
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.device import deterministic_cudnn
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret import stats as stats_mod
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.prototype import head_route

    t_phase = time.perf_counter()
    name = "cityscapes_kld_imnet"
    flagship = config_mod.get_experiment(name)
    cfg = dataclasses.replace(flagship, train=dataclasses.replace(flagship.train,
                                                                  **RUN_SCHEDULE))
    root = tempfile.mkdtemp(prefix="adlm_run_")
    saved_env = os.environ.get("RESULTS_DIR")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    launches_by_cmd = []
    plots = []
    orig_plots = stats_mod.save_eval_plots
    try:
        config_mod.register_experiment(cfg)
        # cuDNN's defaults around the commands: train must set its
        # deterministic algorithms itself for U and H to agree
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
        data = os.path.join(root, "data")
        results = os.path.join(root, "runs")
        os.environ["RESULTS_DIR"] = results
        t0 = time.perf_counter()
        write_dataset(data, RUN_TRAIN_FRAMES, SEED + 21, n_val=RUN_VAL_FRAMES)
        log(f"  wrote {RUN_TRAIN_FRAMES} train and {RUN_VAL_FRAMES} val frames {H}x{W} in "
            f"{time.perf_counter() - t0:.1f} s; schedule cut to {RUN_SCHEDULE} "
            f"(iter_size {cfg.train.iter_size}: 3 + 3 + 2 windows)")
        train = ["train", name, "U", "--data-path", data, "--val-every", "2",
                 "--push-batch-size", "2", "--bn-calibrate", "--proto-init-data"]
        run_u, run_h = os.path.join(results, "U"), os.path.join(results, "H")
        with run_probes() as rec:
            secs_u, _ = run_command(train, rec, launches_by_cmd)
            stages_u, saves_u = list(rec["stages"]), list(rec["saves"])
            rec["stages"].clear()
            rec["saves"].clear()
            h = train[:2] + ["H"] + train[3:]
            run_command(h + ["--halt-after", str(RUN_HALT)], rec, launches_by_cmd)
            torch.cuda.empty_cache()
            secs_r, resume_start = run_command(h + ["--resume"], rec, launches_by_cmd)

        # U: every stage's files, the marker, finite losses
        store_u, store_h = CheckpointStore(run_u), CheckpointStore(run_h)
        for stage in ("warmup", "nopush", "push"):
            for kind in ("last", "best"):
                if not store_u.exists(stage, kind):
                    raise AssertionError(f"U has no {stage}_{kind}")
        with open(os.path.join(run_u, "resume.json")) as f:
            meta_u = json.load(f)
        with open(os.path.join(run_h, "resume.json")) as f:
            meta_h = json.load(f)
        if meta_u["stage"] != "push" or not meta_u["completed"]:
            raise AssertionError(f"U's resume.json: {meta_u}")
        with open(os.path.join(run_u, "logs", "train_metrics.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["loss"]) for r in rows]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"U logged a non-finite loss: {losses}")
        log(f"  U: {len(rows)} logged rows, losses {['%.4f' % v for v in losses]}, "
            f"resume.json {meta_u}")
        with open(os.path.join(run_h, "logs", "train.log")) as f:
            if "halting after window 1" not in f.read():
                raise AssertionError("H did not halt inside the joint phase")

        # H == U, bit for bit
        pay_u, pay_h = store_u.restore("push", "last"), store_h.restore("push", "last")
        bad = same_payload(pay_u, pay_h)
        n_t = len(pay_u["state_dict"]) + 3 * len(pay_u["opt"]) + 2
        log(f"  H (halted after {RUN_HALT} windows, resumed) vs U push_last: "
            f"{n_t - len(bad)} of {n_t} entries equal bit for bit (state_dict, Adam "
            f"step and moments, proto_class, step); resume.json "
            + ("equal" if meta_h == meta_u else f"DIFFERS: {meta_h}"))
        if bad or meta_h != meta_u:
            raise AssertionError(f"the resumed run differs from the unbroken one: {bad[:8]}")
        P = pay_u["proto_class"].numel()
        log(f"  pushed model: {P} prototypes after dedup, head route "
            f"{head_route(64, P, 19, torch.float32)}")

        # eval-valid with upsampled statistics, against the plain versions
        def record_plots(out_dir, *args, **kwargs):
            plots.append(kwargs)
            return orig_plots(out_dir, *args, **kwargs)

        stats_mod.save_eval_plots = record_plots
        with deterministic_cudnn():
            with run_probes() as rec, _RecordedEvaluators() as recorded:
                run_command(["eval-valid", run_u, "push", "--data-path", data, "--stats",
                             "--stats-upsampled", "--batch-size", str(RUN_EVAL_BS),
                             "--examples", "0"], rec, launches_by_cmd)
            stats_mod.save_eval_plots = orig_plots
            check_run_eval(run_u, data, (recorded, plots))

        # prune, the pruned finetune, eval-test
        with run_probes() as rec:
            run_command(["prune", run_u, "--data-path", data, *RUN_PRUNE,
                         "--batch-size", "2"], rec, launches_by_cmd)
            info = np.load(os.path.join(run_u, "prune_info.npy"))
            pruned = store_u.restore("pruned", "last")
            keep = np.setdiff1d(np.arange(P), info[:, 0])
            if not (pruned["state_dict"]["prototype_vectors"].shape[0] == len(keep)
                    and pruned["proto_class"].tolist()
                    == pay_u["proto_class"][torch.from_numpy(keep)].tolist()):
                raise AssertionError("pruned_last does not match prune_info.npy")
            log(f"  prune: {len(info)} of {P} prototypes pruned ({' '.join(RUN_PRUNE)}), "
                f"P' = {len(keep)}, head route {head_route(64, len(keep), 19, torch.float32)}")
            run_command(train[:3] + ["--pruned", "--data-path", data, "--val-every", "2"],
                        rec, launches_by_cmd)
            stages_p = list(rec["stages"])
            with deterministic_cudnn():
                run_command(["eval-test", run_u, "pruned", "--data-path", data,
                             "--max-images", str(RUN_TEST_IMAGES)], rec, launches_by_cmd)
        done = store_u.restore("pruned", "last")
        if done["step"] != 2 or not all(bool(torch.isfinite(v).all())
                                        for v in done["state_dict"].values()):
            raise AssertionError("the pruned finetune did not run its 2 windows")
        from adlm_tpu_torch import cli
        pcfg, ppay, pmodel = cli._load_stage(run_u, "pruned", "last", "cuda")
        ds = SegmentationDataset(pcfg.data, "val", data_path=data, is_eval=True)
        fn = make_inference_fn(pmodel, 19, normalize=(pcfg.data.mean, pcfg.data.std))
        lut = get_class_table(pcfg.data.class_table).submission_lut(19)
        pred_dir = os.path.join(run_u, "evaluation", "pruned", "test_predictions")
        for i, (img, lab) in enumerate(ds.eval_items(raw=True)):
            if i == RUN_TEST_IMAGES:
                break
            with deterministic_cudnn():
                want = lut[fn(ppay["proto_class"], img, lab)["pred"][0].cpu().numpy()]
            got = read_png(os.path.join(pred_dir, ds.img_ids[i] + ".png"))
            if got.shape != (H, W) or not np.array_equal(got, want):
                raise AssertionError(f"prediction PNG {i} differs from submission_lut[pred]")
        log(f"  eval-test: {RUN_TEST_IMAGES} PNGs decode to submission_lut of the pruned "
            f"model's predictions ({len(np.unique(got))} ids in the last)")

        # launches: kernel 1 in every command, kernel 2 once per eval-valid batch
        n_eval_batches = -(-RUN_VAL_FRAMES // RUN_EVAL_BS)
        for tag, counts in launches_by_cmd:
            want_up = n_eval_batches if tag.startswith("eval-valid") else 0
            if counts["prototype_head"] == 0 or counts["upsample_argmin"] != want_up:
                raise AssertionError(f"{tag}: launches {counts}, expected head > 0 and "
                                     f"{want_up} upsample-argmin")
            for k in _build.KERNELS:
                report[k]["launches"] += counts[k]
        log("  launches by command: " + "; ".join(
            f"{tag}: head {c['prototype_head']}, upsample-argmin {c['upsample_argmin']}"
            for tag, c in launches_by_cmd))

        # timings
        by_stage = {}
        for stage, secs in stages_u:
            by_stage[stage] = by_stage.get(stage, 0.0) + secs
        log(f"  U train {secs_u:.2f} s; seconds by stage (saves and validation included): "
            + ", ".join(f"{k} {v:.2f}" for k, v in by_stage.items())
            + f"; pruned finetune {sum(s for _, s in stages_p):.2f}  [{card}]")
        groups = {}
        for stage, kind, secs, nbytes in saves_u:
            g = groups.setdefault(stage, [0, 0.0, 0])
            g[0] += 1
            g[1] += secs
            g[2] = max(g[2], nbytes)
        log("  U checkpoint saves by stage (count, mean s, MB): " + ", ".join(
            f"{k} {n} x {s / n:.3f} s {b / 1e6:.1f} MB" for k, (n, s, b) in groups.items())
            + f"; all {sum(s for *_, s, _ in saves_u):.2f} s for "
            f"{sum(b for *_, b in saves_u) / 1e9:.2f} GB  [{card}]")
        # a resume in a new process first pays the interpreter, the imports
        # and the CUDA context: timed alone, as a child that stops there
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch, adlm_tpu_torch.cli; "
                        "torch.ones(4, device='cuda').sum().item()"], check=True, timeout=300)
        start_secs = time.perf_counter() - t0
        log(f"  resume overhead: {resume_start:.2f} s in process from the call to the first "
            f"resumed window, plus {start_secs:.2f} s for a new process to import the port "
            f"and reach the card; resumed run {secs_r:.2f} s  [{card}]")
    finally:
        stats_mod.save_eval_plots = orig_plots
        config_mod.register_experiment(flagship)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"  run phase {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 11: U-Noise through the command line
# ---------------------------------------------------------------------------

# the shipped U-Net (depth 5, channel factor 6) for the utility and the
# noise model, batch 8 of 256x256 slices (Pancreas at prepare_unoise_data's
# downscale 2); 200 seeded slices split 160 / 20 / 20
UN_SLICES, UN_HW, UN_DEPTH, UN_CF, UN_BS = 200, 256, 5, 6, 8
UN_EPOCHS = 2
UN_OCC_STRIDE = 16        # cut: the default stride 4 costs 16x the forwards
UN_CMP_BS = 2             # batch of the card-vs-CPU checks
# card (cuDNN) against the port on the CPU (oneDNN), both IEEE f32.
# Logits: max |diff| over max |logit| (sums in other orders through 23
# convs and 22 BNs).  A step's gradients sit far from f64 at random
# weights and this size (the CPU port's own f32 gradients some 4e-3 in
# relative L2, as this phase prints), so each step is held to an f64 run
# of the same step on the card, tensor by tensor: each gradient tensor's
# relative L2 error must stay within UN_F32_FACTOR times the CPU port's
# for the same tensor (the card's worst ratio read 1.31, a utility step
# at these seeds), or within UN_GRAD_FLOOR: the head's and the last
# conv's tensors sit at 1e-7 to 5e-5 on both, where the ratio of two
# summation orders' errors is noise (the head's bias read 2.82 once, at
# 3e-6), and a 1% fault is 100 times the floor.  The conv biases that feed a train-mode BN have an
# analytic gradient of 0: the largest one's norm, as a share of all
# gradients', is held the same way.  Controls the limit must refuse: a
# utility step with cuDNN's TF32 convolutions; the card's gradients with
# the head's or an up-block conv's tensor scaled by 1.01 and a BN scale
# by 1.05 (UN_FAULT_CASES); and, tensor by tensor, any one scaled by
# UN_FAULT_ANY.  A 1% fault is seen only where the CPU port's own f32
# error is under 1% / UN_F32_FACTOR: BN scales and biases carry up to 1%.
UN_LOGIT_REL = 1e-4
UN_STATS_RTOL, UN_STATS_ATOL = 1e-4, 1e-5
UN_LOSS_RTOL = 1e-5       # each f32 step's loss against the f64 step's
UN_F32_FACTOR = 2.0
UN_GRAD_FLOOR = 1e-4      # the error no tensor is held below
UN_FAULT_CASES = (("conv1x1.weight", 1.01), ("ups.3.conv.0.weight", 1.01),
                  ("downs.0.1.weight", 1.05))
UN_FAULT_SMALL, UN_FAULT_ANY = 1.01, 1.05
UN_BLUR_ATOL = 1e-6       # the C blur's f64 sums against scipy's
UN_TIME_STEPS = 5
# H100 SXM data-sheet peaks of dense FLOP/s (an FMA counts two): f32 on
# the CUDA cores, bf16 on the tensor cores
PEAK_F32_FLOPS, PEAK_BF16_FLOPS = 67e12, 989e12


def unoise_slices(n: int, hw: int, seed: int):
    """Pancreas-like slices: (n, hw, hw) f32 images in [0, 1] (a smooth
    body, brighter blobs, noise), their blob masks and boxes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.empty((n, hw, hw), np.float32)
    masks = np.zeros((n, hw, hw), np.float32)
    boxes = np.zeros((n, 4), np.int32)
    for i in range(n):
        body = 0.3 + 0.15 * np.sin(6.0 * xx + rng.rand() * 6) * np.cos(5.0 * yy)
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.uniform(0.2, 0.8, size=2)
            ry, rx = rng.uniform(0.04, 0.12, size=2)
            masks[i] = np.maximum(masks[i], (((yy - cy) / ry) ** 2
                                             + ((xx - cx) / rx) ** 2 < 1).astype(np.float32))
        imgs[i] = np.clip(body + 0.3 * masks[i] + 0.08 * rng.randn(hw, hw), 0, 1)
        ys, xs = np.nonzero(masks[i])
        boxes[i] = (ys.min(), ys.max(), xs.min(), xs.max())
    return imgs, masks, boxes


def check_unoise_native() -> None:
    """The remap and blur bindings against their numpy versions at the
    slice size."""
    import numpy as np
    from adlm_tpu_torch import native

    rng = np.random.RandomState(SEED + 40)
    img = rng.rand(UN_HW, UN_HW).astype(np.float32)
    mask = (rng.rand(UN_HW, UN_HW) > 0.5).astype(np.float32)
    # coordinates beyond both edges (reflect-101) and exact .5 ties
    my = (rng.rand(UN_HW, UN_HW) * 1.5 * UN_HW - UN_HW / 4).astype(np.float32)
    mx = (rng.rand(UN_HW, UN_HW) * 1.5 * UN_HW - UN_HW / 4).astype(np.float32)
    my[0, :4] = (0.5, 1.5, -0.5, 254.5)
    for name, got, want in (
            ("remap_bilinear", native.remap_bilinear(img, my, mx),
             native.remap_bilinear_plain(img, my, mx)),
            ("remap_nearest", native.remap_nearest(mask, my, mx),
             native.remap_nearest_plain(mask, my, mx))):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} values differ "
                                 "from the numpy version")
    field = (rng.rand(UN_HW, UN_HW) * 2 - 1).astype(np.float32)
    err = float(np.abs(native.gaussian_blur(field, 6.0)
                       - native.gaussian_blur_plain(field, 6.0)).max())
    log(f"  native remap_bilinear, remap_nearest bit-equal to numpy at {UN_HW}^2; "
        f"gaussian_blur (sigma 6) max |diff| {err:.2e} against scipy (limit {UN_BLUR_ATOL})")
    if err > UN_BLUR_ATOL:
        raise AssertionError("gaussian_blur disagrees with scipy")


def _rel_max(got, want) -> float:
    return float((got.float().cpu() - want.float()).abs().max() / want.float().abs().max())


def _same_stats(card_model, cpu_model, what: str) -> None:
    import torch

    want = cpu_model.state_dict()
    for k, v in card_model.state_dict().items():
        if "running" in k and not torch.allclose(v.cpu(), want[k], rtol=UN_STATS_RTOL,
                                                 atol=UN_STATS_ATOL):
            raise AssertionError(f"{what}: running statistics {k} differ")


def _host64(grads):
    return {n: g.detach().double().cpu() for n, g in grads.items()}


def _step_errors(grads, ref, zero):
    """({name: relative L2 error of the host f64 ``grads[name]`` against
    the f64 ``ref[name]``} over the tensors with a nonzero gradient, the
    largest analytically-zero gradient's norm over all reference
    gradients')."""
    import torch

    rel = {n: float((grads[n] - r).norm() / r.norm()) for n, r in ref.items()
           if n not in zero}
    total = float(torch.cat([r.flatten() for r in ref.values()]).norm())
    return rel, max(float(grads[n].norm()) for n in zero) / total


def _step_faults(card, cpu, ref, card_err, cpu_err):
    """What makes the card's step disagree: its loss or the CPU's off the
    f64 step's, a gradient tensor or the zero-gradient biases off by more
    than UN_F32_FACTOR times the CPU port's error."""
    faults = [f"loss {loss:.7f} against {ref[0]:.7f}" for loss in (card[0], cpu[0])
              if abs(loss - ref[0]) > UN_LOSS_RTOL * abs(ref[0])]
    (rel_card, z_card), (rel_cpu, z_cpu) = card_err, cpu_err
    faults += [f"{n} {rel_card[n]:.2e} (CPU {rel_cpu[n]:.2e})" for n in rel_card
               if not rel_card[n] <= max(UN_F32_FACTOR * rel_cpu[n], UN_GRAD_FLOOR)]
    if not z_card <= UN_F32_FACTOR * z_cpu:
        faults.append(f"zero-gradient biases {z_card:.2e} (CPU {z_cpu:.2e})")
    return faults


def _zero_bias_names(model):
    """The conv biases that feed a train-mode BN: every conv's but the
    head's."""
    from torch import nn

    return [f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and n != "conv1x1"]


def _hold_step(what, model, card, cpu, ref):
    """The card's f32 step and the CPU port's against the f64 step:
    ``card``, ``cpu``, ``ref`` are (loss, {name: gradient}) of ``model``'s
    parameters.  Returns the card's gradients and both errors, for the
    controls."""
    zero = _zero_bias_names(model)
    card = (card[0], _host64(card[1]))
    card_err, cpu_err = (_step_errors(g, ref[1], zero) for g in (card[1], _host64(cpu[1])))
    floored = [n for n in card_err[0] if UN_F32_FACTOR * cpu_err[0][n] < UN_GRAD_FLOOR]
    ratio = {n: card_err[0][n] / cpu_err[0][n] for n in card_err[0] if n not in floored}
    worst = max(ratio, key=ratio.get, default=None)
    lo, hi = min(cpu_err[0].values()), max(cpu_err[0].values())
    log(f"  {what}: loss {card[0]:.7f} card, {cpu[0]:.7f} CPU, {ref[0]:.7f} f64; "
        f"{len(card_err[0])} gradient tensors, relative L2 to f64 "
        f"{min(card_err[0].values()):.2e}-{max(card_err[0].values()):.2e} card, "
        f"{lo:.2e}-{hi:.2e} CPU; worst card/CPU ratio {ratio.get(worst, 0.0):.2f} ({worst}; limit "
        f"{UN_F32_FACTOR:g}), {len(floored)} held to {UN_GRAD_FLOOR:g} instead (worst card "
        f"{max([card_err[0][n] for n in floored], default=0.0):.2e}); zero-gradient biases "
        f"{card_err[1]:.2e} card, {cpu_err[1]:.2e} CPU of all gradients")
    faults = _step_faults(card, cpu, ref, card_err, cpu_err)
    if faults:
        raise AssertionError(f"the card's {what} disagrees with the CPU port's: {faults[:6]}")
    return card, card_err, cpu_err


def _hold_controls(what, card, cpu, ref, cpu_err) -> None:
    """The planted controls of the gradient limit: each of UN_FAULT_CASES
    through ``_step_faults``, and every tensor alone scaled by
    UN_FAULT_ANY (the same test: the other tensors passed already).  How
    many tensors a scale by UN_FAULT_SMALL is refused in is printed."""
    rel_cpu = cpu_err[0]
    zero = [n for n in ref[1] if n not in rel_cpu]
    for name, scale in UN_FAULT_CASES:
        planted = dict(card[1], **{name: card[1][name] * scale})
        if not _step_faults((card[0], planted), cpu, ref,
                            _step_errors(planted, ref[1], zero), cpu_err):
            raise AssertionError(f"the {what} check passed {name}'s gradient scaled by "
                                 f"{scale}")

    def refused(scale):
        return [n for n in rel_cpu
                if float((card[1][n] * scale - ref[1][n]).norm() / ref[1][n].norm())
                > max(UN_F32_FACTOR * rel_cpu[n], UN_GRAD_FLOOR)]

    small, any_ = refused(UN_FAULT_SMALL), refused(UN_FAULT_ANY)
    log(f"  controls, {what}: refused " + ", ".join(f"{n} x {f}" for n, f in UN_FAULT_CASES)
        + f"; one tensor scaled by {UN_FAULT_SMALL} refused in {len(small)} of "
        f"{len(rel_cpu)} tensors, by {UN_FAULT_ANY} in {len(any_)}")
    if len(any_) != len(rel_cpu):
        raise AssertionError(f"the {what} check passed {sorted(set(rel_cpu) - set(any_))[:4]} "
                             f"scaled by {UN_FAULT_ANY}")


@contextlib.contextmanager
def _tf32_convs():
    """The port's steps with cuDNN's TF32 convolutions (its default), in
    place of IEEE f32: the control a gradient limit must refuse."""
    import torch
    from adlm_tpu_torch.train import unoise as tu

    saved = tu.ieee_f32, torch.backends.cudnn.allow_tf32
    tu.ieee_f32, torch.backends.cudnn.allow_tf32 = contextlib.nullcontext, True
    try:
        yield
    finally:
        tu.ieee_f32, torch.backends.cudnn.allow_tf32 = saved


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _f64_unet(sd):
    import torch
    from adlm_tpu_torch.train import unoise as tu

    return tu.build_unet(UN_DEPTH, UN_CF, torch.device("cuda"), state_dict=sd).double()


@contextlib.contextmanager
def _f64_reference():
    """Scope of the f64 reference steps on the card, timed: PyTorch's own
    convolutions (im2col and cuBLAS DGEMM, which runs on the f64 tensor
    cores) in place of cuDNN's f64 kernels."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=False):
        yield
    torch.cuda.synchronize()
    log(f"  f64 reference step on the card {time.perf_counter() - t0:.1f} s")


@_f64_reference()
def _f64_utility_step(sd, raw, y):
    """(loss, gradients on the host) of the utility step's function in f64
    on the card."""
    import torch.nn.functional as F
    from adlm_tpu_torch.train import unoise as tu

    m = _f64_unet(sd).train()
    loss = F.binary_cross_entropy_with_logits(
        m(tu._prep_images(raw.cuda(), True).double()), y.cuda().permute(0, 3, 1, 2).double())
    loss.backward()
    return float(loss.detach()), {n: g.cpu() for n, g in _grads(m).items()}


@_f64_reference()
def _f64_noise_step(cfg, noise_sd, util_sd, raw, y, eps):
    """(loss, noise-model gradients on the host) of the noise step's
    function in f64 on the card (the utility model in eval mode, frozen)."""
    import torch
    import torch.nn.functional as F
    from adlm_tpu_torch.train import unoise as tu

    nm, um = _f64_unet(noise_sd).train(), _f64_unet(util_sd).eval().requires_grad_(False)
    x = tu._prep_images(raw.cuda(), True).double()
    logits = nm(x)
    B = torch.sigmoid(logits)
    noise = eps.cuda().permute(0, 3, 1, 2).double() * (B * (cfg.max_scale - cfg.min_scale)
                                                      + cfg.min_scale)
    loss = (F.binary_cross_entropy_with_logits(um(x + noise),
                                               y.cuda().permute(0, 3, 1, 2).double())
            - cfg.noise_coeff * F.logsigmoid(logits).mean())
    loss.backward()
    return float(loss.detach()), {n: g.cpu() for n, g in _grads(nm).items()}


def check_unoise_card_vs_cpu(imgs, masks) -> None:
    """The U-Net forward (train and eval mode) and one utility and one
    noise step at full width, on the card and through the port on the
    CPU, from the same weights, batch and eps."""
    import numpy as np
    import torch
    from adlm_tpu_torch.core.config import UNoiseConfig
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.models.unet import UNetBatchNorm
    from adlm_tpu_torch.train import unoise as tu

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    raw = torch.from_numpy(imgs[:UN_CMP_BS, :, :, None].copy())
    y = torch.from_numpy(masks[:UN_CMP_BS, :, :, None].copy())
    m_cpu = tu.build_unet(UN_DEPTH, UN_CF, cpu, SEED)

    m_card = tu.build_unet(UN_DEPTH, UN_CF, cuda, state_dict=m_cpu.state_dict())
    t0 = time.perf_counter()
    cpu_s = [0.0]   # of it, the port's work on the CPU
    laps = []       # (what, seconds since the last lap)

    def on(dev, fn):
        t = time.perf_counter()
        out = fn()
        cpu_s[0] += (time.perf_counter() - t) * (dev.type == "cpu")
        return out

    def lap(what):
        laps.append((what, time.perf_counter() - t0 - sum(s for _, s in laps)))

    with torch.no_grad(), ieee_f32():
        for mode in ("train", "eval"):
            outs = [on(dev, lambda: m.train(mode == "train")(tu._prep_images(raw.to(dev), True)))
                    for m, dev in ((m_card, cuda), (m_cpu, cpu))]
            err = _rel_max(*outs)
            log(f"  forward {mode} mode, batch {UN_CMP_BS} x {UN_HW}^2: logits max |diff| "
                f"{err:.2e} of max |logit| {float(outs[1].abs().max()):.3f} "
                f"(limit {UN_LOGIT_REL})")
            if not err <= UN_LOGIT_REL:
                raise AssertionError(f"the card's {mode}-mode U-Net disagrees with the CPU's")
            if mode == "train":
                _same_stats(m_card, m_cpu, "train-mode forward")
    lap("forwards")
    cfg = UNoiseConfig(depth=UN_DEPTH, channel_factor=UN_CF, util_depth=UN_DEPTH,
                       util_channel_factor=UN_CF)
    sd = m_cpu.state_dict()
    steps = {}
    for tag, dev in (("card", cuda), ("cpu", cpu)):
        st = tu.init_utility_state(cfg, device=dev)
        st.model.load_state_dict(sd)
        loss = on(dev, lambda: float(tu.make_utility_train_step(cfg, raw=True)(
            st, raw.to(dev), y.to(dev))))
        steps[tag] = (st, loss)
    lap("utility steps")
    ref = _f64_utility_step(sd, raw, y)
    lap("its f64 step")
    cpu_step = (steps["cpu"][1], _grads(steps["cpu"][0].model))
    card_step, _, cpu_err = _hold_step("utility step", m_cpu,
                                       (steps["card"][1], _grads(steps["card"][0].model)),
                                       cpu_step, ref)
    _same_stats(steps["card"][0].model, steps["cpu"][0].model, "utility step")
    _hold_controls("utility step", card_step, cpu_step, ref, cpu_err)
    lap("their checks")
    st = tu.init_utility_state(cfg, device=cuda)
    st.model.load_state_dict(sd)
    with _tf32_convs():
        loss = tu.make_utility_train_step(cfg, raw=True)(st, raw.to(cuda), y.to(cuda))
    try:
        _hold_step("utility step, control: TF32 convolutions", m_cpu,
                   (float(loss), _grads(st.model)), cpu_step, ref)
    except AssertionError as e:
        log(f"  control refused: {str(e)[:160]}")
    else:
        raise AssertionError("the utility step check passed TF32 convolutions")
    del st
    lap("the TF32 control")

    # the frozen utility model: the stepped one with its running
    # statistics set to those of 16 other slices by one train-mode forward
    # at momentum 1 (its eval-mode BN would blow the noisy inputs up into
    # logits of order 1e5 otherwise)
    util = steps["card"][0].model
    bns = [mod for mod in util.modules() if isinstance(mod, UNetBatchNorm)]
    momenta = [mod.momentum for mod in bns]
    with torch.no_grad(), ieee_f32():
        for mod in bns:
            mod.momentum = 1.0
        util.train()(tu._prep_images(torch.as_tensor(
            imgs[UN_CMP_BS:UN_CMP_BS + 16, :, :, None], device=cuda), True))
    for mod, momentum in zip(bns, momenta):
        mod.momentum = momentum
    util_sd = {k: v.cpu() for k, v in util.state_dict().items()}
    lap("settling")
    eps = torch.from_numpy(np.random.RandomState(SEED + 41).randn(
        UN_CMP_BS, UN_HW, UN_HW, 1).astype(np.float32))
    noise = {}
    for tag, dev in (("card", cuda), ("cpu", cpu)):
        st = tu.init_noise_state(cfg, util_sd, seed=SEED + 1, device=dev)
        noise_sd = {k: v.cpu().clone() for k, v in st.model.state_dict().items()}
        before = {k: v.clone() for k, v in st.utility.state_dict().items()}
        lap(f"{tag} noise init")
        m = on(dev, lambda: {k: float(v) for k, v in tu.make_noise_train_step(cfg, raw=True)(
            st, raw.to(dev), y.to(dev), eps=eps.to(dev)).items()})
        lap(f"{tag} noise step")
        if any(not torch.equal(v, before[k]) for k, v in st.utility.state_dict().items()):
            raise AssertionError(f"the noise step changed the utility model on {dev}")
        noise[tag] = (st, m)
    (card, m_card), (host, m_host) = noise["card"], noise["cpu"]
    log(f"  noise step: mean B {m_card['mean_B']:.7f} card, {m_host['mean_B']:.7f} CPU; "
        "the utility model unchanged")
    if abs(m_card["mean_B"] - m_host["mean_B"]) > UN_LOSS_RTOL * m_host["mean_B"]:
        raise AssertionError("the card's mean B disagrees with the CPU's")
    ref = _f64_noise_step(cfg, noise_sd, util_sd, raw, y, eps)
    lap("its f64 step")
    cpu_step = (m_host["train_loss"], _grads(host.model))
    card_step, _, cpu_err = _hold_step("noise step", m_cpu,
                                       (m_card["train_loss"], _grads(card.model)),
                                       cpu_step, ref)
    _hold_controls("noise step", card_step, cpu_step, ref, cpu_err)
    _same_stats(card.model, host.model, "noise step")
    lap("their checks")
    log(f"  card vs CPU checks {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{what} {secs:.1f}" for what, secs in laps)
        + f"; the CPU port's forwards and steps {cpu_s[0]:.1f} s of it")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def unoise_probes():
    """Record every noise train step's metrics and the importance maps
    ``unoise-visualize`` computes, around the port's own functions."""
    import adlm_tpu_torch.interpret.unoise_vis as vis
    import adlm_tpu_torch.train.unoise_pipeline as up

    rec = {"noise_steps": [], "importance": []}
    saved = (up.make_noise_train_step, vis.unoise_importance)

    def make_noise_train_step(*args, **kwargs):
        step = saved[0](*args, **kwargs)

        def recorded(*a, **kw):
            m = step(*a, **kw)
            rec["noise_steps"].append({k: float(v) for k, v in m.items()})
            return m
        return recorded

    def unoise_importance(*args, **kwargs):
        out = saved[1](*args, **kwargs)
        rec["importance"].append(out)
        return out

    up.make_noise_train_step, vis.unoise_importance = make_noise_train_step, unoise_importance
    try:
        yield rec
    finally:
        up.make_noise_train_step, vis.unoise_importance = saved


def check_unoise_prefetch(imgs, masks) -> None:
    """``device_prefetch`` of an epoch's raw (images, masks) batches, two
    leaves of one shape and dtype, arrives on the card equal to the host
    batches."""
    import torch
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.data.unoise_data import batches, split_datasets

    host = list(batches(split_datasets(imgs, masks, raw=True)[0], UN_BS, shuffle=True,
                        seed=0, n_jobs=4))
    got = list(device_prefetch(iter(host), device="cuda"))
    bad = [i for i, (g, h) in enumerate(zip(got, host))
           if not all(torch.equal(a.cpu(), torch.from_numpy(b)) for a, b in zip(g, h))]
    log(f"  device_prefetch: {len(got)} batches of (images, masks) {host[0][0].shape} f32, "
        f"{len(bad)} differ from the host's")
    if bad or len(got) != len(host):
        raise AssertionError(f"device_prefetch changed batches {bad[:5]}")


def run_unoise_command(argv) -> float:
    """One CLI command in process; its log is printed only on a failure."""
    import torch
    from adlm_tpu_torch import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(argv))
    except BaseException:
        log("\n".join(out.getvalue().splitlines()[-40:]))
        raise
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {argv[0]}: {secs:.2f} s")
    return secs


def check_unoise_cli(root: str, card: str) -> None:
    """unoise-train-util, unoise-train-noise --pretrained --bf16, unoise-visualize
    and unoise-figures through ``adlm_tpu_torch.cli.main``, and their
    files."""
    import csv
    import json
    import os
    import pickle

    import numpy as np
    import torch
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.core.device import deterministic_cudnn
    from adlm_tpu_torch.data.unoise_data import split_datasets
    from adlm_tpu_torch.interpret.unoise_vis import unoise_importance
    from adlm_tpu_torch.interpret.visualize import jet_colormap

    data, results = os.path.join(root, "data"), os.path.join(root, "runs")
    arrays = ["--imgs", os.path.join(data, "images.npy"), "--masks",
              os.path.join(data, "masks.npy"), "--boxes",
              os.path.join(data, "bounding_boxes.npy")]
    arch = [*arrays, "--depth", str(UN_DEPTH), "--channel-factor", str(UN_CF),
            "--batch-size", str(UN_BS)]
    train = [*arch, "--epochs", str(UN_EPOCHS)]
    pickle_path = os.path.join(results, "results.pickle")
    saved_env = os.environ.get("RESULTS_DIR")
    os.environ["RESULTS_DIR"] = results
    try:
        with unoise_probes() as rec:
            # the training commands set cuDNN's deterministic algorithms
            run_unoise_command(["unoise-train-util", *train, "--run-name", "util"])
            # the noise model in bf16: the CLI's --bf16 path, and half the time
            run_unoise_command(["unoise-train-noise", *train, "--run-name", "noise",
                                "--utility-run", "util", "--pretrained", "util", "--bf16"])
            # the importance map is held to a direct call below, in the same mode
            with deterministic_cudnn():
                run_unoise_command(["unoise-visualize", *arrays, "--utility-run", "util",
                                    "--noise-run", "noise", "--occlusion-stride",
                                    str(UN_OCC_STRIDE)])
                run_unoise_command(["unoise-figures", *arrays, "--utility-run", "util",
                                    "--noise-runs", "noise", "--n-images", "8",
                                    "--save-pickle", pickle_path])
        # every file
        vis = os.path.join(results, "noise", "visualizations")
        need = [os.path.join(results, "util", "utility_config.json"),
                os.path.join(results, "noise", "noise_config.json"), pickle_path,
                os.path.join(vis, "timing.json")]
        need += [os.path.join(results, run, "checkpoints", f"{kind}_{k}", "state.pt")
                 for run, kind in (("util", "utility"), ("noise", "noise"))
                 for k in ("last", "best")]
        need += [os.path.join(vis, f) for f in (
            "unoise_importance.png", "grad_cam.png", "occlusion_sensitivity.png")]
        need += [os.path.join(vis, f"threshold_{t:.1f}.png") for t in np.linspace(0, 1, 11)]
        missing = [p for p in need if not os.path.isfile(p)]
        if missing:
            raise AssertionError(f"missing files: {missing}")
        # the same seeds give the same runs: each command once more, for
        # one epoch (the CLI's deterministic algorithms), and its
        # validation row equal
        run_unoise_command(["unoise-train-util", *arch, "--epochs", "1", "--run-name",
                            "util_again"])
        run_unoise_command(["unoise-train-noise", *arch, "--epochs", "1", "--run-name",
                            "noise_again", "--utility-run", "util", "--pretrained", "util",
                            "--bf16"])

        def val_rows(run, name):
            with open(os.path.join(results, run, "logs", f"{name}_metrics.csv")) as f:
                return [(r["step"], r["val_loss"], r["val_dice"]) for r in csv.DictReader(f)]

        for run, name in (("util", "unoise_util"), ("noise", "unoise_noise")):
            rows = val_rows(run, name)
            if len(rows) != UN_EPOCHS or not all(np.isfinite(float(r[1])) for r in rows):
                raise AssertionError(f"{run}: validation rows {rows}")
            again = val_rows(f"{run}_again", name)
            if again != rows[:1]:
                raise AssertionError(f"{run}: a second run from the same seeds validated "
                                     f"{again}, the first {rows[:1]}")
            log(f"  {run} validation: " + "; ".join(
                f"epoch {r[0]} loss {float(r[1]):.4f} dice {float(r[2]):.4f}" for r in rows)
                + "; epoch 0 of a second run bit-equal")
        steps = rec["noise_steps"]
        n_steps = UN_EPOCHS * -(-int(UN_SLICES * 0.8) // UN_BS)
        mean_b = [m["mean_B"] for m in steps]
        if len(steps) != n_steps or not all(np.isfinite(m["train_loss"]) for m in steps):
            raise AssertionError(f"{len(steps)} noise steps (want {n_steps}) or a "
                                 "non-finite loss")
        if not all(0.0 < b < 1.0 for b in mean_b):
            raise AssertionError(f"mean B outside (0, 1): {min(mean_b)}, {max(mean_b)}")
        log(f"  noise steps: {len(steps)}, loss {steps[0]['train_loss']:.4f} -> "
            f"{steps[-1]['train_loss']:.4f}, mean B {mean_b[0]:.4f} -> {mean_b[-1]:.4f}")
        with open(pickle_path, "rb") as f:
            res = pickle.load(f)["noise"]
        at_half = res["dice_at_half_coverage"]
        if not 0.0 <= at_half <= 1.0 or len(res["dice"]) != 21:
            raise AssertionError(f"figures: dice@50% {at_half}, {len(res['dice'])} points")
        log(f"  figures: dice@50% {at_half:.4f}, dice at full coverage "
            f"{res['dice'][-1]:.4f}, {res['num_params']:,} noise parameters")
        # visualize's importance map: a direct call, and the PNG it wrote
        _, _, test_ds = split_datasets(
            np.load(os.path.join(data, "images.npy")), np.load(os.path.join(data, "masks.npy")),
            np.load(os.path.join(data, "bounding_boxes.npy"), allow_pickle=True))
        image, _ = test_ds[0]
        model = cli._unoise_model(os.path.join(results, "noise"), "noise",
                                  torch.device("cuda"), False)
        with deterministic_cudnn():
            direct = unoise_importance(model, torch.as_tensor(image[None], device="cuda"))
        if not np.array_equal(rec["importance"][0], direct):
            raise AssertionError("unoise-visualize's importance map differs from a direct "
                                 "unoise_importance call")
        heat = 1.0 - direct[0, :, :, 0]
        hn = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-12)
        rgb = np.clip(0.5 * np.clip(image * 0.225 + 0.45, 0, 1) + 0.5 * jet_colormap(hn), 0, 1)
        if not np.array_equal(read_png(os.path.join(vis, "unoise_importance.png")),
                              (rgb * 255).astype(np.uint8)):
            raise AssertionError("unoise_importance.png is not the direct call's map")
        log(f"  importance map: equal to a direct unoise_importance call, mean B "
            f"{float(direct.mean()):.4f}; its PNG decodes to the same pixels")
        with open(os.path.join(vis, "timing.json")) as f:
            timing = json.load(f)
        log(f"  seconds per interpretation (batch 1, {UN_HW}^2, f32 IEEE; occlusion patch 10, "
            f"stride {UN_OCC_STRIDE}, {((UN_HW - 10) // UN_OCC_STRIDE + 1) ** 2} anchors): "
            + ", ".join(f"{k} {v:.4f}" for k, v in timing.items()) + f"  [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env


def _unoise_groups(rows):
    """Device ms of a U-Noise step's kernel groups: convolutions (cuDNN's
    GEMM, implicit-GEMM and FFT kernels), batch norm, and the rest
    (elementwise, reductions, Adam, copies)."""
    def group(*keys):
        return sum(r[0] for r in rows if any(k in r[2].lower() for k in keys))

    conv = group("conv", "xmma", "gemm", "cutlass", "nvjet", "dgrad", "wgrad", "implicit",
                 "fft", "mult_and_sum_complex", "winograd")
    bn = group("batch_norm", "batchnorm", "bn_", "welford")
    return conv, bn, sum(r[0] for r in rows) - conv - bn


def unet_counts(hw: int):
    """(forward FLOPs, BN output elements) of the shipped U-Net on one
    hw x hw slice, counted with forward hooks on a meta-device model (2
    FLOPs per multiply-add of every conv)."""
    import torch
    from torch import nn
    from adlm_tpu_torch.models.unet import UNet, UNetBatchNorm

    with torch.device("meta"):
        model = UNet(depth=UN_DEPTH, cf=UN_CF)
    counts = [0, 0]

    def hook(m, _, out):
        if isinstance(m, nn.Conv2d):
            counts[0] += (2 * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                          * out.numel())
        else:
            counts[1] += out.numel()

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, UNetBatchNorm)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.empty(1, 3, hw, hw, device="meta"))
    return counts[0], counts[1]


def time_unoise(imgs, masks, card: str) -> None:
    """ms per utility and noise step at batch 8 x 256^2 in f32 and bf16,
    the utility step also under cuDNN's deterministic algorithms (the
    training commands' setting), one profiled utility step per dtype,
    the loader's slices/s and a loader-fed bf16 epoch against a
    preloaded one."""
    import dataclasses

    import torch
    from adlm_tpu_torch.core.config import UNoiseConfig
    from adlm_tpu_torch.core.device import deterministic_cudnn
    from adlm_tpu_torch.data.pipeline import BatchLoader, device_prefetch
    from adlm_tpu_torch.data.unoise_data import batches, split_datasets
    from adlm_tpu_torch.train import unoise as tu

    train_ds = split_datasets(imgs, masks, raw=True)[0]
    cfg32 = UNoiseConfig(depth=UN_DEPTH, channel_factor=UN_CF, util_depth=UN_DEPTH,
                         util_channel_factor=UN_CF)
    x = torch.as_tensor(imgs[:UN_BS, :, :, None].copy(), device="cuda")
    y = torch.as_tensor(masks[:UN_BS, :, :, None].copy(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def host_ms(fn, n=UN_TIME_STEPS, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    flops, bn_elems = unet_counts(UN_HW)
    step_flops = 3 * flops * UN_BS   # forward, input and weight gradients
    log(f"  U-Net forward {flops / 1e9:.2f} GFLOP and {bn_elems / 1e6:.2f} M BN outputs "
        f"per {UN_HW}^2 slice; a batch-{UN_BS} step about {step_flops / 1e12:.2f} TFLOP: "
        f"bound {step_flops / PEAK_F32_FLOPS * 1e3:.1f} ms f32, "
        f"{step_flops / PEAK_BF16_FLOPS * 1e3:.1f} ms bf16")
    util_sd, det = None, {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg32, compute_dtype=dt)
        st = tu.init_utility_state(cfg, seed=SEED, device="cuda")
        step = tu.make_utility_train_step(cfg, raw=True)
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: step(st, x, y))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with deterministic_cudnn():
            det[dt] = (host_ms(lambda: step(st, x, y)), ms)
        util_sd = util_sd or st.model.state_dict()
        nst = tu.init_noise_state(cfg, util_sd, seed=SEED + 1, device="cuda")
        nstep = tu.make_noise_train_step(cfg, raw=True)
        torch.cuda.reset_peak_memory_stats()
        nms = host_ms(lambda: nstep(nst, x, y, generator=gen))
        npeak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {dt}: utility step {ms:.2f} ms ({UN_BS * 1e3 / ms:.1f} slices/s, peak "
            f"{peak:.2f} GiB), noise step {nms:.2f} ms (peak {npeak:.2f} GiB), batch "
            f"{UN_BS} x {UN_HW}^2, {UN_TIME_STEPS} steps after 2  [{card}]")
        rows, wall_ms, busy_ms = device_profile(lambda: step(st, x, y), 1)
        if not rows:
            log(f"  profile utility step {dt}: the profiler recorded no device time "
                "(not measured)")
        else:
            conv, bn, rest = _unoise_groups(rows)
            total = conv + bn + rest
            log(f"  profile utility step {dt}: device {total:.2f} ms summed, {busy_ms:.2f} "
                f"ms busy, of {wall_ms:.2f} ms host (busy {busy_ms / wall_ms:.1%}); conv {conv:.2f} ms "
                f"({conv / total:.1%}), batch norm {bn:.2f} ms ({bn / total:.1%}), "
                f"other {rest:.2f} ms ({rest / total:.1%})  [{card}]")
            log_rows(rows, 8)
        del st, nst
        torch.cuda.empty_cache()
    log("  utility step under cuDNN's deterministic algorithms (the training commands' "
        "setting) against its defaults: " + ", ".join(
            f"{dt} {a:.2f} against {b:.2f} ms ({a / b:.3f}x)" for dt, (a, b) in det.items())
        + f"  [{card}]")

    # the loader: 4 threads over one augmented epoch, host only
    t0 = time.perf_counter()
    n = sum(b[0].shape[0] for b in batches(train_ds, UN_BS, shuffle=True, seed=0, n_jobs=4))
    rate = n / (time.perf_counter() - t0)
    # one bf16 utility epoch fed by the loader against the same batches
    # preloaded on the card (a bf16 step eats slices about as fast as the
    # loader makes them; an f32 one, six times slower, read 1.04-1.05x)
    pre = [tuple(torch.as_tensor(a, device="cuda") for a in b)
           for b in batches(train_ds, UN_BS, shuffle=True, seed=1, n_jobs=4)]
    cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    st = tu.init_utility_state(cfg, seed=SEED, device="cuda")
    step = tu.make_utility_train_step(cfg, raw=True)
    step(st, *pre[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader = BatchLoader(batches(train_ds, UN_BS, shuffle=True, seed=1, n_jobs=4))
    try:
        for b in device_prefetch(loader, device="cuda"):
            step(st, *b)
    finally:
        loader.close()
    torch.cuda.synchronize()
    fed = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in pre:
        step(st, *b)
    torch.cuda.synchronize()
    preloaded = time.perf_counter() - t0
    log(f"  loader (batches, n_jobs 4, augmented): {rate:.1f} slices/s; one bf16 utility "
        f"epoch ({len(pre)} batches of {UN_BS}) loader-fed {fed:.3f} s, preloaded "
        f"{preloaded:.3f} s ({fed / preloaded:.2f}x)  [{card}]")
    del st, pre
    torch.cuda.empty_cache()


def check_unoise(card: str) -> None:
    """Phase 11: U-Noise at full width (U-Net depth 5, cf 6, batch 8 x
    256^2): the native bindings, the card against the CPU port, the four
    commands through the CLI, and timings."""
    import os
    import shutil
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adlm_unoise_")
    try:
        imgs, masks, boxes = unoise_slices(UN_SLICES, UN_HW, SEED + 42)
        os.makedirs(os.path.join(root, "data"))
        for name, a in (("images", imgs), ("masks", masks), ("bounding_boxes", boxes)):
            np.save(os.path.join(root, "data", f"{name}.npy"), a)
        n_train, n_val = int(UN_SLICES * 0.8), int(UN_SLICES * 0.9) - int(UN_SLICES * 0.8)
        log(f"  wrote {UN_SLICES} slices {UN_HW}x{UN_HW} (blob masks, boxes): {n_train} "
            f"train, {n_val} val, {UN_SLICES - n_train - n_val} test")
        check_unoise_native()
        check_unoise_card_vs_cpu(imgs, masks)
        check_unoise_prefetch(imgs, masks)
        check_unoise_cli(root, card)
        time_unoise(imgs, masks, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  U-Noise phase {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 12: the ProtoPNet classifier
# ---------------------------------------------------------------------------

# the default preset (ClassificationConfig: VGG19 at 224x224, P = 2000,
# C = 128, K = 200, regular add-ons) on a seeded image folder: 200
# classes of 2 training and 1 test PNG at 256x256 (the resize to 224 is
# the dataset's); the push set is the training set.  Batches as the CLI:
# train 80, test 100, push 75
CLS_CLASSES, CLS_TRAIN_PER, CLS_TEST_PER, CLS_SRC = 200, 2, 1, 256
CLS_BS, CLS_TEST_BS, CLS_PUSH_BS = 80, 100, 75
CLS_HW, CLS_GRID = 224, 7
# kernel against plain head forward, one step per phase: the two runs
# differ only in the rounding of d (within D_ATOL, phase 2), and the
# plain run min-pools at the kernel's cells (min_pool_at), so the
# metrics and each gradient tensor are held to phase 7's limits
CLS_RTOL, CLS_GRAD_REL = TRAIN_RTOL, TRAIN_GRAD_REL
# the f32 joint step against the same step in f64 on the card: each
# trained tensor's gradient within CLS_F64_REL relative L2 error; the
# same step with TF32 convolutions and matmuls must exceed it.  At these
# seeded weights and images the first convs' gradients sum over 80 x
# 224^2 positions with cancellation: their IEEE-f32 error read 1.2e-2
# to 2.0e-2 (features.0, .2, .7, .12; 3.4e-3 with pattern classes
# alone), TF32 8e-2 to 1.1e-1 there (the readings, "NVIDIA H100 80GB
# HBM3, 700.00 W"; PERF.md).  The same step with cuDNN off
# (im2col and SGEMM) is printed beside them
CLS_F64_REL = 5e-2
CLS_BF16_LOSS = 0.05      # bf16 loss against f32 (the JAX package's limit)
# cls-prune: k = 6 (the reference's) over 2 training images per class
# gives a prototype at most 2 of its class among its 6 nearest images,
# so the reference's threshold of 3 prunes every prototype (and the
# command refuses); 2 keeps those whose class's other image is near:
# about the pattern classes' half (write_image_folder)
CLS_PRUNE = ("--k", "6", "--threshold", "2", "--last-layer-iterations", "1")
CLS_TIME_STEPS = 3
# joint step FLOPs of the stem per image, for the bound: 19.51 G
# multiply-adds of VGG19's convolutions at 224x224 (counted from
# _VGG_SPECS), forward plus two backward products, an FMA counted two
VGG19_MACS = 19.51e9


def write_image_folder(root: str, seed: int) -> None:
    """``root/{train,test}/class_XXX/*.png`` at 256x256: an even class a
    seeded coarse colour pattern, each image it plus a little noise of
    its own, so that the class's images resemble each other; an odd
    class grey noise alone, so that its images resemble nothing.  Push
    then finds a prototype's class among its nearest images for the
    even classes only, and pruning has both kinds to tell apart."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from adlm_tpu_torch.interpret.visualize import write_png

    rng = np.random.RandomState(seed)
    jobs = []
    for c in range(CLS_CLASSES):
        if c % 2:
            base, amp = np.full((CLS_SRC, CLS_SRC, 3), 128), 96
        else:
            base, amp = np.kron(rng.randint(0, 256, (8, 8, 3)), np.ones((32, 32, 1))), 24
        for split, n in (("train", CLS_TRAIN_PER), ("test", CLS_TEST_PER)):
            d = os.path.join(root, split, f"class_{c:03d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                img = np.clip(base + rng.randint(-amp, amp + 1, base.shape), 0, 255)
                jobs.append((os.path.join(d, f"{i}.png"), img.astype(np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: write_png(*job), jobs))


def cls_setup(root: str):
    """(config, seeded full-width model on the card, the datasets)."""
    import os

    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.train.classification import ClassificationConfig, build_classifier

    cfg = ClassificationConfig()
    model = build_classifier(cfg, "cuda", seed=SEED + 60)
    sets = {s: ImageFolderDataset(os.path.join(root, s), CLS_HW) for s in ("train", "test")}
    return cfg, model, sets


def cls_step(model, cfg, phase, images, labels):
    """One ``phase`` step from ``model``'s weights (a copy): (metrics as
    floats, {name: gradient} of the trained tensors, the stepped
    copy)."""
    import torch
    from adlm_tpu_torch.train.classification import init_classifier_state, make_cls_train_step

    m = copy.deepcopy(model)
    state = init_classifier_state(m, cfg, phase)
    step = make_cls_train_step(m, cfg, phase)
    state, metrics = step(state, images, labels)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads, m


def cls_head_ties(model, cfg, images):
    """The head kernel's (its distances-only route, as ``global_head``
    runs it) and its plain version's distances at the step's features
    (one comparison launch): (the largest |min_d difference| as
    a share of phase 2's d tolerance, the (image, prototype) pairs whose
    nearest cell differs, of them the ones not on a near-tie of the
    plain d under phase 8's rule)."""
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops.prototype import prototype_head_cuda, prototype_head_reference

    act, eps = cfg.model.prototype_activation, cfg.model.epsilon
    with torch.no_grad(), ieee_f32():
        m = copy.deepcopy(model).eval()
        f = m.conv_features(torch.as_tensor(images, device="cuda").permute(0, 3, 1, 2))
        rows = f.permute(0, 2, 3, 1)
        _, dk = prototype_head_cuda(rows, m.prototypes(), m.last_layer_pk(), act, eps, True,
                                    return_logits=False)
        _, dp = prototype_head_reference(rows, m.prototypes(), m.last_layer_pk(), act, eps)
        dk, dp = dk.flatten(1, 2), dp.flatten(1, 2)                   # (B, h*w, P)
        mk, mp = dk.amin(1), dp.amin(1)
        ck, cp = dk.argmin(1), dp.argmin(1)
        differ = ck != cp
        at_k = dp.gather(1, ck[:, None, :])[:, 0]
        unexplained = differ & ((at_k - mp).abs() > D_ATOL + D_RTOL * mp)
    share = ((mk - mp).abs() / (D_ATOL + D_RTOL * mp)).max().item()
    return share, int(differ.sum()), int(unexplained.sum())


@contextlib.contextmanager
def recorded_head_distances():
    """Keep a copy of the distances (B, h, w, P) of every head kernel
    launch inside the block, with whether the launch returned logits, in
    a list of (d, logits returned) that the block receives; the launches
    themselves are unchanged."""
    import adlm_tpu_torch.ops.prototype as pm

    seen, saved = [], pm.prototype_head_cuda

    def head(*args, **kwargs):
        logits, d = saved(*args, **kwargs)
        seen.append((d.detach().clone(), logits is not None))
        return logits, d

    pm.prototype_head_cuda = head
    try:
        yield seen
    finally:
        pm.prototype_head_cuda = saved


def min_pool_weights(d):
    """(B, h*w, P) weights with which ``amin`` over (h, w) of ``d`` (B,
    h, w, P) hands on its gradient: 1 on the nearest cell, split evenly
    among cells that tie it exactly."""
    d = d.flatten(1, 2)
    at_min = (d == d.amin(1, keepdim=True)).to(d.dtype)
    return at_min / at_min.sum(1, keepdim=True)


@contextlib.contextmanager
def min_pool_at(pool):
    """``PPNet.global_head`` with its min-pool over (h, w) taken with the
    weights ``pool`` (``min_pool_weights`` of the kernel step's d) in
    place of ``amin``: where the plain d's rounding would move a pair's
    nearest cell on a near-tie, the plain-forward step still routes the
    pair's gradient to the kernel's cell, so that the two steps differ
    in the rounding of d alone."""
    import torch
    from adlm_tpu_torch.models import ppnet as pp

    def global_head(self, conv_features):
        _, d = pp.prototype_head(conv_features.permute(0, 2, 3, 1), self.prototypes(),
                                 self.last_layer_pk().detach(), self.cfg.prototype_activation,
                                 self.cfg.epsilon, True, return_logits=False)
        min_d = (d.flatten(1, 2) * pool).sum(1)
        act = pp.distance_to_similarity(min_d, self.cfg.prototype_activation,
                                        self.cfg.epsilon)
        return act @ self.last_layer_pk().to(torch.float32), min_d

    saved = pp.PPNet.global_head
    pp.PPNet.global_head = global_head
    try:
        yield
    finally:
        pp.PPNet.global_head = saved


def check_cls_steps(report, model, cfg, images, labels):
    """(a) one warm, joint and last step with the head kernel and from
    the same start with its plain forward, min-pooled at the kernel
    step's cells (``min_pool_at``: the noise classes' images put many
    pairs on near-ties, where the plain d's rounding would otherwise
    send a pair's gradient to another cell); returns the kernel joint
    step's (metrics, gradients, min-pool weights)."""
    import torch
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.prototype import head_route

    for dt in (torch.float32, torch.bfloat16):
        route = head_route(cfg.model.prototype_channels, cfg.model.num_prototypes,
                           cfg.model.num_classes, dt)
        if route != "general":
            raise AssertionError(f"the classifier's head takes the {route} kernel ({dt})")
    d_err, moved, unexplained = cls_head_ties(model, cfg, images)
    pairs = images.shape[0] * cfg.model.num_prototypes
    log(f"  head at the step's features ({images.shape[0] * CLS_GRID ** 2} rows): min_d "
        f"within {d_err:.3f} of its tolerance {D_ATOL:g} + {D_RTOL:g}·d; nearest cell differs "
        f"in {moved} of {pairs} (image, prototype) pairs, {unexplained} of them off a "
        f"near-tie")
    if unexplained or d_err > 1.0:
        raise AssertionError("the head kernel's distances disagree with the plain version's")
    joint = None
    for phase in ("warm", "joint", "last"):
        _build.reset_launches()
        with recorded_head_distances() as seen:
            mk, gk, _ = cls_step(model, cfg, phase, images, labels)
        launches = dict(_build.LAUNCHES)
        if launches != {"prototype_head": 1, "upsample_argmin": 0}:
            raise AssertionError(f"{phase} step launched {launches}: expected one head "
                                 "launch and no upsample-argmin launch")
        report["prototype_head"]["launches"] += 1
        d_seen, with_logits = seen[0]
        if with_logits:
            raise AssertionError(f"{phase} step's head launch computed logits: expected "
                                 "the distances-only route")
        pool = min_pool_weights(d_seen)
        del seen, d_seen
        with plain_head_forward(), min_pool_at(pool):
            mp, gp, _ = cls_step(model, cfg, phase, images, labels)
        if any(_build.LAUNCHES[k] != launches[k] for k in launches):
            raise AssertionError("the plain-forward step launched a kernel")
        errs = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30)
                for k in ("loss", "cross_entropy", "cluster", "separation", "l1")}
        rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)).item() for n in gp}
        worst = max(rel, key=rel.get)
        log(f"  {phase:5s} step (batch {CLS_BS}, f32 IEEE, general path's distances-only route, 1 launch): "
            f"loss {mk['loss']:.6f} (plain {mp['loss']:.6f}), n_correct {mk['n_correct']:.0f} "
            f"({mp['n_correct']:.0f}); metrics rel err max {max(errs.values()):.2e} "
            f"(tolerance {CLS_RTOL:g}); {len(rel)} gradient tensors, worst relative L2 "
            f"{rel[worst]:.2e} ({worst}, tolerance {CLS_GRAD_REL:g})")
        if (max(errs.values()) > CLS_RTOL or mk["n_correct"] != mp["n_correct"]
                or rel[worst] > CLS_GRAD_REL
                or not all(math.isfinite(v) for v in mk.values())):
            raise AssertionError(f"the {phase} step with the head kernel disagrees with "
                                 "the plain-forward step")
        if phase == "joint":
            joint = (mk, gk, pool)
    return joint


def _f64_joint_grads(model, cfg, images, labels, pool):
    """(loss, {name: gradient}, pairs whose f64 nearest cell is off a
    near-tie of the kernel's) of the joint step's function in f64 on
    the card: the model in f64, the head's distances, min-pool and last
    layer written out in f64 (the kernel and the plain head run f32),
    cuDNN off (PyTorch's own f64 convolutions).  The min-pool takes the
    f32 kernel step's cells (``pool``, ``min_pool_weights``), so that a
    near-tie does not send a pair's gradient to another cell: the
    comparison then sees arithmetic alone."""
    import torch
    from adlm_tpu_torch.ops.prototype import distance_to_similarity
    from adlm_tpu_torch.train.classification import classification_loss, freeze_for_phase

    m = copy.deepcopy(model).double().train()
    freeze_for_phase(m, cfg, "joint")
    x = torch.as_tensor(images, device="cuda").double().permute(0, 3, 1, 2)
    y = torch.as_tensor(labels, device="cuda").long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=False):
        f = m.conv_features(x).permute(0, 2, 3, 1).flatten(1, 2)      # (B, h*w, C)
        p = m.prototypes()
        d = ((f * f).sum(-1, keepdim=True) - 2.0 * f @ p.t() + (p * p).sum(-1)).clamp_min(0.0)
        min_d = (d * pool.double()).sum(1)                             # (B, P)
        with torch.no_grad():
            d_min = d.amin(1)
            off = int((min_d - d_min > D_ATOL + D_RTOL * d_min).sum())
        logits = distance_to_similarity(min_d, cfg.model.prototype_activation,
                                        cfg.model.epsilon) @ m.last_layer_pk()
        pc = torch.arange(cfg.model.num_prototypes, device="cuda") // (
            cfg.model.num_prototypes // cfg.model.num_classes)
        loss, _ = classification_loss(logits, min_d, y, pc, m.last_layer_pk(), cfg)
        loss.backward()
    torch.cuda.synchronize()
    log(f"  f64 joint step on the card {time.perf_counter() - t0:.1f} s")
    grads = {n: q.grad.detach() for n, q in m.named_parameters() if q.grad is not None}
    return float(loss.detach()), grads, off


@contextlib.contextmanager
def _cls_tf32():
    """The port's steps with TF32 convolutions and matmuls, in place of
    IEEE f32: the control the f64 limit must refuse."""
    import torch
    from adlm_tpu_torch.train import classification as tc

    saved = (tc.ieee_f32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    tc.ieee_f32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (tc.ieee_f32, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def check_cls_f64(model, cfg, images, labels, joint) -> None:
    """(b) the f32 joint step's gradients against the f64 step's (at the
    kernel's nearest cells), tensor by tensor, and the TF32 control
    refused."""
    import torch

    m32, g32, pool = joint
    loss64, g64, off = _f64_joint_grads(model, cfg, images, labels, pool)
    with _cls_tf32():
        mt, gt, _ = cls_step(model, cfg, "joint", images, labels)
    with torch.backends.cudnn.flags(enabled=False):
        _, gn, _ = cls_step(model, cfg, "joint", images, labels)

    def errs(grads):
        return {n: ((grads[n].double() - g64[n]).norm() / g64[n].norm()).item() for n in g64}

    e32, etf, enc = errs(g32), errs(gt), errs(gn)
    w32, wtf = max(e32, key=e32.get), max(etf, key=etf.get)
    refused = sum(v > CLS_F64_REL for v in etf.values())
    log(f"  joint step vs f64: loss {m32['loss']:.7f} f32, {mt['loss']:.7f} TF32, "
        f"{loss64:.7f} f64; {len(e32)} gradient tensors, relative L2 to f64: f32 IEEE "
        f"{min(e32.values()):.2e}-{e32[w32]:.2e} (worst {w32}), TF32 "
        f"{min(etf.values()):.2e}-{etf[wtf]:.2e} (worst {wtf}, {refused} of {len(etf)} "
        f"tensors over the limit); limit {CLS_F64_REL:g}; f64 nearest cells off a "
        f"near-tie of the kernel's: {off}")
    for n in sorted(g64, key=e32.get, reverse=True)[:6]:
        log(f"    {n:40s} f32 {e32[n]:.2e}  TF32 {etf[n]:.2e}  f32 cuDNN off {enc[n]:.2e}")
    log(f"  f32 with cuDNN off (im2col + SGEMM): {min(enc.values()):.2e}-"
        f"{max(enc.values()):.2e} relative L2 to f64")
    if e32[w32] > CLS_F64_REL or abs(m32["loss"] - loss64) > 1e-5 * abs(loss64) or off:
        raise AssertionError("the f32 joint step is off the f64 step")
    if etf[wtf] <= CLS_F64_REL:
        raise AssertionError("the TF32 control passes the f64 limit: it cannot tell "
                             "IEEE f32 apart")


def check_cls_bf16(model, cfg, images, labels, joint) -> None:
    """(c) one bf16 joint step: finite, near the f32 loss, every stored
    tensor f32."""
    import dataclasses

    import torch
    from adlm_tpu_torch.ops import _build

    _build.reset_launches()
    mb, _, stepped = cls_step(model, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                              "joint", images, labels)
    f32_loss = joint[0]["loss"]
    dtypes = {v.dtype for v in stepped.state_dict().values() if v.is_floating_point()}
    log(f"  bf16 joint step: loss {mb['loss']:.6f} (f32 {f32_loss:.6f}, limit "
        f"{CLS_BF16_LOSS:g} of max(1, |loss|)), head launches {_build.LAUNCHES['prototype_head']}, "
        f"stored dtypes {sorted(str(d) for d in dtypes)}")
    if (not math.isfinite(mb["loss"])
            or abs(mb["loss"] - f32_loss) > CLS_BF16_LOSS * max(1.0, abs(f32_loss))
            or dtypes != {torch.float32} or _build.LAUNCHES["prototype_head"] != 1):
        raise AssertionError("the bf16 joint step is off")


def check_cls_push(model, cfg, train_ds):
    """(d) push over the training set (batch 75), each winner held to
    an f64 recomputation of its candidates' distances under phase 8's
    near-tie rule; returns the push's images/s."""
    import numpy as np
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.train.classification import (
        init_classifier_state,
        push_classification_prototypes,
    )

    state = init_classifier_state(model, cfg, None)
    batches = list(train_ds.batches(CLS_PUSH_BS, with_count=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    protos, info = push_classification_prototypes(state, batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # every image's features again (eval mode, the same f32 forward)
    feats = []
    with torch.inference_mode(), ieee_f32():
        model.eval()
        for images, _, n in batches:
            x = torch.as_tensor(images, device="cuda").permute(0, 3, 1, 2)
            feats.append(model.conv_features(x).permute(0, 2, 3, 1)[:n].double())
    feats = torch.cat(feats)                                         # (N, h, w, C)
    labels = torch.as_tensor(np.asarray([lb for _, lb in train_ds.samples]), device="cuda")
    p64 = model.prototypes().detach().double()
    pc = state.proto_class
    boxes = info["rf_boxes"]
    bad, tied, worst = [], 0, 0.0
    for c in range(cfg.model.num_classes):
        own = torch.nonzero(pc == c)[:, 0]
        imgs = torch.nonzero(labels == c)[:, 0]
        f = feats[imgs].reshape(-1, feats.shape[-1])                  # candidates
        d = ((f * f).sum(-1, keepdim=True) - 2.0 * f @ p64[own].t()
             + (p64[own] ** 2).sum(-1)).clamp_min(0.0)               # (cand, n_own)
        dmin = d.min(dim=0).values
        for col, j in enumerate(own.tolist()):
            img, r, w = int(boxes[j, 0]), int(boxes[j, 1]), int(boxes[j, 3])
            cand = (imgs == img).nonzero()[0, 0].item() * CLS_GRID * CLS_GRID + r * CLS_GRID + w
            dw, dm = d[cand, col].item(), dmin[col].item()
            tol = _tie_tol(dm)
            worst = max(worst, abs(info["min_distances"][j] - dw) / tol)
            if dw - dm > tol or abs(info["min_distances"][j] - dw) > tol:
                bad.append((j, dw, dm, float(info["min_distances"][j])))
            elif dw > dm:
                tied += 1
            if not torch.equal(protos[j].double(), feats[img, r, w]):
                bad.append((j, "prototype is not the winner's feature row"))
    log(f"  push over {len(train_ds)} images (batch {CLS_PUSH_BS}): {secs:.2f} s, "
        f"{len(train_ds) / secs:.1f} img/s; winners against f64 distances of every "
        f"own-class candidate: {cfg.model.num_prototypes - len(bad)} at the f64 minimum "
        f"({tied} of them on a near-tie), worst |d_push - d64| {worst:.2f} of the tie "
        f"tolerance, failures {bad[:4]}")
    if bad:
        raise AssertionError("push winners disagree with the f64 distances")
    return len(train_ds) / secs


def cls_command(argv) -> float:
    """One CLI command in process with its launch counts; its log is
    printed only on a failure."""
    from adlm_tpu_torch.ops import _build

    _build.reset_launches()
    secs = run_unoise_command(argv)
    log(f"    launches {dict(_build.LAUNCHES)}")
    if _build.LAUNCHES["upsample_argmin"]:
        raise AssertionError(f"{argv[0]} launched the upsample-argmin kernel")
    return secs


def check_cls_cli(report, root: str) -> None:
    """(e) cls-train, cls-prune and import-protopnet through
    ``adlm_tpu_torch.cli.main``; the imported model's test accuracy
    equals the trained one's."""
    import csv
    import os

    import numpy as np
    import torch
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.train.classification import (
        build_classifier,
        init_classifier_state,
        make_cls_eval_step,
    )
    from adlm_tpu_torch.train.classification_pipeline import evaluate, load_cls_config

    dirs = ["--train-dir", os.path.join(root, "train"), "--test-dir", os.path.join(root, "test")]
    results = os.path.join(root, "runs")
    run = os.path.join(results, "cls")
    saved_env = os.environ.get("RESULTS_DIR")
    os.environ["RESULTS_DIR"] = results
    try:
        cls_command(["cls-train", "cls", "--epochs", "3", "--warm-epochs", "1",
                     "--push-start", "2", "--push-every", "2",
                     "--last-layer-iterations", "2", *dirs])
        report["prototype_head"]["launches"] += _build.LAUNCHES["prototype_head"]
        store = CheckpointStore(run)
        with open(os.path.join(run, "logs", "classification_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        log_text = open(os.path.join(run, "logs", "classification.log")).read()
        phases = [r["phase"] for r in rows]
        log(f"  cls-train rows: " + ", ".join(f"{r['phase']} {float(r['accuracy']):.4f}"
                                             for r in rows))
        need = [os.path.join(run, "cls_config.json")]
        need += [os.path.join(run, "checkpoints", c, "state.pt")
                 for c in ("nopush_last", "nopush_best")]
        if "push: saved" in log_text:
            need.append(os.path.join(run, "checkpoints", "push_best", "state.pt"))
        missing = [p for p in need if not os.path.exists(p)]
        if (missing or phases != ["warm", "joint", "joint", "push_last_0", "push_last_1"]
                or "epoch 2: prototype push" not in log_text):
            raise AssertionError(f"cls-train: missing {missing}, rows {phases}")
        cfg = load_cls_config(run)
        stage = ("push", "best") if store.exists("push", "best") else ("nopush", "last")

        cls_command(["cls-prune", run, *CLS_PRUNE, *dirs])
        report["prototype_head"]["launches"] += _build.LAUNCHES["prototype_head"]
        info = np.load(os.path.join(run, "cls_prune_info.npy"))
        pruned = store.restore("pruned", "last")
        n_kept = pruned["proto_class"].shape[0]
        log(f"  cls-prune: {info.shape[0]} pruned, {n_kept} kept")
        if (n_kept + info.shape[0] != cfg.model.num_prototypes or n_kept == 0
                or info.shape[0] == 0):
            raise AssertionError("cls-prune: the pruned checkpoint is inconsistent, or "
                                 "pruning kept or dropped every prototype")

        trained = store.restore(*stage)
        ref = os.path.join(root, "reference.pth")
        torch.save(trained["state_dict"], ref)
        cls_command(["import-protopnet", "imported", ref])
        imported = CheckpointStore(os.path.join(results, "imported")).restore("push", "best")
        test = ImageFolderDataset(os.path.join(root, "test"), CLS_HW)
        batches = list(test.batches(CLS_TEST_BS, with_count=True))
        accs, rates = [], []
        for payload in (trained, imported):
            model = build_classifier(cfg, "cuda", state_dict=payload["state_dict"])
            state = init_classifier_state(model, cfg, None, proto_class=payload["proto_class"])
            eval_fn = make_cls_eval_step(model, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accs.append(evaluate(eval_fn, state, batches))
            rates.append(len(test) / (time.perf_counter() - t0))
            del model, state
        log(f"  import-protopnet of {stage[0]}_{stage[1]}: test accuracy {accs[1]!r} "
            f"(trained {accs[0]!r}); eval {rates[0]:.1f} img/s at batch {CLS_TEST_BS}")
        if accs[0] != accs[1]:
            raise AssertionError("the imported model's accuracy differs")
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env


def time_cls(model, cfg, images, labels, test_ds, card: str) -> None:
    """Seconds per warm, joint and last step at batch 80 in f32 and
    bf16 (the joint step also under cuDNN's deterministic algorithms,
    the training commands' setting), eval images/s, both routes of the head's general path at the
    classifier's rows (beside the plain version, the bound and one
    cuBLAS product), its plain backward, and a profile of one f32 and
    one bf16 joint step."""
    import dataclasses

    import torch
    from adlm_tpu_torch.core.device import deterministic_cudnn, ieee_f32
    from adlm_tpu_torch.ops.prototype import (
        _lib,
        l2_distances,
        prototype_head_backward,
        prototype_head_cuda,
        prototype_head_reference,
    )
    from adlm_tpu_torch.train.classification import (
        init_classifier_state,
        make_cls_eval_step,
        make_cls_train_step,
    )
    from adlm_tpu_torch.train.classification_pipeline import evaluate

    cfgs = {"float32": cfg, "bfloat16": dataclasses.replace(cfg, compute_dtype="bfloat16")}
    joint_s = {}
    for dt, c in cfgs.items():
        for phase in ("warm", "joint", "last", "joint det"):
            m = copy.deepcopy(model)
            state = init_classifier_state(m, c, phase.split()[0])
            step = make_cls_train_step(m, c, phase.split()[0])
            with deterministic_cudnn() if phase == "joint det" else contextlib.nullcontext():
                step(state, images, labels)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(CLS_TIME_STEPS):
                    step(state, images, labels)
                torch.cuda.synchronize()
            s = (time.perf_counter() - t0) / CLS_TIME_STEPS
            log(f"  {phase:9s} step {dt:8s} batch {CLS_BS}: {s:.4f} s/step, "
                f"{CLS_BS / s:.1f} img/s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
            if phase == "joint det":
                log(f"    joint {dt} under cuDNN's deterministic algorithms against its "
                    f"defaults: {s / joint_s[dt]:.3f}x  [{card}]")
            if phase == "joint":
                joint_s[dt] = s
                if dt == "float32":
                    # the stem's FLOPs alone (3 products of 19.51 G MACs per image)
                    flops = 3 * 2 * VGG19_MACS * CLS_BS
                    log(f"    joint f32: stem {flops / 1e12:.2f} TFLOP, bound at 67 TFLOP/s "
                        f"{flops / PEAK_F32_FLOPS * 1e3:.1f} ms, "
                        f"{flops / s / 1e12:.1f} TFLOP/s achieved")
            del m, state, step
            torch.cuda.empty_cache()
    m = copy.deepcopy(model)
    state = init_classifier_state(m, cfg, None)
    eval_fn = make_cls_eval_step(m, cfg)
    batches = list(test_ds.batches(CLS_TEST_BS, with_count=True))
    evaluate(eval_fn, state, batches[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(eval_fn, state, batches)
    torch.cuda.synchronize()
    log(f"  eval (preloaded batches of {CLS_TEST_BS}, f32): "
        f"{len(test_ds) / (time.perf_counter() - t0):.1f} img/s  [{card}]")
    del m, state, eval_fn

    C, P, K = cfg.model.prototype_channels, cfg.model.num_prototypes, cfg.model.num_classes
    g = torch.Generator(device="cuda").manual_seed(SEED + 61)
    protos = torch.rand(P, C, device="cuda", generator=g)
    w = torch.randn(P, K, device="cuda", generator=g)
    for N in (CLS_BS * CLS_GRID ** 2, CLS_TEST_BS * CLS_GRID ** 2):
        x = torch.rand(N, C, device="cuda", generator=g)
        g_dist = torch.randn(N, P, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            xd, pd = x.to(dtype), protos.to(dtype)
            xf = xd.float()
            # the general path's two routes: (what runs, its plain version,
            # f32 lane-instructions per pair, bytes besides x)
            routes = {
                "distances only": (
                    lambda: prototype_head_cuda(xd, pd, w, "log", 1e-4, True, False),
                    lambda: l2_distances(xd, pd), C + HEAD_DIST_OPS, 4 * (P * C + N * P)),
                "logits and d": (
                    lambda: prototype_head_cuda(xd, pd, w, "log", 1e-4, True),
                    lambda: prototype_head_reference(xd, pd, w, "log"),
                    C + K + HEAD_EPILOGUE_OPS["log"], 4 * (P * C + P * K + N * K + N * P)),
            }
            # the logits route's partials (groups x N x K floats; none for one group)
            scratch_mb = _lib().adlm_prototype_head_scratch(
                N, C, P, K, int(dtype == torch.bfloat16)) / 1e6
            with torch.inference_mode(), ieee_f32():
                # one cuBLAS call for the distance product alone, as a yardstick
                product = cuda_ms(lambda: torch.matmul(xf, protos.t()), 50)
                for route, (kernel, plain_fn, per_pair, other_bytes) in routes.items():
                    ms = cuda_ms(kernel, 50)
                    plain = cuda_ms(plain_fn, 20)
                    b_ms, b_by = bound(N * P * per_pair, N * C * xd.element_size() + other_bytes,
                                       PEAK_F32_OPS)
                    log(f"  head general path, {route:14s} N={N} C={C} P={P} K={K} "
                        f"{str(dtype)[6:]:8s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                        f"{b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x bound; cuBLAS product "
                        f"alone, not the function: {product:.4f} ms  [{card}]")
                bwd = cuda_ms(lambda: prototype_head_backward(xd, pd, w, None, g_dist,
                                                              "log", 1e-4), 20)
            log(f"  head plain backward (g_dist only) N={N} {str(dtype)[6:]:8s}: "
                f"{bwd:.4f} ms; the logits route's partials {scratch_mb:.2f} MB "
                f"({max(1, round(scratch_mb * 1e6 / (4 * N * K)))} groups)  [{card}]")
            del xf
        del x, g_dist

    for dt, c in cfgs.items():
        m = copy.deepcopy(model)
        state = init_classifier_state(m, c, "joint")
        step = make_cls_train_step(m, c, "joint")
        step(state, images, labels)
        torch.cuda.synchronize()
        rows, wall_ms, busy_ms = device_profile(lambda: step(state, images, labels), 1)
        if not rows:
            log(f"  profile joint step {dt}: the profiler recorded no device time "
                "(not measured)")
        else:
            total = sum(r[0] for r in rows)
            head = sum(r[0] for r in rows if any(k in r[2] for k in HEAD_KERNELS))
            fft = sum(r[0] for r in rows if "fft" in r[2].lower() or "complex" in r[2].lower())
            log(f"  profile joint step {dt} batch {CLS_BS}: "
                f"{profile_line(rows, wall_ms, busy_ms).replace('/batch', '/step')}, FFT convolution "
                f"pieces {fft:.2f} ms; head forward kernels {head:.3f} ms = "
                f"{head / total:.2%} of device time, of a {joint_s[dt] * 1e3:.1f} ms step  "
                f"[{card}]")
            log_rows(rows, 10)
        del m, state, step
        torch.cuda.empty_cache()


def check_classifier(report, card: str) -> None:
    """Phase 12: the ProtoPNet classifier at the default preset's full
    width on a seeded image folder."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adlm_cls_")
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the same stem in compared runs
    try:
        write_image_folder(root, SEED + 62)
        log(f"  wrote {CLS_CLASSES} classes x ({CLS_TRAIN_PER} train + {CLS_TEST_PER} test) "
            f"PNGs at {CLS_SRC}x{CLS_SRC} in {time.perf_counter() - t_phase:.1f} s")
        cfg, model, sets = cls_setup(root)
        t0 = time.perf_counter()
        images, labels = next(sets["train"].batches(CLS_BS, shuffle=True, seed=0))
        log(f"  loaded a batch of {CLS_BS} in {time.perf_counter() - t0:.2f} s "
            f"({len(np.unique(labels))} classes)")
        joint = check_cls_steps(report, model, cfg, images, labels)
        check_cls_f64(model, cfg, images, labels, joint)
        check_cls_bf16(model, cfg, images, labels, joint)
        del joint
        torch.cuda.empty_cache()
        check_cls_push(model, cfg, sets["train"])
        check_cls_cli(report, root)
        time_cls(model, cfg, images, labels, sets["test"], card)
    finally:
        torch.backends.cudnn.deterministic = saved_det
        shutil.rmtree(root, ignore_errors=True)
    log(f"  classifier phase {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 13: windowed eval, checkpoint import/export and the analyses
# ---------------------------------------------------------------------------

# the flagship in 513² windows at overlap 0.25: 15 windows per
# 1024x2048 frame (a 3 x 5 grid), fused in chunks of 8 and 7, so 2 head
# launches per batch of 2; a full chunk is 8 x 2 x 65 x 65 head rows
WIN = (513, 513)
WIN_OVERLAP = 0.25
WIN_BS = 2
WIN_CHUNK = 8
# the stats grid of a window by DeepLab's output-stride arithmetic: 65
# x 65 for 513 x 513
WIN_GRID = tuple((s - 1) // 8 + 1 for s in WIN)
WIN_HEAD_ROWS = WIN_CHUNK * WIN_BS * WIN_GRID[0] * WIN_GRID[1]
WIN_SEAM = 32             # the interior reading leaves out this band round every seam
WIN_SMALL = (384, 1024)   # crops lower than a window: 3 windows, each padded
WIN_TRAIN_FRAMES, WIN_VAL_FRAMES = 4, 2
WIN_TIME_ITERS = 3


@contextlib.contextmanager
def recorded_updates(module, name: str):
    """Patch ``module.<name>``, an evaluator class, with a subclass that
    keeps its instances and each update's output."""
    orig = getattr(module, name)
    seen = {"instances": [], "outs": []}

    class Recording(orig):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["instances"].append(self)

        def update(self, *args, **kwargs):
            out = super().update(*args, **kwargs)
            seen["outs"].append(out)
            return out

    setattr(module, name, Recording)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def run_windowed(model, batches, pc, mean_std, **kw):
    """A statistics ``WindowedSegEvaluator`` over ``batches``: (results and
    per-batch outputs in ``compare_eval``'s form, the evaluator, the
    predictions)."""
    import torch
    from adlm_tpu_torch.interpret.windowed import WindowedSegEvaluator

    ev = WindowedSegEvaluator(model, 19, WIN, overlap=WIN_OVERLAP, with_stats=True,
                              n_random_pixels=N_RANDOM, seed=SEED, normalize=mean_std, **kw)
    outs, preds = [], []
    for img, lab in batches:
        with purity_inputs() as seen:
            o = ev.update(pc, img, lab)
        out = {k: o[k].cpu() for k in ("intersection", "union", "correct", "total",
                                       "agree_counts", "topk_purity")}
        out["sample_d"] = torch.cat([d for d, _ in seen])
        out["sample_pred"] = torch.cat([p for _, p in seen])
        if o["stat_windows"] != 15 or tuple(o["stat_pred"].shape[1:]) != WIN_GRID:
            raise AssertionError(f"windowed stats: {o['stat_windows']} windows, grid "
                                 f"{tuple(o['stat_pred'].shape[1:])}; expected 15 of {WIN_GRID}")
        outs.append(out)
        preds.append(o["pred"])
    return (ev.results(), outs), ev, preds


def same_counters(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.intersection, b.intersection)
            and np.array_equal(a.union, b.union)
            and (a.correct, a.total) == (b.correct, b.total))


def seam_interior(offsets):
    """(H, W) bool: pixels farther than WIN_SEAM from every window edge
    that lies inside the frame."""
    import numpy as np

    rows, cols = np.ones(H, bool), np.ones(W, bool)
    for (sh, sw) in offsets:
        for e in (sh, sh + WIN[0]):
            if 0 < e < H:
                rows[max(0, e - WIN_SEAM):e + WIN_SEAM] = False
        for e in (sw, sw + WIN[1]):
            if 0 < e < W:
                cols[max(0, e - WIN_SEAM):e + WIN_SEAM] = False
    return rows[:, None] & cols[None, :]


def same_window_stats(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                                    for k in ("agree_counts", "topk_purity"))


def check_host_canvas(m32, pc, mean_std, batches, got, per, ev_w):
    """The per-window driver's host canvas with statistics against its
    device canvas: on the frames, on crops lower than the window (the
    auto rule's host canvas), and a deferred queue of the fused driver's
    frames and the crops' host canvas, drained at once."""
    import numpy as np
    from adlm_tpu_torch.interpret.windowed import WindowedSegEvaluator

    host, ev_h, _ = run_windowed(m32, batches, pc, mean_std, fused=False,
                                 device_stitch=False)
    ok_frames = same_counters(ev_h, ev_w) and same_window_stats(host[1], per[1])
    small = [(img[:, :WIN_SMALL[0], :WIN_SMALL[1]], lab[:, :WIN_SMALL[0], :WIN_SMALL[1]])
             for img, lab in batches]

    def evaluator(**kw):
        return WindowedSegEvaluator(m32, 19, WIN, overlap=WIN_OVERLAP, with_stats=True,
                                    n_random_pixels=N_RANDOM, seed=SEED,
                                    normalize=mean_std, **kw)

    def small_run(**kw):
        ev = evaluator(**kw)
        outs = [ev.update(pc, img, lab) for img, lab in small]
        if {o["stat_windows"] for o in outs} != {3}:
            raise AssertionError(f"crops {WIN_SMALL}: {[o['stat_windows'] for o in outs]} windows")
        return ev, [{k: o[k].cpu() for k in ("agree_counts", "topk_purity")} for o in outs]

    ev_sh, sh = small_run()                    # the auto rule: a host canvas
    ev_sd, sd = small_run(device_stitch=True)
    ok_small = same_counters(ev_sh, ev_sd) and same_window_stats(sh, sd)

    queue = evaluator(defer_sync=True)
    for img, lab in batches + small:
        queue.update(pc, img, lab)
    drained = queue.drain()
    ok_queue = (len(drained) == len(batches) + len(small)
                and np.array_equal(queue.intersection,
                                   ev_w.intersection + ev_sh.intersection)
                and np.array_equal(queue.union, ev_w.union + ev_sh.union)
                and (queue.correct, queue.total) == (ev_w.correct + ev_sh.correct,
                                                     ev_w.total + ev_sh.total)
                and all(np.array_equal(d[1], o["agree_counts"].numpy())
                        for d, o in zip(drained, got[1] + sd)))
    log(f"  host canvas with statistics vs device canvas: frames "
        f"{'identical' if ok_frames else 'DIFFER'}, {len(small)} batch of {WIN_SMALL[0]}x"
        f"{WIN_SMALL[1]} crops (3 padded windows each) {'identical' if ok_small else 'DIFFER'}; "
        f"a deferred queue of fused frames and host-canvas crops drained at once: "
        f"{'identical' if ok_queue else 'DIFFER'} (counters and agree_counts)")
    if not (ok_frames and ok_small and ok_queue):
        raise AssertionError("the host canvas disagrees with the device canvas")


def check_windowed_eval(m32, pc, mean_std, batches, launches_by_cmd):
    """(a): the kernel path against the plain head, the fused driver
    against the per-window driver, a frame-sized window against
    whole-frame eval.  Returns the kernel run's evaluator."""
    import numpy as np
    import torch
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.interpret.windowed import (
        WindowedSegEvaluator,
        _grid_extent,
        window_offsets,
    )
    from adlm_tpu_torch.ops import _build

    n_pixels = WIN_BS * H * W
    budget = math.ceil(TIE_SHARE * n_pixels)
    offsets = window_offsets(H, W, WIN, WIN_OVERLAP)
    if len(offsets) != 15 or _grid_extent(WIN, *WIN, *WIN_GRID) != WIN_GRID:
        raise AssertionError(f"window grid: {offsets}")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got, ev_k, preds = run_windowed(m32, batches, pc, mean_std)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    launches_by_cmd.append(("WindowedSegEvaluator (fused)", launches))
    log(f"  fused windowed eval (stats, f32 IEEE): {len(batches)} batch of {WIN_BS} in "
        f"{secs:.2f} s, launches {launches} (2 per batch expected: chunks of 8 and 7; "
        f"1 for the memory probe); the probe measured "
        f"{ev_k._act_bytes_per_pixel:.1f} bytes per window pixel")
    if launches["prototype_head"] != 2 * len(batches) + 1 or launches["upsample_argmin"]:
        raise AssertionError("the fused windowed eval did not launch the head once per chunk")

    with plain_versions():
        want, _, _ = run_windowed(m32, batches, pc, mean_std)
    compare_eval("windowed f32", got, want, n_pixels)

    _build.reset_launches()
    per, ev_w, preds_w = run_windowed(m32, batches, pc, mean_std, fused=False,
                                      device_stitch=True)
    n_per = _build.LAUNCHES["prototype_head"]
    agree_eq = all(torch.equal(a["agree_counts"], b["agree_counts"])
                   for a, b in zip(got[1], per[1]))
    pred_eq = all(torch.equal(a, b) for a, b in zip(preds, preds_w))
    log(f"  fused vs per-window driver (device canvas, {n_per} head launches): counters "
        f"{'identical' if same_counters(ev_k, ev_w) else 'DIFFER'}, agree_counts "
        f"{'identical' if agree_eq else 'DIFFER'}, pred maps "
        f"{'identical' if pred_eq else 'DIFFER'}; topk_purity max_abs "
        f"{max((a['topk_purity'] - b['topk_purity']).abs().max().item() for a, b in zip(got[1], per[1])):.2e}")
    if not same_counters(ev_k, ev_w) or n_per != 15 * len(batches):
        raise AssertionError("the fused and per-window drivers give different counters")

    # the same two drivers under cuDNN's default settings, which the CLI keeps
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        _, ev_fd, _ = run_windowed(m32, batches, pc, mean_std)
        _, ev_wd, _ = run_windowed(m32, batches, pc, mean_std, fused=False,
                                   device_stitch=True)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    log(f"  fused vs per-window driver under cuDNN's default settings: counters "
        f"{'identical' if same_counters(ev_fd, ev_wd) else 'DIFFER'}; fused counters "
        f"{'identical' if same_counters(ev_fd, ev_k) else 'DIFFER'} to the deterministic run's")
    if not same_counters(ev_fd, ev_wd):
        raise AssertionError("under cuDNN's default settings the drivers give different counters")
    check_host_canvas(m32, pc, mean_std, batches, got, per, ev_w)

    # one window the size of the frame against whole-frame eval
    frame = WindowedSegEvaluator(m32, 19, (H, W), normalize=mean_std)
    whole = SegEvaluator(m32, 19, normalize=mean_std)
    whole_preds = [whole.update(pc, img, lab)["pred"] for img, lab in batches]
    for img, lab in batches:
        frame.update(pc, img, lab)
    diffs = {"intersection": int(np.abs(frame.intersection - whole.intersection).sum()),
             "union": int(np.abs(frame.union - whole.union).sum()),
             "correct": abs(frame.correct - whole.correct),
             "total": abs(frame.total - whole.total)}
    limits = {"intersection": budget, "union": 2 * budget, "correct": budget, "total": 0}
    log(f"  frame-sized window vs whole-frame make_inference_fn: |diff| {diffs} (budget "
        f"{budget} px, x2 for union); mIoU {frame.results()['mean_iou']:.6f} vs "
        f"{whole.results()['mean_iou']:.6f}")
    if any(diffs[k] > v for k, v in limits.items()):
        raise AssertionError("a frame-sized window disagrees with whole-frame eval")

    inside = torch.from_numpy(seam_interior(offsets)).cuda()
    agree = [((pw == pf) & inside).sum().item() / (inside.sum().item() * pw.shape[0])
             for pw, pf in zip(preds, whole_preds)]
    log(f"  reading: windowed vs whole-frame argmax agreement in the window interiors "
        f"({inside.float().mean().item():.1%} of the frame, seams +-{WIN_SEAM} px left out) "
        f"{min(agree):.4f}; random weights, so no floor")
    return ev_k, got


def check_windowed_cli(m32, pc, cfg, data, results, ev_k, got, launches_by_cmd):
    """(b) eval-valid --windowed --stats and eval-test --windowed through
    the CLI on a run holding the same weights, and (c) import-protoseg /
    export-torch round trips.  Returns the source run directory."""
    import json
    import os

    import numpy as np
    import torch
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret import windowed as win_mod

    rec = {"first_window": None}
    src = os.path.join(results, "src")
    sd = {k: v.detach().cpu() for k, v in m32.state_dict().items()}
    store = CheckpointStore(src)
    store.save_config(cfg.to_json())
    store.save("push", "last", {"state_dict": sd, "proto_class": pc.cpu(), "step": 0})
    eval_args = ["push", "--data-path", data, "--windowed", f"{WIN[0]},{WIN[1]}", "--stats",
                 "--batch-size", str(WIN_BS), "--examples", "0"]

    def windowed_eval_valid(run):
        with recorded_updates(win_mod, "WindowedSegEvaluator") as seen:
            run_command(["eval-valid", run] + eval_args, rec, launches_by_cmd)
        (ev,), outs = seen["instances"], seen["outs"]
        return ev, outs, json.loads(rec["stdout"])

    ev_c, outs_c, res_c = windowed_eval_valid(src)
    agree_eq = all(torch.equal(o["agree_counts"].cpu(), g["agree_counts"])
                   for o, g in zip(outs_c, got[1]))
    log(f"  eval-valid --windowed {WIN[0]},{WIN[1]} --stats: counters "
        f"{'equal' if same_counters(ev_c, ev_k) else 'DIFFER'} to the direct run's, "
        f"agree_counts {'equal' if agree_eq else 'DIFFER'}; mIoU {res_c['mean_iou']:.6f}, "
        f"stats_mode {res_c.get('stats_mode')}")
    if not same_counters(ev_c, ev_k) or not agree_eq or res_c.get("stats_mode") != "grid":
        raise AssertionError("eval-valid --windowed differs from the direct windowed run")

    run_command(["eval-test", src, "push", "--data-path", data, "--windowed",
                 f"{WIN[0]},{WIN[1]}"], rec, launches_by_cmd)
    ds = SegmentationDataset(cfg.data, "val", data_path=data, is_eval=True)
    lut = get_class_table(cfg.data.class_table).submission_lut(19)
    direct = win_mod.WindowedSegEvaluator(m32, 19, WIN, normalize=(cfg.data.mean, cfg.data.std))
    pred_dir = os.path.join(src, "evaluation", "push", "test_predictions")
    for i, (img, lab) in enumerate(ds.eval_items(raw=True)):
        want = lut[direct.update(pc, img, lab)["pred"][0].cpu().numpy()]
        got_png = read_png(os.path.join(pred_dir, ds.img_ids[i] + ".png"))
        if got_png.shape != (H, W) or not np.array_equal(got_png, want):
            raise AssertionError(f"eval-test --windowed PNG {i} differs from submission_lut[pred]")
    log(f"  eval-test --windowed: {len(ds)} PNGs decode to submission_lut of a direct "
        f"batch-1 windowed run")

    # (c) the reference's layouts: a state_dict with torch BN's
    # num_batches_tracked, and the whole module pickled with its
    # prototype_class_identity, as the reference saves its stages
    root = os.path.dirname(results)
    ref_sd = dict(sd)
    for k in sd:
        if k.endswith("bn.running_mean"):
            ref_sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    torch.save(ref_sd, os.path.join(root, "ref_sd.pth"))
    module = copy.deepcopy(m32).cpu()
    module.prototype_class_identity = torch.nn.functional.one_hot(pc.cpu(), 19).float()
    torch.save(module, os.path.join(root, "ref_module.pth"))
    del module
    name = cfg.name

    def imported(run):
        payload = CheckpointStore(os.path.join(results, run)).restore("push", "best")
        if not torch.equal(payload["proto_class"], pc.cpu()):
            raise AssertionError(f"{run}: proto_class differs")
        return payload["state_dict"]

    def bit_equal(a, b) -> list:
        return [k for k in sorted(set(a) | set(b))
                if k not in a or k not in b or a[k].dtype != b[k].dtype
                or not torch.equal(a[k], b[k])]

    for run, f in (("imp_sd", "ref_sd.pth"), ("imp_mod", "ref_module.pth")):
        run_command(["import-protoseg", name, run, os.path.join(root, f)], rec, launches_by_cmd)
        bad = bit_equal(imported(run), sd)
        log(f"  import-protoseg {f}: {len(sd) - len(bad)} of {len(sd)} tensors bit-equal "
            f"to the source weights")
        if bad:
            raise AssertionError(f"import-protoseg {f} changed {bad[:8]}")
    ev_i, _, _ = windowed_eval_valid(os.path.join(results, "imp_mod"))
    log(f"  eval-valid --windowed on the imported run: counters "
        f"{'equal' if same_counters(ev_i, ev_c) else 'DIFFER'} to the source run's")
    if not same_counters(ev_i, ev_c):
        raise AssertionError("the imported run evaluates differently from its source")
    out = os.path.join(root, "export.pth")
    run_command(["export-torch", os.path.join(results, "imp_mod"), "push", "--out", out],
                rec, launches_by_cmd)
    exported = torch.load(out, map_location="cpu", weights_only=True)
    bad = bit_equal(exported, sd)
    pc_file = np.load(os.path.splitext(out)[0] + "_proto_class.npy")
    run_command(["import-protoseg", name, "imp_again", out], rec, launches_by_cmd)
    again = bit_equal(imported("imp_again"), imported("imp_mod"))
    log(f"  export-torch: {len(exported)} tensors, {len(bad)} not bit-equal to the source "
        f"(ones regenerated), class ids {'equal' if pc_file.tolist() == pc.tolist() else 'DIFFER'}; "
        f"re-import of the export: {len(again)} tensors differ")
    if bad or again or pc_file.tolist() != pc.tolist():
        raise AssertionError("the export/import round trip is not bit-equal")
    return src


def check_analysis_cli(m32, pc, cfg, data, src, launches_by_cmd):
    """(d) analyze-local (kernel path against the plain head, near-ties
    counted) and analyze-global (against find_k_nearest_patches)."""
    import itertools
    import json
    import os

    import numpy as np
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret.analysis import local_analysis
    from adlm_tpu_torch.interpret.evaluate import _images_nchw
    from adlm_tpu_torch.interpret.nearest import find_k_nearest_patches

    rec = {"first_window": None}
    run_command(["analyze-local", src, "push", "--data-path", data, "--top-k", "10",
                 "--per-class-top", "1"], rec, launches_by_cmd)
    res = json.loads(rec["stdout"])
    ds = SegmentationDataset(cfg.data, "val", data_path=data, is_eval=True)
    img = ds.get_eval_item(0)[0][None]
    out_dir = os.path.join(src, "local_analysis", ds.img_ids[0])
    files = sorted(os.listdir(out_dir))
    n_png = sum(f.endswith(".png") for f in files)
    sections = [f for f in files if f.endswith("_class_prototypes")]
    if n_png != 20 or not sections or len(res["top_prototypes"]) != 10:
        raise AssertionError(f"analyze-local wrote {files}")
    with plain_versions():
        plain = local_analysis(m32, pc, img, top_k=10)
    # each prototype's minimum distance over the frame, both heads: the
    # ranking is by activation, a decreasing function of it
    dmin = []
    for ctx in (contextlib.nullcontext(), plain_versions()):
        with ctx, torch.inference_mode(), ieee_f32():
            _, d = m32(_images_nchw(m32, torch.from_numpy(img).cuda()))
            dmin.append(d.amin(dim=(0, 1, 2)).double().cpu().numpy())
    dk, dp = dmin
    tol = D_ATOL + D_RTOL * np.abs(dp)
    d_ok = bool((np.abs(dk - dp) <= tol).all())
    top_k, top_p = res["top_prototypes"], plain["top_prototypes"].tolist()
    moved = [(r, a, b) for r, (a, b) in enumerate(zip(top_k, top_p)) if a != b]
    unexplained = [(r, a, b) for r, a, b in moved if abs(dp[a] - dp[b]) > tol[a] + tol[b]]
    log(f"  analyze-local --top-k 10 --per-class-top 1: {n_png} PNGs and {len(sections)} "
        f"class sections written; top prototypes {top_k}, plain head {top_p}; min-d "
        f"max_abs {np.abs(dk - dp).max():.2e} (d tolerance {'ok' if d_ok else 'EXCEEDED'}), "
        f"{len(moved)} ranks on a near-tie {moved}, unexplained {unexplained}; own class "
        f"strongest: {res['own_class_is_strongest']}")
    if not d_ok or unexplained:
        raise AssertionError("analyze-local with the head kernel disagrees with the plain head")

    run_command(["analyze-global", src, "push", "--data-path", data, "--split", "train",
                 "--k", "5", "--max-images", str(WIN_TRAIN_FRAMES), "--batch-size", "2"],
                rec, launches_by_cmd)
    ids = np.load(os.path.join(src, "global_analysis", "full_class_id.npy"))
    train = SegmentationDataset(cfg.data, "train", data_path=data, is_eval=True,
                                push_prototypes=True)
    want = find_k_nearest_patches(m32, pc, itertools.islice(train.eval_items(), WIN_TRAIN_FRAMES),
                                  19, k=5, batch_size=2)
    log(f"  analyze-global --k 5 over {WIN_TRAIN_FRAMES} frames: class ids {ids.shape} "
        f"{'equal' if np.array_equal(ids, want) else 'DIFFER'} to find_k_nearest_patches; "
        f"{int((ids == pc.cpu().numpy()[:, None]).sum())} of {ids.size} of the prototype's class")
    if ids.shape != (190, 5) or not np.array_equal(ids, want):
        raise AssertionError("analyze-global differs from find_k_nearest_patches")


def time_windowed(m32, pc, mean_std, batches, card: str) -> None:
    """(e) windowed and whole-frame eval img/s at batch 2, f32 and bf16;
    a fused window batch's peak memory against the auto rule's probe;
    the head at the fused chunk's rows."""
    import torch
    from adlm_tpu_torch.core.device import cast_params, ieee_f32
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.interpret.windowed import WindowedSegEvaluator
    from adlm_tpu_torch.ops.prototype import prototype_head_cuda, prototype_head_reference

    img, lab = batches[0]
    img, lab = torch.from_numpy(img).cuda(), torch.from_numpy(lab).cuda()
    models = {"float32": m32,
              "bfloat16": cast_params(copy.deepcopy(m32), torch.bfloat16)}
    for dt, model in models.items():
        wev = WindowedSegEvaluator(model, 19, WIN, overlap=WIN_OVERLAP, normalize=mean_std)
        whole = make_inference_fn(model, 19, normalize=mean_std)
        rates = {}
        for mode, fn in (("windowed", lambda: wev.update(pc, img, lab)),
                         ("whole-frame", lambda: whole(pc, img, lab))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WIN_TIME_ITERS):
                fn()
            torch.cuda.synchronize()
            rates[mode] = (time.perf_counter() - t0) / WIN_TIME_ITERS
        log(f"  eval batch {WIN_BS} {dt:8s}: windowed {WIN[0]}x{WIN[1]} "
            f"{WIN_BS / rates['windowed']:.3f} img/s ({rates['windowed'] * 1e3:.1f} ms/batch), "
            f"whole-frame {WIN_BS / rates['whole-frame']:.3f} img/s "
            f"({rates['whole-frame'] * 1e3:.1f} ms/batch), ratio "
            f"{rates['windowed'] / rates['whole-frame']:.2f}  [{card}]")
        if dt == "float32":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            wev.update(pc, img, lab)
            torch.cuda.synchronize()
            canvas = 4 * WIN_BS * H * W * (19 + 4)   # frames, canvas and norm
            act = (torch.cuda.max_memory_allocated() - base - canvas) / (WIN_CHUNK * WIN_BS * WIN[0] * WIN[1])
            log(f"  fused window batch ({WIN_CHUNK} x {WIN_BS} windows, f32): peak "
                f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB over the "
                f"model, of it the frames, canvas and norm {canvas / 2**30:.2f} GiB; the rest "
                f"{act:.0f} bytes per window pixel (the auto rule's probe measured "
                f"{wev._act_bytes_per_pixel:.1f})  [{card}]")
    del models
    torch.cuda.empty_cache()

    C, P, K = 64, 190, 19
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.rand(WIN_HEAD_ROWS, C, device="cuda", generator=g)
    protos = torch.rand(P, C, device="cuda", generator=g)
    wt = torch.randn(P, K, device="cuda", generator=g)
    with torch.inference_mode(), ieee_f32():
        for emit in (True, False):
            ms = cuda_ms(lambda: prototype_head_cuda(x, protos, wt, "log", 1e-4, emit), 50)
            plain = cuda_ms(lambda: prototype_head_reference(x, protos, wt, "log"), 20)
            ops = WIN_HEAD_ROWS * P * (C + K + HEAD_EPILOGUE_OPS["log"])
            nbytes = 4 * (WIN_HEAD_ROWS * C + P * C + P * K + WIN_HEAD_ROWS * K
                          + (WIN_HEAD_ROWS * P if emit else 0))
            b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
            log(f"  prototype_head at a fused chunk's {WIN_HEAD_ROWS} rows f32 dist={emit!s:5s}: "
                f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})  [{card}]")


def check_windowed(report, card: str) -> None:
    """Phase 13: windowed eval, checkpoint import/export and the analyses
    on the flagship at full width, f32 IEEE under cuDNN deterministic."""
    import os
    import shutil
    import tempfile

    import torch
    from adlm_tpu_torch.core import config as config_mod
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.models.ppnet import default_proto_class

    t_phase = time.perf_counter()
    cfg = config_mod.get_experiment("cityscapes_kld_imnet")
    mean_std = (cfg.data.mean, cfg.data.std)
    root = tempfile.mkdtemp(prefix="adlm_win_")
    saved_env = os.environ.get("RESULTS_DIR")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    launches_by_cmd = []
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        data, results = os.path.join(root, "data"), os.path.join(root, "runs")
        os.environ["RESULTS_DIR"] = results
        t0 = time.perf_counter()
        write_dataset(data, WIN_TRAIN_FRAMES, SEED + 31, n_val=WIN_VAL_FRAMES)
        m32 = random_model(cfg.model, SEED + 13)
        pc = default_proto_class(190, 19, device="cuda")
        ds = SegmentationDataset(cfg.data, "val", data_path=data, is_eval=True)
        batches = [(img, lab) for img, lab, _ in ds.eval_batches(WIN_BS, with_counts=True,
                                                                 raw=True)]
        log(f"  wrote {WIN_TRAIN_FRAMES} train and {WIN_VAL_FRAMES} val frames {H}x{W}, "
            f"built the model in {time.perf_counter() - t0:.1f} s")
        ev_k, got = check_windowed_eval(m32, pc, mean_std, batches, launches_by_cmd)
        src = check_windowed_cli(m32, pc, cfg, data, results, ev_k, got, launches_by_cmd)
        check_analysis_cli(m32, pc, cfg, data, src, launches_by_cmd)
        # the main path's launches: the fused windowed eval and the commands
        for _, counts in launches_by_cmd:
            for name, n in counts.items():
                report[name]["launches"] += n
        log("  launches by command: " + "; ".join(
            f"{tag}: head {c['prototype_head']}, upsample-argmin {c['upsample_argmin']}"
            for tag, c in launches_by_cmd))
        if any(c["upsample_argmin"] for _, c in launches_by_cmd):
            raise AssertionError("the windowed path launched the upsample-argmin kernel")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    time_windowed(m32, pc, mean_std, batches, card)
    log(f"  timings {time.perf_counter() - t0:.1f} s; windowed phase "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")



# ---------------------------------------------------------------------------
# phase 14: deployment
# ---------------------------------------------------------------------------

# the artifacts' batches: the flagship and the classifier at 2, the
# U-Net at unoise-export's default of 8 (cuDNN's IEEE-f32 algorithms
# for it are several times slower per item at 2; PERF.md §7)
DEPLOY_BATCH = {"flagship_f32": 2, "flagship_bf16": 2, "classifier_f32": 2,
                "unoise_utility_f32": 8}
DEPLOY_ITEMS = 4          # items the flagship's and classifier's requests cycle through
DEPLOY_SEQ_S = 1.0        # seconds of sequential requests of 1 item, then of a full batch
# the sustained window: client threads sending single items back to
# back, and its seconds
DEPLOY_CLIENTS, DEPLOY_SUSTAIN_S = 4, 4.0
UN_DEPLOY_HW = 256
# artifact → (outputs held as values, outputs held as choices)
DEPLOY_OUTPUTS = {
    "seg": (("grid_logits",), ("pred", "nearest_proto")),
    "cls": (("logits", "min_distances", "proto_activation"), ("pred",)),
    "unoise": (("mask_prob",), ("mask",)),
}


def serve_child(dirs) -> int:
    """The serving process of phase 14 (started by ``check_deploy`` as
    ``python -c``, importing this file): ``InferenceServer`` on each
    artifact directory, on the card, at the default coalescing window.  It prints one JSON line (ports,
    the ``adlm_tpu_torch`` subpackages it imported, launch counts and
    batches per server), then one more such line for each line it reads
    on stdin, and stops its servers at EOF."""
    from adlm_tpu_torch.deploy.server import InferenceServer
    from adlm_tpu_torch.ops import _build

    servers = [InferenceServer(d, port=0, platform="cuda") for d in dirs]
    try:
        for srv in servers:
            srv.start()

        def state():
            return {"launches": dict(_build.LAUNCHES),
                    "batches": [srv.batcher.n_batches for srv in servers]}

        mods = sorted({m.split(".")[1] for m in sys.modules
                       if m.startswith("adlm_tpu_torch.")})
        print(json.dumps({"ports": [srv.port for srv in servers], "modules": mods,
                          **state()}), flush=True)
        for _ in sys.stdin:
            print(json.dumps(state()), flush=True)
    finally:
        for srv in servers:
            srv.close()
    return 0


def deploy_runs(root: str, m32, cls_model, unet):
    """Run directories as training writes them: the flagship's push_last,
    the classifier's push_best and the U-Net's utility_best."""
    import os

    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.train.classification import ClassificationConfig
    from adlm_tpu_torch.train.classification_pipeline import save_cls_config

    def cpu_sd(m):
        return {k: v.detach().cpu() for k, v in m.state_dict().items()}

    runs = {k: os.path.join(root, k) for k in ("seg", "cls", "unoise")}
    store = CheckpointStore(runs["seg"])
    store.save_config(get_experiment("cityscapes_kld_imnet").to_json())
    store.save("push", "last", {"state_dict": cpu_sd(m32),
                                "proto_class": default_proto_class(190, 19), "step": 0})
    save_cls_config(runs["cls"], ClassificationConfig())
    CheckpointStore(runs["cls"]).save("push", "best", {
        "state_dict": cpu_sd(cls_model), "proto_class": default_proto_class(2000, 200),
        "step": 0})
    store = CheckpointStore(runs["unoise"])
    store.save("utility", "best", {"state_dict": cpu_sd(unet), "step": 0})
    store.save_metadata("utility_config", {"depth": 5, "channel_factor": 6})
    return runs


def deploy_exports(runs, root: str, card: str):
    """``export`` (f32 and bf16), ``cls-export`` and ``unoise-export``
    through the CLI, for the card: {artifact: directory}."""
    import os

    from adlm_tpu_torch import cli

    cmds = {
        "flagship_f32": ["export", runs["seg"], "push", "--size", f"{H},{W}", "--f32-compute"],
        "flagship_bf16": ["export", runs["seg"], "push", "--size", f"{H},{W}"],
        "classifier_f32": ["cls-export", runs["cls"], "push", "--f32-compute"],
        "unoise_utility_f32": ["unoise-export", runs["unoise"], "--model", "utility",
                               "--size", f"{UN_DEPLOY_HW},{UN_DEPLOY_HW}", "--f32-compute"],
    }
    dirs = {}
    for name, argv in cmds.items():
        dirs[name] = os.path.join(root, "artifacts", name)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli.main(argv + ["--batch", str(DEPLOY_BATCH[name]), "--platforms", "cuda",
                             "--out", dirs[name]])
        sec = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(dirs[name], "inference_cuda.pt2")) / 2 ** 20
        log(f"  {argv[0]} {name}: {sec:.1f} s, artifact {mb:.1f} MB ({out.getvalue().strip()})"
            f"  [{card}]")
    return dirs


def eager_in_batches(fn, x, batch: int):
    """``fn`` (→ (values, scores)) over ``x`` in batches of the
    artifact's ``batch``: the same convolution shapes, so cuDNN takes the
    same algorithms as in the served program."""
    import torch

    parts = [fn(x[i:i + batch]) for i in range(0, len(x), batch)]
    return tuple({k: torch.cat([p[j][k] for p in parts]) for k in parts[0][j]}
                 for j in range(2))


def eager_seg(model, frames, mean_std):
    """The artifact's program run eagerly on ``model``: values and the
    scores each choice took its argmax of."""
    import torch
    from adlm_tpu_torch.core.device import ieee_f32, model_dtype
    from adlm_tpu_torch.ops.normalize import normalize
    from adlm_tpu_torch.ops.resize import resize_bilinear

    with torch.inference_mode(), ieee_f32():
        x = normalize(frames, mean_std).to(model_dtype(model))
        gl, d = model(x.permute(0, 3, 1, 2), return_distances=True)
        up = resize_bilinear(gl, (H, W))
    return {"grid_logits": gl.float()}, {"pred": up, "nearest_proto": -d}


def eager_cls(model, images):
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.data.image_folder import IMAGENET_MEAN, IMAGENET_STD
    from adlm_tpu_torch.ops.normalize import normalize
    from adlm_tpu_torch.ops.prototype import distance_to_similarity

    with torch.inference_mode(), ieee_f32():
        x = normalize(images, (IMAGENET_MEAN, IMAGENET_STD))
        logits, min_d = model(x.permute(0, 3, 1, 2))
    cfg = model.cfg
    act = distance_to_similarity(min_d, cfg.prototype_activation, cfg.epsilon)
    return ({"logits": logits, "min_distances": min_d, "proto_activation": act},
            {"pred": logits})


def eager_unoise(unet, slices):
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.train.unoise import _prep_images

    with torch.inference_mode(), ieee_f32():
        logits = unet(_prep_images(slices, True)).permute(0, 2, 3, 1)
    return ({"mask_prob": torch.sigmoid(logits)},
            {"mask": torch.stack([torch.zeros_like(logits[..., 0]), logits[..., 0]], -1)[..., None, :]})


def hold_served(tag, kind, got, values, scores) -> str:
    """Served answers ([(item, {output: array})]) against the eager run
    on the same card, f32 and bf16 alike (the same kernels and cuDNN
    algorithms on both sides).  Values within the head check's d
    tolerance; a choice may differ only where the eager scores of the
    two choices lie within twice the score's own tolerance, and on at
    most phase 4's tie budget."""
    import numpy as np
    import torch

    def limit(t):
        return D_ATOL + D_RTOL * float(t.abs().max())

    value_names, choice_names = DEPLOY_OUTPUTS[kind]
    worst, flips = {}, {}
    for i, out in got:
        for k in value_names:
            want = values[k][i]
            err = float((torch.as_tensor(np.asarray(out[k])).to(want.device) - want).abs().max())
            worst[k] = max(worst.get(k, 0.0), err)
            if err > limit(values[k]):
                raise AssertionError(f"{tag} item {i}: served {k} off by {err:.3e} "
                                     f"(limit {limit(values[k]):.3e})")
        for k in choice_names:
            sc = scores[k][i]
            pick = torch.as_tensor(np.asarray(out[k])).to(sc.device).long()
            want = sc.argmax(-1)
            differ = pick != want
            n = int(differ.sum())
            flips[k] = flips.get(k, 0) + n
            if n:
                margin = (sc.gather(-1, want[..., None]) - sc.gather(-1, pick[..., None]))[..., 0]
                if (float(margin[differ].max()) > 2 * limit(sc)
                        or n > math.ceil(TIE_SHARE * pick.numel())):
                    raise AssertionError(f"{tag} item {i}: {n} {k} differ, margin "
                                         f"{float(margin[differ].max()):.3e}")
    return (", ".join(f"{k} max|diff| {v:.2e}" for k, v in worst.items()) + "; choices off "
            + ", ".join(f"{k} {v}" for k, v in flips.items()))


def post(port: int, arr):
    """One /predict request: (outputs with the request's leading axis,
    seconds)."""
    import http.client

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    sec = time.perf_counter() - t0
    if resp.status != 200:
        raise AssertionError(f"/predict answered {resp.status}: {body[:300]!r}")
    out = dict(np.load(io.BytesIO(body)))
    return out, sec


def drive_server(port: int, items, child, slot: int, batch: int):
    """The requests of one artifact: one untimed single item (the
    server's first call); single items one after another for
    DEPLOY_SEQ_S seconds (each a padded batch), then full batches for as
    long; then DEPLOY_CLIENTS threads sending single items back to back
    for DEPLOY_SUSTAIN_S seconds.  Returns ([(item, served outputs)] of
    every request, timings, and the launches and batches the child
    counted over all of them)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def ask():
        child.stdin.write("\n")
        child.stdin.flush()
        line = child.stdout.readline()
        if not line:
            raise AssertionError("the serving process ended")
        return json.loads(line)

    n = len(items)
    before = ask()
    got = [(0, post(port, items[0])[0])]

    def sequential(k):
        secs = []
        t_end = time.perf_counter() + DEPLOY_SEQ_S
        while time.perf_counter() < t_end:
            idx = [(k * len(secs) + j) % n for j in range(k)]
            if k == 1:
                out, sec = post(port, items[idx[0]])
                got.append((idx[0], out))
            else:
                out, sec = post(port, np.stack([items[i] for i in idx]))
                got.extend((i, {key: v[j] for key, v in out.items()})
                           for j, i in enumerate(idx))
            secs.append(sec)
        return secs

    one, full = sequential(1), sequential(batch)

    def client(c):
        mine = []
        while time.perf_counter() < t_end:
            i = (c + DEPLOY_CLIENTS * len(mine)) % n
            out, sec = post(port, items[i])
            mine.append((i, out, sec))
        return mine

    t0 = time.perf_counter()
    t_end = t0 + DEPLOY_SUSTAIN_S
    with ThreadPoolExecutor(DEPLOY_CLIENTS) as pool:
        runs = [r for mine in pool.map(client, range(DEPLOY_CLIENTS)) for r in mine]
    wall = time.perf_counter() - t0
    got.extend((i, out) for i, out, _ in runs)
    lat = 1e3 * np.array([sec for _, _, sec in runs])
    after = ask()
    counts = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
    batches = after["batches"][slot] - before["batches"][slot]
    times = {"fill1_ms": 1e3 * float(np.mean(one)), "n_fill1": len(one),
             "full_ms": 1e3 * float(np.mean(full)), "n_full": len(full),
             "rps": len(runs) / wall, "n_sustained": len(runs), "wall_s": wall,
             "lat_mean": float(lat.mean()), "lat_p50": float(np.percentile(lat, 50)),
             "lat_p99": float(np.percentile(lat, 99)), "requests": len(got)}
    return got, times, counts, batches


def check_deploy(report, card: str) -> None:
    """Phase 14: precompile twice, export the flagship (f32, bf16), the
    classifier preset and the shipped U-Net through the CLI for the
    card, serve the four artifacts from a fresh process that imports
    only the port's ops and deploy modules, and hold every answer to
    the eager model on this card."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import cast_params
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.train.classification import ClassificationConfig, build_classifier
    from adlm_tpu_torch.train.unoise import build_unet

    t_phase = time.perf_counter()
    stamps = {n: os.stat(_build._target(n)).st_mtime_ns for n in _build.KERNELS}
    for i in range(2):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli.main(["precompile", "cityscapes_kld_imnet"])
        text = out.getvalue()
        log(f"  precompile call {i + 1}: {time.perf_counter() - t0:.2f} s: "
            + " | ".join(text.strip().splitlines()))
        if "built none" not in text or text.count("reused") != len(_build.KERNELS):
            raise AssertionError("precompile rebuilt a kernel library that was built")
    if {n: os.stat(_build._target(n)).st_mtime_ns for n in _build.KERNELS} != stamps:
        raise AssertionError("precompile touched a built library")

    cfg = get_experiment("cityscapes_kld_imnet")
    mean_std = (cfg.data.mean, cfg.data.std)
    m32 = random_model(cfg.model, SEED + 71).to("cuda", memory_format=torch.channels_last).eval()
    m16 = cast_params(copy.deepcopy(m32), "bfloat16")
    cls_model = build_classifier(ClassificationConfig(), "cuda", seed=SEED + 72).eval()
    unet = build_unet(5, 6, torch.device("cuda"), seed=SEED + 73).eval()
    frames = torch.cat([img for img, _ in make_batches(DEPLOY_ITEMS // 2, 2, SEED + 74)])
    rng = np.random.RandomState(SEED + 75)
    cls_images = rng.randint(0, 256, (DEPLOY_ITEMS, CLS_HW, CLS_HW, 3)).astype(np.uint8)
    slices = unoise_slices(DEPLOY_BATCH["unoise_utility_f32"], UN_DEPLOY_HW,
                           SEED + 76)[0][..., None]
    inputs = {"flagship_f32": frames.cpu().numpy(), "flagship_bf16": frames.cpu().numpy(),
              "classifier_f32": cls_images, "unoise_utility_f32": slices}
    eager = {"flagship_f32": ("seg", lambda x: eager_seg(m32, x, mean_std), frames),
             "flagship_bf16": ("seg", lambda x: eager_seg(m16, x, mean_std), frames),
             "classifier_f32": ("cls", lambda x: eager_cls(cls_model, x),
                                torch.from_numpy(cls_images).cuda()),
             "unoise_utility_f32": ("unoise", lambda x: eager_unoise(unet, x),
                                    torch.from_numpy(slices).cuda())}
    refs = {name: (kind, eager_in_batches(fn, x, DEPLOY_BATCH[name]))
            for name, (kind, fn, x) in eager.items()}
    root = tempfile.mkdtemp(prefix="adlm_deploy_")
    child, err = None, tempfile.TemporaryFile(mode="w+")
    try:
        runs = deploy_runs(root, m32, cls_model, unet)
        dirs = deploy_exports(runs, root, card)
        names = list(dirs)
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke as c; "
             "sys.exit(c.serve_child(sys.argv[1:]))", *dirs.values()],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        line = child.stdout.readline()
        if not line:
            raise AssertionError("the serving process ended before it served")
        hello = json.loads(line)
        log(f"  serving process up in {time.perf_counter() - t0:.1f} s with "
            f"{len(names)} artifacts; it imported adlm_tpu_torch.{hello['modules']}")
        if set(hello["modules"]) != {"core", "deploy", "ops"}:
            raise AssertionError("the serving process imported more than the ops and deploy "
                                 "modules")
        for slot, name in enumerate(names):
            kind, (values, scores) = refs[name]
            items = list(inputs[name])
            got, times, counts, batches = drive_server(
                hello["ports"][slot], items, child, slot, DEPLOY_BATCH[name])
            held = hold_served(name, kind, got, values, scores)
            want = batches if kind != "unoise" else 0
            log(f"  served {name}: {times['requests']} requests in {batches} batches, "
                f"head launches {counts['prototype_head']}, upsample-argmin "
                f"{counts['upsample_argmin']}; {held}")
            log(f"    sequential: {times['fill1_ms']:.2f} ms/request at fill 1 "
                f"({times['n_fill1']} requests), {times['full_ms']:.2f} ms at fill "
                f"{DEPLOY_BATCH[name]} ({times['n_full']})  [{card}]")
            log(f"    sustained, {DEPLOY_CLIENTS} clients of single items: "
                f"{times['n_sustained']} requests in {times['wall_s']:.2f} s, "
                f"{times['rps']:.2f} requests/s; latency mean {times['lat_mean']:.2f} ms, "
                f"p50 {times['lat_p50']:.2f}, p99 {times['lat_p99']:.2f}  [{card}]")
            if counts["prototype_head"] != want or counts["upsample_argmin"]:
                raise AssertionError(f"{name}: {counts} launches for {batches} served batches")
            report["prototype_head"]["launches"] += counts["prototype_head"]
        child.stdin.close()
        if child.wait(timeout=120) != 0:
            raise AssertionError(f"the serving process exited {child.returncode}")
    except Exception:
        if child is not None:
            err.seek(0)
            log("  serving process stderr (last 4000 chars):\n" + err.read()[-4000:])
        raise
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        err.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"  deploy phase {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 15: dataset preparation on the card's machine, fed to the flagship
# ---------------------------------------------------------------------------

# a raw Cityscapes tree at the dataset's 2048x1024 (10 of its 5,000
# frames: 3 train and 2 val frames a city, 2 cities a split) and 3
# Task07-like Pancreas volumes of 512x512x8 (of its 281)
PREP_CITIES = {"train": ("aachen", "bremen"), "val": ("frankfurt", "lindau")}
PREP_PER_CITY = {"train": 3, "val": 2}
PREP_VOL_SHAPE = (512, 512, 8)
PREP_VOLUMES = 3
PREP_ANNOTATED = (2, 5)          # each volume's slices with a label; the others are empty
# raw ids whose blocks hold instances (person .. bus), two per class:
# instanceIds class * 1000 + k; every other block its raw id (stuff)
PREP_THING_IDS = (24, 25, 26, 27, 28)
PREP_EVAL_BS = 2
PREP_TIMEOUT = 300               # seconds allowed a preparation command


def encode_png(path: str, data, color: int, depth: int = 8) -> None:
    """The phase's own PNG encoder, of (H, W, bytes per pixel) uint8
    ``data`` (16-bit samples big-endian): row r carries scanline filter
    r % 5, so that the reader undoes every filter."""
    import struct
    import zlib

    import numpy as np

    h, w, bpp = data.shape
    x = data.reshape(h, w * bpp).astype(np.int16)
    left, up, upleft = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up[1:] = x[:-1]
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    ftype = np.arange(h) % 5
    pred = np.zeros_like(x)
    for t, arr in ((1, left), (2, up), (3, (left + up) >> 1), (4, paeth)):
        pred[ftype == t] = arr[ftype == t]
    rows = np.concatenate([ftype[:, None].astype(np.uint8),
                           ((x - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_nifti(path: str, data) -> None:
    """The phase's own NIfTI-1 writer (``tests/test_nifti.py``'s layout):
    a gzipped single file, the 348-byte header, the 4-byte extension
    flag, then ``data`` (int16 or uint8) in Fortran order, unscaled."""
    import gzip
    import struct

    import numpy as np

    code = {np.dtype(np.int16): 4, np.dtype(np.uint8): 2}[data.dtype]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape, *([1] * (7 - data.ndim)))
    struct.pack_into("<hh", hdr, 70, code, data.dtype.itemsize * 8)
    struct.pack_into("<f", hdr, 108, 352.0)
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(gzip.compress(bytes(hdr) + bytes(4) + data.astype("<" + data.dtype.str[1:])
                              .tobytes(order="F"), compresslevel=1))


def write_raw_cityscapes(root: str, seed: int):
    """The raw tree (``gtFine_trainvaltest/gtFine`` and
    ``leftImg8bit_trainvaltest/leftImg8bit``): RGB frames with structure
    at two scales, 8-bit labelIds of raw ids 0..33 in 30-pixel blocks,
    16-bit instanceIds (the first frame has no instance), all through
    ``encode_png``.  Returns {split: {id: (rgb, ids, inst)}}."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    rng = np.random.RandomState(seed)
    frames, jobs = {}, []
    for split, cities in PREP_CITIES.items():
        frames[split] = {}
        for city in cities:
            lab_dir = os.path.join(root, "gtFine_trainvaltest", "gtFine", split, city)
            img_dir = os.path.join(root, "leftImg8bit_trainvaltest", "leftImg8bit", split, city)
            os.makedirs(lab_dir)
            os.makedirs(img_dir)
            for k in range(PREP_PER_CITY[split]):
                fid = f"{city}_{k:06d}_000019"
                coarse = rng.randint(0, 200, (H // 64, W // 64, 3)).astype(np.uint8)
                rgb = np.repeat(np.repeat(coarse, 64, 0), 64, 1)
                rgb += rng.randint(0, 56, (H, W, 3)).astype(np.uint8)
                blocks = rng.randint(0, 34, (-(-H // 30), -(-W // 30)))
                inst_k = rng.randint(0, 2, blocks.shape)
                things = np.isin(blocks, PREP_THING_IDS) & bool(frames[split] or split != "train")
                inst_blocks = np.where(things, blocks * 1000 + inst_k, blocks)
                ids = np.repeat(np.repeat(blocks, 30, 0), 30, 1)[:H, :W].astype(np.uint8)
                inst = np.repeat(np.repeat(inst_blocks, 30, 0), 30, 1)[:H, :W].astype(np.uint16)
                frames[split][fid] = (rgb, ids, inst)
                jobs += [(os.path.join(img_dir, fid + "_leftImg8bit.png"), rgb, 2, 8),
                         (os.path.join(lab_dir, fid + "_gtFine_labelIds.png"),
                          ids[:, :, None], 0, 8),
                         (os.path.join(lab_dir, fid + "_gtFine_instanceIds.png"),
                          np.stack([inst >> 8, inst & 255], -1).astype(np.uint8), 0, 16)]
    with ThreadPoolExecutor(8) as pool:   # zlib leaves the GIL
        list(pool.map(lambda job: encode_png(*job), jobs))
    return frames


def write_raw_pancreas(root: str, seed: int):
    """``imagesTr``/``labelsTr`` int16 CT-like volumes (-1024..1500 HU)
    and uint8 labels 0..2 on ``PREP_ANNOTATED`` slices.  Returns
    {file name: (volume, labels)}."""
    import os

    import numpy as np

    rng = np.random.RandomState(seed)
    vols = {}
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(root, sub))
    h, w, d = PREP_VOL_SHAPE
    for i in range(PREP_VOLUMES):
        coarse = rng.randint(-1024, 1300, (h // 32, w // 32, d))
        vol = (np.repeat(np.repeat(coarse, 32, 0), 32, 1) + rng.randint(0, 200, (h, w, d)))
        seg = np.zeros((h, w, d), np.uint8)
        for z in PREP_ANNOTATED:
            y0, x0 = rng.randint(100, 300, 2)
            seg[y0:y0 + 96, x0:x0 + 128, z] = np.repeat(np.repeat(
                rng.randint(0, 3, (12, 16)), 8, 0), 8, 1)
            seg[y0, x0, z] = 1   # every annotated slice has a label
        name = f"pancreas_{i:03d}.nii.gz"
        vols[name] = (vol.astype(np.int16), seg)
        write_nifti(os.path.join(root, "imagesTr", name), vols[name][0])
        write_nifti(os.path.join(root, "labelsTr", name), seg)
    return vols


def prep_command(argv, what: str):
    """(seconds, standard output) of one preparation command in a
    process of its own, as a user runs it (its process pool, if any,
    killed with it on a timeout)."""
    import os
    import signal

    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=PREP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # the command and its pool
        proc.communicate()
        raise
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log("\n".join(err.splitlines()[-40:]))
        raise AssertionError(f"{what} exited {proc.returncode}")
    return secs, out


def cli_argv(*args):
    return [sys.executable, "-m", "adlm_tpu_torch.cli", *args]


def same_files(a: str, b: str) -> int:
    """Every file under ``a`` byte-equal to the file of its name under
    ``b`` (the port's writers are deterministic); returns the count."""
    import os

    names = [os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs]
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{name} differs between {a} and {b}")
    return len(names)


def cityscapes_lut():
    """Raw Cityscapes id → category index, from the class table."""
    import numpy as np
    from adlm_tpu_torch.data.constants import CITYSCAPES_CATEGORIES, CITYSCAPES_ID_2_LABEL

    lut = np.zeros(256, np.uint8)
    for raw_id, name in CITYSCAPES_ID_2_LABEL.items():
        if raw_id >= 0:
            lut[raw_id] = CITYSCAPES_CATEGORIES.index(name)
    return lut


def check_prepared_cityscapes(out: str, frames, lut) -> None:
    """Annotations, images (``.npy`` and PNG) and ``all_images.json``
    against the source arrays."""
    import json
    import os

    import numpy as np

    with open(os.path.join(out, "all_images.json")) as f:
        listed = json.load(f)
    want = {s: sorted(frames.get(s, {})) for s in ("train", "val", "test")}
    if listed != want:
        raise AssertionError(f"all_images.json lists {listed}")
    for split, items in frames.items():
        for fid, (rgb, ids, _) in items.items():
            ann = np.load(os.path.join(out, "annotations", split, fid + ".npy"))
            img = np.load(os.path.join(out, "img_with_margin_0", split, fid + ".npy"))
            png = read_png(os.path.join(out, "img_with_margin_0", split, fid + ".png"))
            if ann.dtype != np.uint8 or not np.array_equal(ann, lut[ids]):
                raise AssertionError(f"{fid}: annotation is not the class table of the ids")
            if img.dtype != np.uint8 or not np.array_equal(img, rgb) or not np.array_equal(png, rgb):
                raise AssertionError(f"{fid}: image .npy or PNG differs from the source")


def check_object_masks(out: str, frames) -> int:
    """Each frame's masks are ``inst == id`` for its sorted ids ≥ 1000;
    returns the number of masks."""
    import os

    import numpy as np

    n_masks = n_empty = 0
    for split, items in frames.items():
        for fid, (_, _, inst) in items.items():
            with np.load(os.path.join(out, "obj_masks", split, fid + ".npz")) as z:
                masks, got_ids = z["masks"], z["instance_ids"]
            want_ids = np.unique(inst[inst >= 1000]).astype(np.int32)
            if got_ids.dtype != np.int32 or not np.array_equal(got_ids, want_ids):
                raise AssertionError(f"{fid}: instance ids {got_ids[:8]}")
            if masks.dtype != np.uint8 or masks.shape != (len(want_ids), H, W):
                raise AssertionError(f"{fid}: masks {masks.dtype} {masks.shape}")
            for m, i in zip(masks, want_ids):
                if not np.array_equal(m, inst == i):
                    raise AssertionError(f"{fid}: mask {i} is not inst == {i}")
            n_masks += len(want_ids)
            n_empty += not len(want_ids)
    if n_empty != 1:
        raise AssertionError(f"{n_empty} frames without an instance, expected 1")
    return n_masks


def check_prepared_pancreas(out: str, vols) -> int:
    """The annotated slices only, in file and slice order, at
    (1024, 2048, 3) grey within the slice's normalized range, labels a
    subset of the source slice's; returns the slice count."""
    import json
    import os

    import numpy as np

    with open(os.path.join(out, "all_images.json")) as f:
        listed = json.load(f)
    want = [f"{name.split('.')[0]}_slice{z:03d}" for name in sorted(vols)
            for z in PREP_ANNOTATED]
    if listed != {"train": want, "val": [], "test": []}:
        raise AssertionError(f"all_images.json lists {listed}")
    for name, (vol, seg) in sorted(vols.items()):
        v = vol.astype(np.float64)
        norm = (v - v.min()) / (v.max() - v.min() + 1e-8) * 255.0
        for z in PREP_ANNOTATED:
            sid = f"{name.split('.')[0]}_slice{z:03d}"
            img = np.load(os.path.join(out, "img_with_margin_0", "train", sid + ".npy"))
            png = read_png(os.path.join(out, "img_with_margin_0", "train", sid + ".png"))
            lab = np.load(os.path.join(out, "annotations", "train", sid + ".npy"))
            src = norm[:, :, z].astype(np.float32).astype(np.uint8)
            if (img.shape != (H, W, 3) or img.dtype != np.uint8 or not np.array_equal(png, img)
                    or not (img == img[:, :, :1]).all()
                    or img.min() < src.min() or img.max() > src.max()):
                raise AssertionError(f"{sid}: image {img.dtype} {img.shape} is not the "
                                     "grey slice upsampled")
            if (lab.shape != (H, W) or lab.dtype != np.uint8
                    or not set(np.unique(lab)) <= set(np.unique(seg[:, :, z]))
                    or not lab.any()):
                raise AssertionError(f"{sid}: labels {np.unique(lab)} not of the source slice")
    return len(want)


def time_png_frame(raw: str, out: str, fid: str, split: str) -> str:
    """One frame's host work split: PNG decoding (labelIds,
    leftImg8bit, instanceIds; filters 0-4), ``to_rgb``, PNG writing and
    ``np.save``."""
    import os

    import numpy as np
    from adlm_tpu_torch.data.image_folder import read_png as port_read_png
    from adlm_tpu_torch.data.image_folder import to_rgb, write_png

    city = fid.split("_")[0]
    lab_dir = os.path.join(raw, "gtFine_trainvaltest", "gtFine", split, city)
    img_path = os.path.join(raw, "leftImg8bit_trainvaltest", "leftImg8bit", split, city,
                            fid + "_leftImg8bit.png")
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        secs[name] = time.perf_counter() - t0
        return r

    timed("decode labelIds", lambda: port_read_png(
        os.path.join(lab_dir, fid + "_gtFine_labelIds.png")))
    timed("decode instanceIds (16-bit)", lambda: port_read_png(
        os.path.join(lab_dir, fid + "_gtFine_instanceIds.png")))
    px = timed("decode leftImg8bit", lambda: port_read_png(img_path))
    rgb = timed("to_rgb", lambda: to_rgb(px))
    timed("write_png", lambda: write_png(os.path.join(out, "t.png"), rgb))
    timed("np.save", lambda: np.save(os.path.join(out, "t.npy"), rgb))
    timed("decode the written PNG (filter 0)", lambda: port_read_png(os.path.join(out, "t.png")))
    return ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())


def check_prepared_feed(report, cfg, data: str, results: str, frames, lut) -> dict:
    """import-protoseg of the seeded flagship into a run, then
    ``eval-valid --stats --stats-upsampled`` on the prepared val split
    against a direct ``SegEvaluator`` fed the source arrays: mIoU,
    per-class IoU and nearest-prototype counts bit-equal.  Returns the
    commands' launches."""
    import json
    import os

    import numpy as np
    import torch
    import adlm_tpu_torch.interpret.stats as stats_mod
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.interpret.stats import ProtoStatsAccumulator
    from adlm_tpu_torch.ops import _build

    m32 = random_model(cfg.model, SEED)
    sd = {k: v.detach().cpu() for k, v in m32.state_dict().items()}
    del m32
    for k in list(sd):   # the reference's layout, as phase 13 writes it
        if k.endswith("bn.running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    ckpt = os.path.join(os.path.dirname(results), "flagship.pth")
    torch.save(sd, ckpt)
    rec, launches_by_cmd, plots = {"first_window": None}, [], []
    run = os.path.join(results, "prepared")
    run_command(["import-protoseg", cfg.name, "prepared", ckpt], rec, launches_by_cmd)
    orig_plots = stats_mod.save_eval_plots

    def record_plots(out_dir, *args, **kwargs):
        plots.append(kwargs)
        return orig_plots(out_dir, *args, **kwargs)

    stats_mod.save_eval_plots = record_plots
    try:
        with _RecordedEvaluators() as recorded:
            run_command(["eval-valid", run, "push", "--data-path", data, "--stats",
                         "--stats-upsampled", "--batch-size", str(PREP_EVAL_BS),
                         "--examples", "0"], rec, launches_by_cmd)
    finally:
        stats_mod.save_eval_plots = orig_plots
    (cli_ev,) = recorded.instances
    res = cli_ev.results()
    counts = plots[0]["stats"]["nearest_proto_counts"]

    # the same frames straight from the source arrays
    _, payload, model = cli._load_stage(run, "push", "last", "cuda")
    pc = payload["proto_class"]
    table = get_class_table(cfg.data.class_table)
    ev = SegEvaluator(model, cfg.model.num_classes, with_stats=True, stats_upsampled=True,
                      normalize=(cfg.data.mean, cfg.data.std), device="cuda")
    acc = ProtoStatsAccumulator(pc.numel(), cfg.model.num_classes, pc.cpu().numpy())
    val = [frames["val"][fid] for fid in sorted(frames["val"])]
    torch.cuda.synchronize()
    _build.reset_launches()
    for i in range(0, len(val), PREP_EVAL_BS):
        chunk = val[i:i + PREP_EVAL_BS]
        img = torch.from_numpy(np.stack([rgb for rgb, _, _ in chunk])).cuda()
        lab = torch.from_numpy(np.stack([table.convert_labels(lut[ids]).astype(np.uint8)
                                         for _, ids, _ in chunk])).cuda()
        o = ev.update(pc, img, lab)
        acc.update_counts(o["agree_counts"][:len(chunk)], o["topk_purity"][:len(chunk)],
                          n_images=len(chunk))
    torch.cuda.synchronize()
    direct_launches = dict(_build.LAUNCHES)
    want = ev.results()
    want_counts = acc.results()["nearest_proto_counts"]
    with open(os.path.join(run, "evaluation", "push", "mean_iou.txt")) as f:
        miou_file = float(f.read())
    with open(os.path.join(run, "evaluation", "push", "iou_scores.json")) as f:
        ious_file = json.load(f)
    diff = max([abs(res["mean_iou"] - want["mean_iou"])]
               + [abs(res["iou_per_class"].get(k, math.inf) - v)
                  for k, v in want["iou_per_class"].items()]
               + [int(np.abs(np.asarray(counts) - np.asarray(want_counts)).max())])
    n_batches = -(-len(val) // PREP_EVAL_BS)
    log(f"  eval-valid --stats --stats-upsampled on the prepared val split ({len(val)} "
        f"frames, batch {PREP_EVAL_BS}): mIoU {res['mean_iou']!r}, direct from the source "
        f"arrays {want['mean_iou']!r}; per-class IoU and {int(np.sum(want_counts))} "
        f"nearest-prototype counts max |diff| {diff}; direct launches {direct_launches}")
    if (res["mean_iou"] != want["mean_iou"] or res["iou_per_class"] != want["iou_per_class"]
            or res["pixel_accuracy"] != want["pixel_accuracy"]
            or not np.array_equal(counts, want_counts) or miou_file != res["mean_iou"]
            or ious_file != {str(k): v for k, v in res["iou_per_class"].items()}
            or not math.isfinite(res["mean_iou"])):
        raise AssertionError("eval-valid on the prepared split differs from the source "
                             "arrays' direct evaluation")
    (_, imp), (_, evl) = launches_by_cmd
    for name in _build.KERNELS:
        report[name]["launches"] += evl[name]
    if (any(imp.values()) or evl["prototype_head"] != n_batches
            or evl["upsample_argmin"] != n_batches or direct_launches != evl):
        raise AssertionError(f"launches: import-protoseg {imp}, eval-valid {evl}, direct "
                             f"{direct_launches}; expected {n_batches} of each kernel")
    return evl


def check_prepare(report, card: str) -> dict:
    """Phase 15: a raw Cityscapes tree and Pancreas volumes prepared by
    the port's commands on the card's host, checked against the source
    arrays, then the flagship on the card evaluating the prepared frames
    bit-equal to the same frames fed from memory.  Returns what phase 17
    evaluates again (the temporary ``root``, which the caller removes;
    the prepared ``data``, the ``run``, the eval's ``miou`` text,
    and per-class ``ious``)."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from adlm_tpu_torch.core import config as config_mod

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adlm_prep_")
    kept = None
    saved_env = os.environ.get("RESULTS_DIR")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        raw, out = os.path.join(root, "raw"), os.path.join(root, "cityscapes")
        t0 = time.perf_counter()
        frames = write_raw_cityscapes(raw, SEED + 41)
        vols = write_raw_pancreas(os.path.join(root, "task07"), SEED + 43)
        n_frames = sum(len(v) for v in frames.values())
        ids_seen = set(np.unique(np.stack([ids for f in frames.values()
                                           for _, ids, _ in f.values()])))
        if ids_seen != set(range(34)):
            raise AssertionError(f"the labelIds cover {sorted(ids_seen)}")
        log(f"  wrote {n_frames} raw frames {W}x{H} (leftImg8bit RGB, labelIds ids 0..33, "
            f"16-bit instanceIds; scanline filters 0-4) and {PREP_VOLUMES} volumes "
            f"{PREP_VOL_SHAPE} in {time.perf_counter() - t0:.1f} s")
        # what every command pays before its work: an interpreter that
        # imports torch (here), then the device check (CUDA's start-up;
        # gen-image-list below is little else)
        start_torch, _ = prep_command([sys.executable, "-c", "import torch"], "import torch")
        lut = cityscapes_lut()

        secs_cli, _ = prep_command(cli_argv("preprocess-cityscapes", raw, out),
                                   "preprocess-cityscapes")
        check_prepared_cityscapes(out, frames, lut)
        # the function at n_jobs=1 on one city (linked into a tree of its own)
        raw1, out1 = os.path.join(root, "raw_1city"), os.path.join(root, "cityscapes_1job")
        city = PREP_CITIES["val"][0]
        for part in (("gtFine_trainvaltest", "gtFine"),
                     ("leftImg8bit_trainvaltest", "leftImg8bit")):
            os.makedirs(os.path.join(raw1, *part, "val"))
            os.symlink(os.path.join(raw, *part, "val", city),
                       os.path.join(raw1, *part, "val", city))
        secs_1, _ = prep_command(
            [sys.executable, "-c", "import sys; from adlm_tpu_torch.data.preprocess import "
             "preprocess_cityscapes as f; f(sys.argv[1], sys.argv[2], n_jobs=1)", raw1, out1],
            "preprocess_cityscapes(n_jobs=1)")
        os.remove(os.path.join(out1, "all_images.json"))
        n_files = same_files(out1, out)
        shutil.rmtree(out1)
        n_city = PREP_PER_CITY["val"]
        log(f"  preprocess-cityscapes (CLI, its default 8 jobs over 4 cities): {secs_cli:.2f} s, "
            f"{secs_cli / n_frames:.3f} s per frame; the function at n_jobs=1 on {city} "
            f"({n_city} frames): {secs_1:.2f} s, {secs_1 / n_city:.3f} s per frame ({n_files} "
            f"files byte-equal to the CLI's); an interpreter importing torch starts in "
            f"{start_torch:.2f} s  [host of {card}]")

        from adlm_tpu_torch.data.preprocess import preprocess_cityscapes_obj_masks
        t0 = time.perf_counter()
        preprocess_cityscapes_obj_masks(raw, out)
        secs_masks = time.perf_counter() - t0
        n_masks = check_object_masks(out, frames)
        log(f"  preprocess_cityscapes_obj_masks: {n_masks} masks (one frame without an "
            f"instance) equal inst == id, {secs_masks:.2f} s, "
            f"{secs_masks / n_frames:.3f} s per frame  [host of {card}]")

        # gen-image-list lists the same ids, its splits in sorted order (the
        # JAX function's; preprocess-cityscapes writes train, val, test)
        listing = os.path.join(out, "all_images.json")
        with open(listing) as f:
            want_listing = json.load(f)
        os.remove(listing)
        secs_list, _ = prep_command(cli_argv("gen-image-list", out), "gen-image-list")
        with open(listing) as f:
            if f.read() != json.dumps({k: want_listing[k] for k in sorted(want_listing)}):
                raise AssertionError("gen-image-list wrote another all_images.json")
        val_dir = os.path.join(out, "img_with_margin_0", "val")
        want_npy = {}
        for fid in frames["val"]:
            with open(os.path.join(val_dir, fid + ".npy"), "rb") as f:
                want_npy[fid] = f.read()
            os.remove(os.path.join(val_dir, fid + ".npy"))
        secs_itn, said = prep_command(cli_argv("img-to-numpy", out), "img-to-numpy")
        for fid, data in want_npy.items():
            with open(os.path.join(val_dir, fid + ".npy"), "rb") as f:
                if f.read() != data:
                    raise AssertionError(f"img-to-numpy wrote another {fid}.npy")
        if said.strip() != f"converted {len(want_npy)} images":
            raise AssertionError(f"img-to-numpy said {said!r}")
        log(f"  gen-image-list: all_images.json the same lists, {secs_list:.2f} s (the start "
            f"with the device check: its own work is a directory listing); img-to-numpy: "
            f"{len(want_npy)} val images byte-equal, {secs_itn:.2f} s, "
            f"{secs_itn / len(want_npy):.3f} s per frame  [host of {card}]")

        pan = os.path.join(root, "pancreas")
        secs_pan, _ = prep_command(cli_argv("preprocess-pancreas", os.path.join(root, "task07"),
                                            pan), "preprocess-pancreas")
        n_slices = check_prepared_pancreas(pan, vols)
        n_all = PREP_VOLUMES * PREP_VOL_SHAPE[2]
        log(f"  preprocess-pancreas: {n_slices} annotated slices of {n_all} at {H}x{W}x3, "
            f"{secs_pan:.2f} s, "
            f"{secs_pan / PREP_VOLUMES:.3f} s per volume, {secs_pan / n_slices:.3f} s per "
            f"written slice  [host of {card}]")
        log("  one frame's host work: " + time_png_frame(
            raw, root, sorted(frames["val"])[0], "val") + f"  [host of {card}]")

        cfg = config_mod.get_experiment("cityscapes_kld_imnet")
        results = os.path.join(root, "runs")
        os.environ["RESULTS_DIR"] = results
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        t0 = time.perf_counter()
        launches = check_prepared_feed(report, cfg, out, results, frames, lut)
        log(f"  feed: import-protoseg and eval-valid {time.perf_counter() - t0:.1f} s, "
            f"launches head {launches['prototype_head']}, upsample-argmin "
            f"{launches['upsample_argmin']}")
        run = os.path.join(results, "prepared")
        ev_dir = os.path.join(run, "evaluation", "push")
        with open(os.path.join(ev_dir, "mean_iou.txt")) as f:
            miou = f.read()
        with open(os.path.join(ev_dir, "iou_scores.json")) as f:
            ious = json.load(f)
        kept = {"root": root, "data": out, "run": run, "miou": miou, "ious": ious}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
        if kept is None:
            shutil.rmtree(root, ignore_errors=True)
    log(f"  prepare phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return kept


# ---------------------------------------------------------------------------


# phase 16: data parallelism.  Two gloo ranks share the one card (NCCL
# refuses two ranks on one device; gloo stages CUDA tensors through the
# host, so their step times are not a speed figure).
DP_WORLD = 2
DP_COLLECTIVE_TIMEOUT = 120.0   # seconds a rank waits in a collective
DP_TIMEOUT = 600.0              # seconds allowed the spawned ranks in all
DP_PUSH_FRAMES = 4              # frame 0 repeated as frame 2, on the other rank
DP_UN_BS = 8
DP_UN_HW = 256
DP_UN_GRAD_REL = 1e-3           # each U-Net gradient tensor, relative L2
# the CLI runs: 4 train and 2 val frames; the flagship's schedule scaled
# to 5 + 50 + 3 steps (iter_size 5: 1 + 10 + 1 windows)
DP_TRAIN_FRAMES, DP_VAL_FRAMES = 4, 2
DP_STEPS_SCALE = "0.0003334"
DP_RUN_L2 = 1e-5                # all weights of the world-1 run, relative L2
# two ranks against one process over the warmup and joint stages: the
# sums run in another order and Adam's first steps of rounding-noise
# gradients take either sign (read on four H100s: 8.4e-8 and 1.53e-5);
# the push is left out, its winners move with any such change
DP_RUN2_L2 = 1e-4
DP_TIME_ITERS = 3


def dp_window(cfg, seed: int):
    """Phase 7's joint window with labels whose two rank halves hold
    different void shares: rank 0's image of every microbatch has its
    left half void, and rank 1's image of microbatch 2 is all void."""
    images, labels = make_train_batch(cfg, seed)
    labels = labels.clone()
    labels[:, 0, :, :TRAIN_HW // 2] = 0
    labels[2, 1] = 0
    return images, labels


def dp_inputs(path: str, cfg) -> None:
    """The phase's inputs on the host, for the ranks and this process."""
    import torch

    images, labels = dp_window(cfg, SEED + 31)
    (eval_img, eval_lab), = make_batches(1, 2, SEED + 32)
    frames = make_push_frames(DP_PUSH_FRAMES - 1, SEED + 33)
    frames = frames[:2] + [frames[0]] + frames[2:]
    imgs, masks, _ = unoise_slices(DP_UN_BS, DP_UN_HW, SEED + 34)
    eps = torch.randn(DP_UN_BS, DP_UN_HW, DP_UN_HW, 1,
                      generator=torch.Generator().manual_seed(SEED + 35))
    torch.save({"images": images.cpu(), "labels": labels.cpu(),
                "eval_img": eval_img.cpu(), "eval_lab": eval_lab.cpu(),
                "push_img": torch.cat([torch.from_numpy(f) for f, _ in frames]),
                "push_lab": torch.cat([torch.from_numpy(l) for _, l in frames]),
                "un_x": torch.from_numpy(imgs[..., None]),
                "un_y": torch.from_numpy(masks[..., None]), "un_eps": eps}, path)


def dp_unoise_cfg():
    from adlm_tpu_torch.core.config import UNoiseConfig

    return UNoiseConfig(batch_size=DP_UN_BS)


def dp_steps(model, cfg, inp, dev, mesh, out_dir):
    """The flagship's joint window (plain, fused) through the sharded
    step, or the single-process step without a mesh: per variant the
    metrics, the head launches, the seconds, a digest of the parameters
    and, on the first rank, the gradients written to ``out_dir``."""
    import dataclasses
    import hashlib

    import torch
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    out = {}
    images, labels = inp["images"].to(dev), inp["labels"].to(dev)
    if mesh is not None:
        rows = mesh.batch_slice(images.shape[1])
        images, labels = images[:, rows], labels[:, rows]
    fused = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               fused_accumulation=True))
    for name, c in (("plain", cfg), ("fused", fused)):
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, c, 1, c.train.joint_steps, device=dev)
        step = make_train_step(m, c, 1, c.train.joint_steps, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        digest = hashlib.sha256()
        for p in m.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "launches": launches, "secs": secs, "digest": digest.hexdigest()}
        if out_dir is not None:
            torch.save({n: p.grad.detach().cpu() for n, p in m.named_parameters()
                        if p.grad is not None}, f"{out_dir}/grads_{name}.pt")
        del m, state, step
        torch.cuda.empty_cache()
    return out


def dp_naive(model, cfg, inp, dev, mesh) -> float:
    """The naive control: this rank's own mean loss over the window."""
    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.train.protoseg import loss_fn

    rows = mesh.batch_slice(inp["images"].shape[1])
    pc = default_proto_class(190, 19, device=dev)
    losses = []
    with torch.no_grad(), ieee_f32():
        for i in range(inp["images"].shape[0]):
            batch = (inp["images"][i, rows].to(dev), inp["labels"][i, rows].to(dev))
            losses.append(float(loss_fn(model, pc, cfg, batch, True)[0]))
    return sum(losses) / len(losses)


class _Draws:
    """An evaluator's random state that hands out the given arrays, in
    order, as its draws."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def random_sample(self, shape):
        out = self.arrays.pop(0)
        if out.shape != tuple(shape):
            raise AssertionError(f"a draw of {tuple(shape)} was given {out.shape}")
        return out


def dp_eval(model, cfg, inp, dev, mesh, draws=None):
    """``SegEvaluator`` with upsampled statistics on the batch of 2 (the
    rank's image under a mesh): (results, [outputs as ``run_eval``'s]),
    the statistic rows and sampled distances of the global batch.
    ``draws``: the sample pixels' (u, v), in place of the evaluator's."""
    import torch
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.models.ppnet import default_proto_class

    K = cfg.model.num_classes
    pc = default_proto_class(cfg.model.num_prototypes, K, device=dev)
    img, lab = inp["eval_img"].to(dev), inp["eval_lab"].to(dev)
    n_valid = img.shape[0]
    if mesh is not None:
        rows = mesh.batch_slice(img.shape[0])
        img, lab = img[rows], lab[rows]
    ev = SegEvaluator(model, K, with_stats=True, stats_upsampled=True,
                      normalize=(cfg.data.mean, cfg.data.std), n_random_pixels=N_RANDOM,
                      seed=SEED, device=dev, mesh=mesh)
    if draws is not None:
        ev.rng = _Draws(draws)
    with purity_inputs() as seen:
        o = (ev.update(pc, img, lab) if mesh is None
             else ev.update(pc, img, lab, n_valid=n_valid))
    sample_d, sample_pred = (t.to(dev) for t in seen[0])
    if mesh is not None:
        sample_d = mesh.gather_rows(sample_d)
        sample_pred = mesh.gather_rows(sample_pred.float()).long()
    out = {k: v.cpu() for k, v in o.items()
           if k in ("intersection", "union", "correct", "total", "agree_counts",
                    "topk_purity")}
    out["sample_d"], out["sample_pred"] = sample_d.cpu(), sample_pred.cpu()
    return ev.results(), [out]


def dp_push(model, cfg, inp, dev, mesh):
    """The batched push step's winners over the 4 frames: through the
    sharded step, or one process's scan of two batches of 2 merged in
    order (strict <: the earlier frame wins a tie), as ``push_prototypes``
    does."""
    import torch
    from adlm_tpu_torch.interpret.push import make_push_batched_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class

    pc = default_proto_class(190, 19, device=dev)
    fn = make_push_batched_fn(model, 19, normalize=(cfg.data.mean, cfg.data.std),
                              device=dev, mesh=mesh)
    img, lab = inp["push_img"], inp["push_lab"]
    if mesh is not None:
        rows = mesh.batch_slice(img.shape[0])
        return [t.cpu() for t in fn(pc, img[rows].to(dev), lab[rows].to(dev))]
    best = None
    for h in range(0, img.shape[0], 2):
        mind, bi, pi, pj, fmap = (t.cpu() for t in fn(pc, img[h:h + 2].to(dev),
                                                       lab[h:h + 2].to(dev)))
        cur = [mind, bi + h, pi, pj, fmap]
        if best is None:
            best = cur
            continue
        better = cur[0] < best[0]
        best = [torch.where(better[:, None] if a.dim() == 2 else better, a, b)
                for a, b in zip(cur, best)]
    return best


def dp_unoise(inp, dev, mesh, out_dir):
    """One utility and one noise step at batch 8 x 256^2 (a rank's 4
    under a mesh, eps given at the global shape): losses, running
    statistics, seconds, and on the first rank the gradients."""
    import torch
    from adlm_tpu_torch.train import unoise as tu

    cfg = dp_unoise_cfg()
    x, y, eps = inp["un_x"].to(dev), inp["un_y"].to(dev), inp["un_eps"].to(dev)
    if mesh is not None:
        rows = mesh.batch_slice(x.shape[0])
        x, y = x[rows], y[rows]
    util = tu.init_utility_state(cfg, seed=0, device=dev)
    util_sd = {k: v.clone() for k, v in util.model.state_dict().items()}
    noise = tu.init_noise_state(cfg, util_sd, seed=1, device=dev)
    out = {}
    for name, state, make in (("utility", util, tu.make_utility_train_step),
                              ("noise", noise, tu.make_noise_train_step)):
        step = make(cfg, raw=True, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, x, y) if name == "utility" else step(state, x, y, eps=eps)
        torch.cuda.synchronize()
        m = {"loss": m} if name == "utility" else m
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "secs": time.perf_counter() - t0,
                     "stats": {k: v.cpu() for k, v in state.model.state_dict().items()
                               if "running" in k}}
        if out_dir is not None:
            torch.save({n: p.grad.detach().cpu() for n, p in state.model.named_parameters()},
                       f"{out_dir}/grads_{name}.pt")
    return out


def dp_unoise_f64(inp):
    """Phase 11's f64 steps on the card from the U-Nets' initial weights
    and the whole batch: {"utility", "noise": (loss, gradients)}."""
    import torch
    from adlm_tpu_torch.train import unoise as tu

    cfg, dev = dp_unoise_cfg(), torch.device("cuda", 0)
    util_sd = tu.init_utility_state(cfg, seed=0, device=dev).model.state_dict()
    noise_sd = tu.build_unet(cfg.depth, cfg.channel_factor, dev, seed=1).state_dict()
    return {"utility": _f64_utility_step(util_sd, inp["un_x"], inp["un_y"]),
            "noise": _f64_noise_step(cfg, noise_sd, util_sd, inp["un_x"], inp["un_y"],
                                     inp["un_eps"])}


def dp_work(cfg, inp, dev, mesh, out_dir):
    """Everything phase 16 holds, on ``dev``: through the sharded entry
    points with a ``mesh``, else through the single-process ones; main
    path launches are counted around the window, eval and push."""
    import torch
    from adlm_tpu_torch.ops import _build

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = random_model(cfg.model, SEED).to(dev)
    res = {"steps": dp_steps(model, cfg, inp, dev, mesh, out_dir)}
    model.eval()
    _build.reset_launches()
    t0 = time.perf_counter()
    res["eval"] = dp_eval(model, cfg, inp, dev, mesh)
    torch.cuda.synchronize()
    res["eval_launches"], res["eval_secs"] = dict(_build.LAUNCHES), time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    res["push"] = dp_push(model, cfg, inp, dev, mesh)
    torch.cuda.synchronize()
    res["push_launches"], res["push_secs"] = dict(_build.LAUNCHES), time.perf_counter() - t0
    if mesh is not None:
        res["naive"] = dp_naive(model, cfg, inp, dev, mesh)
    del model
    torch.cuda.empty_cache()
    res["unoise"] = dp_unoise(inp, dev, mesh, out_dir)
    return res


def dp_rank(dev, mesh_args, in_path: str, out_dir: str) -> None:
    """One spawned rank of phase 16 (``core/mesh.py::spawn_local``)."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.mesh import MeshSpec, destroy, make_mesh

    mesh = make_mesh(MeshSpec(DP_WORLD, 1), dev, **mesh_args)
    try:
        inp = torch.load(in_path, weights_only=False)
        res = dp_work(get_experiment("cityscapes_kld_imnet"), inp, dev, mesh,
                      out_dir if mesh.is_main else None)
        res["backend"] = mesh.backend
    finally:
        destroy(mesh)
    torch.save(res, f"{out_dir}/rank{mesh.rank}.pt")


def dp_compare(ranks, single, root: str, report, tag: str) -> None:
    """The ranks' results against the single-process ones (module
    docstring, phase 16)."""
    import torch

    pc = torch.arange(190) // 10
    r0 = ranks[0]
    for name in ("plain", "fused"):
        want = single["steps"][name]["metrics"]
        n_patches = int(want["n_patches"])
        budget = math.ceil(TRAIN_TIE_SHARE * n_patches)
        for r, res in enumerate(ranks):
            got = res["steps"][name]["metrics"]
            errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                    for k in ("loss", "cross_entropy", "kld_loss", "l1", "grad_norm")}
            dn = abs(got["n_correct"] - want["n_correct"])
            log(f"  [{tag}] {name} window, rank {r}: loss {got['loss']:.6f} (one process "
                f"{want['loss']:.6f}); rel err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tolerance {TRAIN_RTOL:g}); n_correct {got['n_correct']:.0f} vs "
                f"{want['n_correct']:.0f} of {n_patches} (budget {budget}); n_patches "
                f"{got['n_patches']:.0f}; head launches {res['steps'][name]['launches']}")
            if (any(v > TRAIN_RTOL for v in errs.values()) or dn > budget
                    or got["n_patches"] != want["n_patches"]):
                raise AssertionError(f"[{tag}] {name} window: rank {r} disagrees")
        want_l = 1 if name == "fused" else TRAIN_ITER
        for r, res in enumerate(ranks):
            if res["steps"][name]["launches"]["prototype_head"] != want_l:
                raise AssertionError(f"[{tag}] {name}: rank {r} launched the head "
                                     f"{res['steps'][name]['launches']}, expected {want_l}")
        digests = {res["steps"][name]["digest"] for res in ranks}
        log(f"  [{tag}] {name}: parameters after the window "
            + ("bit-equal on both ranks" if len(digests) == 1 else "DIFFER between ranks"))
        if len(digests) != 1:
            raise AssertionError(f"[{tag}] {name}: the ranks' parameters differ")
        g_rank = torch.load(f"{root}/{tag}/grads_{name}.pt")
        g_one = torch.load(f"{root}/single/grads_{name}.pt")
        rel = {n: ((g_rank[n] - g_one[n]).norm() / g_one[n].norm().clamp_min(1e-30)).item()
               for n in g_one}
        worst = max(rel, key=rel.get)
        log(f"  [{tag}] {name}: the update's gradients, {len(rel)} tensors, largest "
            f"relative L2 error {rel[worst]:.2e} ({worst}), tolerance {TRAIN_GRAD_REL:g}")
        if rel[worst] > TRAIN_GRAD_REL or set(g_rank) != set(g_one):
            raise AssertionError(f"[{tag}] {name}: gradients disagree")
    want = single["steps"]["plain"]["metrics"]["loss"]
    naive = sum(res["naive"] for res in ranks) / len(ranks)
    err = abs(naive - want) / abs(want)
    log(f"  [{tag}] naive control (mean of the ranks' own means): {naive:.6f} against "
        f"{want:.6f}, rel err {err:.2e}, must exceed {TRAIN_RTOL:g}")
    if err <= TRAIN_RTOL:
        raise AssertionError("the naive control matches: the labels cannot see the fault")

    n_pixels = 2 * H * W
    for r, res in enumerate(ranks):
        compare_eval(f"[{tag}] rank {r} vs one process", res["eval"], single["eval"],
                     n_pixels, pc)
        if (res["eval_launches"]["prototype_head"] != 1
                or res["eval_launches"]["upsample_argmin"] != 1):
            raise AssertionError(f"[{tag}] eval launches on rank {r}: {res['eval_launches']}")
    log(f"  [{tag}] eval launches per rank: {[res['eval_launches'] for res in ranks]}")

    want = single["push"]
    for r, res in enumerate(ranks):
        got = res["push"]
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        log(f"  [{tag}] push winners, rank {r}: (min d, frame, row, col, features) equal "
            f"to one process's {same}; winners per frame "
            f"{torch.bincount(got[1][got[0] < 1e29], minlength=DP_PUSH_FRAMES).tolist()}; "
            f"head launches {res['push_launches']}")
        if not all(same) or res["push_launches"]["prototype_head"] != 1:
            raise AssertionError(f"[{tag}] push: rank {r} disagrees")
    seen = want[0] < 1e29
    if (want[1][seen] == 2).any() or not (want[1][seen] == 0).any():
        raise AssertionError("push: the repeated frame must lose every tie to frame 0")

    for name, loss_key in (("utility", "loss"), ("noise", "train_loss")):
        g_rank = torch.load(f"{root}/{tag}/grads_{name}.pt")
        g_one = torch.load(f"{root}/single/grads_{name}.pt")
        ref = single["unoise_f64"][name]
        zero = _zero_bias_names_of(g_one)
        w = single["unoise"][name]
        for r, res in enumerate(ranks):
            s = res["unoise"][name]
            lerr = {k: abs(s["metrics"][k] - w["metrics"][k]) / abs(w["metrics"][k])
                    for k in w["metrics"]}
            serr = max(float(((s["stats"][k] - w["stats"][k]).abs()
                              - UN_STATS_RTOL * w["stats"][k].abs()).max())
                       for k in w["stats"])
            log(f"  [{tag}] U-Noise {name} step, rank {r}: {s['metrics']} (one process "
                f"{w['metrics']}), rel err {lerr}; running statistics' largest excess "
                f"over rtol {UN_STATS_RTOL:g}: {serr:.2e} (atol {UN_STATS_ATOL:g})")
            if any(v > UN_LOSS_RTOL for v in lerr.values()) or serr > UN_STATS_ATOL:
                raise AssertionError(f"[{tag}] U-Noise {name}: rank {r} disagrees")
        # phase 11's rule: each gradient tensor held to the f64 step within
        # UN_F32_FACTOR times the one-process f32 step's own error
        card = (ranks[0]["unoise"][name]["metrics"][loss_key], _host64(g_rank))
        one = (w["metrics"][loss_key], g_one)
        card_err, one_err = (_step_errors(g, ref[1], zero) for g in (card[1], _host64(g_one)))
        worst = max(card_err[0], key=card_err[0].get)
        log(f"  [{tag}] U-Noise {name}: loss {card[0]:.7f} sharded, {one[0]:.7f} one "
            f"process, {ref[0]:.7f} f64; gradients' relative L2 to f64 up to "
            f"{card_err[0][worst]:.2e} ({worst}; one process "
            f"{max(one_err[0].values()):.2e}); zero-gradient biases {card_err[1]:.2e} "
            f"({one_err[1]:.2e}) of all gradients")
        faults = _step_faults(card, one, ref, card_err, one_err)
        if faults:
            raise AssertionError(f"[{tag}] U-Noise {name}: {faults[:6]}")

    for res in ranks:
        for part in ("eval_launches", "push_launches"):
            for k, v in res[part].items():
                report[k]["launches"] += v
        for name in ("plain", "fused"):
            for k, v in res["steps"][name]["launches"].items():
                report[k]["launches"] += v


def _zero_bias_names_of(grads):
    """The U-Net's conv biases ahead of a train-mode BN, by name (every
    conv bias but the head's): their analytic gradient is 0."""
    return [n for n in grads if n.endswith(".bias") and not n.startswith("conv1x1")
            and grads[n].dim() == 1 and n.replace(".bias", ".weight") in grads
            and grads[n.replace(".bias", ".weight")].dim() == 4]


def dp_spawn(root: str, in_path: str, tag: str, devices, backend: str):
    """Phase 16's ranks on ``devices``: their results, rank by rank."""
    import os

    import torch
    from adlm_tpu_torch.core.mesh import spawn_local

    out = os.path.join(root, tag)
    os.makedirs(out)
    t0 = time.perf_counter()
    codes = spawn_local(dp_rank, DP_WORLD, os.path.join(root, f"store_{tag}"), devices,
                        args=(in_path, out), backend=backend,
                        timeout_s=DP_COLLECTIVE_TIMEOUT, join_timeout=DP_TIMEOUT)
    log(f"  [{tag}] {DP_WORLD} ranks ({backend}) on {list(devices)}: exit codes {codes} "
        f"in {time.perf_counter() - t0:.1f} s (process start-up and the flagship's "
        f"build included)")
    if codes != [0] * DP_WORLD:
        raise AssertionError(f"[{tag}] a rank failed: {codes}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_WORLD)]


def dp_cli_run(root: str, card: str) -> None:
    """The NCCL world of one through the CLI: ``torchrun --standalone
    --nproc-per-node 1 -m adlm_tpu_torch.cli train ... --distributed
    --mesh-data 1`` against the same command without ``--distributed``
    in this process, then ``eval-test`` of both; the window's time with
    and without the mesh and the gradient's all-reduce in a world of one
    in this process."""
    import os

    from adlm_tpu_torch import cli

    import torch

    data, results = os.path.join(root, "data"), os.path.join(root, "runs")
    write_dataset(data, DP_TRAIN_FRAMES, SEED + 36, n_val=DP_VAL_FRAMES)
    train = ["train", "cityscapes_kld_imnet", "{run}", "--data-path", data,
             "--steps-scale", DP_STEPS_SCALE, "--val-batches", "1", "--push-batch-size", "2"]
    saved_env = os.environ.get("RESULTS_DIR")
    os.environ["RESULTS_DIR"] = results
    try:
        # both runs under cuDNN's deterministic algorithms, which train
        # sets itself, so that bit-equality can be asked for
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main([a.format(run="one") for a in train])
        log(f"  train (one process, no mesh): {time.perf_counter() - t0:.1f} s")
        env = dict(os.environ, RESULTS_DIR=results)
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1", "-m", "adlm_tpu_torch.cli",
                *[a.format(run="world1") for a in train], "--distributed", "--mesh-data", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=900)
        log(f"  torchrun --nproc-per-node 1 -m adlm_tpu_torch.cli train ... "
            f"--distributed --mesh-data 1: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            log("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]))
            raise AssertionError("the NCCL world-1 run failed")
        dp_same_run(results, "one", "world1")
        pngs = {}
        for run in ("one", "world1"):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["eval-test", os.path.join(results, run), "push", "--data-path",
                          data, "--split", "val"])
            d = os.path.join(results, run, "evaluation", "push", "test_predictions")
            pngs[run] = {f: read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        diff = sum(int((pngs["one"][f] != pngs["world1"][f]).sum()) for f in pngs["one"])
        budget = math.ceil(TIE_SHARE * DP_VAL_FRAMES * H * W)
        log(f"  eval-test of both runs: {len(pngs['one'])} PNGs, {diff} pixels differ "
            f"(phase 4's budget {budget})")
        if sorted(pngs["one"]) != sorted(pngs["world1"]) or diff > budget:
            raise AssertionError("eval-test of the world-1 run differs")
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
    dp_time_world1(root, card)


def dp_same_run(results: str, a_run: str, b_run: str, stages=("warmup", "nopush", "push"),
                limit: float = DP_RUN_L2) -> None:
    """Two runs' stage checkpoints: bit-equal or not (printed), all
    weights within ``limit`` relative L2 error, the same classes."""
    import os

    import torch
    from adlm_tpu_torch.core.checkpoint import CheckpointStore

    l2 = 0.0
    for stage in stages:
        a = CheckpointStore(os.path.join(results, a_run)).restore(stage, "last")
        b = CheckpointStore(os.path.join(results, b_run)).restore(stage, "last")
        bad = same_payload(a, b)
        keys = [k for k in a["state_dict"] if a["state_dict"][k].is_floating_point()]
        diff = {k: float((a["state_dict"][k].float() - b["state_dict"][k].float()).abs().max())
                for k in keys}
        worst = max(diff, key=diff.get)
        va = torch.cat([a["state_dict"][k].float().flatten() for k in keys])
        vb = torch.cat([b["state_dict"][k].float().flatten() for k in keys])
        err = float((va - vb).norm() / va.norm())
        l2 = max(l2, err)
        log(f"  run {b_run} against run {a_run}, {stage}_last: "
            + ("bit-equal" if not bad else f"{len(bad)} entries differ ({bad[:4]}...)")
            + f"; weights' relative L2 error {err:.2e}, largest entry difference "
            f"{diff[worst]:.2e} ({worst})")
        if not torch.equal(a["proto_class"], b["proto_class"]):
            raise AssertionError(f"{b_run}: {stage} proto_class differs from {a_run}'s")
    if l2 > limit:
        raise AssertionError(f"run {b_run} differs from run {a_run} beyond {limit:g}")


def dp_time_world1(root: str, card: str) -> None:
    """A flagship f32 window through the step with a world-1 NCCL mesh
    and without one, and the all-reduce of its flattened gradient."""
    import os

    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.mesh import MeshSpec, destroy, make_mesh
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    cfg = get_experiment("cityscapes_kld_imnet")
    dev = torch.device("cuda", 0)
    mesh = make_mesh(MeshSpec(1, 1), dev, backend="nccl",
                     init_method="file://" + os.path.join(root, "store_time"),
                     rank=0, world_size=1)
    try:
        images, labels = make_train_batch(cfg, SEED + 37)
        model = random_model(cfg.model, SEED).to(dev)
        secs = {}
        for name, m in (("plain step", None), ("world-1 NCCL step", mesh)):
            state = init_protoseg_state(model, cfg, 1, cfg.train.joint_steps, device=dev)
            step = make_train_step(model, cfg, 1, cfg.train.joint_steps, device=dev, mesh=m)
            step(state, images, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIME_ITERS):
                step(state, images, labels)
            torch.cuda.synchronize()
            secs[name] = (time.perf_counter() - t0) / DP_TIME_ITERS
        n = sum(p.numel() for p in model.parameters() if p.requires_grad)
        buf = torch.randn(n, device=dev)
        ms = cuda_ms(lambda: mesh.all_reduce_(buf), 10)
        log(f"  [{card}] f32 window 2 x 5 x 513^2: plain step {secs['plain step']:.4f} s, "
            f"world-1 NCCL step {secs['world-1 NCCL step']:.4f} s "
            f"({100 * (secs['world-1 NCCL step'] / secs['plain step'] - 1):+.2f}%); "
            f"gradient {n} f32 = {4 * n / 1e6:.1f} MB per window, its all-reduce "
            f"{ms:.3f} ms (world of one)")
    finally:
        destroy(mesh)


def dp_multi_card(root: str, in_path: str, single, report, train2) -> None:
    """Where the machine has two cards: the phase's ranks with NCCL, one
    card each, against ``single``, and ``train2`` (``train ...
    --mesh-data 2``) against the one-process run ``one`` of
    ``dp_cli_run`` over the warmup and joint stages (DP_RUN2_L2)."""
    import os

    ranks = dp_spawn(root, in_path, "nccl", ["cuda:0", "cuda:1"], "nccl")
    dp_compare(ranks, single, root, report, "nccl")
    log("  seconds per NCCL rank, one card each: " + "; ".join(
        f"rank {r}: window {res['steps']['plain']['secs']:.3f} (one process "
        f"{single['steps']['plain']['secs']:.3f}), fused {res['steps']['fused']['secs']:.3f} "
        f"({single['steps']['fused']['secs']:.3f})" for r, res in enumerate(ranks)))
    env = dict(os.environ, RESULTS_DIR=os.path.join(root, "runs"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "adlm_tpu_torch.cli", *train2],
                          env=env, capture_output=True, text=True, timeout=900)
    log(f"  train --mesh-data 2 (NCCL, cuda:0 and cuda:1): exit {proc.returncode} "
        f"in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        log("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]))
        raise AssertionError("train --mesh-data 2 failed")
    dp_same_run(os.path.join(root, "runs"), "one", "two", ("warmup", "nopush"), DP_RUN2_L2)


def check_parallel(report, card: str) -> None:
    """Phase 16: the sharded window, eval, push and U-Noise steps on two
    gloo ranks sharing the card against this process's single-process
    runs; the NCCL world of one through the CLI; the refusal of more
    ranks than cards; two NCCL ranks where the machine has two cards."""
    import os
    import shutil
    import tempfile

    import torch
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.core.config import get_experiment

    t_phase = time.perf_counter()
    cfg = get_experiment("cityscapes_kld_imnet")
    root = tempfile.mkdtemp(prefix="adlm_dp_")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        in_path = os.path.join(root, "inputs.pt")
        dp_inputs(in_path, cfg)
        ranks = dp_spawn(root, in_path, "gloo", ["cuda:0"] * DP_WORLD, "gloo")
        os.makedirs(os.path.join(root, "single"))
        t0 = time.perf_counter()
        inp = torch.load(in_path, weights_only=False)
        single = dp_work(cfg, inp, torch.device("cuda", 0), None, os.path.join(root, "single"))
        log(f"  single-process runs in {time.perf_counter() - t0:.1f} s")
        single["unoise_f64"] = dp_unoise_f64(inp)
        dp_compare(ranks, single, root, report, "gloo")
        log("  seconds on each gloo rank sharing the card (host-staged collectives: "
            "not a speed figure): " + "; ".join(
                f"rank {r}: window {res['steps']['plain']['secs']:.2f} (one process "
                f"{single['steps']['plain']['secs']:.2f}), fused "
                f"{res['steps']['fused']['secs']:.2f} ({single['steps']['fused']['secs']:.2f}), "
                f"eval {res['eval_secs']:.2f} ({single['eval_secs']:.2f}), push "
                f"{res['push_secs']:.2f} ({single['push_secs']:.2f}), utility "
                f"{res['unoise']['utility']['secs']:.2f}, noise "
                f"{res['unoise']['noise']['secs']:.2f}" for r, res in enumerate(ranks)))
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        torch.cuda.empty_cache()

        dp_cli_run(root, card)

        n_cards = torch.cuda.device_count()
        train2 = ["train", "cityscapes_kld_imnet", "two", "--data-path",
                  os.path.join(root, "data"), "--steps-scale", DP_STEPS_SCALE,
                  "--val-batches", "1", "--push-batch-size", "2", "--mesh-data", "2"]
        if n_cards < 2:
            msg, saved_env = None, os.environ.get("RESULTS_DIR")
            os.environ["RESULTS_DIR"] = os.path.join(root, "runs")
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(train2)
            except SystemExit as e:
                msg = str(e)
            finally:
                if saved_env is None:
                    os.environ.pop("RESULTS_DIR", None)
                else:
                    os.environ["RESULTS_DIR"] = saved_env
            log(f"  train --mesh-data 2 on {n_cards} card: exits with {msg!r}")
            if not msg or "card" not in msg:
                raise AssertionError("train --mesh-data 2 on one card did not refuse")
            log("  two NCCL ranks, one card each, and train --mesh-data 2: skipped, this "
                "machine has one card")
        else:
            dp_multi_card(root, in_path, single, report, train2)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 16 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: spatial eval.  Two gloo ranks share the one card as a (data 1,
# model 2) mesh, each holding half of image H (NCCL refuses two ranks on
# one device; gloo stages CUDA tensors through the host, so their seconds
# are not a speed figure).
# ---------------------------------------------------------------------------

SP_WORLD = 2
SP_COLLECTIVE_TIMEOUT = 120.0   # seconds a rank waits in a collective
SP_TIMEOUT = 600.0              # seconds allowed the spawned ranks in all
# bf16: cuDNN picks its bf16 algorithms by shape, and a rank's half-height
# slabs round differently from the whole frame, as the same batch one
# image at a time does (the control).  So bf16 is held to the one-process
# bf16 eval no further than SP_BF16_FACTOR times the control is, plus
# phase 4's budgets.  f32 keeps phase 4's budgets.
SP_BF16_FACTOR = 2.0
# the MSC case: PASCAL's model (PPNet, 210 prototypes x 64 channels, 21
# classes, DeepLabV2-ResNet101 at full depth, msc_scales (0.5, 0.75)) on
# frames at its eval size; the CLI case's frames are resized to it
MSC_EXPERIMENT = "pascal_kld_imnet"
MSC_HW = (513, 513)
MSC_CLI_HW, MSC_CLI_FRAMES = (375, 500), 4
# the tensor-parallel head's purity against one process
# (tests/test_parallel.py's prototype-parallel test)
TP_PURITY = dict(rtol=1e-5, atol=1e-6)
TP_KEYS = ("intersection", "union", "correct", "total", "pred", "stat_pred",
           "nearest_proto", "agree_counts", "topk_purity")


def sp_inputs(path: str) -> None:
    """The ranks' and this process's batches: the flagship's (2 x 1024 x
    2048, uint8, a void band) and the MSC model's (2 x 513 x 513, PASCAL's
    21 classes)."""
    import torch

    img, lab = make_batches(1, 2, SEED + 71)[0]
    m_img, m_lab = make_batches(1, 2, SEED + 73, MSC_HW, 22)[0]
    torch.save({"flagship": {"eval_img": img.cpu(), "eval_lab": lab.cpu()},
                "msc": {"eval_img": m_img.cpu(), "eval_lab": m_lab.cpu()}}, path)


def sp_models(cfg, dev):
    import torch
    from adlm_tpu_torch.core.device import cast_params

    m32 = random_model(cfg.model, SEED).to(dev)
    return {"f32": m32, "bf16": cast_params(copy.deepcopy(m32), torch.bfloat16)}


def sp_work(cfg, inp, dev, mesh):
    """Eval with upsampled statistics (phase 16's ``dp_eval``) of the
    batch in f32 and bf16, cuDNN deterministic, launches counted around
    each; with a mesh, also what the rank handed the upsample-argmin
    kernel (its map slab, window and answer); without, also bf16 one
    image at a time on the batch's sample pixels (the control of
    ``sp_hold_bf16``)."""
    import numpy as np
    import torch
    import adlm_tpu_torch.ops.upsample_argmin as ua
    from adlm_tpu_torch.ops import _build

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    res = {}
    models = sp_models(cfg, dev)
    # a batch in each dtype first, neither counted nor timed: a new
    # process's first eval picks cuDNN's algorithms and opens the collectives
    for model in models.values():
        dp_eval(model.eval(), cfg, inp, dev, mesh)
    for tag, model in models.items():
        model.eval()
        calls = []
        orig = ua.upsampled_nearest

        def record(d, size, *args, **kw):
            out = orig(d, size, *args, **kw)
            calls.append((d, kw.get("out_rows"), kw.get("map_rows"), out, tuple(size)))
            return out

        ua.upsampled_nearest = record
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            ev = dp_eval(model, cfg, inp, dev, mesh)
            torch.cuda.synchronize()
            res[tag] = {"eval": ev, "launches": dict(_build.LAUNCHES),
                        "secs": time.perf_counter() - t0}
        finally:
            ua.upsampled_nearest = orig
        if mesh is not None:
            (d, out_rows, map_rows, out, size), = calls
            res[tag]["window"] = (d.cpu(), out_rows, map_rows, out.cpu(), size)
        elif tag == "bf16":
            # each image on the pixels the batch's evaluator draws for it
            rng, n = np.random.RandomState(SEED), inp["eval_img"].shape[0]
            u, v = (rng.random_sample((n, N_RANDOM)) for _ in range(2))
            one = [dp_eval(model, cfg, {k: t[i:i + 1] for k, t in inp.items()}, dev, None,
                           draws=(u[i:i + 1], v[i:i + 1])) for i in range(n)]
            res["bf16 b1"] = ({}, [{k: (torch.cat if k in SP_STACKED else sum)(
                [o[1][0][k] for o in one]) for k in SP_COUNTERS + SP_STACKED[1:]}])
        models[tag] = None
        del model
        torch.cuda.empty_cache()
    return res


def sp_rank(dev, mesh_args, in_path: str, out_dir: str) -> None:
    """One spawned rank of phase 17 (``core/mesh.py::spawn_local``)."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.mesh import MeshSpec, destroy, make_mesh

    mesh = make_mesh(MeshSpec(1, SP_WORLD), dev, **mesh_args)
    try:
        inp = torch.load(in_path, weights_only=False)
        flagship = get_experiment("cityscapes_kld_imnet")
        res = {"spatial": sp_work(flagship, inp["flagship"], dev, mesh),
               "tp": tp_work(flagship, inp["flagship"], dev, mesh),
               "msc": sp_work(get_experiment(MSC_EXPERIMENT), inp["msc"], dev, mesh)}
    finally:
        destroy(mesh)
    torch.save(res, f"{out_dir}/rank{mesh.rank}.pt")


def tp_keep(o) -> dict:
    """What the tensor-parallel comparison reads of an eval output, on the
    host (the maps narrowed: classes to uint8)."""
    import torch

    out = {k: o[k].cpu() for k in TP_KEYS if k in o}
    for k in ("pred", "stat_pred"):
        if k in out:
            out[k] = out[k].to(torch.uint8)
    return out


def tp_work(cfg, inp, dev, mesh):
    """The tensor-parallel head on the flagship's batch: with a mesh, the
    rank's ``PrototypeSlice`` through ``make_sharded_inference_fn(spatial=
    False, prototype_parallel=True)``; without, ``make_inference_fn`` with
    the whole bank.  Grid and upsampled statistics, f32 and bf16, the
    same sample pixels, launches counted around each.  With a mesh also
    one f32 batch of ``spatial=True`` and ``prototype_parallel=True``
    (the bank gathered) against ``spatial=True`` with the whole bank."""
    import numpy as np
    import torch
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.parallel.sharding import (
        make_sharded_inference_fn,
        prototype_parallel_params,
    )

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    K = cfg.model.num_classes
    pc = default_proto_class(cfg.model.num_prototypes, K, device=dev)
    img, lab = inp["eval_img"].to(dev), inp["eval_lab"].to(dev)
    rng = np.random.RandomState(SEED + 5)
    u, v = (torch.from_numpy(rng.random_sample((img.shape[0], N_RANDOM)).astype(np.float32))
            for _ in range(2))
    mean_std = (cfg.data.mean, cfg.data.std)
    models = sp_models(cfg, dev)
    res = {}

    def timed(fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        o = fn()
        torch.cuda.synchronize()
        return {"out": tp_keep(o), "launches": dict(_build.LAUNCHES),
                "secs": time.perf_counter() - t0}

    for tag in ("f32", "bf16"):
        model = models[tag].eval()
        tp = prototype_parallel_params(model, mesh) if mesh is not None else None

        def step(upsampled, spatial=False, parallel=True):
            if mesh is None:
                f = make_inference_fn(model, K, True, upsampled, normalize=mean_std, device=dev)
                return lambda: f(pc, img, lab, u, v)
            f = make_sharded_inference_fn(model, K, mesh, spatial=spatial, with_stats=True,
                                          prototype_parallel=parallel,
                                          stats_upsampled=upsampled, normalize=mean_std)
            return (lambda: f(tp, pc, img, lab, u, v)) if parallel else (
                lambda: f(pc, img, lab, u, v))

        step(False)()   # the whole frame's first batch in this dtype: not counted
        for upsampled in (False, True):
            res[(tag, upsampled)] = timed(step(upsampled))
        if tag == "f32" and mesh is not None:
            res["spatial whole bank"] = timed(step(True, spatial=True, parallel=False))
            res["spatial tp"] = timed(step(True, spatial=True))
        models[tag] = None
        del model
        torch.cuda.empty_cache()
    return res


def sp_cli_rank(dev, mesh_args, argv, root: str) -> None:
    """One rank of ``adlm_tpu_torch.cli``'s own (``_rank_main``), its
    output in ``root/cli_rank<r>.log``, under phase 15's cuDNN setting."""
    import os

    import torch
    from adlm_tpu_torch import cli

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    path = os.path.join(root, f"cli_rank{mesh_args['rank']}.log")
    with open(path, "w") as f, contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
        cli._rank_main(dev, mesh_args, argv)


def sp_spawn(fn, root: str, tag: str, args, devices=("cuda:0",) * SP_WORLD,
             backend: str = "gloo") -> None:
    import os

    from adlm_tpu_torch.core.mesh import spawn_local

    t0 = time.perf_counter()
    codes = spawn_local(fn, SP_WORLD, os.path.join(root, f"store_{tag}"),
                        list(devices), args=args, backend=backend,
                        timeout_s=SP_COLLECTIVE_TIMEOUT, join_timeout=SP_TIMEOUT)
    log(f"  [{tag}] {SP_WORLD} {backend} ranks on {', '.join(devices)} as a (data 1, model "
        f"{SP_WORLD}) mesh: exit codes {codes} in {time.perf_counter() - t0:.1f} s "
        "(process start-up included)")
    if codes != [0] * SP_WORLD:
        raise AssertionError(f"[{tag}] a rank failed: {codes}")


def sp_windows(ranks, tag: str) -> None:
    """Each rank's row-window kernel answer against the whole-frame kernel
    on the same map: the distance map the ranks computed, put together
    from their slabs (rows two slabs share must agree bit for bit)."""
    import torch
    from adlm_tpu_torch.ops.upsample_argmin import upsampled_argmin_cuda

    slabs = [res[tag]["window"] for res in ranks]
    h, size = slabs[0][2][1], slabs[0][4]
    d0 = slabs[0][0]
    full = torch.full((d0.shape[0], h) + tuple(d0.shape[2:]), math.nan)
    for d, _, (first, _), _, _ in slabs:
        rows = full[:, first:first + d.shape[1]]
        seen = ~rows.isnan().all(dim=(0, 2, 3))
        if not torch.equal(rows[:, seen], d[:, seen]):
            raise AssertionError(f"spatial {tag}: the ranks' slabs disagree on shared rows")
        full[:, first:first + d.shape[1]] = d
    if bool(full.isnan().any()):
        raise AssertionError(f"spatial {tag}: the slabs leave map rows out")
    with torch.inference_mode():
        whole = upsampled_argmin_cuda(full.cuda(), size).cpu()
    parts = []
    for r, (d, (o0, n), (first, _), out, _) in enumerate(slabs):
        bad = int((out != whole[:, o0:o0 + n]).sum())
        parts.append(f"rank {r}: rows [{o0}, {o0 + n}) from map rows [{first}, "
                     f"{first + d.shape[1]}), {bad} mismatches")
        if bad:
            raise AssertionError(f"spatial {tag}: rank {r}'s row window differs from the "
                                 "whole-frame kernel")
    log(f"  spatial {tag} row windows vs the whole-frame kernel on the ranks' map "
        f"({h} rows): " + "; ".join(parts))


SP_COUNTERS = ("intersection", "union", "correct", "total", "agree_counts")
SP_STACKED = ("agree_counts", "sample_d", "topk_purity")   # one row per image


def sp_distance(a, b, floats: bool = True) -> dict:
    """How far eval ``a`` sits from ``b`` (each ``dp_eval``'s output):
    summed |diff| of the counters and agree counts, and max |diff| of the
    sampled distances and of the purity."""
    (oa,), (ob,) = a[1], b[1]
    out = {k: int((oa[k].long() - ob[k].long()).abs().sum()) for k in SP_COUNTERS}
    for k in ("sample_d", "topk_purity") if floats else ():
        out[k] = (oa[k] - ob[k]).abs().max().item()
    return out


def sp_hold_bf16(tag: str, got, want, control, n_pixels: int) -> None:
    """bf16 spatial eval against the one-process bf16 eval ``want``: no
    further than SP_BF16_FACTOR times ``control`` (the same batch one
    image at a time, on the same sample pixels) is, plus phase 4's
    budgets (``total`` exact)."""
    budget = math.ceil(TIE_SHARE * n_pixels)
    extra = {"intersection": budget, "correct": budget, "total": 0, "union": 2 * budget,
             "agree_counts": 2 * budget, "topk_purity": 1e-3,
             "sample_d": D_ATOL + D_RTOL * want[1][0]["sample_d"].abs().max().item()}
    far, ctl = sp_distance(got, want), sp_distance(control, want)
    limits = {k: SP_BF16_FACTOR * ctl[k] + extra[k] for k in far}
    log(f"  {tag} vs the one-process bf16 eval: {far}; the control: {ctl}; limits {limits}")
    bad = [k for k in far if far[k] > limits[k] or (k == "total" and far[k])]
    if bad:
        raise AssertionError(f"{tag}: further from the one-process bf16 eval than "
                             f"{SP_BF16_FACTOR} x the control ({bad})")


def sp_hold_cli(label: str, run: str, prepared) -> None:
    """The eval's mIoU and per-class IoU files in ``run`` against phase
    15's one-process command's, bit for bit."""
    import json
    import os

    out = os.path.join(run, "evaluation", "push")
    with open(os.path.join(out, "mean_iou.txt")) as f:
        miou = f.read()
    with open(os.path.join(out, "iou_scores.json")) as f:
        ious = json.load(f)
    same_ious = ious == prepared["ious"]
    log(f"  {label} on the prepared val split: mIoU {miou}, the one-process command's "
        f"{prepared['miou']}; per-class IoU " + ("equal" if same_ious else "differ: max |diff| "
        f"{max(abs(v - prepared['ious'].get(k, math.inf)) for k, v in ious.items()):.3e}"))
    if miou != prepared["miou"] or not same_ious:
        raise AssertionError(f"{label}: mIoU or per-class IoU differ from the one-process "
                             "command's")


def sp_cli(root: str, prepared, label: str = "cityscapes_kld_imnet") -> None:
    """``eval-valid --stats --stats-upsampled --mesh-model 2`` on prepared
    frames (phase 15's, or ``msc_cli``'s) through the CLI's rank entry
    (two gloo ranks sharing the card), against the one-process command;
    on a machine with two cards, also ``python -m adlm_tpu_torch.cli``
    with the same arguments, which starts its own NCCL ranks, one card
    each."""
    import os

    import torch

    run, data = prepared["run"], prepared["data"]
    argv = ["eval-valid", run, "push", "--data-path", data, "--stats", "--stats-upsampled",
            "--batch-size", str(PREP_EVAL_BS), "--examples", "0",
            "--mesh-model", str(SP_WORLD)]
    logs = [os.path.join(root, f"cli_rank{r}.log") for r in range(SP_WORLD)]
    try:
        sp_spawn(sp_cli_rank, root, "cli", (argv, root))
    except AssertionError:
        for p in logs:
            if os.path.exists(p):
                with open(p) as f:
                    log("\n".join(f.read().splitlines()[-30:]))
        raise
    sp_hold_cli(f"{label} eval-valid --mesh-model {SP_WORLD} (CLI rank entry, gloo)", run,
                prepared)
    if torch.cuda.device_count() < 2:
        return
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "adlm_tpu_torch.cli", *argv],
                          capture_output=True, text=True, timeout=SP_TIMEOUT)
    log(f"  python -m adlm_tpu_torch.cli eval-valid ({label}) --mesh-model {SP_WORLD} (NCCL, "
        f"cuda:0 and cuda:1): exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        log("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]))
        raise AssertionError(f"eval-valid --mesh-model {SP_WORLD} on {SP_WORLD} cards failed")
    sp_hold_cli(f"{label} eval-valid --mesh-model {SP_WORLD} (NCCL)", run, prepared)


def sp_compare(ranks, single, report, label: str, n_pixels: int, exact: bool = False) -> None:
    """Each rank of a spatial world against this process's one-process
    evals: f32 within phase 4's budgets (``exact``: 0 apart on every
    counter, agree count, sampled distance and purity), bf16 by
    ``sp_hold_bf16``; one head and one upsample-argmin launch per rank;
    the same totals on every rank; the row windows against the
    whole-frame kernel."""
    import torch
    from adlm_tpu_torch.ops import _build

    for tag in ("f32", "bf16"):
        want = single[tag]["eval"]
        for r, res in enumerate(ranks):
            name = f"spatial {label} {tag} rank {r}"
            if tag == "f32":
                far = sp_distance(res[tag]["eval"], want)
                log(f"  {name} vs one process: {far}, {res[tag]['secs']:.2f} s (one process "
                    f"{single[tag]['secs']:.2f} s)")
                if exact and any(far.values()):
                    raise AssertionError(f"{name}: not equal to the one-process eval")
                if not exact:
                    compare_eval(name, res[tag]["eval"], want, n_pixels)
            else:
                sp_hold_bf16(name, res[tag]["eval"], want, single["bf16 b1"], n_pixels)
            got = res[tag]["launches"]
            log(f"  {name}: launches {got}, the one-process eval's {single[tag]['launches']}")
            if got["prototype_head"] != 1 or got["upsample_argmin"] != 1:
                raise AssertionError(f"{name} launched {got}, expected one head and one "
                                     "upsample-argmin launch")
            for k in _build.KERNELS:
                report[k]["launches"] += got[k]
        keys = ("intersection", "union", "correct", "total", "agree_counts", "topk_purity")
        first = ranks[0][tag]["eval"][1][0]
        if not all(torch.equal(first[k], res[tag]["eval"][1][0][k])
                   for res in ranks[1:] for k in keys):
            raise AssertionError(f"spatial {label} {tag}: the ranks' totals differ")
        log(f"  spatial {label} {tag}: both ranks hold the same counters, agree_counts and "
            f"purity; mIoU {ranks[0][tag]['eval'][0]['mean_iou']!r}, one process "
            f"{want[0]['mean_iou']!r}")
        sp_windows(ranks, tag)


def tp_compare(ranks, single, report, label: str, n_pixels: int) -> None:
    """Each rank of the tensor-parallel head against this process's
    whole-bank eval: the counters within phase 4's tie budget (the logits
    are a sum of two partial products, so a near-tie may flip; the
    pixels that moved are printed), ``nearest_proto`` bit-equal, ``agree_counts`` apart by no
    more than the statistic's predicted classes that moved, purity at
    ``TP_PURITY``; launches: one head per batch, and one upsample-argmin
    with upsampled statistics; every rank the same outputs (the SUM gives
    every model rank the same bits).  Then the spatial batch with the
    gathered bank against the spatial batch with the whole bank, bit for
    bit on every output of the rank."""
    import torch
    from adlm_tpu_torch.ops import _build

    budget = math.ceil(TIE_SHARE * n_pixels)
    limits = {"intersection": budget, "correct": budget, "total": 0, "union": 2 * budget}
    for tag in ("f32", "bf16"):
        for upsampled in (False, True):
            mode = "upsampled" if upsampled else "grid"
            want = single[(tag, upsampled)]["out"]
            for r, res in enumerate(ranks):
                got = res[(tag, upsampled)]
                o = got["out"]
                name = f"tensor-parallel head {label} {tag} {mode} rank {r}"
                moved = int((o["pred"] != want["pred"]).sum())
                stat_moved = int((o["stat_pred"] != want["stat_pred"]).sum())
                diffs = {k: int((o[k].long() - want[k].long()).abs().sum()) for k in limits}
                agree = int((o["agree_counts"].long() - want["agree_counts"].long()).abs().sum())
                near = torch.equal(o["nearest_proto"], want["nearest_proto"])
                pur = (o["topk_purity"] - want["topk_purity"]).abs().max().item()
                pur_ok = bool(torch.allclose(o["topk_purity"], want["topk_purity"], **TP_PURITY))
                log(f"  {name} vs one process: pixels moved {moved}, counters {diffs} (budget "
                    f"{budget} px, x2 for union), nearest_proto bit-equal {near}, agree_counts "
                    f"{agree} apart ({stat_moved} statistic classes moved), purity max |diff| "
                    f"{pur:.3e}; launches {got['launches']}; {got['secs']:.2f} s (one process "
                    f"{single[(tag, upsampled)]['secs']:.2f} s)")
                if (any(diffs[k] > v for k, v in limits.items())
                        or not near or agree > stat_moved or not pur_ok):
                    raise AssertionError(f"{name}: differs from the one-process eval")
                if got["launches"] != {"prototype_head": 1, "upsample_argmin": int(upsampled)}:
                    raise AssertionError(f"{name}: launched {got['launches']}")
                for k in _build.KERNELS:
                    report[k]["launches"] += got["launches"][k]
            first = ranks[0][(tag, upsampled)]["out"]
            if not all(torch.equal(first[k], res[(tag, upsampled)]["out"][k])
                       for res in ranks[1:] for k in first):
                raise AssertionError(f"tensor-parallel head {label} {tag} {mode}: the ranks' "
                                     "outputs differ")
            log(f"  tensor-parallel head {label} {tag} {mode}: every rank holds the same "
                "prediction, counters, nearest_proto, agree_counts and purity")
    for r, res in enumerate(ranks):
        whole, got = res["spatial whole bank"], res["spatial tp"]
        same = all(torch.equal(whole["out"][k], got["out"][k]) for k in whole["out"])
        log(f"  spatial + tensor-parallel {label} f32 rank {r} (bank gathered) vs spatial with "
            f"the whole bank: bit-equal {same}; launches {got['launches']}; "
            f"{got['secs']:.2f} s ({whole['secs']:.2f} s)")
        if not same or got["launches"] != {"prototype_head": 1, "upsample_argmin": 1}:
            raise AssertionError(f"spatial + tensor-parallel {label} rank {r} differs")
        for k in _build.KERNELS:
            report[k]["launches"] += got["launches"][k]


def msc_cli(root: str) -> None:
    """``eval-valid --stats --stats-upsampled --mesh-model 2`` of the MSC
    experiment through the CLI (``sp_cli``) against the one-process
    command, on a val split this phase writes in the prepared ``.npy``
    layout (PASCAL-sized frames, raw ids 0..20 and a band of 255) and a
    run imported from the seeded model (``import-protoseg``)."""
    import json
    import os

    import numpy as np
    import torch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    data, results = os.path.join(root, "msc_data"), os.path.join(root, "msc_runs")
    ids = [f"val{i}" for i in range(MSC_CLI_FRAMES)]
    for sub in ("img_with_margin_0", "annotations"):
        os.makedirs(os.path.join(data, sub, "val"))
    frames = make_batches(MSC_CLI_FRAMES // 2, 2, SEED + 75, MSC_CLI_HW, 22)
    imgs = torch.cat([i for i, _ in frames]).cpu().numpy()
    labs = torch.cat([lb for _, lb in frames]).cpu().numpy()
    for i, fid in enumerate(ids):
        np.save(os.path.join(data, "img_with_margin_0", "val", f"{fid}.npy"), imgs[i])
        raw = np.where(labs[i] == 0, 255, labs[i].astype(np.int32) - 1).astype(np.uint8)
        np.save(os.path.join(data, "annotations", "val", f"{fid}.npy"), raw)
    with open(os.path.join(data, "all_images.json"), "w") as f:
        json.dump({"train": [], "val": ids}, f)
    from adlm_tpu_torch.core.config import get_experiment

    m32 = random_model(get_experiment(MSC_EXPERIMENT).model, SEED)
    sd = {k: v.detach().cpu() for k, v in m32.state_dict().items()}
    del m32
    for k in list(sd):   # the reference's layout, as phase 15 writes it
        if k.endswith("bn.running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    ckpt = os.path.join(root, "msc.pth")
    torch.save(sd, ckpt)
    saved_env = os.environ.get("RESULTS_DIR")
    os.environ["RESULTS_DIR"] = results
    rec, launches = {"first_window": None}, []
    try:
        run_command(["import-protoseg", MSC_EXPERIMENT, "msc", ckpt], rec, launches)
        run = os.path.join(results, "msc")
        run_command(["eval-valid", run, "push", "--data-path", data, "--stats",
                     "--stats-upsampled", "--batch-size", str(PREP_EVAL_BS), "--examples", "0"],
                    rec, launches)
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
    n_batches = MSC_CLI_FRAMES // PREP_EVAL_BS
    if launches[-1][1] != {"prototype_head": n_batches, "upsample_argmin": n_batches}:
        raise AssertionError(f"{MSC_EXPERIMENT} eval-valid launched {launches[-1][1]}")
    out = os.path.join(run, "evaluation", "push")
    with open(os.path.join(out, "mean_iou.txt")) as f:
        miou = f.read()
    with open(os.path.join(out, "iou_scores.json")) as f:
        ious = json.load(f)
    sp_cli(root, {"run": run, "data": data, "miou": miou, "ious": ious}, MSC_EXPERIMENT)


def check_spatial(report, card: str, prepared) -> None:
    """Phase 17: spatial eval of the flagship at full width on two gloo
    ranks sharing the card, against this process's one-process eval; the
    row windows against the whole-frame kernel; the tensor-parallel head
    (spatial off, then on) and spatial eval of the MSC model on the same
    ranks; then eval-valid --mesh-model 2 through the CLI, the flagship's
    and the MSC model's.  On two cards or more, the same on two NCCL
    ranks, one card each."""
    import os
    import shutil
    import tempfile

    import torch
    from adlm_tpu_torch.core.config import get_experiment

    t_phase = time.perf_counter()
    cfg = get_experiment("cityscapes_kld_imnet")
    root = tempfile.mkdtemp(prefix="adlm_sp_")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    n_cards = torch.cuda.device_count()
    worlds = [("gloo", ("cuda:0",) * SP_WORLD)]
    if n_cards >= SP_WORLD:
        worlds.append(("nccl", tuple(f"cuda:{r}" for r in range(SP_WORLD))))
    try:
        in_path = os.path.join(root, "inputs.pt")
        sp_inputs(in_path)
        ranks = {}
        for backend, devices in worlds:
            out = os.path.join(root, backend)
            os.makedirs(out)
            sp_spawn(sp_rank, root, backend, (in_path, out), devices, backend)
            ranks[backend] = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                              for r in range(SP_WORLD)]
        inp = torch.load(in_path, weights_only=False)
        dev = torch.device("cuda", 0)
        t0 = time.perf_counter()
        single = sp_work(cfg, inp["flagship"], dev, None)
        single_tp = tp_work(cfg, inp["flagship"], dev, None)
        single_msc = sp_work(get_experiment(MSC_EXPERIMENT), inp["msc"], dev, None)
        log(f"  the one-process evals (flagship, its grid and upsampled statistics, "
            f"{MSC_EXPERIMENT}): {time.perf_counter() - t0:.1f} s")
        n_pixels, n_msc = 2 * H * W, 2 * MSC_HW[0] * MSC_HW[1]
        for name, one, n in (("", single, n_pixels), (f"{MSC_EXPERIMENT} ", single_msc, n_msc)):
            log(f"  control: the one-process {name}bf16 eval one image at a time vs the batch "
                f"of 2, on the same sample pixels: "
                f"{sp_distance(one['bf16 b1'], one['bf16']['eval'])} (phase 4's budget "
                f"{math.ceil(TIE_SHARE * n)} px)")
        for backend, devices in worlds:
            sp_compare([res["spatial"] for res in ranks[backend]], single, report, backend,
                       n_pixels)
            tp_compare([res["tp"] for res in ranks[backend]], single_tp, report, backend,
                       n_pixels)
            sp_compare([res["msc"] for res in ranks[backend]], single_msc, report,
                       f"{MSC_EXPERIMENT} {backend}", n_msc, exact=True)
            log(f"  seconds per batch of 2 on each {backend} rank ("
                + ("host-staged collectives on one shared card: not a speed figure"
                   if backend == "gloo" else "one card each") + "): " + "; ".join(
                    f"{case} {tag} rank {r} {res[key][tag]['secs']:.2f} (one process "
                    f"{one[tag]['secs']:.2f})" for case, key, one in (
                        ("flagship", "spatial", single), (MSC_EXPERIMENT, "msc", single_msc))
                    for tag in ("f32", "bf16") for r, res in enumerate(ranks[backend]))
                + f"  [{card}]")
        if len(worlds) == 1:
            log(f"  two NCCL ranks, one card each, and python -m adlm_tpu_torch.cli "
                f"eval-valid --mesh-model {SP_WORLD}: skipped, this machine has one card")
        del single, single_tp, single_msc, ranks
        torch.cuda.empty_cache()
        sp_cli(root, prepared)
        t0 = time.perf_counter()
        msc_cli(root)
        log(f"  {MSC_EXPERIMENT} CLI case {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 17 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: JPEG.  The host library's decoder against PIL's pixels (the
# committed manifest of tests/fixtures/torch_jpeg), preprocess-pascal on a
# VOC tree of the fixtures' PASCAL-sized frames, eval-valid of
# pascal_kld_imnet on the prepared val split, and a JPEG class folder fed
# to the classifier
# ---------------------------------------------------------------------------

JPEG_FIXTURES = ("tests", "fixtures", "torch_jpeg")
# the fixtures' four frames at PASCAL's shapes (375x500, 500x375, 333x500,
# 375x500; PIL's defaults, quality 75, 4:2:0) under VOC-style ids: 4 of
# PASCAL's 1,449 val and 10,582 train_aug frames
JPEG_PASCAL = {"2007_000032": "pascal_0.jpg", "2007_000039": "pascal_1.jpg",
               "2008_000123": "pascal_2.jpg", "2009_000001": "pascal_3.jpg"}
JPEG_DECODES = 9        # decodes of each frame; the median is kept
JPEG_EXPERIMENT = "pascal_kld_imnet"
# eval-valid's default batch: PASCAL's frames differ in shape, and the
# eval dataset stacks each frame's labels at its own shape
JPEG_EVAL_BS = 1
# the class folder (2 classes) fed to cls-train at phase 12's preset
# (VGG19 224^2, P = 2000, C = 128, K = 200: --num-classes keeps K at the
# preset's 200 over the folder's 2), one warm epoch, no push
JPEG_CLASSES = {"class_000": ("pascal_0.jpg", "pascal_1.jpg", "pascal_2.jpg",
                              "pascal_3.jpg", "q95_444.jpg", "q100_optimize.jpg", "q10.jpg"),
                "class_001": ("grey.jpg", "s422.jpg", "progressive.jpg",
                              "progressive_grey.jpg", "restart.jpg", "adobe_rgb.jpg")}
JPEG_CLS_ARGS = ("--epochs", "1", "--warm-epochs", "1", "--push-start", "2",
                 "--num-classes", str(200))


def host_cpu() -> str:
    """The host's CPU: its architecture, the model ``/proc/cpuinfo`` names
    (x86's "model name", or an Arm core's implementer and part), and the
    core count."""
    import os
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or (
        f"implementer {fields['CPU implementer']} part {fields['CPU part']}"
        if "CPU part" in fields else "model not named")
    return f"{platform.machine()} {model}, {os.cpu_count()} cores"


def jpeg_decode_check(root: str, fixtures: str, where: str):
    """(a) The host library built afresh by this host's g++ into a
    directory of its own; every fixture decoded through it to the
    manifest's pixels (shape and SHA-256 of PIL's ``convert("RGB")``);
    the median ms per PASCAL-sized frame.  Returns {fixture: pixels}."""
    import hashlib
    import os
    import statistics

    from adlm_tpu_torch import native
    from adlm_tpu_torch.data.image_folder import load_rgb

    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    saved = (native.BUILD_DIR, native._lib)
    native.BUILD_DIR, native._lib = os.path.join(root, "build"), None
    try:
        t0 = time.perf_counter()
        lib = native.build()
        build_s = time.perf_counter() - t0
        decoded = {}
        for name in sorted(manifest):
            px = load_rgb(os.path.join(fixtures, name))
            want = manifest[name]
            if (list(px.shape) != want["shape"]
                    or hashlib.sha256(px.tobytes()).hexdigest() != want["sha256"]):
                raise AssertionError(f"{name}: decoded {px.shape}, not the manifest's pixels "
                                     f"{want['shape']} ({want['mode']})")
            decoded[name] = px
        ms = {}
        for name in JPEG_PASCAL.values():
            with open(os.path.join(fixtures, name), "rb") as f:
                data = f.read()
            times = []
            for _ in range(JPEG_DECODES):
                t0 = time.perf_counter()
                native.decode_jpeg(data, name)
                times.append(time.perf_counter() - t0)
            ms[name] = statistics.median(times) * 1e3
    finally:
        native.BUILD_DIR, native._lib = saved
    log(f"  host library built by {gxx.splitlines()[0] if gxx else 'g++'} in {build_s:.1f} s "
        f"({os.path.basename(lib)}); {len(decoded)} fixtures decoded to the manifest's pixels "
        f"(PIL's convert('RGB'), SHA-256 and shape)")
    log("  decode ms per PASCAL-sized frame (median of "
        f"{JPEG_DECODES}): " + ", ".join(f"{n} {decoded[n].shape[1]}x{decoded[n].shape[0]} "
                                          f"{v:.3f}" for n, v in ms.items())
        + f"  [host: {host_cpu()}; {where}]")
    return decoded


def write_voc(voc: str, fixtures: str, decoded, seed: int):
    """A VOC 2012 + SegmentationClassAug tree of the PASCAL-sized
    fixtures: ``JPEGImages/<id>.jpg``, 8-bit grey labels 0..20 in 25-pixel
    blocks with a void (255) band (``write_png``), SBD's two-column
    ``train_aug.txt`` and ``val.txt`` listing every frame.  Returns
    {id: label}."""
    import os
    import shutil

    import numpy as np
    from adlm_tpu_torch.data.image_folder import write_png

    rng = np.random.RandomState(seed)
    split_dir = os.path.join(voc, "ImageSets", "SegmentationAug")
    for sub in ("JPEGImages", "SegmentationClassAug", split_dir):
        os.makedirs(os.path.join(voc, sub))
    labels = {}
    for fid, name in JPEG_PASCAL.items():
        shutil.copy(os.path.join(fixtures, name), os.path.join(voc, "JPEGImages", fid + ".jpg"))
        h, w = decoded[name].shape[:2]
        blocks = rng.randint(0, 21, (-(-h // 25), -(-w // 25)))
        lab = np.repeat(np.repeat(blocks, 25, 0), 25, 1)[:h, :w].astype(np.uint8)
        lab[:, :16] = 255
        write_png(os.path.join(voc, "SegmentationClassAug", fid + ".png"), lab)
        labels[fid] = lab
    lines = "".join(f"/JPEGImages/{fid}.jpg /SegmentationClassAug/{fid}.png\n"
                    for fid in JPEG_PASCAL)
    for split_file in ("train_aug.txt", "val.txt"):
        with open(os.path.join(split_dir, split_file), "w") as f:
            f.write(lines)
    return labels


def jpeg_prepare_check(root: str, fixtures: str, decoded, where: str) -> str:
    """(b) ``preprocess-pascal`` as a user runs it (a process of its own)
    on a VOC tree of the fixtures: every prepared image ``.npy`` and PNG
    equal to the manifest's pixels, every label ``.npy`` to the label
    written, ``all_images.json`` the sorted ids; then the function in
    this process on the same tree, byte-equal, for the host seconds per
    frame without the interpreter's start.  Returns the prepared root."""
    import os
    import shutil

    import numpy as np
    from adlm_tpu_torch.data.image_folder import read_png
    from adlm_tpu_torch.data.preprocess import preprocess_pascal

    voc, out = os.path.join(root, "voc"), os.path.join(root, "pascal")
    labels = write_voc(voc, fixtures, decoded, SEED + 81)
    secs_cli, _ = prep_command(cli_argv("preprocess-pascal", voc, out), "preprocess-pascal")
    ids = sorted(JPEG_PASCAL)
    with open(os.path.join(out, "all_images.json")) as f:
        if json.load(f) != {"train": ids, "val": ids}:
            raise AssertionError("preprocess-pascal listed other ids")
    for split in ("train", "val"):
        for fid, name in JPEG_PASCAL.items():
            stem = os.path.join(out, "img_with_margin_0", split, fid)
            img, png = np.load(stem + ".npy"), read_png(stem + ".png")
            lab = np.load(os.path.join(out, "annotations", split, fid + ".npy"))
            if (img.dtype != np.uint8 or not np.array_equal(img, decoded[name])
                    or not np.array_equal(png, decoded[name])
                    or lab.dtype != np.uint8 or not np.array_equal(lab, labels[fid])):
                raise AssertionError(f"preprocess-pascal: {split}/{fid} differs from the "
                                     "manifest's pixels or the label written")
    again = os.path.join(root, "pascal_fn")
    t0 = time.perf_counter()
    preprocess_pascal(voc, again)
    secs_fn = time.perf_counter() - t0
    n_files = same_files(again, out)
    shutil.rmtree(again)
    n = 2 * len(JPEG_PASCAL)
    log(f"  preprocess-pascal (CLI, its own process): {secs_cli:.2f} s, {secs_cli / n:.3f} s per "
        f"frame over {n} (4 train_aug + 4 val), images equal to the manifest's pixels, labels "
        f"to those written; the function in process: {secs_fn:.3f} s, {secs_fn / n:.4f} s per "
        f"frame ({n_files} files byte-equal)  [host: {host_cpu()}; {where}]")
    return out


def jpeg_eval_check(report, root: str, data: str) -> None:
    """(c) ``import-protoseg`` of the seeded ``pascal_kld_imnet`` and
    ``eval-valid --stats --stats-upsampled`` on the prepared val split
    (eval-valid's default batch of 1, its 513x513 eval resize, f32 IEEE,
    cuDNN deterministic); against the same frames through the eval
    dataset in this process, with the kernels (every count and sampled
    distance bit-equal) and with their plain versions (phase 4's tie
    budget and near-tie rule).  One head and one upsample-argmin launch
    per batch."""
    import os

    import numpy as np
    import torch
    import adlm_tpu_torch.interpret.evaluate as ev_mod
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.ops import _build

    cfg = get_experiment(JPEG_EXPERIMENT)
    results = os.path.join(root, "runs")
    m32 = random_model(cfg.model, SEED)
    sd = {k: v.detach().cpu() for k, v in m32.state_dict().items()}
    del m32
    for k in list(sd):   # the reference's layout, as phases 15 and 17 write it
        if k.endswith("bn.running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    ckpt = os.path.join(root, "pascal.pth")
    torch.save(sd, ckpt)
    del sd
    saved_env = os.environ.get("RESULTS_DIR")
    saved_det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    os.environ["RESULTS_DIR"] = results
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    rec, launches = {"first_window": None}, []
    try:
        run_command(["import-protoseg", JPEG_EXPERIMENT, "jpeg", ckpt], rec, launches)
        run = os.path.join(results, "jpeg")
        with _RecordedEvaluators() as recorded:
            secs, _ = run_command(["eval-valid", run, "push", "--data-path", data, "--stats",
                                   "--stats-upsampled", "--batch-size", str(JPEG_EVAL_BS),
                                   "--examples", "0"], rec, launches)
        (cli_ev,) = recorded.instances
        res, cli_outs = cli_ev.results(), recorded.outs

        _, payload, model = cli._load_stage(run, "push", "last", "cuda")
        pc = payload["proto_class"]
        ds = SegmentationDataset(cfg.data, "val", data_path=data, is_eval=True)
        raw = ds.supports_raw_eval()
        items = list(ds.eval_batches(JPEG_EVAL_BS, with_counts=True, raw=raw))
        n_pixels = sum(int(np.prod(lab.shape)) for _, lab, _ in items)

        def direct():
            with _RecordedEvaluators() as r:    # it patches ev_mod.SegEvaluator
                ev = ev_mod.SegEvaluator(model, cfg.model.num_classes, with_stats=True,
                                  stats_upsampled=True,
                                  normalize=(cfg.data.mean, cfg.data.std) if raw else None,
                                  device="cuda")
                for img, lab, _ in items:
                    ev.update(pc, torch.from_numpy(img).cuda(), torch.from_numpy(lab).cuda())
            return ev.results(), r.outs

        torch.cuda.synchronize()
        _build.reset_launches()
        got = direct()
        direct_launches = dict(_build.LAUNCHES)
        with plain_versions():
            want = direct()
        if dict(_build.LAUNCHES) != direct_launches:
            raise AssertionError("the plain run launched a kernel")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
    differ = [k for a, b in zip(cli_outs, got[1]) for k in b if not torch.equal(a[k], b[k])]
    same = (res["mean_iou"] == got[0]["mean_iou"]
            and res["iou_per_class"] == got[0]["iou_per_class"]
            and res["pixel_accuracy"] == got[0]["pixel_accuracy"])
    n_batches = len(items)
    log(f"  eval-valid --stats --stats-upsampled on the prepared val split ({len(ds)} frames, "
        f"batch {JPEG_EVAL_BS}, {n_batches} batches): {secs:.2f} s, {secs / n_batches:.3f} s per "
        f"batch; mIoU {res['mean_iou']!r}, direct from the eval dataset {got[0]['mean_iou']!r}; "
        f"outputs that differ {sorted(set(differ))}")
    if (not same or differ or not len(cli_outs) == len(got[1]) == len(want[1]) == n_batches
            or not math.isfinite(res["mean_iou"])):
        raise AssertionError("eval-valid on the prepared PASCAL split differs from the direct "
                             "evaluation of the same frames")
    compare_eval(f"{JPEG_EXPERIMENT} prepared", got, want, n_pixels, proto_class=pc)
    (_, imp), (_, evl) = launches
    for name in _build.KERNELS:
        report[name]["launches"] += evl[name]
    if (any(imp.values()) or evl != {k: n_batches for k in _build.KERNELS}
            or direct_launches != evl):
        raise AssertionError(f"launches: import-protoseg {imp}, eval-valid {evl}, direct "
                             f"{direct_launches}; expected {n_batches} of each kernel")


def jpeg_folder_check(report, root: str, fixtures: str) -> None:
    """(d) A JPEG class folder of the fixtures (2 classes) against the same
    folder written as ``.npy`` from the decoded pixels: every batch
    ``ImageFolderDataset`` gives, shuffled and with counts, bit-equal;
    then one warm epoch of ``cls-train`` on the JPEG folder at the
    preset's width, its head launches (the general path: P = 2000) counted."""
    import csv
    import os
    import shutil

    import numpy as np
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset, read_jpeg
    from adlm_tpu_torch.ops import _build

    jpeg_dir, npy_dir = os.path.join(root, "cls_jpeg"), os.path.join(root, "cls_npy")
    for cls, names in JPEG_CLASSES.items():
        os.makedirs(os.path.join(jpeg_dir, cls))
        os.makedirs(os.path.join(npy_dir, cls))
        for name in names:
            src = os.path.join(fixtures, name)
            shutil.copy(src, os.path.join(jpeg_dir, cls, name))
            np.save(os.path.join(npy_dir, cls, name[:-len(".jpg")] + ".npy"), read_jpeg(src))
    jd, nd = ImageFolderDataset(jpeg_dir, CLS_HW), ImageFolderDataset(npy_dir, CLS_HW)
    n_batches = 0
    for kw in (dict(shuffle=True, seed=0), dict(with_count=True)):
        for a, b in zip(jd.batches(CLS_BS, **kw), nd.batches(CLS_BS, **kw), strict=True):
            n_batches += 1
            if any(not np.array_equal(x, y) for x, y in zip(a, b, strict=True)):
                raise AssertionError("the JPEG folder's batches differ from the .npy folder's")
    t0 = time.perf_counter()
    for _ in jd.batches(CLS_BS):
        pass
    secs_batch = time.perf_counter() - t0
    log(f"  JPEG class folder ({len(jd)} images, 2 classes) bit-equal to its .npy folder over "
        f"{n_batches} batches of {CLS_BS} at {CLS_HW}^2; one batch decoded and resized in "
        f"{secs_batch:.3f} s on 8 threads")
    results = os.path.join(root, "cls_runs")
    saved_env = os.environ.get("RESULTS_DIR")
    os.environ["RESULTS_DIR"] = results
    try:
        cls_command(["cls-train", "jpeg", *JPEG_CLS_ARGS, "--train-dir", jpeg_dir,
                     "--test-dir", jpeg_dir])
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
    launches = dict(_build.LAUNCHES)
    with open(os.path.join(results, "jpeg", "logs", "classification_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    log("  cls-train on the JPEG folder: rows " + ", ".join(
        f"{r['phase']} accuracy {float(r['accuracy']):.4f}" for r in rows)
        + f"; launches {launches}")
    if [r["phase"] for r in rows] != ["warm"] or launches["prototype_head"] < 2:
        raise AssertionError(f"cls-train on the JPEG folder: rows {rows}, launches {launches}")
    report["prototype_head"]["launches"] += launches["prototype_head"]


def check_jpeg(report, card: str) -> None:
    """Phase 18: (a) the decoder, built by this host's g++, against the
    manifest of PIL's pixels; (b) preprocess-pascal on a VOC tree of the
    fixtures; (c) eval-valid of pascal_kld_imnet on the prepared frames
    against the direct evaluation, kernels and plain versions; (d) a JPEG
    class folder against its .npy twin, and cls-train on it."""
    import os
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), *JPEG_FIXTURES)
    root = tempfile.mkdtemp(prefix="adlm_jpeg_")
    try:
        decoded = jpeg_decode_check(root, fixtures, card)
        t0 = time.perf_counter()
        data = jpeg_prepare_check(root, fixtures, decoded, card)
        log(f"  (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        jpeg_eval_check(report, root, data)
        log(f"  (c) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        jpeg_folder_check(report, root, fixtures)
        log(f"  (d) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 18 {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 19: the classifier's offline augmentation (data/img_aug.py) on the
# card's host, byte for byte against the committed manifest of the JAX
# function's files, then cls-train on the augmented folder
# ---------------------------------------------------------------------------

IMG_AUG_FIXTURES = ("tests", "fixtures", "torch_img_aug")
IMG_AUG_REPEATS = 5     # warps and encodes of each PASCAL-sized output; the median is kept


def img_aug_bytes_check(root: str, where: str) -> str:
    """(a) The manifest's tree of fixtures through ``augment_directory``
    at its seed and copies: the count, every file name, size and SHA-256
    equal to the manifest (PIL's bytes); then the warp and the encoder
    timed apart on the PASCAL-sized sources.  Returns the augmented
    folder."""
    import importlib.util
    import os
    import random
    import statistics

    from adlm_tpu_torch import native
    from adlm_tpu_torch.data import img_aug
    from adlm_tpu_torch.data.image_folder import image_comment, load_rgb

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), *IMG_AUG_FIXTURES)
    spec = importlib.util.spec_from_file_location(
        "img_aug_fixtures", os.path.join(fixtures, "make_fixtures.py"))
    mf = importlib.util.module_from_spec(spec)     # build_tree, outputs: no PIL
    spec.loader.exec_module(mf)
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    src, dst = os.path.join(root, "src"), os.path.join(root, "aug")
    mf.build_tree(manifest["tree"], src)
    t0 = time.perf_counter()
    native._load()     # built by phase 9 in a whole run; timed apart from the work
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = img_aug.augment_directory(src, dst, copies_per_op=manifest["copies_per_op"],
                                  seed=manifest["seed"])
    secs = time.perf_counter() - t0
    got, want = mf.outputs(dst), manifest["outputs"]
    differ = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    if n != len(want) or differ:
        raise AssertionError(f"augment_directory wrote {n} files, the manifest {len(want)}; "
                             f"names or bytes differ: {differ[:8]}")
    warp_ms, enc_ms, sizes = [], [], []
    rng = random.Random(SEED)
    for rel in manifest["tree"]["class_000"]:
        path = os.path.join(src, "class_000", os.path.basename(rel))
        img, comment = load_rgb(path), image_comment(path)
        for op in ("rotate", "shear", "skew"):
            tw, te = [], []
            for _ in range(IMG_AUG_REPEATS):
                t0 = time.perf_counter()
                out = img_aug._affine(img, op, rng)
                t1 = time.perf_counter()
                data = native.encode_jpeg(out, comment)
                te.append(time.perf_counter() - t1)
                tw.append(t1 - t0)
            warp_ms.append(statistics.median(tw) * 1e3)
            enc_ms.append(statistics.median(te) * 1e3)
            sizes.append(len(data))
    w, e = statistics.median(warp_ms), statistics.median(enc_ms)
    log(f"  augment_directory: {n} files ({len(manifest['tree'])} classes, "
        f"{sum(map(len, manifest['tree'].values()))} sources, {manifest['copies_per_op']} "
        f"copies per operation, seed {manifest['seed']}) in {secs:.3f} s (the host library "
        f"built or loaded before in {load_s:.3f} s), every name, size and SHA-256 equal to the "
        "manifest of PIL's files")
    log(f"  ms per PASCAL-sized output (median over {len(warp_ms)} source x operation cells, "
        f"each the median of {IMG_AUG_REPEATS}): warp {w:.3f} + encode {e:.3f} = {w + e:.3f} "
        f"(warp cells {min(warp_ms):.3f}..{max(warp_ms):.3f}, encode cells "
        f"{min(enc_ms):.3f}..{max(enc_ms):.3f}; {statistics.mean(sizes) / 1e3:.1f} KB a file)  "
        f"[host: {host_cpu()}; {where}]")
    return dst


def check_img_aug(report, card: str) -> None:
    """Phase 19: (a) ``augment_directory`` on the manifest's tree, byte for
    byte; (b) one warm epoch of ``cls-train`` on the augmented folder at
    phase 12's preset (P = 2000: the head's general path), its head
    launches counted."""
    import csv
    import os
    import shutil
    import tempfile

    from adlm_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adlm_img_aug_")
    saved_env = os.environ.get("RESULTS_DIR")
    try:
        aug = img_aug_bytes_check(root, card)
        log(f"  (a) {time.perf_counter() - t_phase:.1f} s")
        t0 = time.perf_counter()
        results = os.path.join(root, "cls_runs")
        os.environ["RESULTS_DIR"] = results
        cls_command(["cls-train", "aug", *JPEG_CLS_ARGS, "--train-dir", aug,
                     "--test-dir", aug])
        launches = dict(_build.LAUNCHES)
        with open(os.path.join(results, "aug", "logs", "classification_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        log("  cls-train on the augmented folder: rows " + ", ".join(
            f"{r['phase']} accuracy {float(r['accuracy']):.4f}" for r in rows)
            + f"; launches {launches}")
        if [r["phase"] for r in rows] != ["warm"] or launches["prototype_head"] < 2:
            raise AssertionError(f"cls-train on the augmented folder: rows {rows}, "
                                 f"launches {launches}")
        report["prototype_head"]["launches"] += launches["prototype_head"]
        log(f"  (b) {time.perf_counter() - t0:.1f} s")
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 19 {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# phase 20: the PNG and BMP readers on the card's host against the
# committed manifest of PIL's readings, their host read times, then
# cls-train on a folder of them
# ---------------------------------------------------------------------------

PNG_BMP_FIXTURES = ("tests", "fixtures", "torch_png_bmp")
PNG_BMP_READS = 5       # reads of each PASCAL-sized file; the median is kept


def png_bmp_read_check(root: str, where: str) -> str:
    """(a) Every fixture through ``read_png``/``read_bmp`` and ``load_rgb``
    against the manifest (dtype, shape and digest of PIL's ``np.asarray``
    and ``convert("RGB")``); (b) the PASCAL-sized files written by the
    fixtures' encoders, each read back to the encoder's input, timed.
    Returns a 2-class folder of all of them (BMPs, PNGs)."""
    import importlib.util
    import os
    import shutil
    import statistics

    import numpy as np
    from adlm_tpu_torch.data.image_folder import load_rgb, read_bmp, read_png

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), *PNG_BMP_FIXTURES)
    spec = importlib.util.spec_from_file_location(
        "png_bmp_fixtures", os.path.join(fixtures, "make_fixtures.py"))
    mf = importlib.util.module_from_spec(spec)     # the encoders, digest: no PIL
    spec.loader.exec_module(mf)
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    folder = os.path.join(root, "cls_png_bmp")
    modes = {}
    for name in sorted(manifest):
        path, want = os.path.join(fixtures, name), manifest[name]
        raw = (read_png if name.endswith(".png") else read_bmp)(path)
        rgb = load_rgb(path)
        for key, got in (("raw", raw.reshape(want["raw"]["shape"])), ("rgb", rgb)):
            if (str(got.dtype) != want[key]["dtype"] or list(got.shape) != want[key]["shape"]
                    or mf.digest(got) != want[key]["sha256"]):
                raise AssertionError(f"{name}: {key} {got.dtype} {got.shape}, not the "
                                     f"manifest's {want[key]} (PIL mode {want['mode']})")
        modes[want["mode"]] = modes.get(want["mode"], 0) + 1
        cls = "class_000" if name.endswith(".bmp") else "class_001"
        os.makedirs(os.path.join(folder, cls), exist_ok=True)
        shutil.copy(path, os.path.join(folder, cls, name))
    log(f"  {len(manifest)} fixtures read to the manifest of PIL's readings (np.asarray and "
        f"convert('RGB'): dtype, shape, digest); PIL modes {modes}")
    ms = {}
    for path, want in mf.pascal_files(root):
        png = path.endswith(".png")
        if not np.array_equal((read_png if png else read_bmp)(path), want):
            raise AssertionError(f"{os.path.basename(path)}: not the encoder's input")
        times = []
        for _ in range(PNG_BMP_READS):
            t0 = time.perf_counter()
            load_rgb(path)
            times.append(time.perf_counter() - t0)
        ms[os.path.basename(path)] = (statistics.median(times) * 1e3, os.path.getsize(path))
        shutil.copy(path, os.path.join(folder, "class_001" if png else "class_000"))
    h, w = mf.PASCAL_HW
    log(f"  load_rgb ms per {w}x{h} file (median of {PNG_BMP_READS}; decode and to_rgb): "
        + ", ".join(f"{n} {v:.3f} ({size / 1e3:.1f} KB)" for n, (v, size) in ms.items())
        + f"  [host: {host_cpu()}; {where}]")
    return folder


def check_png_bmp(report, card: str) -> None:
    """Phase 20: (a) the fixtures against the manifest; (b) the
    PASCAL-sized reads; (c) one warm epoch of ``cls-train`` on the folder
    of them at phase 12's preset (P = 2000: the head's general path), its
    head launches counted."""
    import csv
    import os
    import shutil
    import tempfile

    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adlm_png_bmp_")
    saved_env = os.environ.get("RESULTS_DIR")
    try:
        folder = png_bmp_read_check(root, card)
        log(f"  (a, b) {time.perf_counter() - t_phase:.1f} s")
        t0 = time.perf_counter()
        n = len(ImageFolderDataset(folder, CLS_HW))
        results = os.path.join(root, "cls_runs")
        os.environ["RESULTS_DIR"] = results
        cls_command(["cls-train", "png_bmp", *JPEG_CLS_ARGS, "--train-dir", folder,
                     "--test-dir", folder])
        launches = dict(_build.LAUNCHES)
        with open(os.path.join(results, "png_bmp", "logs", "classification_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        log(f"  cls-train on the PNG and BMP folder ({n} images, 2 classes): rows " + ", ".join(
            f"{r['phase']} accuracy {float(r['accuracy']):.4f}" for r in rows)
            + f"; launches {launches}")
        if [r["phase"] for r in rows] != ["warm"] or launches["prototype_head"] < 2:
            raise AssertionError(f"cls-train on the PNG and BMP folder: rows {rows}, "
                                 f"launches {launches}")
        report["prototype_head"]["launches"] += launches["prototype_head"]
        log(f"  (c) {time.perf_counter() - t0:.1f} s")
    finally:
        if saved_env is None:
            os.environ.pop("RESULTS_DIR", None)
        else:
            os.environ["RESULTS_DIR"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 20 {time.perf_counter() - t_phase:.1f} s  [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and hold the kernels, then stop")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    try:
        from adlm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the adlm_tpu_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    report = {k: {"name": k, "route": "cuda",
                  "source": f"adlm_tpu_torch/csrc/{k}.cu",
                  "replaces": REPLACES[k], "launches": 0,
                  "max_abs_err": None, "ms": None, "plain_ms": None,
                  "bound_ms": None, "bound_by": None, "library_ms": None}
              for k in _build.KERNELS}
    prepared = None
    try:
        log(f"[1] card and build (torch {torch.__version__}, CUDA {torch.version.cuda})")
        card = card_line()
        log(card)
        t0 = time.perf_counter()
        outs = _build.build_all(verbose_ptxas=True)
        for name, out in outs.items():
            for ln in out.splitlines():
                inst = re.search(r"([a-z_]*kernel)I(\w+?)EEv", ln)
                if "Compiling entry" in ln and inst:  # the template instance
                    log(f"  {name}: {inst.group(1)}<{inst.group(2)}> (mangled arguments)")
                elif "registers" in ln or "smem" in ln or "spill" in ln:
                    log(f"  {name}:   {ln.strip()}")
        log(f"  built {sorted(outs) or 'nothing (cached)'} in "
            f"{time.perf_counter() - t0:.1f} s")

        log("[2] prototype head kernel vs plain version (f32 IEEE, no TF32)")
        check_head(report)
        log("[3] upsample-argmin kernel vs plain version (exact f32 blend)")
        check_upsample(report)
        if args.kernels_only:
            log(f"kernels-only: ok in {time.perf_counter() - t_start:.1f} s")
            return 0

        log("[4] the slice: flagship eval at 1024x2048, batch 2, kernels vs plain")
        t0 = time.perf_counter()
        model = check_slice(report)
        log(f"  slice phase {time.perf_counter() - t0:.1f} s")

        log(f"[5] timings  [{card}]")
        time_kernels(report, card)
        time_eval(model, card)
        log(f"[6] profile of an eval batch  [{card}]")
        profile_eval(model, card)

        log("[7] the training slice: flagship joint steps, 2 x 5 x 513^2, f32 "
            "IEEE, kernel vs plain head forward")
        t0 = time.perf_counter()
        check_training(report, model)
        log(f"  training check {time.perf_counter() - t0:.1f} s")
        time_training(model, card)
        profile_training(model, card)

        log("[8] the interpretation slice: push, k-nearest scan and prune at 1024x2048, "
            "f32 IEEE, kernel vs plain head forward")
        t0 = time.perf_counter()
        frames = check_interpretation(report, model)
        log(f"  interpretation check {time.perf_counter() - t0:.1f} s")
        time_interpretation(model, frames, card)
        del model, frames

        log("[9] the data slice: dataset on disk, host augment, loader modes, device "
            "prefetch, from-scratch init and loader-fed flagship joint windows")
        t0 = time.perf_counter()
        check_data_slice(report, card)
        log(f"  data slice phase {time.perf_counter() - t0:.1f} s")

        log("[10] the training run through the CLI: train (unbroken; halted and "
            "resumed), eval-valid --stats --stats-upsampled, prune, train --pruned, "
            "eval-test, flagship at full width, f32 IEEE")
        check_run(report, card)

        log("[11] U-Noise at full width (U-Net depth 5, cf 6, batch 8 x 256^2): native "
            "warps, card vs CPU, unoise-train-util, unoise-train-noise --pretrained --bf16, "
            "unoise-visualize, unoise-figures, timings")
        check_unoise(card)

        log("[12] the ProtoPNet classifier at full width (VGG19 224^2, P=2000, C=128, "
            "K=200, batch 80): kernel vs plain head per phase, f64 and TF32, bf16, push "
            "vs f64, cls-train, cls-prune, import-protopnet, timings")
        check_classifier(report, card)

        log("[13] windowed eval (513x513 windows, fused), import-protoseg / export-torch and "
            "analyze-local / analyze-global through the CLI, flagship at full width, f32 IEEE")
        check_windowed(report, card)

        log("[14] deployment: precompile twice; export (f32, bf16), cls-export and "
            "unoise-export through the CLI for the card; the artifacts served from a fresh "
            "process, answers held to the eager models")
        check_deploy(report, card)

        log("[15] dataset preparation on the card's machine: preprocess-cityscapes, "
            "gen-image-list, img-to-numpy and preprocess-pancreas through the CLI on raw "
            "trees, object masks, then the flagship's eval-valid on the prepared frames")
        prepared = check_prepare(report, card)

        log("[16] data parallelism: two gloo ranks sharing the card (joint window, eval, "
            "push, U-Noise) against one process, the NCCL world of one through torchrun, "
            "more ranks than cards refused")
        check_parallel(report, card)

        log("[17] spatial eval: the flagship at 1024x2048 on two gloo ranks sharing the "
            "card, image H split (f32, bf16) against one process; the row windows against "
            "the whole-frame kernel; the tensor-parallel head on the same ranks; spatial "
            "eval of pascal_kld_imnet (MSC) at 513x513; eval-valid --mesh-model 2 through "
            "the CLI for both")
        check_spatial(report, card, prepared)

        log("[18] JPEG: the host decoder built by this host's g++ against the manifest of "
            "PIL's pixels; preprocess-pascal on a VOC tree of PASCAL-sized JPEGs; eval-valid "
            "--stats --stats-upsampled of pascal_kld_imnet on it, kernels and plain versions; a "
            "JPEG class folder against its .npy twin, and cls-train on it")
        check_jpeg(report, card)

        log("[19] the classifier's offline augmentation: augment_directory (the host "
            "library's PIL warp and JPEG encoder) on the fixtures' tree against the manifest "
            "of PIL's bytes; cls-train on the augmented folder")
        check_img_aug(report, card)

        log("[20] PNG and BMP: the fixtures of every PNG depth and colour type (plain and "
            "Adam7) and every BMP header, depth and compression read to the manifest of "
            "PIL's readings; PASCAL-sized reads timed; cls-train on a folder of them")
        check_png_bmp(report, card)
    except Exception:  # report any failure and exit non-zero
        traceback.print_exc()
        log(f"FAILED after {time.perf_counter() - t_start:.1f} s")
        return 1
    finally:
        if prepared is not None:
            import shutil

            shutil.rmtree(prepared["root"], ignore_errors=True)

    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": list(report.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

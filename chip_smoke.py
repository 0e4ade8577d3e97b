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
   that take the general path (``GENERAL_CASES``: P = 257, C = 20 and
   the classification preset's C = 128, P = 2000, K = 200), whose
   logits limit must refuse logits products of TF32- and bf16-rounded
   operands;
3. kernel 2 (upsample + argmin) vs the plain exact-f32 scan:
   (2,129,257,190) → (2,1024,2048) in f32 and bf16, the batch-8 bf16
   map the eval runs, an all-equal tie map, a map quantised to three
   levels (ties across chunk and tile edges), ragged, downsampling,
   small-factor and integer-scale shapes, each through
   ``upsampled_nearest`` (which must launch the kernel); 0 mismatches;
4. the slice: ``SegEvaluator(with_stats=True, stats_upsampled=True)``
   on uint8 batches normalized on the device, in f32 and bf16, plus one
   ``make_overlay_fn`` call, with the launch counts reset just before
   and read just after; then the same batches once more with the plain
   versions patched in, compared within a tie budget;
5. timings (CUDA events for the kernels, host clock + synchronize for
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
   accumulation, the head's forward and plain backward at the training
   rows, and a ``torch.profiler`` window over one f32 and one bf16 step;
8. the interpretation slice: ``push_prototypes`` (batch 2, raw uint8,
   dedup) over five 1024x2048 frames with block labels, then
   ``find_k_nearest_patches`` (k = 6) and ``prune_by_purity``, each with
   the head kernel and again with the head's forward patched to its
   plain version, compared under the near-tie rule (``compare_push``,
   ``compare_scan``), with 3 head launches per pass; then push and scan
   images/s in f32 and bf16 over 40 frames (the five cycled, 20 full
   batches), a ``torch.profiler`` window over one push and one scan
   batch in each dtype, and the head's general path timed at the
   classification shape.

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
# K = 200 > 64): the general path of the same .cu file
CLS_N, CLS_C, CLS_P, CLS_K = 80 * 7 * 7, 128, 2000, 200
GENERAL_CASES = [
    ("P=257 K=3", 3001, 64, 257, 3, _DTYPES, _ACTS, False),
    ("C=20", 3001, 20, 190, 19, _DTYPES, _ACTS, False),
    ("classification", CLS_N, CLS_C, CLS_P, CLS_K, _DTYPES, _ACTS, False),
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
    report["upsample_argmin"]["max_abs_err"] = 0


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


def make_batches(n: int, B: int, seed: int):
    """uint8 frames with structure at several scales (a random coarse
    image upsampled, plus noise) and random labels with a void band."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        coarse = torch.rand(B, 3, 16, 32, device="cuda", generator=g)
        img = F.interpolate(coarse, size=(H, W), mode="bilinear",
                            align_corners=False) * 200
        img = img + torch.rand(B, 3, H, W, device="cuda", generator=g) * 55
        img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        lab = torch.randint(0, 20, (B, H, W), device="cuda", generator=g,
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

    def head(x, p, w, act, eps, return_distances=True):
        logits, d = prototype_head_reference(x, p, w, act, eps)
        return logits, (d if return_distances else None)

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


def compare_eval(tag, got, want, n_pixels) -> None:
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
    pc = default_proto_class(190, 19, device="cpu")
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
            dd = dist.to(dtype)
            ms = cuda_ms(lambda: upsampled_argmin_cuda(dd, (H, W)), 20)
            plain = cuda_ms(lambda: upsampled_argmin_reference(dd, (H, W), 16, True), 3, 1)
            # separable blend (x pass over h rows, y pass over H) and
            # compares: single f32 instructions, none fuses
            ops = B * (3.0 * P * W * (h + H) + P * H * W)
            nbytes = B * (h * w * P * dd.element_size() + 4 * H * W)
            b_ms, b_by = bound(ops, nbytes, PEAK_F32_OPS)
            rows.append(("upsample_argmin", str(dtype)[6:], None, ms, plain, b_ms, b_by))
    for name, dt, emit, ms, plain, b_ms, b_by in rows:
        extra = "" if emit is None else f" dist={emit!s:5s}"
        was = {"prototype_head": PR1_HEAD_MS, "upsample_argmin": PR1_UPSAMPLE_MS}[name]
        was = f"  (first kernel {was} ms f32)"
        log(f"  {name:16s} {dt:8s}{extra} kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}){was}  [{card}]")
    # the kernels line reports the f32 shape the stats eval runs
    for name, dt, emit, ms, plain, b_ms, b_by in rows:
        if dt == "float32" and emit in (True, None):
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
    time first; host ms per call).  The rows are empty when the
    profiler recorded no device time."""
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
    return rows, wall_ms


def profile_line(rows, wall_ms: float) -> str:
    """Device time, busy share (device time over the window's host time,
    which includes the profiler's own overhead) and the kernel groups."""
    def group(*keys):
        return sum(r[0] for r in rows if any(k in r[2].lower() for k in keys))

    total = sum(r[0] for r in rows)
    # cuDNN's IEEE-f32 backward kernels are dgrad_engine / wgrad_alg0_engine
    convs = group("conv", "xmma", "gemm", "cutlass", "nvjet", "dgrad", "wgrad")
    elementwise = group("elementwise")
    layout = group("nhwctonchw", "nchwtonhwc")
    return (f"device {total:.2f} ms/batch of {wall_ms:.2f} ms host (busy "
            f"{total / wall_ms:.1%}); conv/gemm {convs:.2f} ms ({convs / total:.1%}), "
            f"elementwise {elementwise:.2f} ms ({elementwise / total:.1%}), "
            f"layout transposes {layout:.2f} ms ({layout / total:.1%}), "
            f"prototype head {group('head_kernel'):.3f} ms, upsample-argmin "
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
        rows, wall_ms = device_profile(lambda: fn(pc, img, lab, *uv), iters)
        if not rows:
            log(f"  profile {dt}: the profiler recorded no device time "
                "(not measured)")
            continue
        log(f"  profile {dt} batch {B} stats_upsampled: {profile_line(rows, wall_ms)}"
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

    def head(x, p, w, act="log", eps=1e-4, return_distances=True):
        logits, d = pm.prototype_head_reference(x, p, w, act, eps)
        return logits, (d if return_distances else None)

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
    step) in f32, bf16 and bf16 with fused accumulation; then the head's
    forward kernel and its plain backward at the training rows."""
    import torch
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops.prototype import (
        prototype_head_backward,
        prototype_head_cuda,
        prototype_head_reference,
    )
    from adlm_tpu_torch.train.protoseg import init_protoseg_state, make_train_step

    cfg = get_experiment("cityscapes_kld_imnet")
    images, labels = make_train_batch(cfg, SEED + 7)
    for name, vcfg in train_variants(cfg).items():
        m = copy.deepcopy(model)
        state = init_protoseg_state(m, vcfg, 1, vcfg.train.joint_steps)
        step = make_train_step(m, vcfg, 1, vcfg.train.joint_steps)
        torch.cuda.reset_peak_memory_stats()
        step(state, images, labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / iters
        log(f"  joint step {name:15s} (2 x 5 x 513^2): {s:.4f} s/step, "
            f"{TRAIN_ITER * TRAIN_BS / s:.2f} windows/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"loss {float(metrics['loss']):.4f}  [{card}]")
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"joint step {name}: loss not finite")
        del m, state, step
        torch.cuda.empty_cache()
    del images, labels

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
        rows, wall_ms = device_profile(lambda: step(state, images, labels), 1)
        if not rows:
            log(f"  profile joint step {name}: the profiler recorded no device "
                "time (not measured)")
            continue
        adam = sum(r[0] for r in rows if "adam" in r[2].lower()
                   or "multi_tensor" in r[2].lower())
        log(f"  profile joint step {name} (2 x 5 x 513^2): "
            f"{profile_line(rows, wall_ms).replace('/batch', '/step')}, "
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
            rows, wall_ms = device_profile(lambda: step(pc, images, labels), 2)
            if not rows:
                log(f"  profile {name} {dt}: the profiler recorded no device "
                    "time (not measured)")
                continue
            log(f"  profile {name} batch {INTERP_BS} {dt} (uint8 upload included): "
                f"{profile_line(rows, wall_ms)}  [{card}]")
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
            log(f"  head general path, classification shape N={N} C={C} P={P} K={K} "
                f"f32 dist={emit!s:5s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})  [{card}]")


# ---------------------------------------------------------------------------


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
    except Exception:  # report any failure and exit non-zero
        traceback.print_exc()
        log(f"FAILED after {time.perf_counter() - t_start:.1f} s")
        return 1

    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": list(report.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

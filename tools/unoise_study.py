#!/usr/bin/env python3
"""Three studies of the port's U-Noise training on one card, at the shipped
width (U-Net depth 5, channel factor 6) on ``chip_smoke.py`` phase 11's
seeded slices.

    python3 tools/unoise_study.py grads [--out FILE]
    python3 tools/unoise_study.py determinism --mode cudnn|all [--epochs 2]
    python3 tools/unoise_study.py forwards [--reps 5]

``grads``: the relative L2 error of each gradient tensor of one utility
step (batch 2 x 256^2) against an f64 run of the same step on the card,
for the card's IEEE-f32 step and its step with cuDNN's TF32
convolutions, each with the BNs in train mode (batch statistics) and in
eval mode (running statistics settled by 30 train-mode forwards of
batch 2).  Train against eval mode separates the
train-mode BN backward from the rest of the network.  Prints the spread
per case and writes every tensor's errors to ``--out`` (JSON).

``determinism``: ``unoise-train-util`` twice, then ``unoise-train-noise
--pretrained --bf16`` twice from the first utility run (phase 11's
commands and sizes), in one process; compares the runs' checkpoints
tensor by tensor and their validation rows.  ``--mode cudnn`` sets
``torch.backends.cudnn.deterministic`` (as phase 11 does); ``--mode
all`` also ``torch.use_deterministic_algorithms(True, warn_only=True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, and lists the ops it warns
about (those without a deterministic implementation).

``forwards``: ms per train-mode forward (no grad) of the U-Net on new
slices at batch 1, 2, 4, 8 and 16, in IEEE f32 and with cuDNN's TF32
convolutions (the heuristic's algorithm for each shape, as the port
runs it).

Each prints the card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _step_grads(model, x, y, train: bool, dtype):
    """(loss, {name: host f64 gradient}) of the utility loss at ``model``
    in ``dtype`` on the card, BNs in train or eval mode."""
    import torch.nn.functional as F

    model = model.to(dtype).train(train)
    model.zero_grad(set_to_none=True)
    loss = F.binary_cross_entropy_with_logits(model(x.to(dtype)), y.to(dtype))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters()}


def study_grads(out: str) -> None:
    import copy

    import torch
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.train import unoise as tu

    cuda = torch.device("cuda")
    imgs, masks, _ = cs.unoise_slices(cs.UN_SLICES, cs.UN_HW, cs.SEED + 42)
    raw = torch.as_tensor(imgs[:cs.UN_CMP_BS, :, :, None], device=cuda)
    x = tu._prep_images(raw, True).contiguous()
    y = torch.as_tensor(masks[:cs.UN_CMP_BS, None], device=cuda)
    base = tu.build_unet(cs.UN_DEPTH, cs.UN_CF, cuda, cs.SEED)
    with torch.no_grad(), ieee_f32():
        for i in range(30):
            sl = slice(cs.UN_CMP_BS * (i % 8 + 1), cs.UN_CMP_BS * (i % 8 + 2))
            base.train()(tu._prep_images(torch.as_tensor(imgs[sl, :, :, None], device=cuda),
                                         True))
    zero = cs._zero_bias_names(base)
    table = {}
    for mode in ("train", "eval"):
        with torch.backends.cudnn.flags(enabled=False):
            ref = _step_grads(copy.deepcopy(base), x, y, mode == "train", torch.float64)
        for prec in ("ieee_f32", "tf32"):
            with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                            allow_tf32=prec == "tf32"):
                loss, grads = _step_grads(copy.deepcopy(base), x, y, mode == "train",
                                          torch.float32)
            rel, z = cs._step_errors(grads, ref[1], zero)
            vals = sorted(rel.values())
            table[f"{mode}_{prec}"] = {"loss": loss, "loss_f64": ref[0], "zero_share": z,
                                       "rel": rel}
            print(f"BN {mode} mode, {prec}: loss {loss:.7f} (f64 {ref[0]:.7f}); "
                  f"{len(vals)} gradient tensors, relative L2 to f64 min {vals[0]:.2e} "
                  f"median {vals[len(vals) // 2]:.2e} max {vals[-1]:.2e} "
                  f"({max(rel, key=rel.get)}); zero-gradient biases {z:.2e} of all",
                  flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(table, f)


def study_forwards(reps: int) -> None:
    """ms per train-mode U-Net forward (no grad) on new 256^2 slices, per
    batch size, in IEEE f32 and with cuDNN's TF32 convolutions."""
    import time

    import torch
    from adlm_tpu_torch.train import unoise as tu

    imgs, _, _ = cs.unoise_slices(cs.UN_SLICES, cs.UN_HW, cs.SEED + 42)
    model = tu.build_unet(cs.UN_DEPTH, cs.UN_CF, torch.device("cuda"), cs.SEED).train()
    for batch in (1, 2, 4, 8, 16):
        for tf32 in (False, True):
            def forward(i):
                x = torch.as_tensor(imgs[i * batch:(i + 1) * batch, :, :, None], device="cuda")
                model(tu._prep_images(x, True))

            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                forward(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(1, reps + 1):
                    forward(i)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / reps
            print(f"batch {batch:2d} x {cs.UN_HW}^2, {'TF32' if tf32 else 'IEEE f32'}: "
                  f"{ms:.2f} ms per forward ({ms / batch:.2f} ms per slice), {reps} after 1",
                  flush=True)


def _state(results: str, run: str, kind: str, which: str):
    import torch

    return torch.load(os.path.join(results, run, "checkpoints", f"{kind}_{which}",
                                   "state.pt"), map_location="cpu")


def _compare(results: str, kind: str, a: str, b: str) -> bool:
    """Print how the two runs' checkpoints and validation rows differ."""
    import csv

    import torch

    same = True
    for which in ("last", "best"):
        sa, sb = (_state(results, r, kind, which)["state_dict"] for r in (a, b))
        diff = [(k, float((sa[k].double() - sb[k].double()).abs().max()))
                for k in sa if not torch.equal(sa[k], sb[k])]
        same &= not diff
        print(f"  {kind} {which}: {len(sa) - len(diff)} of {len(sa)} tensors bit-equal"
              + (f"; first differing {diff[0][0]} (max |diff| {diff[0][1]:.3e}), largest "
                 f"|diff| {max(d for _, d in diff):.3e}" if diff else ""), flush=True)
    name = {"utility": "unoise_util", "noise": "unoise_noise"}[kind]
    rows = []
    for r in (a, b):
        with open(os.path.join(results, r, "logs", f"{name}_metrics.csv")) as f:
            rows.append([(row["val_loss"], row["val_dice"]) for row in csv.DictReader(f)])
    print(f"  {kind} validation (loss, dice) per epoch: {rows[0]} and {rows[1]}: "
          f"{'equal' if rows[0] == rows[1] else 'DIFFERENT'}", flush=True)
    return same and rows[0] == rows[1]


def study_determinism(mode: str, epochs: int) -> bool:
    import numpy as np
    import torch

    if mode == "all":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="adlm_unoise_det_")
    try:
        data, results = os.path.join(root, "data"), os.path.join(root, "runs")
        os.makedirs(data)
        for name, a in zip(("images", "masks", "bounding_boxes"),
                           cs.unoise_slices(cs.UN_SLICES, cs.UN_HW, cs.SEED + 42)):
            np.save(os.path.join(data, f"{name}.npy"), a)
        arrays = ["--imgs", os.path.join(data, "images.npy"), "--masks",
                  os.path.join(data, "masks.npy"), "--boxes",
                  os.path.join(data, "bounding_boxes.npy")]
        train = [*arrays, "--depth", str(cs.UN_DEPTH), "--channel-factor", str(cs.UN_CF),
                 "--epochs", str(epochs), "--batch-size", str(cs.UN_BS)]
        os.environ["RESULTS_DIR"] = results
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for run in ("util_a", "util_b"):
                cs.run_unoise_command(["unoise-train-util", *train, "--run-name", run])
            for run in ("noise_a", "noise_b"):
                cs.run_unoise_command(["unoise-train-noise", *train, "--run-name", run,
                                       "--utility-run", "util_a", "--pretrained", "util_a",
                                       "--bf16"])
        ops = sorted({str(w.message).split("\n")[0][:200] for w in caught
                      if "deterministic" in str(w.message)})
        print(f"mode {mode}: {len(ops)} ops warned as without a deterministic "
              "implementation" + "".join(f"\n  {op}" for op in ops), flush=True)
        util = _compare(results, "utility", "util_a", "util_b")
        noise = _compare(results, "noise", "noise_a", "noise_b")
        print(f"mode {mode}: utility runs {'bit-equal' if util else 'differ'}, noise runs "
              f"{'bit-equal' if noise else 'differ'}", flush=True)
        return util and noise
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="study", required=True)
    g = sub.add_parser("grads")
    g.add_argument("--out", default="")
    d = sub.add_parser("determinism")
    d.add_argument("--mode", choices=("cudnn", "all"), required=True)
    d.add_argument("--epochs", type=int, default=cs.UN_EPOCHS)
    f = sub.add_parser("forwards")
    f.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("unoise_study: needs the card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    if args.study == "grads":
        study_grads(args.out)
        return 0
    if args.study == "forwards":
        study_forwards(args.reps)
        return 0
    return 0 if study_determinism(args.mode, args.epochs) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry points of the port (counterpart of
``adlm_tpu.cli``):

    python -m adlm_tpu_torch.cli train <experiment> <run_name> [--pruned]
    python -m adlm_tpu_torch.cli eval-valid <run_dir> <stage>
    python -m adlm_tpu_torch.cli eval-test <run_dir> <stage>
    python -m adlm_tpu_torch.cli prune <run_dir>

Environment: DATA_PATH (dataset root) and RESULTS_DIR (run outputs), as
the reference's env.sh / settings.py.  Every command runs on the CUDA
card unless ``--device cpu`` is given; without a card it raises before
it writes anything.  A run directory written by either package's
``train`` has the same layout and ``config.json``; the checkpoint files
are each package's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from adlm_tpu_torch.utils.watchdog import DIVERGED_EXIT

STAGES = ("warmup", "nopush", "push", "pruned")


def _results_dir(run_name: str) -> str:
    base = os.environ.get("RESULTS_DIR", "./runs")
    return os.path.join(base, run_name)


def _strip_valued_flags(argv, names):
    """argv minus the given ``--flag value`` / ``--flag=value`` pairs."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in names:
            skip = True
            continue
        if any(a.startswith(n + "=") for n in names):
            continue
        out.append(a)
    return out


def _watchdog_relaunch_cmd(base_argv, run_dir, attempt):
    """Child command of ``--auto-restart`` attempt N.  It resumes only
    once there is something to resume: a child that died before its
    first phase (pretrained load, bn-calibrate) wrote no resume.json,
    and ``--resume`` on a fresh run directory exits at once."""
    child = [sys.executable, "-m", "adlm_tpu_torch.cli"] + list(base_argv)
    has_resume = os.path.exists(os.path.join(run_dir, "resume.json"))
    if attempt > 0 and has_resume and "--resume" not in child:
        child.append("--resume")
    return child


def apply_train_overrides(cfg, bf16: bool, fused: bool, s2b: bool,
                          wire_uint8: bool = False):
    """The config overrides of ``train``'s --bf16, --fused, --s2b and
    --wire-uint8 (a copy of ``adlm_tpu.deploy.precompile``'s)."""
    if bf16 or fused or wire_uint8:
        overrides = {}
        if bf16:
            overrides["compute_dtype"] = "bfloat16"
        if fused:
            overrides["fused_accumulation"] = True
        if wire_uint8:
            overrides["wire_uint8"] = True
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    if s2b:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dilated_space_to_batch=True))
    return cfg


def cmd_train(args):
    from adlm_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    if args.auto_restart is not None:
        # supervisor mode: the training runs as a child under a heartbeat
        # watchdog; on a hang or a crash the child is killed, the device
        # probed, and the run relaunched with --resume (utils/watchdog.py)
        from adlm_tpu_torch.utils.watchdog import run_with_watchdog

        run_dir = _results_dir(args.run_name)
        base = _strip_valued_flags(list(args._argv),
                                   ("--auto-restart", "--watchdog-timeout"))
        raise SystemExit(run_with_watchdog(
            lambda attempt: _watchdog_relaunch_cmd(base, run_dir, attempt),
            [os.path.join(run_dir, "logs", "train.log"),
             os.path.join(run_dir, "logs", "train_metrics.csv")],
            timeout_s=args.watchdog_timeout, max_restarts=args.auto_restart))

    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.train.pipeline import TrainingDiverged, run_protoseg_training

    cfg = get_experiment(args.experiment)
    cfg = apply_train_overrides(cfg, args.bf16, args.fused, args.s2b,
                                wire_uint8=args.wire_uint8)
    train_kw = {}
    if args.bn_calibrate:
        train_kw["bn_calibrate"] = True
    if args.proto_init_data:
        train_kw["proto_init_data"] = True
    if args.grad_clip is not None:
        train_kw["grad_clip_norm"] = args.grad_clip
    if args.joint_lr_warmup is not None:
        train_kw["joint_lr_warmup_updates"] = args.joint_lr_warmup
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    if args.presigmoid_ln:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, presigmoid_ln=True))
    if args.dataloader_mode or args.dataloader_jobs:
        # loader execution only: the sample stream is a pure function of
        # the seed, so these never change a result
        dkw = {}
        if args.dataloader_mode:
            dkw["dataloader_mode"] = args.dataloader_mode
        if args.dataloader_jobs:
            dkw["dataloader_n_jobs"] = args.dataloader_jobs
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **dkw))
    run_dir = _results_dir(args.run_name)
    os.makedirs(run_dir, exist_ok=True)
    try:
        run_protoseg_training(
            cfg, run_dir, data_path=args.data_path, pruned=args.pruned,
            start_checkpoint=args.start_checkpoint,
            val_every=args.val_every, val_batches=args.val_batches,
            steps_scale=args.steps_scale,
            save_push_visualizations=args.save_push_visualizations,
            push_batch_size=args.push_batch_size,
            pretrained_path=args.pretrained,
            pretrained_naming="deeplab" if cfg.load_coco else "torchvision",
            trace_dir=args.trace_dir, val_augment=args.val_augment,
            resume=args.resume, halt_after_windows=args.halt_after,
            device=dev)
    except TrainingDiverged:
        # a distinct exit code: a resume with the same arguments replays
        # the divergence, so the watchdog must not restart it
        raise SystemExit(DIVERGED_EXIT)


def _load_stage(run_dir: str, stage: str, kind: str, dev):
    """(config with the checkpoint's prototype count, payload, model on
    ``dev``) of a run's ``<stage>_<kind>`` checkpoint."""
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.config import ExperimentConfig
    from adlm_tpu_torch.train.pipeline import _build_model, _with_prototypes

    store = CheckpointStore(run_dir)
    cfg = ExperimentConfig.from_json(store.load_config_json())
    payload = store.restore(stage, kind, map_location=dev)
    sd = payload["state_dict"]
    cfg = _with_prototypes(cfg, sd["prototype_vectors"].shape[0])
    return cfg, payload, _build_model(cfg, sd, dev)


def cmd_eval_valid(args):
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.interpret.stats import (
        ProtoStatsAccumulator,
        prototype_pair_distances,
        save_eval_plots,
    )

    dev = resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    proto_class = payload["proto_class"]
    n_proto = cfg.model.num_prototypes
    table = get_class_table(cfg.data.class_table)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path,
                             is_eval=True)
    # raw uint8 items normalized on the device where that equals the
    # host path: a quarter of the bytes on the wire
    raw = ds.supports_raw_eval()
    ev = SegEvaluator(model, cfg.model.num_classes, with_stats=args.stats,
                      stats_upsampled=args.stats_upsampled,
                      normalize=(cfg.data.mean, cfg.data.std) if raw else None,
                      device=dev)
    acc = (ProtoStatsAccumulator(n_proto, cfg.model.num_classes,
                                 proto_class.cpu().numpy())
           if args.stats else None)
    if args.batch_size > 1:
        items = ds.eval_batches(args.batch_size, with_counts=True, raw=raw)
    else:
        items = ((img, lab, 1) for img, lab in ds.eval_items(raw=raw))
    n_images = 0
    # the next batch's upload rides under the current batch's compute
    for img, lab, n_real in device_prefetch(items, device=dev):
        out = ev.update(proto_class, img, lab)
        if acc is not None:
            # padded tail images are left out: the nearest-prototype
            # counts have no void mask to drop them
            acc.update_counts(out["agree_counts"][:n_real],
                              out["topk_purity"][:n_real], n_images=n_real)
        n_images += n_real
        if args.max_images and n_images >= args.max_images:
            break
    res = ev.results()
    if args.stats:
        res["stats_mode"] = "upsampled" if args.stats_upsampled else "grid"
    out_dir = os.path.join(args.run_dir, "evaluation", args.stage)
    save_eval_plots(out_dir, res["iou_per_class"], res["mean_iou"],
                    res["pixel_accuracy"],
                    stats=acc.results() if acc else None,
                    pair_stats=prototype_pair_distances(
                        model.prototypes().detach(), proto_class),
                    class_names=table.class_names)

    if args.examples:
        # qualitative prediction / nearest-prototype overlays on random
        # val images (reference eval_valid.py:270-343)
        from adlm_tpu_torch.interpret.evaluate import make_overlay_fn
        from adlm_tpu_torch.interpret.stats import save_example_overlays

        ov_fn = make_overlay_fn(model, device=dev)
        rng = np.random.RandomState(0)
        idxs = rng.choice(len(ds), size=min(args.examples, len(ds)), replace=False)
        ppc = int(np.bincount(proto_class.cpu().numpy()).max())
        run_name = os.path.basename(os.path.normpath(args.run_dir))
        for ei, idx in enumerate(idxs):
            img_n, _ = ds.get_eval_item(int(idx))
            raw_img, lab = ds.get_overlay_item(int(idx))
            pred, nearest = ov_fn(img_n[None])
            save_example_overlays(out_dir, ei, raw_img, pred[0].cpu().numpy(),
                                  nearest[0].cpu().numpy(),
                                  (lab == 0).astype(np.float32),
                                  protos_per_class=ppc,
                                  title=f"{run_name} ({args.stage})")
    print(json.dumps(res, indent=2, default=float))


def cmd_eval_test(args):
    """Per-image greyscale prediction PNGs mapped back to the source
    dataset's ids (reference segmentation/eval_test.py:53-115)."""
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.interpret.visualize import write_png

    dev = resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    proto_class = payload["proto_class"]
    table = get_class_table(cfg.data.class_table)
    # prediction → source-dataset id (Cityscapes submission format,
    # reference eval_test.py:52-60)
    lut = table.submission_lut(cfg.model.num_classes)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path,
                             is_eval=True)
    raw = ds.supports_raw_eval()
    fn = make_inference_fn(model, cfg.model.num_classes,
                           normalize=(cfg.data.mean, cfg.data.std) if raw else None,
                           device=dev)
    out_dir = os.path.join(args.run_dir, "evaluation", args.stage, "test_predictions")
    os.makedirs(out_dir, exist_ok=True)
    for i, (img, lab) in enumerate(device_prefetch(ds.eval_items(raw=raw), device=dev)):
        pred = fn(proto_class, img, lab)["pred"][0].cpu().numpy().astype(np.uint8)
        write_png(os.path.join(out_dir, ds.img_ids[i] + ".png"), lut[pred])
        if args.max_images and i + 1 >= args.max_images:
            break
    print(f"wrote predictions to {out_dir}")


def cmd_prune(args):
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret.prune import prune_by_purity

    dev = resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, "push", args.kind, dev)
    ds = SegmentationDataset(cfg.data, cfg.data.train_key, data_path=args.data_path,
                             is_eval=True, push_prototypes=True)
    # the batched scan takes raw uint8 normalized on the device
    raw = args.batch_size > 1 and ds.supports_raw_eval()
    new_sd, new_pc, prune_info = prune_by_purity(
        model, payload["proto_class"], ds.eval_items(raw=raw),
        cfg.model.num_classes, k=args.k, prune_threshold=args.threshold,
        batch_size=args.batch_size,
        raw_normalize=(cfg.data.mean, cfg.data.std) if raw else None, device=dev)
    CheckpointStore(args.run_dir).save("pruned", "last", {
        "state_dict": new_sd, "proto_class": new_pc, "step": int(payload["step"])})
    np.save(os.path.join(args.run_dir, "prune_info.npy"), prune_info)
    print(f"pruned {prune_info.shape[0]} prototypes; finetune with "
          f"`train ... --pruned`")


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="adlm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    tp = sub.add_parser("train")
    tp.add_argument("experiment")
    tp.add_argument("run_name")
    tp.add_argument("--pruned", action="store_true")
    tp.add_argument("--resume", action="store_true",
                    help="continue a killed or halted run from its last "
                         "checkpoint: stage, window, Adam moments, LR "
                         "position, early-stopping counters and the "
                         "loader streams pick up where they stopped")
    tp.add_argument("--halt-after", type=int, default=None,
                    help="stop gracefully after N optimizer windows "
                         "(counted across phases), saving a resumable "
                         "checkpoint")
    tp.add_argument("--auto-restart", type=int, default=None, metavar="N",
                    help="supervise the run under a heartbeat watchdog: a "
                         "hang (no log progress for --watchdog-timeout) "
                         "or a crash kills the child, waits for the "
                         "device probe, and relaunches with --resume, up "
                         "to N times (utils/watchdog.py)")
    tp.add_argument("--watchdog-timeout", type=float, default=900.0,
                    help="seconds without a run-log heartbeat before the "
                         "supervisor declares a stall")
    tp.add_argument("--joint-lr-warmup", type=int, default=None,
                    metavar="UPDATES",
                    help="linear LR ramp over the first N updates of the "
                         "joint phase, then the poly decay (default off: "
                         "the reference)")
    tp.add_argument("--grad-clip", type=float, default=None, metavar="NORM",
                    help="global-norm gradient clip ahead of every phase "
                         "optimizer (default off: the reference never "
                         "clips)")
    tp.add_argument("--start-checkpoint", default=None,
                    help="<run_dir>/checkpoints/<stage>_<kind> of the port "
                         "to start from")
    tp.add_argument("--pretrained", default=None,
                    help="a torch .pth state_dict or an .npz with "
                         "torchvision (ImageNet) or deeplab (COCO) keys")
    tp.add_argument("--data-path", default=None)
    tp.add_argument("--val-every", type=int, default=500)
    tp.add_argument("--val-batches", type=int, default=None,
                    help="cap validation to the first N ordered batches "
                         "(default: the whole val split)")
    tp.add_argument("--steps-scale", type=float, default=1.0)
    tp.add_argument("--bf16", action="store_true",
                    help="bf16 compute for the train forward and backward")
    tp.add_argument("--fused", action="store_true",
                    help="fused gradient accumulation: one forward and "
                         "backward per window, gradient-identical")
    tp.add_argument("--s2b", action="store_true",
                    help="compute the d=2/4 dilated convs by "
                         "space-to-batch (numerically exact)")
    tp.add_argument("--wire-uint8", action="store_true",
                    help="ship train windows as raw uint8 pixels and "
                         "normalize on the device")
    tp.add_argument("--dataloader-mode", default=None,
                    choices=["thread", "process"],
                    help="override the experiment's loader pool")
    tp.add_argument("--dataloader-jobs", type=int, default=0,
                    help="override the experiment's loader worker count "
                         "(0 = keep the preset's)")
    tp.add_argument("--bn-calibrate", action="store_true",
                    help="from-scratch init: standardize the frozen "
                         "backbone BNs on real windows before training")
    tp.add_argument("--proto-init-data", action="store_true",
                    help="from-scratch init: draw each prototype from a "
                         "real feature cell of its own class")
    tp.add_argument("--presigmoid-ln", action="store_true",
                    help="per-pixel LayerNorm before the add-on sigmoid "
                         "(off by default: the reference architecture)")
    tp.add_argument("--save-push-visualizations", action="store_true")
    tp.add_argument("--push-batch-size", type=int, default=1,
                    help="images per push step (the same result)")
    tp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of one "
                         "steady-state window per phase under "
                         "<dir>/<stage>/")
    tp.add_argument("--val-augment", action="store_true",
                    help="apply the training augment to validation too, "
                         "as the reference does (dataset.py:119-173)")
    _add_device(tp)
    tp.set_defaults(fn=cmd_train)

    for name, fn in (("eval-valid", cmd_eval_valid), ("eval-test", cmd_eval_test)):
        ep = sub.add_parser(name)
        ep.add_argument("run_dir")
        ep.add_argument("stage", choices=STAGES)
        ep.add_argument("--kind", default="last", choices=["last", "best"])
        ep.add_argument("--split", default="val")
        ep.add_argument("--data-path", default=None)
        ep.add_argument("--max-images", type=int, default=0)
        ep.add_argument("--batch-size", type=int, default=1,
                        help="full-resolution eval batch (uniform-shape "
                             "datasets)")
        if name == "eval-valid":
            ep.add_argument("--stats", action="store_true",
                            help="also compute the prototype statistics "
                                 "and plots (same forward per batch)")
            ep.add_argument("--stats-upsampled", action="store_true",
                            help="the reference's statistics on bilinearly "
                                 "upsampled distance maps "
                                 "(eval_valid.py:172-214)")
            ep.add_argument("--examples", type=int, default=5,
                            help="qualitative overlay examples (0 = off)")
        _add_device(ep)
        ep.set_defaults(fn=fn)

    pp = sub.add_parser("prune")
    pp.add_argument("run_dir")
    pp.add_argument("--kind", default="last", choices=["last", "best"])
    pp.add_argument("--data-path", default=None)
    pp.add_argument("--k", type=int, default=6)
    pp.add_argument("--threshold", type=int, default=3)
    pp.add_argument("--batch-size", type=int, default=1,
                    help="images per step of the k-nearest scan (the same "
                         "result)")
    _add_device(pp)
    pp.set_defaults(fn=cmd_prune)

    raw = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(raw)
    args._argv = raw  # the --auto-restart supervisor re-runs these
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

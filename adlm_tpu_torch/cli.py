"""Command-line entry points of the port (counterpart of
``adlm_tpu.cli``):

    python -m adlm_tpu_torch.cli train <experiment> <run_name> [--pruned]
    python -m adlm_tpu_torch.cli eval-valid <run_dir> <stage> [--windowed WH,WW]
    python -m adlm_tpu_torch.cli eval-test <run_dir> <stage> [--windowed WH,WW]
    python -m adlm_tpu_torch.cli prune <run_dir>
    python -m adlm_tpu_torch.cli import-protoseg <experiment> <run_name> <checkpoint>
    python -m adlm_tpu_torch.cli export-torch <run_dir> <stage>
    python -m adlm_tpu_torch.cli analyze-local / analyze-global <run_dir> <stage>
    python -m adlm_tpu_torch.cli unoise-train-util / unoise-train-noise
    python -m adlm_tpu_torch.cli unoise-visualize / unoise-figures
    python -m adlm_tpu_torch.cli prepare-unoise <source_path> <target_path>
    python -m adlm_tpu_torch.cli preprocess-cityscapes / preprocess-pancreas <source_path> <target_path>
    python -m adlm_tpu_torch.cli gen-image-list <target_path>
    python -m adlm_tpu_torch.cli img-to-numpy <data_path> [--margin M]
    python -m adlm_tpu_torch.cli cls-train <run_name> / cls-prune <run_dir>
    python -m adlm_tpu_torch.cli import-protopnet <run_name> <checkpoint>
    python -m adlm_tpu_torch.cli export <run_dir> <stage> / cls-export <run_dir> <stage>
    python -m adlm_tpu_torch.cli unoise-export <run_dir> [--model utility|noise]
    python -m adlm_tpu_torch.cli serve <artifact_dir> / precompile <experiment>

Environment: DATA_PATH (dataset root) and RESULTS_DIR (run outputs), as
the reference's env.sh / settings.py.  Every command runs on the CUDA
card unless ``--device cpu`` is given; without a card it raises before
it writes anything.

Several cards (``core/mesh.py``, ``parallel/sharding.py``): ``--mesh-data N
[--mesh-model M]`` on ``train``, ``eval-valid``, ``eval-test``,
``cls-train`` and ``unoise-train-*`` starts N·M local ranks itself, one
card each (gloo ranks on the CPU under ``--device cpu``), joined through
a file store in the run directory; ``train ... --distributed`` takes the
world from ``torchrun``'s environment instead.  On eval, ``--mesh-model
M`` > 1 also splits image H over the M ranks of each data coordinate
(spatial eval, ``parallel/spatial.py``).

The training commands (``train``, ``unoise-train-*``, ``cls-train``) run
cuDNN's deterministic algorithms (``core.device.deterministic_cudnn``),
so that a run resumed with the same arguments replays an unbroken one
on the same card.

A run directory written by either package's ``train`` (or
``unoise-train-*``) has the same layout and config files; the
checkpoint files are each package's own.
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


def _deterministic(cmd):
    """A training command, run under cuDNN's deterministic algorithms."""
    import functools

    @functools.wraps(cmd)
    def run(args, mesh=None):
        from adlm_tpu_torch.core.device import deterministic_cudnn

        with deterministic_cudnn():
            return cmd(args, mesh=mesh)

    return run


def _rank_main(dev, mesh_args, argv):
    """One spawned rank of ``_mesh_for``: the same command on ``dev``,
    inside the world ``mesh_args`` joins."""
    from adlm_tpu_torch.core.mesh import destroy, make_mesh

    args = _parser().parse_args(argv)
    args._argv = argv
    mesh = make_mesh(_mesh_spec(args), dev, **mesh_args)
    try:
        code = args.fn(args, mesh=mesh)
    finally:
        destroy(mesh)
    if code:
        raise SystemExit(code)


def _mesh_spec(args):
    from adlm_tpu_torch.core.mesh import MeshSpec

    return MeshSpec(data=getattr(args, "mesh_data", 0) or -1,
                    model=getattr(args, "mesh_model", 1))


def _mesh_for(args, store_dir: str, batch_size=None):
    """This command's mesh: (mesh or None, exit code of a spawned world
    or None).

    ``--distributed`` joins ``torchrun``'s world.  ``--mesh-data N
    [--mesh-model M]`` alone runs N·M ranks: one is this process when
    N·M = 1 (a mesh without a process group), else this process spawns
    them, one card each (gloo CPU ranks under ``--device cpu``), joined
    through a file store in ``store_dir``, and returns their exit code.
    ``batch_size``, where given, must divide by N."""
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.core.mesh import init_distributed, make_mesh, spawn_local

    data = getattr(args, "mesh_data", 0)
    model = getattr(args, "mesh_model", 1)
    if data and batch_size is not None and batch_size % data:
        raise SystemExit("--batch-size must be divisible by --mesh-data")
    dev = resolve_device(args.device)
    if getattr(args, "distributed", False):
        mesh = init_distributed(_mesh_spec(args), device="cpu" if dev.type == "cpu" else None)
        if mesh.device.type == "cuda":
            # the first rank builds the kernel libraries; the others load them
            from adlm_tpu_torch.ops import _build

            if mesh.is_main:
                _build.build_all()
            mesh.barrier()
        return mesh, None
    if not data and model <= 1:
        return None, None
    n = (data or 1) * model
    if n == 1:
        return make_mesh(_mesh_spec(args), dev), None
    if dev.type == "cuda":
        import torch

        have = torch.cuda.device_count()
        if n > have:
            raise SystemExit(
                f"--mesh-data {data or 1} x --mesh-model {model} asks for {n} ranks, "
                f"one card each, but this machine has {have} card(s); use "
                f"torchrun with --distributed across machines, or --device cpu")
        devices = [f"cuda:{r}" for r in range(n)]
        # built once here, before the ranks start and load them
        from adlm_tpu_torch.ops import _build

        _build.build_all()
    else:
        devices = ["cpu"] * n
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(store_dir), f".mesh_store_{os.getpid()}")
    codes = spawn_local(_rank_main, n, store, devices, args=(list(args._argv),))
    bad = [c for c in codes if c]
    if bad:
        raise SystemExit(bad[0])
    return None, 0


@_deterministic
def cmd_train(args, mesh=None):
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
    if mesh is None:
        mesh, code = _mesh_for(args, run_dir)
        if code is not None:
            return code
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
            device=dev, mesh=mesh)
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


def _window(spec: str):
    """``--windowed WH,WW`` → (WH, WW)."""
    wh, ww = (int(x) for x in spec.split(","))
    return wh, ww


def _eval_mesh(args, mesh):
    """(mesh, exit code) of an eval command: the batch split over
    ``--mesh-data`` ranks and image H over ``--mesh-model`` ranks (spatial
    eval)."""
    if mesh is not None:
        return mesh, None
    if args.windowed and (getattr(args, "mesh_data", 0) or args.mesh_model > 1):
        raise SystemExit("--mesh-* shards whole-image eval; windowed mode is "
                         "the single-device memory-bounded alternative")
    return _mesh_for(args, args.run_dir, batch_size=args.batch_size)


def cmd_eval_valid(args, mesh=None):
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

    mesh, code = _eval_mesh(args, mesh)
    if code is not None:
        return code
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    main = mesh is None or mesh.is_main
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    proto_class = payload["proto_class"]
    n_proto = cfg.model.num_prototypes
    table = get_class_table(cfg.data.class_table)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path,
                             is_eval=True)
    # raw uint8 items normalized on the device where that equals the
    # host path: a quarter of the bytes on the wire
    raw = ds.supports_raw_eval()
    normalize = (cfg.data.mean, cfg.data.std) if raw else None
    if args.windowed:
        if args.stats_upsampled:
            raise SystemExit(
                "--stats-upsampled is whole-image only; use --stats "
                "with --windowed for the memory-bounded grid statistics")
        from adlm_tpu_torch.interpret.windowed import WindowedSegEvaluator

        # the CLI needs the (B, P) statistics vectors only
        ev = WindowedSegEvaluator(model, cfg.model.num_classes, _window(args.windowed),
                                  with_stats=args.stats, normalize=normalize,
                                  keep_stat_maps=False, device=dev)
    else:
        ev = SegEvaluator(model, cfg.model.num_classes, with_stats=args.stats,
                          stats_upsampled=args.stats_upsampled, normalize=normalize,
                          device=dev, mesh=mesh)
    acc = (ProtoStatsAccumulator(n_proto, cfg.model.num_classes,
                                 proto_class.cpu().numpy())
           if args.stats else None)
    if mesh is not None:
        # each rank loads its slice of every batch
        items = ds.eval_batches(args.batch_size, with_counts=True, raw=raw,
                                shard=(mesh.data_index, mesh.data))
    elif args.batch_size > 1:
        items = ds.eval_batches(args.batch_size, with_counts=True, raw=raw)
    else:
        items = ((img, lab, 1) for img, lab in ds.eval_items(raw=raw))
    n_images = 0
    # the next batch's upload rides under the current batch's compute
    for img, lab, n_real in device_prefetch(items, device=dev):
        out = (ev.update(proto_class, img, lab) if mesh is None
               else ev.update(proto_class, img, lab, n_valid=n_real))
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
    if not main:
        return None
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


def cmd_eval_test(args, mesh=None):
    """Per-image greyscale prediction PNGs mapped back to the source
    dataset's ids (reference segmentation/eval_test.py:53-115).  Over a
    mesh each rank predicts its slice of every batch and the first rank
    writes every PNG."""
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.interpret.visualize import write_png

    mesh, code = _eval_mesh(args, mesh)
    if code is not None:
        return code
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    proto_class = payload["proto_class"]
    table = get_class_table(cfg.data.class_table)
    # prediction → source-dataset id (Cityscapes submission format,
    # reference eval_test.py:52-60)
    lut = table.submission_lut(cfg.model.num_classes)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path,
                             is_eval=True)
    raw = ds.supports_raw_eval()
    normalize = (cfg.data.mean, cfg.data.std) if raw else None
    if args.windowed:
        from adlm_tpu_torch.interpret.windowed import WindowedSegEvaluator

        fn = WindowedSegEvaluator(model, cfg.model.num_classes, _window(args.windowed),
                                  normalize=normalize, device=dev).update
    elif mesh is not None and mesh.model > 1:
        from adlm_tpu_torch.parallel.sharding import make_sharded_inference_fn

        fn = make_sharded_inference_fn(model, cfg.model.num_classes, mesh,
                                       normalize=normalize)
    else:
        fn = make_inference_fn(model, cfg.model.num_classes, normalize=normalize,
                               device=dev)
    out_dir = os.path.join(args.run_dir, "evaluation", args.stage, "test_predictions")
    os.makedirs(out_dir, exist_ok=True)
    if mesh is not None:
        _sharded_eval_test(args, mesh, ds, fn, proto_class, lut, raw, out_dir)
        return None
    for i, (img, lab) in enumerate(device_prefetch(ds.eval_items(raw=raw), device=dev)):
        pred = fn(proto_class, img, lab)["pred"][0].cpu().numpy().astype(np.uint8)
        write_png(os.path.join(out_dir, ds.img_ids[i] + ".png"), lut[pred])
        if args.max_images and i + 1 >= args.max_images:
            break
    print(f"wrote predictions to {out_dir}")


def _sharded_eval_test(args, mesh, ds, fn, proto_class, lut, raw, out_dir):
    """eval-test over a mesh: each rank's slice of every batch (and under
    spatial eval its rows of each frame), the predictions gathered (a
    zero-filled buffer each rank fills) and written by the first rank."""
    import torch

    from adlm_tpu_torch.core.mesh import row_range
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.interpret.visualize import write_png

    items = ds.eval_batches(args.batch_size, with_counts=True, raw=raw,
                            shard=(mesh.data_index, mesh.data))
    start = 0
    for img, lab, n_real in device_prefetch(items, device=mesh.device):
        if mesh.model > 1:
            b, H = lab.shape[0], lab.shape[1]
            out = fn(proto_class, img, lab, n_valid=n_real)
            full = torch.zeros((b * mesh.data,) + tuple(lab.shape[1:]), dtype=torch.int32,
                               device=mesh.device)
            if "pred" in out:
                lo, hi = row_range(mesh.model_index, H, mesh.model)
                full[mesh.data_index * b:(mesh.data_index + 1) * b, lo:hi] = out["pred"]
            pred = mesh.all_reduce_world_(full)
        else:
            pred = mesh.gather_rows(fn(proto_class, img, lab)["pred"].to(torch.int32))
        if mesh.is_main:
            pred = pred.cpu().numpy().astype(np.uint8)
            for j in range(n_real):
                if args.max_images and start + j >= args.max_images:
                    break
                write_png(os.path.join(out_dir, ds.img_ids[start + j] + ".png"),
                          lut[pred[j]])
        start += n_real
        if args.max_images and start >= args.max_images:
            break
    if mesh.is_main:
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


def _unoise_model(run_dir: str, kind: str, dev, bf16: bool,
                  depth: int = 5, cf: int = 6, which: str = "best"):
    """The U-Net of a U-Noise run's ``<kind>_<which>`` checkpoint (kind
    'utility' or 'noise'), in eval mode on ``dev``; its architecture from
    the run's ``<kind>_config.json``, else from ``depth``/``cf`` (the
    flags)."""
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.device import cast_params
    from adlm_tpu_torch.train.unoise import build_unet

    arch = os.path.join(run_dir, f"{kind}_config.json")
    if os.path.exists(arch):
        with open(arch) as f:
            cfgd = json.load(f)
        depth, cf = cfgd["depth"], cfgd["channel_factor"]
    payload = CheckpointStore(run_dir).restore(kind, which)
    model = build_unet(depth, cf, dev, state_dict=payload["state_dict"]).eval()
    return cast_params(model, "bfloat16") if bf16 else model


@_deterministic
def cmd_unoise_train_util(args, mesh=None):
    from adlm_tpu_torch.train.unoise_pipeline import results_dir, train_utility

    if mesh is None:
        mesh, code = _mesh_for(args, os.path.join(results_dir(), args.run_name),
                               batch_size=args.batch_size)
        if code is not None:
            return code
    train_utility(args, mesh=mesh)


@_deterministic
def cmd_unoise_train_noise(args, mesh=None):
    from adlm_tpu_torch.train.unoise_pipeline import results_dir, train_noise

    if mesh is None:
        mesh, code = _mesh_for(args, os.path.join(results_dir(), args.run_name),
                               batch_size=args.batch_size)
        if code is not None:
            return code
    train_noise(args, mesh=mesh)


def cmd_unoise_visualize(args):
    """Interpretation artifacts of trained U-Noise models: the importance
    mask, its threshold ablation, grad-CAM, occlusion sensitivity and the
    timing comparison (reference src/make_visualizations.py)."""
    import torch

    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.interpret.unoise_vis import (
        grad_cam, interpretation_timing, occlusion_sensitivity, unoise_importance)
    from adlm_tpu_torch.interpret.visualize import jet_colormap, upsample_cubic, write_png
    from adlm_tpu_torch.train.unoise_pipeline import load_split, results_dir

    dev = resolve_device(args.device)
    results = results_dir()
    util_model = _unoise_model(os.path.join(results, args.utility_run), "utility", dev, args.bf16)
    noise_model = _unoise_model(os.path.join(results, args.noise_run), "noise", dev, args.bf16,
                                args.depth, args.channel_factor)
    image, mask = load_split(args, raw=False)[2][args.index]
    image_t = torch.as_tensor(image[None], device=dev)
    mask_t = torch.as_tensor(mask[None], device=dev)
    out_dir = os.path.join(results, args.noise_run, "visualizations")
    os.makedirs(out_dir, exist_ok=True)
    H, W = image.shape[:2]
    # approximate inverse of the ImageNet normalization of tiled grey
    # slices (mean about 0.45, std about 0.225 over the channels)
    denorm_img = np.clip(image * 0.225 + 0.45, 0, 1)

    def save_heat(heat, name):
        hn = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-12)
        if hn.shape != (H, W):
            hn = upsample_cubic(hn, (H, W))
        rgb = np.clip(0.5 * denorm_img + 0.5 * jet_colormap(hn), 0, 1)
        write_png(os.path.join(out_dir, name), (rgb * 255).astype(np.uint8))

    imp = unoise_importance(noise_model, image_t)[0, :, :, 0]
    save_heat(1.0 - imp, "unoise_importance.png")
    # threshold ablation: keep the pixels whose noise tolerance B is at
    # most each threshold (reference make_visualizations.py:193-198)
    for threshold in np.linspace(0.0, 1.0, 11):
        masked = denorm_img * (imp <= threshold)[..., None]
        write_png(os.path.join(out_dir, f"threshold_{threshold:.1f}.png"),
                  (masked * 255).astype(np.uint8))
    save_heat(grad_cam(util_model, image_t, x=W // 2, y=H // 2), "grad_cam.png")
    occ = occlusion_sensitivity(util_model, image_t, mask_t, patch=args.occlusion_patch,
                                stride=args.occlusion_stride)[0]
    save_heat(-occ, "occlusion_sensitivity.png")
    timing = interpretation_timing({
        "unoise": lambda: unoise_importance(noise_model, image_t),
        "grad_cam": lambda: grad_cam(util_model, image_t, x=W // 2, y=H // 2),
        "occlusion": lambda: occlusion_sensitivity(
            util_model, image_t, mask_t, patch=args.occlusion_patch,
            stride=args.occlusion_stride),
    })
    print(json.dumps({"seconds_per_interpretation": timing}, indent=2))
    with open(os.path.join(out_dir, "timing.json"), "w") as f:
        json.dump(timing, f)


def cmd_unoise_figures(args):
    """Coverage-vs-dice curves (reference src/make_figures.py): the fixed
    threshold grid and the median-mask dice@50% (make_figures.py:135-173)
    per noise run.  ``--from-pickle`` renders a reference-format
    results.pickle without any checkpoint; ``--save-pickle`` writes the
    results in that format."""
    import torch

    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.unoise_data import batches
    from adlm_tpu_torch.interpret.figures import (
        device_threshold_sweep, dice_at_median_importance, load_results_pickle,
        make_predict, plot_curves, save_results_pickle)
    from adlm_tpu_torch.interpret.unoise_vis import unoise_importance
    from adlm_tpu_torch.models.unet import num_params
    from adlm_tpu_torch.train.unoise_pipeline import load_split, results_dir

    dev = resolve_device(args.device)
    results = results_dir()
    out = os.path.join(results, "unoise_coverage_dice.png")
    if args.from_pickle:
        curves, params_per_model, at_half = load_results_pickle(args.from_pickle)
        plot_curves(curves, out, params_per_model, dice_at_half=at_half)
        print(json.dumps({name: {"num_params": params_per_model[name],
                                 "dice_at_half_coverage": at_half[name]}
                          for name in curves}, indent=2))
        return
    util_model = _unoise_model(os.path.join(results, args.utility_run), "utility", dev, args.bf16)
    test_imgs, test_masks = next(iter(batches(load_split(args, raw=False)[2],
                                             args.n_images)))
    predict = make_predict(util_model)
    curves, params_per_model, at_half, pickle_payload = {}, {}, {}, {}
    for run in args.noise_runs.split(","):
        # per-run architecture: sizes differ across --noise-runs
        noise_model = _unoise_model(os.path.join(results, run), "noise", dev, args.bf16,
                                    args.depth, args.channel_factor)
        params_per_model[run] = num_params(noise_model)
        imp = unoise_importance(noise_model, torch.as_tensor(test_imgs, device=dev))
        dice, cov, thresholds = device_threshold_sweep(
            predict, imp, test_imgs, test_masks, batch_size=args.sweep_batch_size,
            device=dev)
        at_half[run] = dice_at_median_importance(predict, imp, test_imgs, test_masks,
                                                 batch_size=args.sweep_batch_size)
        curves[run] = list(zip(cov, dice))
        pickle_payload[run] = {
            "thresholds": np.asarray(thresholds), "num_params": params_per_model[run],
            "dice": dice, "coverage": cov, "dice_at_half_coverage": at_half[run]}
    plot_curves(curves, out, params_per_model, dice_at_half=at_half)
    if args.save_pickle:
        save_results_pickle(args.save_pickle, pickle_payload)
    print(json.dumps({run: {"curve": curves[run], "num_params": params_per_model[run],
                            "dice_at_half_coverage": at_half[run]}
                      for run in curves}, indent=2))


def cmd_prepare_unoise(args):
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.preprocess import prepare_unoise_data

    # host-only work; the device check keeps every command's contract
    resolve_device(args.device)
    prepare_unoise_data(args.source_path, args.target_path)


def cmd_preprocess(args):
    """preprocess-cityscapes / preprocess-pascal / preprocess-pancreas:
    host work (numpy and the host library's JPEG decoder), as in the JAX
    package."""
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data import preprocess

    resolve_device(args.device)
    fn = {"preprocess-cityscapes": preprocess.preprocess_cityscapes,
          "preprocess-pascal": preprocess.preprocess_pascal,
          "preprocess-pancreas": preprocess.preprocess_pancreas}[args.cmd]
    fn(args.source_path, args.target_path)


def cmd_gen_image_list(args):
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.preprocess import generate_image_list

    resolve_device(args.device)
    generate_image_list(args.target_path)


def cmd_img_to_numpy(args):
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.preprocess import convert_images_to_numpy

    resolve_device(args.device)
    n = convert_images_to_numpy(args.data_path, margin=args.margin)
    print(f"converted {n} images")


@_deterministic
def cmd_cls_train(args, mesh=None):
    """ProtoPNet image-classification training (reference main.py:107-189
    over ImageFolder datasets, settings.py:14-17 environment)."""
    from adlm_tpu_torch.core.config import PPNetConfig
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.train.classification import ClassificationConfig
    from adlm_tpu_torch.train.classification_pipeline import run_classification_training

    if mesh is None:
        mesh, code = _mesh_for(args, _results_dir(args.run_name),
                               batch_size=args.batch_size)
        if code is not None:
            return code
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    shard = None if mesh is None else (mesh.data_index, mesh.data)
    train_dir = args.train_dir or os.environ.get("TRAIN_DIR")
    test_dir = args.test_dir or os.environ.get("TEST_DIR")
    push_dir = args.push_dir or os.environ.get("TRAIN_PUSH_DIR") or train_dir
    if not train_dir or not test_dir:
        raise SystemExit("--train-dir/--test-dir (or TRAIN_DIR/TEST_DIR env) required")
    train_ds = ImageFolderDataset(train_dir, args.img_size)
    test_ds = ImageFolderDataset(test_dir, args.img_size)
    # push images normalized, as the push forward expects
    push_ds = ImageFolderDataset(push_dir, args.img_size)
    cfg = ClassificationConfig(
        model=PPNetConfig(
            base_architecture=args.arch, img_size=args.img_size,
            num_prototypes=args.prototypes, prototype_channels=args.proto_channels,
            num_classes=args.num_classes or len(train_ds.classes),
            add_on_layers_type="regular", patch_classification=False),
        num_warm_epochs=args.warm_epochs, num_train_epochs=args.epochs,
        push_start=args.push_start,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    run_classification_training(
        cfg, _results_dir(args.run_name),
        train_batches=lambda: train_ds.batches(args.batch_size, shuffle=True, seed=0,
                                               shard=shard),
        test_batches=lambda: test_ds.batches(args.test_batch_size, with_count=True),
        push_batches=lambda: push_ds.batches(args.push_batch_size, with_count=True),
        steps_per_epoch=-(-len(train_ds) // args.batch_size),
        target_accuracy=args.target_accuracy,
        last_layer_iterations=args.last_layer_iterations,
        push_every=args.push_every, pretrained_path=args.pretrained, device=dev,
        mesh=mesh)


def cmd_cls_prune(args):
    """Classification pruning and an optional last-layer finetune
    (reference run_pruning.py root:113-158): from ``push_best``, else
    ``nopush_last``, to ``pruned_last`` and ``cls_prune_info.npy``."""
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.train.classification import (
        build_classifier,
        init_classifier_state,
        make_cls_eval_step,
        make_cls_train_step,
        prune_classification_prototypes,
        with_prototypes,
    )
    from adlm_tpu_torch.train.classification_pipeline import (
        cls_payload,
        evaluate,
        load_cls_config,
        run_epoch,
    )

    dev = resolve_device(args.device)
    run_dir = args.run_dir
    store = CheckpointStore(run_dir)
    stage, kind = ("push", "best") if store.exists("push", "best") else ("nopush", "last")
    payload = store.restore(stage, kind, map_location=dev)
    sd = payload["state_dict"]
    cfg = with_prototypes(load_cls_config(run_dir), sd["prototype_vectors"].shape[0])
    state = init_classifier_state(build_classifier(cfg, dev, state_dict=sd), cfg, None,
                                  proto_class=payload["proto_class"], device=dev)

    train_dir = args.train_dir or os.environ.get("TRAIN_DIR")
    push_dir = args.push_dir or os.environ.get("TRAIN_PUSH_DIR") or train_dir
    push_ds = ImageFolderDataset(push_dir, cfg.model.img_size)
    new_sd, new_pc, prune_info = prune_classification_prototypes(
        state, push_ds.batches(args.batch_size, with_count=True), k=args.k,
        prune_threshold=args.threshold, device=dev)
    np.save(os.path.join(run_dir, "cls_prune_info.npy"), prune_info)

    pruned_cfg = with_prototypes(cfg, new_sd["prototype_vectors"].shape[0])
    model = build_classifier(pruned_cfg, dev, state_dict=new_sd)
    if args.last_layer_iterations > 0 and train_dir:
        test_dir = args.test_dir or os.environ.get("TEST_DIR")
        train_ds = ImageFolderDataset(train_dir, cfg.model.img_size)
        test_ds = ImageFolderDataset(test_dir or train_dir, cfg.model.img_size)
        final = init_classifier_state(model, pruned_cfg, "last", proto_class=new_pc,
                                      device=dev)
        last_step = make_cls_train_step(model, pruned_cfg, "last", device=dev)
        eval_fn = make_cls_eval_step(model, pruned_cfg, device=dev)
        for it in range(args.last_layer_iterations):
            final, _ = run_epoch(last_step, final,
                                 train_ds.batches(args.batch_size, shuffle=True, seed=it))
            acc = evaluate(eval_fn, final, test_ds.batches(args.batch_size, with_count=True))
            print(f"pruned last-layer iter {it}: accuracy {acc:.4f}")
    else:
        final = init_classifier_state(model, pruned_cfg, None, proto_class=new_pc,
                                      device=dev)
        final.step = int(payload["step"])
    store.save("pruned", "last", cls_payload(final))
    print(f"pruned {prune_info.shape[0]} prototypes → {int(new_pc.shape[0])} remain; "
          f"saved pruned_last")


def cmd_import_protopnet(args):
    """Import a trained reference CLASSIFICATION ProtoPNet checkpoint
    (``torch.save(obj=model, ...)``, reference save.py:11) into a run
    directory that cls-prune and last-layer finetuning read."""
    import torch

    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.config import PPNetConfig
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.train.classification import ClassificationConfig
    from adlm_tpu_torch.train.classification_pipeline import save_cls_config
    from adlm_tpu_torch.utils.torch_import import (
        load_protopnet_cls,
        load_torch_ppnet_checkpoint,
        resolve_proto_class,
    )

    resolve_device(args.device)
    sd, proto_class = load_torch_ppnet_checkpoint(args.checkpoint)
    n_proto, proto_ch = sd["prototype_vectors"].shape[:2]
    num_classes = int(sd["last_layer.weight"].shape[0])
    cfg = ClassificationConfig(model=PPNetConfig(
        base_architecture=args.arch, img_size=args.img_size,
        num_prototypes=int(n_proto), prototype_channels=int(proto_ch),
        num_classes=num_classes, add_on_layers_type=args.add_on,
        patch_classification=False))
    proto_class = resolve_proto_class(proto_class, args.proto_class, int(n_proto), num_classes)
    target = _nan_target(cfg.model)
    report = load_protopnet_cls(target, sd, args.arch)
    _assert_fully_imported(report, target, args.checkpoint)
    run_dir = _results_dir(args.run_name)
    store = CheckpointStore(run_dir)
    save_cls_config(run_dir, cfg)
    payload = {"state_dict": target,
               "proto_class": torch.as_tensor(np.asarray(proto_class)).long(), "step": 0}
    store.save(args.stage, "last", payload)
    store.save(args.stage, "best", payload)
    print(f"imported {len(report['loaded'])} tensors ({n_proto} prototypes / "
          f"{num_classes} classes, {args.arch}) into {run_dir} stage {args.stage!r}")


def _nan_target(model_cfg):
    """A NaN-filled ``state_dict`` of a port PPNet of ``model_cfg`` (built
    on the meta device), ``ones`` set: an importer fills it, and a tensor
    the checkpoint does not write stays NaN."""
    import torch

    from adlm_tpu_torch.models.ppnet import PPNet

    with torch.device("meta"):
        template = PPNet(model_cfg).state_dict()
    target = {k: torch.full(v.shape, float("nan"), dtype=v.dtype) for k, v in template.items()}
    target["ones"] = torch.ones(template["ones"].shape)
    return target


def _assert_fully_imported(report, target, checkpoint: str) -> None:
    holes = [k for k, v in target.items() if v.is_floating_point() and bool(v.isnan().any())]
    for what, keys in (("unmapped keys", report["unexpected_keys"]),
                       ("corrupt BN running_var", report["negative_variance_keys"]),
                       ("uninitialized tensors", holes)):
        if keys:
            raise SystemExit(f"{what} in {checkpoint}: {keys[:8]}")


def cmd_import_protoseg(args):
    """Import a trained reference ProtoSeg checkpoint (a whole-module
    pickle, as the reference saves its stages, reference
    segmentation/train.py:60-65; a plain state_dict; or a
    ``{"state_dict": ...}`` wrapper) into a run directory that eval-valid,
    eval-test, prune and ``train --start-checkpoint`` read."""
    import torch

    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.train.pipeline import _with_prototypes
    from adlm_tpu_torch.utils.torch_import import (
        load_protoseg_model,
        load_torch_ppnet_checkpoint,
        resolve_proto_class,
    )

    resolve_device(args.device)  # host-only work; every command's contract
    sd, proto_class = load_torch_ppnet_checkpoint(args.checkpoint)
    n_proto = int(sd["prototype_vectors"].shape[0])
    cfg = _with_prototypes(get_experiment(args.experiment), n_proto)
    proto_class = resolve_proto_class(proto_class, args.proto_class, n_proto,
                                      cfg.model.num_classes)
    target = _nan_target(cfg.model)
    report = load_protoseg_model(target, sd)
    _assert_fully_imported(report, target, args.checkpoint)
    run_dir = _results_dir(args.run_name)
    store = CheckpointStore(run_dir)
    store.save_config(cfg.to_json())
    payload = {"state_dict": target,
               "proto_class": torch.as_tensor(np.asarray(proto_class)).long(), "step": 0}
    store.save(args.stage, "last", payload)
    store.save(args.stage, "best", payload)
    print(f"imported {len(report['loaded'])} tensors ({n_proto} prototypes) into "
          f"{run_dir} stage {args.stage!r}; run eval-valid/eval-test/prune on it, or "
          f"continue training with --start-checkpoint")


def cmd_export_torch(args):
    """Export a run's ProtoSeg model as a reference-named torch
    state_dict (the reverse of import-protoseg), with its prototype class
    ids in ``<out>_proto_class.npy``."""
    import torch

    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.utils.torch_import import export_protoseg_state_dict

    resolve_device(args.device)  # host-only work; every command's contract
    payload = CheckpointStore(args.run_dir).restore(args.stage, args.kind,
                                                    map_location="cpu")
    sd = export_protoseg_state_dict(payload["state_dict"])
    out = args.out or os.path.join(args.run_dir, "export_torch",
                                   f"{args.stage}_{args.kind}.pth")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save(sd, out)
    pc_out = os.path.splitext(out)[0] + "_proto_class.npy"
    np.save(pc_out, payload["proto_class"].cpu().numpy().astype(np.int32))
    print(f"exported {len(sd)} tensors to {out} (+ prototype class ids in {pc_out})")


def _push_time_indices(run_dir, stage, n_current):
    """Current checkpoint prototype indices → the push-time indices in
    the artifact file names, or None where the map cannot be rebuilt
    (never link wrong artifacts).

    Push dedup compacts the indices and records the kept ORIGINAL ones
    in ``prototypes/unique_prototypes.json``; pruning compacts again (the
    removed push-stage indices are in ``prune_info.npy``)."""
    uniq_path = os.path.join(run_dir, "prototypes", "unique_prototypes.json")
    orig = None
    if os.path.exists(uniq_path):
        with open(uniq_path) as f:
            orig = json.load(f)          # push-stage current -> original
    if stage == "pruned":
        pi_path = os.path.join(run_dir, "prune_info.npy")
        if not os.path.exists(pi_path):
            return None
        pruned = {int(r[0]) for r in np.load(pi_path).reshape(-1, 2)}
        n_push = len(orig) if orig is not None else n_current + len(pruned)
        idx = [j for j in range(n_push) if j not in pruned]
        if len(idx) != n_current:
            return None
    else:
        idx = list(range(n_current))
    if orig is not None:
        if idx and max(idx) >= len(orig):
            return None
        idx = [int(orig[j]) for j in idx]
    return idx


def cmd_analyze_local(args):
    """The local analysis of one image (reference local_analysis.py),
    with each top prototype's push-time artifacts linked beside it."""
    import glob
    import shutil

    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret.analysis import local_analysis, make_denorm

    dev = resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path, is_eval=True)
    img, _ = ds.get_eval_item(args.index)
    out_dir = os.path.join(args.run_dir, "local_analysis", ds.img_ids[args.index])
    res = local_analysis(model, payload["proto_class"], img[None], top_k=args.top_k,
                         save_dir=out_dir, denorm=make_denorm(cfg.data),
                         per_class_top=args.per_class_top, device=dev)
    # the reference renders each top prototype's own source image and
    # box (local_analysis.py:215-228); here push wrote them, under
    # push-time indices that dedup and pruning compact afterwards
    proto_dir = os.path.join(args.run_dir, "prototypes")
    orig_idx = _push_time_indices(args.run_dir, args.stage, cfg.model.num_prototypes)
    if os.path.isdir(proto_dir) and orig_idx is not None:
        for rank, j in enumerate(res["top_prototypes"]):
            for src in glob.glob(os.path.join(
                    proto_dir, "*", f"prototype-img_{orig_idx[int(j)]}-*.png")):
                shutil.copy(src, os.path.join(out_dir, f"top-{rank + 1}_" + os.path.basename(src)))
    print(json.dumps({
        "top_prototypes": res["top_prototypes"].tolist(),
        "top_classes": res["top_classes"].tolist(),
        "own_class_is_strongest": bool(res["own_class_is_strongest"].all()),
    }, indent=2))


def cmd_analyze_global(args):
    """The k nearest training patches of every prototype (reference
    global_analysis.py)."""
    import itertools

    from adlm_tpu_torch.core.device import resolve_device
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.interpret.analysis import global_analysis, make_denorm

    dev = resolve_device(args.device)
    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind, dev)
    ds = SegmentationDataset(cfg.data, args.split, data_path=args.data_path, is_eval=True,
                             push_prototypes=True)
    items = ds.eval_items()
    if args.max_images:
        items = itertools.islice(items, args.max_images)

    def get_item(i):
        im, lb = ds.get_eval_item(i)
        return im[None], lb[None]

    ids = global_analysis(model, payload["proto_class"], items, cfg.model.num_classes,
                          k=args.k, save_dir=os.path.join(args.run_dir, "global_analysis"),
                          full_save=args.full_save, get_item=get_item,
                          denorm=make_denorm(cfg.data), batch_size=args.batch_size,
                          device=dev)
    print(f"nearest patch class ids saved; shape {ids.shape}")


def _export_args(args, default_name: str):
    """(platforms, compute dtype, output directory) of an export command."""
    import torch

    out = args.out or os.path.join(args.run_dir, "export", default_name)
    return (tuple(args.platforms.split(",")),
            torch.float32 if args.f32_compute else torch.bfloat16, out)


def cmd_export(args):
    """Export a run's ProtoSeg inference program (weights inside) to a
    ``.pt2`` artifact and manifest for serving (deploy/export.py).  The
    reference has no deployment path (its eval scripts rebuild the
    model per run)."""
    import torch

    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.deploy.export import export_inference_artifact

    cfg, payload, model = _load_stage(args.run_dir, args.stage, args.kind,
                                      torch.device("cpu"))
    h, w = _window(args.size)
    # uint8 inputs normalized on the device, unless the preset keeps raw
    # ranges (cells) or the caller sends pre-normalized float32
    normalize = None
    if not args.f32_inputs and not cfg.data.cells:
        normalize = (cfg.data.mean, cfg.data.std)
    platforms, dtype, out_dir = _export_args(args, f"{args.stage}_{args.batch}x{h}x{w}")
    manifest = export_inference_artifact(
        model, payload["proto_class"], out_dir, args.batch, (h, w), normalize=normalize,
        platforms=platforms, compute_dtype=dtype,
        class_names=list(get_class_table(cfg.data.class_table).class_names))
    print(f"exported {manifest['input']['shape']} {manifest['input']['dtype']} "
          f"inference for platforms {manifest['platforms']} to {out_dir}")


def cmd_unoise_export(args):
    """Export a trained U-Noise model (utility segmenter or noise
    importance map) for serving (deploy/export.py)."""
    import torch

    from adlm_tpu_torch.deploy.export import export_unoise_artifact

    model = _unoise_model(args.run_dir, args.model, torch.device("cpu"), False,
                          args.depth, args.channel_factor, which=args.kind)
    h, w = _window(args.size)
    platforms, dtype, out_dir = _export_args(args, f"{args.model}_{args.batch}x{h}x{w}")
    manifest = export_unoise_artifact(model, args.model, out_dir, args.batch, (h, w),
                                      platforms=platforms, compute_dtype=dtype)
    print(f"exported {manifest['model']} {manifest['input']['shape']} "
          f"for platforms {manifest['platforms']} to {out_dir}")


def cmd_cls_export(args):
    """Export a trained ProtoPNet classifier (logits and the prototype
    activation vector, weights inside) for serving (deploy/export.py)."""
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.data.image_folder import IMAGENET_MEAN, IMAGENET_STD
    from adlm_tpu_torch.deploy.export import export_cls_artifact
    from adlm_tpu_torch.train.classification import build_classifier, with_prototypes
    from adlm_tpu_torch.train.classification_pipeline import load_cls_config

    payload = CheckpointStore(args.run_dir).restore(args.stage, args.kind)
    sd = payload["state_dict"]
    cfg = with_prototypes(load_cls_config(args.run_dir), sd["prototype_vectors"].shape[0])
    model = build_classifier(cfg, "cpu", state_dict=sd)
    normalize = None if args.f32_inputs else (IMAGENET_MEAN, IMAGENET_STD)
    size = cfg.model.img_size
    platforms, dtype, out_dir = _export_args(args, f"{args.stage}_{args.batch}x{size}x{size}")
    manifest = export_cls_artifact(model, payload["proto_class"], out_dir, args.batch,
                                   (size, size), normalize=normalize, platforms=platforms,
                                   compute_dtype=dtype)
    print(f"exported {manifest['model']} {manifest['input']['shape']} "
          f"for platforms {manifest['platforms']} to {out_dir}")


def cmd_precompile(args):
    """Build the kernel libraries before a run (deploy/precompile.py); a
    library already built is reused.  The experiment is named as in the
    JAX CLI and checked; every experiment launches the same libraries."""
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.deploy.precompile import precompile_kernels

    get_experiment(args.experiment)  # an unknown name raises
    built, sec = precompile_kernels()
    names = sorted(n for n, b in built.items() if b)
    print(f"precompiled {len(built)} kernel libraries, built {names or 'none'}, "
          f"in {sec:.2f}s")


def cmd_serve(args):
    """Serve an exported artifact over HTTP (micro-batched, pipelined
    dispatch; deploy/server.py)."""
    from adlm_tpu_torch.deploy.server import InferenceServer

    server = InferenceServer(args.artifact_dir, port=args.port, host=args.host,
                             platform=args.platform, window_ms=args.window_ms)
    shape = server.manifest["input"]["shape"]
    print(f"serving {server.manifest['input']['dtype']} {shape} -> "
          f"{server.known_outputs} on http://{args.host}:{server.port} "
          f"(batch {shape[0]}, window {args.window_ms} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def _add_unoise_data(p) -> None:
    p.add_argument("--imgs", default="data/images.npy")
    p.add_argument("--masks", default="data/masks.npy")
    p.add_argument("--boxes", default="data/bounding_boxes.npy")


def _add_bf16(p, what: str) -> None:
    p.add_argument("--bf16", action="store_true", help=f"bf16 {what}")


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")


def _add_mesh(p, model: bool = True, distributed: bool = False,
              data_help: str = "data-parallel mesh axis size (0 = single device)") -> None:
    p.add_argument("--mesh-data", type=int, default=0, help=data_help)
    if model:
        p.add_argument("--mesh-model", type=int, default=1,
                       help="model mesh axis size: ranks that share a data "
                            "coordinate take the same batch slice (on eval, "
                            "> 1 splits image H over them: spatial eval)")
    if distributed:
        p.add_argument("--distributed", action="store_true",
                       help="join the world torchrun describes (RANK, "
                            "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) "
                            "instead of starting local ranks")


def _parser() -> argparse.ArgumentParser:
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
    _add_mesh(tp, distributed=True)
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
        _add_mesh(ep, data_help="shard the eval batch over a data-parallel mesh "
                                "axis (0 = single device; batch must divide evenly)")
        ep.add_argument("--windowed", default=None, metavar="WH,WW",
                        help="sliding-window inference with the given "
                             "window size instead of whole-image "
                             "forwards (memory-bounded mode)")
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

    for name, fn, run in (("unoise-train-util", cmd_unoise_train_util, "unoise_util"),
                          ("unoise-train-noise", cmd_unoise_train_noise, "unoise_noise")):
        up = sub.add_parser(name)
        _add_unoise_data(up)
        up.add_argument("--run-name", default=run)
        up.add_argument("--depth", type=int, default=5)
        up.add_argument("--channel-factor", type=int, default=6)
        up.add_argument("--learning-rate", type=float, default=3e-3)
        up.add_argument("--batch-size", type=int, default=8)
        up.add_argument("--epochs", type=int, default=100)
        _add_bf16(up, "U-Net forward and backward (parameters cast inside the step)")
        if name == "unoise-train-noise":
            up.add_argument("--utility-run", default="unoise_util")
            up.add_argument("--pretrained", default=None,
                            help="utility run name to initialize the noise U-Net from "
                                 "(architectures must match)")
            up.add_argument("--pretrained-torch-ckpt", default=None,
                            help="reference pytorch-lightning UtilityModel checkpoint "
                                 "(.ckpt) to initialize the noise U-Net from")
            up.add_argument("--utility-torch-ckpt", default=None,
                            help="load the FROZEN utility model from a reference "
                                 "pytorch-lightning checkpoint instead of "
                                 "--utility-run (architecture from its keys)")
            up.add_argument("--min-scale", type=float, default=1.0)
            up.add_argument("--max-scale", type=float, default=5.0)
            up.add_argument("--noise-coeff", type=float, default=0.001)
        _add_mesh(up, model=False, data_help="data-parallel mesh axis size (0 = single "
                                             "device); batch must be divisible by it")
        _add_device(up)
        up.set_defaults(fn=fn)

    vp = sub.add_parser("unoise-visualize")
    _add_unoise_data(vp)
    vp.add_argument("--utility-run", default="unoise_util")
    vp.add_argument("--noise-run", default="unoise_noise")
    vp.add_argument("--depth", type=int, default=5)
    vp.add_argument("--channel-factor", type=int, default=6)
    vp.add_argument("--index", type=int, default=0)
    vp.add_argument("--occlusion-patch", type=int, default=10)
    vp.add_argument("--occlusion-stride", type=int, default=4)
    _add_bf16(vp, "interpretation forwards")
    _add_device(vp)
    vp.set_defaults(fn=cmd_unoise_visualize)

    fp = sub.add_parser("unoise-figures")
    _add_unoise_data(fp)
    fp.add_argument("--utility-run", default="unoise_util")
    fp.add_argument("--noise-runs", default="unoise_noise",
                    help="comma-separated noise run names")
    fp.add_argument("--depth", type=int, default=5)
    fp.add_argument("--channel-factor", type=int, default=6)
    fp.add_argument("--n-images", type=int, default=8)
    fp.add_argument("--sweep-batch-size", type=int, default=32,
                    help="per-batch dice averaging granularity "
                         "(reference make_figures.py:128)")
    fp.add_argument("--from-pickle", default=None,
                    help="render a reference-format results.pickle instead of "
                         "evaluating checkpoints")
    fp.add_argument("--save-pickle", default=None,
                    help="also write the results in the reference's "
                         "results.pickle format")
    _add_bf16(fp, "sweep forwards")
    _add_device(fp)
    fp.set_defaults(fn=cmd_unoise_figures)

    cp = sub.add_parser("cls-train")
    cp.add_argument("run_name")
    cp.add_argument("--arch", default="vgg19",
                    help="resnet18/34/50/101/152, vggNN[_bn], densenet121/161/169/201")
    cp.add_argument("--train-dir", default=None)
    cp.add_argument("--test-dir", default=None)
    cp.add_argument("--push-dir", default=None)
    cp.add_argument("--img-size", type=int, default=224)
    cp.add_argument("--num-classes", type=int, default=0,
                    help="default: inferred from train-dir subfolders")
    cp.add_argument("--prototypes", type=int, default=2000)
    cp.add_argument("--proto-channels", type=int, default=128)
    cp.add_argument("--batch-size", type=int, default=80)
    cp.add_argument("--test-batch-size", type=int, default=100)
    cp.add_argument("--push-batch-size", type=int, default=75)
    cp.add_argument("--epochs", type=int, default=1000)
    cp.add_argument("--warm-epochs", type=int, default=5)
    cp.add_argument("--push-start", type=int, default=10)
    cp.add_argument("--push-every", type=int, default=10)
    cp.add_argument("--last-layer-iterations", type=int, default=20)
    cp.add_argument("--target-accuracy", type=float, default=0.0)
    cp.add_argument("--pretrained", default=None,
                    help="torchvision .pth state_dict (or .npz) with ImageNet stem weights")
    _add_bf16(cp, "train forward and backward (push and eval stay f32)")
    _add_mesh(cp, model=False, data_help="data-parallel mesh axis size for the "
                                          "train steps (0 = single device)")
    _add_device(cp)
    cp.set_defaults(fn=cmd_cls_train)

    cq = sub.add_parser("cls-prune")
    cq.add_argument("run_dir")
    cq.add_argument("--train-dir", default=None)
    cq.add_argument("--test-dir", default=None)
    cq.add_argument("--push-dir", default=None)
    cq.add_argument("--batch-size", type=int, default=75)
    cq.add_argument("--k", type=int, default=6)
    cq.add_argument("--threshold", type=int, default=3)
    cq.add_argument("--last-layer-iterations", type=int, default=0)
    _add_device(cq)
    cq.set_defaults(fn=cmd_cls_prune)

    icp = sub.add_parser("import-protopnet",
                         help="import a trained reference classification ProtoPNet "
                              "checkpoint into a run dir")
    icp.add_argument("run_name")
    icp.add_argument("checkpoint")
    icp.add_argument("--arch", default="vgg19",
                     help="feature stem architecture (reference settings.py "
                          "base_architecture)")
    icp.add_argument("--img-size", type=int, default=224)
    icp.add_argument("--add-on", default="regular",
                     choices=["regular", "bottleneck", "deeplab_simple"])
    icp.add_argument("--stage", default="push", choices=["nopush", "push", "pruned"])
    icp.add_argument("--proto-class", default=None,
                     help="(P,) class-id .npy for pruned checkpoints")
    _add_device(icp)
    icp.set_defaults(fn=cmd_import_protopnet)

    ip = sub.add_parser("import-protoseg",
                        help="import a trained reference ProtoSeg checkpoint "
                             "(torch.save'd ppnet module or state_dict) into a run dir")
    ip.add_argument("experiment")
    ip.add_argument("run_name")
    ip.add_argument("checkpoint")
    ip.add_argument("--stage", default="push", choices=STAGES,
                    help="stage to file the checkpoint under (the reference "
                         "names its files by the same stages)")
    ip.add_argument("--proto-class", default=None,
                    help="(P,) class-id .npy for pruned checkpoints whose "
                         "identity is not in the pickle")
    _add_device(ip)
    ip.set_defaults(fn=cmd_import_protoseg)

    et = sub.add_parser("export-torch",
                        help="export a run's ProtoSeg model as a reference-named "
                             "torch state_dict (reverse of import-protoseg)")
    et.add_argument("run_dir")
    et.add_argument("stage")
    et.add_argument("--kind", default="best", choices=["last", "best"])
    et.add_argument("--out", default=None)
    _add_device(et)
    et.set_defaults(fn=cmd_export_torch)

    for name, fn in (("analyze-local", cmd_analyze_local),
                     ("analyze-global", cmd_analyze_global)):
        ap = sub.add_parser(name)
        ap.add_argument("run_dir")
        ap.add_argument("stage", choices=STAGES)
        ap.add_argument("--kind", default="last")
        ap.add_argument("--split", default="val")
        ap.add_argument("--data-path", default=None)
        if name == "analyze-local":
            ap.add_argument("--index", type=int, default=0)
            ap.add_argument("--top-k", type=int, default=10)
            ap.add_argument("--per-class-top", type=int, default=3,
                            help="also save each of the k most-represented "
                                 "classes' own prototypes ranked by activation "
                                 "(reference local_analysis.py:272-330); 0 = off")
        else:
            ap.add_argument("--k", type=int, default=5)
            ap.add_argument("--max-images", type=int, default=0)
            ap.add_argument("--full-save", action="store_true",
                            help="save nearest-patch image artifacts")
            ap.add_argument("--batch-size", type=int, default=1,
                            help="images per step of the k-nearest scan")
        _add_device(ap)
        ap.set_defaults(fn=fn)

    def add_export_flags(p) -> None:
        p.add_argument("--platforms", default="cpu,cuda",
                       help="comma-separated devices of cpu, cuda: one artifact each "
                            "(cuda needs the card)")
        p.add_argument("--f32-compute", action="store_true",
                       help="keep float32 weights and activations (default bfloat16)")
        p.add_argument("--out", default=None,
                       help="artifact directory (default <run_dir>/export/...)")

    xp = sub.add_parser("export", help="export a run's ProtoSeg inference program "
                                       "(weights inside) for serving")
    xp.add_argument("run_dir")
    xp.add_argument("stage", choices=STAGES)
    xp.add_argument("--kind", default="last", choices=["last", "best"])
    xp.add_argument("--batch", type=int, default=1)
    xp.add_argument("--size", default="1024,2048", metavar="H,W",
                    help="input resolution of the artifact")
    xp.add_argument("--f32-inputs", action="store_true",
                    help="take pre-normalized float32 inputs instead of raw uint8 "
                         "normalized on the device")
    add_export_flags(xp)
    xp.set_defaults(fn=cmd_export)

    pcp = sub.add_parser("precompile", help="build the kernel libraries before a run")
    pcp.add_argument("experiment")
    pcp.set_defaults(fn=cmd_precompile)

    sv = sub.add_parser("serve", help="HTTP inference server over an exported artifact "
                                      "(micro-batched, pipelined)")
    sv.add_argument("artifact_dir",
                    help="directory written by export / unoise-export / cls-export")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--platform", default="cuda",
                    help="device to serve on: cuda (default) or cpu")
    sv.add_argument("--window-ms", type=float, default=5.0,
                    help="micro-batch coalescing window")
    sv.set_defaults(fn=cmd_serve)

    ux = sub.add_parser("unoise-export", help="export a trained U-Noise model (utility "
                                              "segmenter or noise importance map)")
    ux.add_argument("run_dir")
    ux.add_argument("--model", default="utility", choices=["utility", "noise"])
    ux.add_argument("--kind", default="best", choices=["last", "best"])
    ux.add_argument("--batch", type=int, default=8)
    ux.add_argument("--size", default="256,256", metavar="H,W")
    ux.add_argument("--depth", type=int, default=5,
                    help="fallback when the run has no config file")
    ux.add_argument("--channel-factor", type=int, default=6)
    add_export_flags(ux)
    ux.set_defaults(fn=cmd_unoise_export)

    cx = sub.add_parser("cls-export", help="export a trained ProtoPNet classifier (logits "
                                           "and prototype activations, weights inside)")
    cx.add_argument("run_dir")
    cx.add_argument("stage", choices=["nopush", "push", "pruned"])
    cx.add_argument("--kind", default="best", choices=["last", "best"])
    cx.add_argument("--batch", type=int, default=1)
    cx.add_argument("--f32-inputs", action="store_true",
                    help="take pre-normalized float32 inputs instead of raw uint8 "
                         "normalized on the device")
    add_export_flags(cx)
    cx.set_defaults(fn=cmd_cls_export)

    pu = sub.add_parser("prepare-unoise",
                        help="Pancreas NIfTI volumes -> U-Noise slice arrays")
    pu.add_argument("source_path")
    pu.add_argument("target_path")
    _add_device(pu)
    pu.set_defaults(fn=cmd_prepare_unoise)

    for name in ("preprocess-cityscapes", "preprocess-pascal", "preprocess-pancreas"):
        sp = sub.add_parser(name, help="raw dataset -> the npy layout")
        sp.add_argument("source_path")
        sp.add_argument("target_path")
        _add_device(sp)
        sp.set_defaults(fn=cmd_preprocess)

    itn = sub.add_parser("img-to-numpy",
                         help="PNG->npy pass over existing img_with_margin dirs "
                              "(reference segmentation/img_to_numpy.py)")
    itn.add_argument("data_path")
    itn.add_argument("--margin", type=int, default=0)
    _add_device(itn)
    itn.set_defaults(fn=cmd_img_to_numpy)

    gp = sub.add_parser("gen-image-list", help="all_images.json from an npy layout")
    gp.add_argument("target_path")
    _add_device(gp)
    gp.set_defaults(fn=cmd_gen_image_list)

    return p


def main(argv=None):
    raw = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(raw)
    args._argv = raw  # the --auto-restart supervisor re-runs these
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

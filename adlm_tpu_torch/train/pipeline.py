"""ProtoSeg phase orchestration: warmup → joint → push → finetune
(counterpart of ``adlm_tpu.train.pipeline``).

Mirrors the reference's training script (reference segmentation/train.py:34-233):

* phase 0 warmup for ``warmup_steps`` (skipped if 0);
* phase 1 joint for ``joint_steps`` with poly LR;
* prototype push over the train split (eval transforms, no augment);
* phase 2 last-layer finetune with early stopping on val accuracy;
* ``pruned=True`` finetunes a previously pruned model instead
  (reference train.py:197-233).

Checkpoints are stage-keyed ``{warmup,nopush,push,pruned}_{last,best}``
(reference module.py:285-297, ``core/checkpoint.py``).  A payload holds
the model's ``state_dict``, ``proto_class``, ``step``, ``phase``,
``max_steps`` and the Adam state keyed by parameter name (``opt``), so
that ``train --resume`` continues a halted or killed run exactly where
it stopped: a resumed run ends on the same parameters, bit for bit, as
an unbroken one wherever the device's kernels are deterministic (on the
card: ``torch.backends.cudnn.deterministic = True``).

Entry points run on the card unless the caller passes ``device="cpu"``;
a missing card raises before anything is written.

``mesh=`` (``core/mesh.py``) trains data-parallel, one process per rank:
each rank loads only its slice of every window and validation batch,
the steps are ``parallel/sharding.py``'s (global loss denominators, one
gradient SUM per window), the state is broadcast from the first rank at
every phase's start, and the first rank alone writes checkpoints,
``resume.json``, logs, TensorBoard and push artifacts, the others
waiting at a barrier after each save.  Every decision that ends or
changes a phase (validation accuracy, early stopping, the non-finite
guard, ``--halt-after``) reads values that are the same on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.config import ExperimentConfig
from adlm_tpu_torch.core.device import DeviceLike, resolve_device

STAGE_BY_PHASE = {0: "warmup", 1: "nopush", 2: "push"}

# run position markers for resume: each training stage in execution
# order, the push event sitting between joint and last-layer finetune
STAGE_ORDER = {"warmup": 0, "nopush": 1, "push": 2, "pruned": 3}

# a window's metrics go to the log every this many windows (and at a
# phase's first window), where the non-finite guard also looks
LOG_EVERY = 50


class TrainingHalted(Exception):
    """Raised for a graceful time-boxed stop (``--halt-after``): the
    current state and the resume marker are on disk already; ``train
    --resume`` continues from the exact window."""


class TrainingDiverged(Exception):
    """Raised when a phase's loss goes non-finite (checked at the log
    cadence and before every checkpoint save).  A non-finite state is
    never checkpointed: the stage's ``last``/``best`` payloads stay at
    the most recent finite window, so a relaunch (with e.g.
    ``--grad-clip``) resumes from a healthy state."""


def ship_dtypes(cfg: ExperimentConfig) -> Tuple[torch.dtype, torch.dtype]:
    """Host→device wire dtypes of the train windows' (images, labels),
    for ``data/pipeline.py::device_prefetch(dtypes=...)``: uint8 images
    under ``wire_uint8`` (the loader's normalization inverted on the host
    by ``wire_uint8_images`` and re-applied on the device by the step),
    else bf16 images when the step computes in bf16 (it casts them
    anyway, so rounding on the host is the same), else f32; uint8 labels
    when the ids fit (the step widens them before the void shift).  The
    bf16 cast happens into the pinned buffer, never in numpy."""
    if cfg.train.wire_uint8:
        if cfg.data.cells:
            raise ValueError(
                "wire_uint8 requires /255-scaled inputs (cells=False): "
                "the on-device normalizer (ops/normalize.py) assumes them")
        img = torch.uint8
    elif cfg.train.compute_dtype == "bfloat16":
        img = torch.bfloat16
    else:
        img = torch.float32
    lab = torch.uint8 if cfg.model.num_classes < 255 else torch.int32
    return img, lab


def wire_uint8_images(images: np.ndarray, mean, std) -> np.ndarray:
    """Invert the loader's ``(x/255 − mean)/std`` back to raw uint8
    pixels for the wire (``TrainConfig.wire_uint8``).  The augmented
    values are bilinear blends of uint8 sources rounded to uint8 steps,
    so the round trip through ``ops/normalize.py`` loses at most 0.5/255
    per pixel."""
    px = (images * (np.asarray(std, np.float32) * 255.0)
          + np.asarray(mean, np.float32) * 255.0)
    return np.clip(np.rint(px), 0.0, 255.0).astype(np.uint8)


def _ckpt_payload(state) -> Dict[str, Any]:
    """The whole train state: weights, ``proto_class``, the update count,
    the phase and its budget, and the Adam state keyed by parameter name
    (the reference drops the optimizer, ``torch.save(obj=ppnet)``,
    module.py:292-297, so its resume restarts moments and LR schedule)."""
    from adlm_tpu_torch.train.optimizer import adam_state_by_name

    return {"state_dict": state.model.state_dict(),
            "proto_class": state.proto_class,
            "step": int(state.step), "phase": int(state.phase),
            "max_steps": state.max_steps,
            "opt": adam_state_by_name(state.optimizer, state.model)}


def _restore_opt_state(state, payload: Dict[str, Any], log=print):
    """Put a payload's Adam state and update count into ``state``.  A
    payload without ``opt`` (a pruned checkpoint, or an older format)
    keeps the fresh moments (logged)."""
    from adlm_tpu_torch.train.optimizer import load_adam_state

    opt = payload.get("opt")
    if opt:
        load_adam_state(state.optimizer, state.model, opt)
    elif "opt" not in payload:
        log("resume: checkpoint has no optimizer state "
            "(old format) — starting with fresh moments")
    state.step = int(payload["step"])
    return state


def _resume_path(run_dir: str) -> str:
    return os.path.join(run_dir, "resume.json")


def _write_resume(run_dir: str, stage: str, windows_done: int,
                  n_windows: int, best_acc: float, stale: int, mesh=None) -> None:
    """Atomic resume marker (written beside every ``last`` save; by the
    first rank of a ``mesh`` only)."""
    if mesh is not None and not mesh.is_main:
        return
    meta = {"stage": stage, "windows_done": int(windows_done),
            "n_windows": int(n_windows),
            "completed": windows_done >= n_windows,
            "best_acc": float(best_acc), "stale": int(stale)}
    tmp = _resume_path(run_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _resume_path(run_dir))


def _read_resume(run_dir: str) -> Dict[str, Any]:
    with open(_resume_path(run_dir)) as f:
        return json.load(f)


def _run_phase(model, cfg: ExperimentConfig, phase: int, state,
               train_ds, val_ds, store: CheckpointStore, logger,
               max_steps: int, batch_size: int, val_every: int,
               val_batches: Optional[int],
               early_stopping_patience: Optional[int] = None,
               stage_key: Optional[str] = None,
               trace_dir: Optional[str] = None, start_window: int = 0,
               best_acc: float = -1.0, stale: int = 0,
               halt: Optional[Dict[str, int]] = None,
               device: DeviceLike = None, mesh=None):
    from adlm_tpu_torch.data.pipeline import BatchLoader, superbatch_iterator
    from adlm_tpu_torch.train.protoseg import make_eval_step, make_train_step

    t = cfg.train
    stage = stage_key or STAGE_BY_PHASE[phase]
    shard = None
    if mesh is not None:
        from adlm_tpu_torch.parallel.sharding import (
            make_sharded_train_step,
            shard_state,
        )

        if batch_size % mesh.data:
            raise ValueError(f"{stage}: batch {batch_size} does not divide over "
                             f"{mesh.data} data ranks")
        step_fn = make_sharded_train_step(model, cfg, phase, mesh, max_steps)
        state = shard_state(state, mesh)
        shard = (mesh.data_index, mesh.data)
        device = mesh.device
    else:
        step_fn = make_train_step(model, cfg, phase, max_steps, device=device)
    eval_fn = make_eval_step(model, cfg, device=device, mesh=mesh)
    n_windows = max(max_steps // t.iter_size, 1)
    _write_resume(store.run_dir, stage, start_window, n_windows, best_acc, stale,
                  mesh)
    if start_window >= n_windows:
        return state

    # the loader's index and augmentation streams are pure functions of
    # the seed and the window counter, so start_window > 0 resumes the
    # exact stream an unbroken run reads (data/pipeline.py)
    loader = BatchLoader(superbatch_iterator(
        train_ds, t.iter_size, batch_size, n_windows, seed=t.random_seed,
        n_jobs=cfg.data.dataloader_n_jobs, start_window=start_window,
        mode=cfg.data.dataloader_mode, shard=shard))
    dtypes = ship_dtypes(cfg)

    def ship(images, labels):
        if dtypes[0] == torch.uint8:
            # raw pixels on the wire; the step normalizes on the device
            images = wire_uint8_images(images, cfg.data.mean, cfg.data.std)
        return images, labels

    try:
        state, best_acc, stale = _phase_loop(
            loader, state, step_fn, eval_fn, val_ds, batch_size, val_batches,
            n_windows, val_every, early_stopping_patience, stage, store, logger,
            trace_dir=trace_dir, start_window=start_window, best_acc=best_acc,
            stale=stale, halt=halt, ship=ship, dtypes=dtypes, device=device,
            mesh=mesh)
    finally:
        loader.close()
    store.save(stage, "last", _ckpt_payload(state))
    # the completed marker carries the phase's final best accuracy and
    # stale count (the JAX package writes the values the phase began with)
    _write_resume(store.run_dir, stage, n_windows, n_windows, best_acc, stale, mesh)
    return state


def _phase_loop(loader, state, step_fn, eval_fn, val_ds, batch_size,
                val_batches, n_windows, val_every,
                early_stopping_patience, stage, store, logger,
                trace_dir=None, start_window=0, best_acc=-1.0,
                stale=0, halt=None, ship: Optional[Callable] = None,
                dtypes=None, device: DeviceLike = None, mesh=None):
    """The windows of one phase: the loader's host windows through
    ``ship`` (host casts) and ``device_prefetch`` into ``step_fn``, the
    metric log, the non-finite guard, validation with best and last
    saves, early stopping and the halt budget.  Returns (state, best
    val accuracy, stale validations)."""
    from adlm_tpu_torch.data.pipeline import device_prefetch
    from adlm_tpu_torch.utils.profiling import StepMeter, trace

    def casted(src):
        for images, labels in src:
            yield ship(images, labels) if ship is not None else (images, labels)

    def finite_loss(metrics) -> bool:
        return bool(np.isfinite(float(metrics["loss"])))

    meter = None
    windows = device_prefetch(casted(loader), device=device, dtypes=dtypes)
    for w, (images, labels) in enumerate(windows, start=start_window):
        if meter is None:
            meter = StepMeter(images_per_step=int(np.prod(images.shape[:2])))
        if (trace_dir is not None and w == start_window + 1
                and (mesh is None or mesh.is_main)):
            # profile one steady-state window (the first pays the
            # kernel builds and cuDNN's choices) under <trace_dir>/<stage>/
            with trace(f"{stage}_window", os.path.join(trace_dir, stage)):
                state, metrics = step_fn(state, images, labels)
                float(metrics["loss"])
            logger.log(f"{stage}: profiler trace written to {trace_dir}/{stage}")
        else:
            state, metrics = step_fn(state, images, labels)
        meter.tick()
        if (w + 1) % LOG_EVERY == 0 or w == start_window:
            n_patches = max(float(metrics["n_patches"]), 1)
            logger.metrics(w, stage, "train",
                           {"loss": float(metrics["loss"]),
                            "cross_entropy": float(metrics["cross_entropy"]),
                            "kld_loss": float(metrics["kld_loss"]),
                            "l1": float(metrics["l1"]),
                            "grad_norm": float(metrics.get("grad_norm", 0.0)),
                            "accuracy": float(metrics["n_correct"]) / n_patches,
                            **meter.rates()})
            if not finite_loss(metrics):
                logger.log(f"{stage}: NON-FINITE loss at window {w} "
                           f"(grad_norm={float(metrics.get('grad_norm', 0.0))}) — "
                           f"aborting the phase; last checkpoint is the "
                           f"most recent finite state")
                raise TrainingDiverged(stage)
        if (w + 1) % val_every == 0 or (w + 1) == n_windows:
            # never checkpoint a non-finite state: a poisoned ``last``
            # makes every resume non-finite from its first window
            if not finite_loss(metrics):
                logger.log(f"{stage}: NON-FINITE loss at validation "
                           f"window {w} — aborting without saving")
                raise TrainingDiverged(stage)
            val_metrics = _validate(eval_fn, state, val_ds, batch_size, val_batches,
                                    mesh)
            logger.metrics(w, stage, "val", val_metrics)
            if val_metrics["accuracy"] > best_acc:
                best_acc = val_metrics["accuracy"]
                stale = 0
                store.save(stage, "best", _ckpt_payload(state))
                logger.log(f"{stage}: new best val accuracy {best_acc:.4f}")
            else:
                stale += 1
            store.save(stage, "last", _ckpt_payload(state))
            _write_resume(store.run_dir, stage, w + 1, n_windows, best_acc, stale, mesh)
            if (early_stopping_patience is not None
                    and stale >= early_stopping_patience):
                logger.log(f"{stage}: early stopping after {stale} "
                           f"stale validations")
                break
        if halt is not None:
            halt["remaining"] -= 1
            if halt["remaining"] <= 0:
                # a halt on the phase's final window is a halt too:
                # windows_done == n_windows marks the stage completed,
                # so --resume enters the next stage
                if not finite_loss(metrics):
                    logger.log(f"{stage}: NON-FINITE loss at halting "
                               f"window {w} — aborting without saving")
                    raise TrainingDiverged(stage)
                store.save(stage, "last", _ckpt_payload(state))
                _write_resume(store.run_dir, stage, w + 1, n_windows, best_acc, stale,
                              mesh)
                logger.log(f"{stage}: halting after window {w + 1} "
                           f"(--halt-after); resume with train --resume")
                raise TrainingHalted(stage)
    return state, best_acc, stale


def _validate(eval_fn, state, val_ds, batch_size: int,
              val_batches: Optional[int] = None, mesh=None) -> Dict[str, float]:
    """Validation over the whole val split, in dataset order.

    The reference picks its best checkpoint by val accuracy over the
    full val split every val epoch (reference module.py:280-297).  The
    final partial batch wraps around to the split's start, so every
    batch has one shape, and the wrapped images are masked out through
    the eval step's ``n_valid``: each image counts exactly once.

    ``val_batches`` caps the number of (ordered) batches; None = all.

    With a ``mesh`` the eval step takes this rank's rows of each batch
    and returns the global batch's metrics.  Each rank still reads the
    whole batch: the crops of frames larger than the window come from
    the one ``val_ds.rng`` stream, in item order."""
    totals: Dict[str, float] = {}
    total_real = 0
    if val_ds.is_eval:
        val_ds.rng.seed(0)  # the same crops of frames larger than the window
    n_batches = -(-len(val_ds) // batch_size)
    if val_batches is not None:
        n_batches = min(val_batches, n_batches)
    for b in range(n_batches):
        start = b * batch_size
        n_real = min(batch_size, len(val_ds) - start)
        items = [val_ds[(start + j) % len(val_ds)] for j in range(batch_size)]
        images = np.stack([im for im, _ in items])
        labels = np.stack([lb for _, lb in items])
        if mesh is not None:
            rows = mesh.batch_slice(batch_size)
            images, labels = images[rows], labels[rows]
        m = eval_fn(state, images, labels, n_valid=n_real)
        for k, v in m.items():
            w = 1.0 if k in ("n_correct", "n_patches") else n_real
            totals[k] = totals.get(k, 0.0) + float(v) * w
        total_real += n_real
    out = {k: v / max(total_real, 1) for k, v in totals.items()
           if k not in ("n_correct", "n_patches")}
    out["accuracy"] = totals.get("n_correct", 0.0) / max(
        totals.get("n_patches", 1.0), 1.0)
    return out


def _first_rank_push(mesh, new_sd, new_pc):
    """The first rank's push result on every rank: the entries a push
    changes (prototype vectors, ``ones``, last layer, classes)."""
    changed = ("prototype_vectors", "ones", "last_layer.weight")
    ours = ({k: new_sd[k].cpu() for k in changed}, new_pc.cpu())
    theirs, pc = mesh.broadcast_object(ours)
    out = dict(new_sd)
    for k, v in theirs.items():
        out[k] = v.to(new_sd[k].device)
    return out, pc.to(new_pc.device)


def _with_prototypes(cfg: ExperimentConfig, n: int) -> ExperimentConfig:
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_prototypes=int(n)))


def _build_model(cfg: ExperimentConfig, state_dict=None, device=None):
    """A PPNet of ``cfg`` on ``device`` (channels-last): the port's
    initializers drawn from the run's seed, then ``state_dict`` if given."""
    from adlm_tpu_torch.models.ppnet import PPNet

    model = PPNet(cfg.model, generator=torch.Generator().manual_seed(
        cfg.train.random_seed))
    model.to(device=device, memory_format=torch.channels_last)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def run_protoseg_training(cfg: ExperimentConfig, run_dir: str,
                          data_path: Optional[str] = None,
                          pruned: bool = False,
                          start_checkpoint: Optional[str] = None,
                          val_every: int = 500,
                          val_batches: Optional[int] = None,
                          steps_scale: float = 1.0,
                          save_push_visualizations: bool = False,
                          push_batch_size: int = 1,
                          pretrained_path: Optional[str] = None,
                          pretrained_naming: str = "torchvision",
                          trace_dir: Optional[str] = None,
                          val_augment: bool = False,
                          resume: bool = False,
                          halt_after_windows: Optional[int] = None,
                          device: DeviceLike = None, mesh=None):
    """The full training pipeline on ``device`` (default the card).
    ``steps_scale`` shrinks every phase budget (1.0 is the reference
    schedule).  ``trace_dir`` writes a ``torch.profiler`` trace of one
    steady-state window per phase under ``<trace_dir>/<stage>/``.

    ``val_augment`` applies the training augment to validation as the
    reference does (reference segmentation/dataset.py:119-173); by
    default validation reads deterministic crops.

    ``resume=True`` continues a killed or halted run from its last
    checkpoint: stage, window, Adam moments, LR schedule position,
    early-stopping counters and the loader's streams all pick up where
    they stopped (``resume.json`` and the ``last`` payloads).  The
    reference cannot: it pickles the bare module and restarts phases
    from step 0 (reference segmentation/train.py:58-65).
    ``halt_after_windows`` stops gracefully after N optimizer windows,
    counted across phases.

    Returns the final ``ProtoSegState``.  The start is a PPNet of the
    port's initializers drawn from ``cfg.train.random_seed``, or
    ``start_checkpoint`` (``<run_dir>/checkpoints/<stage>_<kind>``), or a
    pretrained backbone.

    ``mesh`` trains data-parallel on ``mesh.device`` (see the module's
    docstring); every rank calls this with the same arguments."""
    dev = resolve_device(mesh.device if mesh is not None else device)

    from adlm_tpu_torch.data.constants import get_class_table
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.train.protoseg import init_protoseg_state
    from adlm_tpu_torch.utils.logging import RunLogger

    t = cfg.train
    if mesh is not None:
        from adlm_tpu_torch.parallel.sharding import RankStore, rank_logger

        logger = rank_logger(mesh, lambda: RunLogger(run_dir))
        store = RankStore(CheckpointStore(run_dir), mesh)
    else:
        logger = RunLogger(run_dir)
        store = CheckpointStore(run_dir)
    store.save_config(cfg.to_json())
    logger.log_hyperparams(json.loads(cfg.to_json()))
    table = get_class_table(cfg.data.class_table)

    train_ds = SegmentationDataset(cfg.data, cfg.data.train_key, data_path=data_path)
    val_ds = SegmentationDataset(cfg.data, "val", data_path=data_path,
                                 is_eval=not val_augment)

    warmup_steps = int(t.warmup_steps * steps_scale)
    joint_steps = int(t.joint_steps * steps_scale)
    finetune_steps = int(t.finetune_steps * steps_scale)
    halt = ({"remaining": int(halt_after_windows)} if halt_after_windows else None)

    def _restore_stage(stage: str, phase: int, max_steps: int, with_opt: bool):
        """(model, cfg, state) rebuilt from a stage's ``last`` payload;
        the prototype count comes from the payload (push and prune make
        it ragged).  ``with_opt`` restores the Adam state and step."""
        payload = store.restore(stage, "last", map_location=dev)
        sd = payload["state_dict"]
        rcfg = _with_prototypes(cfg, sd["prototype_vectors"].shape[0])
        rmodel = _build_model(rcfg, sd, dev)
        st = init_protoseg_state(rmodel, rcfg, phase, max_steps,
                                 proto_class=payload["proto_class"], device=dev)
        if with_opt:
            st = _restore_opt_state(st, payload, log=logger.log)
        return rmodel, rcfg, st

    entry_stage: Optional[str] = None
    entry_window, entry_best, entry_stale = 0, -1.0, 0
    if resume:
        if not os.path.exists(_resume_path(run_dir)):
            raise SystemExit(f"--resume: no resume.json under {run_dir} "
                             f"(nothing to resume)")
        meta = _read_resume(run_dir)
        run_complete = False
        if meta["completed"]:
            # stopped between stages: enter the next position; a stop
            # during the push event re-runs it (push is deterministic)
            entry_stage = {"warmup": "nopush", "nopush": "push_event",
                           "push": None, "pruned": None}[meta["stage"]]
            run_complete = entry_stage is None
        else:
            entry_stage = meta["stage"]
            entry_window = int(meta["windows_done"])
            entry_best = float(meta["best_acc"])
            entry_stale = int(meta["stale"])
        if entry_stage in STAGE_ORDER and not store.exists(entry_stage, "last"):
            # stopped between a stage's entry and its first save: the
            # stage holds no state yet, so re-enter it from the state of
            # the stage before it
            logger.log(f"resume: stage {entry_stage!r} has no "
                       f"checkpoint yet — re-entering it from its start")
            entry_window, entry_best, entry_stale = 0, -1.0, 0
            if entry_stage == "warmup":
                entry_stage = None  # the fresh start below
            elif entry_stage == "nopush":
                entry_stage = ("joint_start" if store.exists("warmup", "last")
                               else None)
            elif entry_stage == "push":
                # push/last is saved by the push event before the
                # finetune starts: without it the push never completed
                entry_stage = "push_event"
            elif entry_stage == "pruned":
                raise SystemExit("--resume: the pruned stage has no "
                                 "checkpoint — run the prune command first")
        logger.log(f"resume: stage={entry_stage} window={entry_window} "
                   f"best_acc={entry_best:.4f} stale={entry_stale}")
        if run_complete:
            logger.log("resume: run already complete — nothing to do")
            _, _, state = _restore_stage(meta["stage"], 2, finetune_steps,
                                         with_opt=True)
            logger.close()
            return state

    def _sw(stage):
        return entry_window if entry_stage == stage else 0

    def _ba(stage):
        return entry_best if entry_stage == stage else -1.0

    def _stl(stage):
        return entry_stale if entry_stage == stage else 0

    if pruned or entry_stage == "pruned":
        # finetune a pruned model (reference train.py:197-233); on
        # resume, continue it mid-phase with its moments
        model, pruned_cfg, state = _restore_stage(
            "pruned", 2, finetune_steps, with_opt=(entry_stage == "pruned"))
        logger.log("LAST LAYER FINE-TUNING (pruned)")
        try:
            state = _run_phase(model, pruned_cfg, 2, state, train_ds, val_ds,
                               store, logger, finetune_steps,
                               t.warmup_batch_size, val_every, val_batches,
                               early_stopping_patience=t.early_stopping_patience_last_layer,
                               stage_key="pruned", trace_dir=trace_dir,
                               start_window=_sw("pruned"), best_acc=_ba("pruned"),
                               stale=_stl("pruned"), halt=halt, device=dev,
                               mesh=mesh)
        except TrainingHalted:
            pass
        except TrainingDiverged as e:
            logger.log(f"training DIVERGED in stage {e.args[0]!r}; the last "
                       f"checkpoint holds the most recent finite state")
            logger.close()
            raise
        logger.close()
        return state

    # run position: 0 = warmup, 1 = joint, 1.5 = push event,
    # 2 = last-layer finetune
    if entry_stage == "warmup":
        model, cfg, state = _restore_stage("warmup", 0, warmup_steps, with_opt=True)
        pos = 0.0
    elif entry_stage == "joint_start":
        # the joint phase stopped before its first save: re-enter it at
        # window 0 from the completed warmup (the joint block below
        # builds the phase-1 optimizer and schedule afresh)
        model, cfg, state = _restore_stage("warmup", 0, warmup_steps, with_opt=False)
        pos = 1.0
    elif entry_stage == "nopush":
        model, cfg, state = _restore_stage("nopush", 1, joint_steps, with_opt=True)
        pos = 1.0
    elif entry_stage == "push_event":
        model, cfg, state = _restore_stage("nopush", 1, joint_steps, with_opt=False)
        pos = 1.5
    elif entry_stage == "push":
        model, cfg, state = _restore_stage("push", 2, finetune_steps, with_opt=True)
        pos = 2.0
    else:
        pos = 0.0
        start_sd = None
        if start_checkpoint:
            src = CheckpointStore(os.path.dirname(os.path.dirname(start_checkpoint)))
            start_sd = src.restore(*os.path.basename(start_checkpoint).rsplit("_", 1),
                                   map_location=dev)["state_dict"]
        model = _build_model(cfg, start_sd, dev)
        state = init_protoseg_state(model, cfg, 0, warmup_steps, device=dev)

    if pretrained_path and not start_checkpoint and entry_stage is None:
        # ImageNet/COCO backbone init (reference train.py:70-95): a torch
        # .pth state_dict or an .npz with the same keys
        from adlm_tpu_torch.utils.torch_import import load_deeplab_backbone

        logger.log(f"Loading pretrained backbone from {pretrained_path} "
                   f"({pretrained_naming} naming)")
        if pretrained_path.endswith(".npz"):
            with np.load(pretrained_path) as z:
                sd = {k: z[k] for k in z.files}
        else:
            sd = torch.load(pretrained_path, map_location="cpu", weights_only=True)
        target = model.state_dict()
        report = load_deeplab_backbone(target, sd, naming=pretrained_naming)
        logger.log(f"Loaded {len(report['loaded'])} tensors "
                   f"({len(report['unexpected_keys'])} unexpected)")
        if report["negative_variance_keys"]:
            logger.log(f"WARNING: {len(report['negative_variance_keys'])} "
                       f"BN running_var tensors have negative entries — "
                       f"forward passes will produce NaNs")
        model.load_state_dict(target, strict=True)

    if (t.bn_calibrate and not pretrained_path and not start_checkpoint
            and entry_stage is None):
        # from-scratch init: standardize the frozen BNs on real windows
        # (models/calibrate.py).  The windows are drawn with per-item
        # seeds, so the calibration is the same in every run
        from adlm_tpu_torch.models.calibrate import (
            calibrate_frozen_bn,
            standardize_presigmoid,
        )

        n_cal = min(4, len(train_ds))
        images = np.stack([train_ds.get_train_item(i, sample_seed=t.random_seed + i)[0]
                           for i in range(n_cal)])
        logger.log(f"bn-calibrate: standardizing frozen BNs on "
                   f"{n_cal} training windows")
        calibrate_frozen_bn(model, images, log=logger.log, device=dev)
        # the pre-sigmoid tensor has no BN and saturates the sigmoid at
        # random init; presigmoid_ln standardizes it for the whole run,
        # else fold a measured (x − μ)/σ into its producing convs
        if not cfg.model.presigmoid_ln:
            standardize_presigmoid(model, images, log=logger.log, device=dev)
        logger.log("bn-calibrate: done")

    if t.proto_init_data and not start_checkpoint and entry_stage is None:
        # from-scratch init, step 2: prototypes from real feature cells
        # of their own class (models/calibrate.py)
        from adlm_tpu_torch.models.calibrate import init_prototypes_from_data

        n_init = min(8, len(train_ds))
        items = [train_ds.get_train_item(i, sample_seed=t.random_seed + i)
                 for i in range(n_init)]
        init_prototypes_from_data(model, state.proto_class,
                                  np.stack([im for im, _ in items]),
                                  np.stack([lb for _, lb in items]),
                                  seed=t.random_seed, log=logger.log, device=dev)

    try:
        if pos <= 0 and warmup_steps > 0:
            logger.log(f"WARM-UP TRAINING START ({warmup_steps} steps)")
            state = _run_phase(model, cfg, 0, state, train_ds, val_ds, store,
                               logger, warmup_steps, t.warmup_batch_size,
                               val_every, val_batches, trace_dir=trace_dir,
                               start_window=_sw("warmup"), best_acc=_ba("warmup"),
                               stale=_stl("warmup"), halt=halt, device=dev,
                               mesh=mesh)

        if pos <= 1:
            logger.log(f"JOINT TRAINING START ({joint_steps} steps)")
            if entry_stage != "nopush":
                state = init_protoseg_state(model, cfg, 1, joint_steps,
                                            proto_class=state.proto_class, device=dev)
            state = _run_phase(model, cfg, 1, state, train_ds, val_ds, store,
                               logger, joint_steps, t.joint_batch_size,
                               val_every, val_batches, trace_dir=trace_dir,
                               start_window=_sw("nopush"), best_acc=_ba("nopush"),
                               stale=_stl("nopush"), halt=halt, device=dev,
                               mesh=mesh)

        if pos <= 1.5:
            logger.log("SAVING PROTOTYPES (push)")
            from adlm_tpu_torch.interpret.analysis import make_denorm
            from adlm_tpu_torch.interpret.push import push_prototypes

            push_ds = SegmentationDataset(cfg.data, cfg.data.train_key,
                                          data_path=data_path, is_eval=True,
                                          push_prototypes=True)
            # uint8 items normalized on the device (a quarter of the
            # bytes) where that equals the host path: batched and
            # without visualizations only
            raw_push = (push_batch_size > 1 and not save_push_visualizations
                        and push_ds.supports_raw_eval())
            # over a mesh the push splits its batches over the data ranks
            # where they divide; else every rank scans the whole split and
            # takes the first rank's prototypes
            sharded_push = (mesh is not None and push_batch_size > 1
                            and push_batch_size % mesh.data == 0)
            items = (push_ds.eval_batches(push_batch_size, with_counts=True, raw=raw_push,
                                          shard=(mesh.data_index, mesh.data))
                     if sharded_push else push_ds.eval_items(raw=raw_push))
            main = mesh is None or mesh.is_main
            new_sd, new_pc, _ = push_prototypes(
                model, state.proto_class, items,
                cfg.model.num_classes,
                run_dir=os.path.join(run_dir, "prototypes") if main else None,
                save_visualizations=save_push_visualizations and main,
                batch_size=push_batch_size, raw_uint8=raw_push,
                raw_normalize=(cfg.data.mean, cfg.data.std),
                get_item=lambda i: (lambda im, lb: (im[None], lb[None]))(
                    *push_ds.get_eval_item(i)),
                class_names=table.class_names, log=logger.log,
                denorm=make_denorm(cfg.data), device=dev,
                mesh=mesh if sharded_push else None)
            if mesh is not None and not sharded_push:
                new_sd, new_pc = _first_rank_push(mesh, new_sd, new_pc)
            pushed_cfg = _with_prototypes(cfg, new_sd["prototype_vectors"].shape[0])
            model = _build_model(pushed_cfg, new_sd, dev)
            state = init_protoseg_state(model, pushed_cfg, 2, finetune_steps,
                                        proto_class=new_pc, device=dev)
            store.save("push", "last", _ckpt_payload(state))
            store.save("push", "best", _ckpt_payload(state))
        else:
            pushed_cfg = cfg  # resumed into the finetune: cfg is rebuilt

        logger.log("LAST LAYER FINE-TUNING")
        state = _run_phase(model, pushed_cfg, 2, state, train_ds, val_ds, store,
                           logger, finetune_steps, t.warmup_batch_size,
                           val_every, val_batches,
                           early_stopping_patience=t.early_stopping_patience_last_layer,
                           stage_key="push", trace_dir=trace_dir,
                           start_window=_sw("push"), best_acc=_ba("push"),
                           stale=_stl("push"), halt=halt, device=dev,
                           mesh=mesh)
    except TrainingHalted:
        logger.log("training halted (--halt-after); continue with "
                   "train --resume")
    except TrainingDiverged as e:
        logger.log(f"training DIVERGED in stage {e.args[0]!r}; the last "
                   f"checkpoint holds the most recent finite state — "
                   f"relaunch with --resume and a stability knob "
                   f"(e.g. --grad-clip)")
        logger.close()
        raise
    logger.close()
    return state

"""U-Noise training runs, utility and noise model (counterpart of
``adlm_tpu.train.unoise_pipeline``).

Mirrors reference src/train_util.py:45-59 and src/train_noise.py:105-137:
load the slice arrays, ordered 80/10/10 split, train with per-epoch
validation; the utility model keeps its best checkpoint by val dice, the
noise model by val loss.  A run directory holds ``utility_config.json``
or ``noise_config.json`` (the U-Net's depth and channel factor, read by
the noise trainer, ``unoise-visualize`` and ``unoise-figures``) and the
checkpoints ``utility_{last,best}`` or ``noise_{last,best}``: payloads
``{"state_dict", "step"}``, no optimizer state, as the JAX package's.

The device is resolved and the arrays read before anything is written.
Batches come from ``unoise_data.batches`` (4 loader threads) through a
``BatchLoader`` and ``device_prefetch``; ε is drawn on the device from a
generator seeded with 1.

With a ``mesh`` (``--mesh-data``) the training steps are data-parallel
(``parallel/sharding.py``): each rank loads its rows of every batch, the
batches drop their partial tail (the JAX package's ``drop_last`` under a
mesh), and the first rank writes the checkpoints and logs.  Validation
runs whole on every rank, and the first rank's value decides the best
checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.config import UNoiseConfig
from adlm_tpu_torch.core.device import resolve_device
from adlm_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from adlm_tpu_torch.data.unoise_data import batches, split_datasets
from adlm_tpu_torch.train.unoise import (
    NoiseState,
    UtilityState,
    init_noise_state,
    init_utility_state,
    make_noise_eval_step,
    make_noise_train_step,
    make_utility_eval_step,
    make_utility_train_step,
)
from adlm_tpu_torch.utils.logging import RunLogger
from adlm_tpu_torch.utils.torch_import import load_unoise_checkpoint

LOADER_JOBS = 4


def results_dir() -> str:
    return os.environ.get("RESULTS_DIR", "./runs")


def load_split(args, raw: bool = True):
    """(train, val, test) datasets of ``--imgs``/``--masks``/``--boxes``,
    the slices without a box dropped first.  Training and the
    interpretation commands share this split, so the test slices never
    overlap the training data.  ``raw`` items are (H, W, 1) slices that
    the steps tile to 3 channels and normalize on the device; otherwise
    normalized (H, W, 3) items."""
    imgs = np.load(args.imgs)
    masks = np.load(args.masks)
    boxes = (np.load(args.boxes, allow_pickle=True)
             if args.boxes and os.path.exists(args.boxes) else None)
    return split_datasets(imgs, masks, boxes, raw=raw)


def _cfg_from_args(args) -> UNoiseConfig:
    return UNoiseConfig(
        depth=args.depth, channel_factor=args.channel_factor,
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        epochs=args.epochs,
        min_scale=getattr(args, "min_scale", 1.0),
        max_scale=getattr(args, "max_scale", 5.0),
        noise_coeff=getattr(args, "noise_coeff", 0.001),
        compute_dtype="bfloat16" if args.bf16 else "float32")


def _epoch_batches(ds, cfg: UNoiseConfig, epoch: int, mesh=None):
    shard = None if mesh is None else (mesh.data_index, mesh.data)
    return BatchLoader(batches(ds, cfg.batch_size, shuffle=True, seed=epoch,
                               n_jobs=LOADER_JOBS, drop_last=mesh is not None,
                               shard=shard))


def _mesh_io(mesh, run_dir: str, name: str):
    """(logger, store) of a run: the first rank's, quiet elsewhere."""
    if mesh is None:
        return RunLogger(run_dir, name), CheckpointStore(run_dir)
    from adlm_tpu_torch.parallel.sharding import RankStore, rank_logger

    return (rank_logger(mesh, lambda: RunLogger(run_dir, name)),
            RankStore(CheckpointStore(run_dir), mesh))


def _first_rank(mesh, value: float) -> float:
    """A decision value the same on every rank: the first rank's."""
    return value if mesh is None else float(mesh.broadcast_object(value))


def _payload(model: torch.nn.Module, step: int) -> dict:
    return {"state_dict": model.state_dict(), "step": step}


def _check_batch(cfg: UNoiseConfig, mesh) -> None:
    if mesh is not None and cfg.batch_size % mesh.data:
        raise SystemExit("--batch-size must be divisible by --mesh-data")


def train_utility(args, mesh=None) -> UtilityState:
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = dataclasses.replace(_cfg_from_args(args), util_depth=args.depth,
                              util_channel_factor=args.channel_factor)
    _check_batch(cfg, mesh)
    train_ds, val_ds, _ = load_split(args)
    run_dir = os.path.join(results_dir(), args.run_name)
    logger, store = _mesh_io(mesh, run_dir, "unoise_util")
    state = init_utility_state(cfg, seed=0, device=dev)
    if mesh is not None:
        from adlm_tpu_torch.parallel.sharding import make_sharded_utility_step, shard_state

        state = shard_state(state, mesh)
        step = make_sharded_utility_step(cfg, mesh, raw=True)
    else:
        step = make_utility_train_step(cfg, raw=True)
    evaluate = make_utility_eval_step(cfg, raw=True)
    # the noise trainer rebuilds the frozen utility model from this
    store.save_metadata("utility_config", {"depth": cfg.util_depth,
                                           "channel_factor": cfg.util_channel_factor})
    best_dice = -1.0
    try:
        for epoch in range(cfg.epochs):
            loader = _epoch_batches(train_ds, cfg, epoch, mesh)
            try:
                for imgs, masks in device_prefetch(loader, device=dev):
                    step(state, imgs, masks)
            finally:
                loader.close()
            dices, losses = [], []
            for imgs, masks in device_prefetch(batches(val_ds, cfg.batch_size), device=dev):
                m = evaluate(state, imgs, masks)
                dices.append(float(m["val_dice"]))
                losses.append(float(m["val_loss"]))
            dice = _first_rank(mesh, float(np.mean(dices)) if dices else 0.0)
            logger.metrics(epoch, "utility", "val",
                           {"val_dice": dice,
                            "val_loss": float(np.mean(losses)) if losses else 0})
            payload = _payload(state.model, state.step)
            store.save("utility", "last", payload)
            if dice > best_dice:
                best_dice = dice
                store.save("utility", "best", payload)
                logger.log(f"epoch {epoch}: new best val dice {dice:.4f}")
    finally:
        logger.close()
    return state


def _noise_pretrained(args, cfg: UNoiseConfig, logger: RunLogger
                      ) -> Optional[Mapping[str, torch.Tensor]]:
    """The noise model's optional init from a pretrained utility model
    (the reference's "pretrained" variants, train_noise.py:115-119)."""
    if args.pretrained_torch_ckpt:
        sd, depth, cf = load_unoise_checkpoint(args.pretrained_torch_ckpt, "utility")
        if (depth, cf) != (cfg.depth, cfg.channel_factor):
            raise SystemExit(
                f"--pretrained-torch-ckpt architecture (depth {depth}, cf {cf}) "
                f"does not match the noise model (depth {cfg.depth}, cf "
                f"{cfg.channel_factor})")
        logger.log(f"Initializing noise model from torch checkpoint "
                   f"{args.pretrained_torch_ckpt!r}")
        return sd
    if args.pretrained:
        payload = CheckpointStore(os.path.join(results_dir(), args.pretrained)
                                  ).restore("utility", "best")
        logger.log(f"Initializing noise model from pretrained run {args.pretrained!r}")
        return payload["state_dict"]
    return None


def train_noise(args, mesh=None) -> NoiseState:
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = _cfg_from_args(args)
    _check_batch(cfg, mesh)
    train_ds, val_ds, _ = load_split(args)
    run_dir = os.path.join(results_dir(), args.run_name)
    logger, store = _mesh_io(mesh, run_dir, "unoise_noise")
    try:
        if args.utility_torch_ckpt:
            # the frozen utility straight from a reference lightning checkpoint
            util_sd, depth, cf = load_unoise_checkpoint(args.utility_torch_ckpt, "utility")
            logger.log(f"Loaded frozen utility model from torch checkpoint "
                       f"{args.utility_torch_ckpt!r} (depth {depth}, cf {cf})")
        else:
            util_dir = os.path.join(results_dir(), args.utility_run)
            util_sd = CheckpointStore(util_dir).restore("utility", "best")["state_dict"]
            with open(os.path.join(util_dir, "utility_config.json")) as f:
                uc = json.load(f)
            depth, cf = uc["depth"], uc["channel_factor"]
        cfg = dataclasses.replace(cfg, util_depth=depth, util_channel_factor=cf)
        state = init_noise_state(cfg, util_sd, seed=0,
                                 pretrained=_noise_pretrained(args, cfg, logger), device=dev)
        if mesh is not None:
            from adlm_tpu_torch.parallel.sharding import make_sharded_noise_step, shard_state

            state = shard_state(state, mesh)
            step = make_sharded_noise_step(cfg, mesh, raw=True)
        else:
            step = make_noise_train_step(cfg, raw=True)
        evaluate = make_noise_eval_step(cfg, raw=True)
        # the visualization and figure commands rebuild each run's U-Net
        # from this, not from their flags
        store.save_metadata("noise_config", {"depth": cfg.depth,
                                             "channel_factor": cfg.channel_factor})
        gen = torch.Generator(device=dev).manual_seed(1)
        best_loss = np.inf
        for epoch in range(cfg.epochs):
            loader = _epoch_batches(train_ds, cfg, epoch, mesh)
            try:
                for imgs, masks in device_prefetch(loader, device=dev):
                    step(state, imgs, masks, generator=gen)
            finally:
                loader.close()
            losses, dices = [], []
            for imgs, masks in device_prefetch(batches(val_ds, cfg.batch_size), device=dev):
                m = evaluate(state, imgs, masks, generator=gen)
                losses.append(float(m["val_loss"]))
                dices.append(float(m["val_dice"]))
            vl = _first_rank(mesh, float(np.mean(losses)) if losses else np.inf)
            logger.metrics(epoch, "noise", "val",
                           {"val_loss": vl,
                            "val_dice": float(np.mean(dices)) if dices else 0})
            payload = _payload(state.model, state.step)
            store.save("noise", "last", payload)
            if vl < best_loss:
                best_loss = vl
                store.save("noise", "best", payload)
                logger.log(f"epoch {epoch}: new best val loss {vl:.4f}")
    finally:
        logger.close()
    return state

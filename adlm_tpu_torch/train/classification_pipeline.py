"""ProtoPNet classification training loop (counterpart of
``adlm_tpu.train.classification_pipeline``).

The reference's ``main.py`` epoch loop (main.py:107-189): warm epochs,
then joint epochs under a StepLR; a prototype push from ``push_start``
every ``push_every`` epochs, each push followed by last-layer
iterations; accuracy-gated checkpoints (reference save.py:4-11) under
the stages ``nopush`` and ``push``, ``nopush_last`` at the end.  The run
directory holds the JAX run's files: ``cls_config.json`` (the JAX
package's keys), ``logs/classification.log`` with its lines and
``logs/classification_metrics.csv`` with its columns; the checkpoints
are the port's ``state.pt`` payloads (``{"state_dict", "proto_class",
"step"}``).

With a ``mesh`` (``--mesh-data``) the train steps are data-parallel
(``parallel/sharding.py::make_sharded_cls_step``): ``train_batches``
then yields this rank's rows of each batch (``ImageFolderDataset.batches(
shard=...)``), test and push batches run whole on every rank, the first
rank's accuracy decides each save and its pushed prototypes go to every
rank, and the first rank writes the checkpoints and logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.core.device import DeviceLike, resolve_device
from adlm_tpu_torch.train.classification import (
    ClassificationConfig,
    ClassifierState,
    build_classifier,
    init_classifier_state,
    make_cls_eval_step,
    make_cls_train_step,
    push_classification_prototypes,
    set_prototypes,
    unpack_batch,
)
from adlm_tpu_torch.utils.logging import RunLogger

BatchIter = Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]]


def run_epoch(step_fn, state: ClassifierState, batches,
              n_ranks: int = 1) -> Tuple[ClassifierState, float]:
    """One pass of ``step_fn`` over ``batches``: (state, train accuracy
    over every image stepped, wrapped ones included, as the JAX run
    counts).  ``n_ranks``: each batch is one of that many data ranks'
    equal slices (the step's ``n_correct`` is the global batch's)."""
    n_correct = torch.zeros((), device=state.proto_class.device)
    n_total = 0
    for batch in batches:
        images, labels = batch[0], batch[1]
        state, m = step_fn(state, images, labels)
        n_correct += m["n_correct"]
        n_total += images.shape[0] * n_ranks
    return state, float(n_correct) / max(n_total, 1)


def evaluate(eval_fn, state: ClassifierState, batches) -> float:
    """Test accuracy; the wrap-padded tail images of ``with_count``
    batches are left out."""
    n_correct = torch.zeros((), device=state.proto_class.device)
    n_total = 0
    for batch in batches:
        images, labels, n_valid = unpack_batch(batch)
        m = eval_fn(state, images, labels)
        n_correct += m["correct"][:n_valid].sum()
        n_total += n_valid
    return float(n_correct) / max(n_total, 1)


def cls_payload(state: ClassifierState) -> dict:
    return {"state_dict": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "proto_class": state.proto_class.cpu(), "step": int(state.step)}


def save_if_better(store: CheckpointStore, stage: str, state: ClassifierState,
                   acc: float, best: float, threshold: float, log) -> float:
    """Accuracy-threshold-gated save (reference save.py:4-11)."""
    if acc > threshold and acc > best:
        store.save(stage, "best", cls_payload(state))
        log(f"{stage}: saved at accuracy {acc:.4f}")
        return acc
    return best


def load_pretrained_stem(model, path: str, arch: str, log) -> None:
    """ImageNet stem weights from a torchvision ``.pth`` state_dict (or
    an ``.npz`` of its arrays) into ``model``'s ``features``."""
    from adlm_tpu_torch.utils.torch_import import load_classification_backbone

    log(f"Loading pretrained stem from {path}")
    if path.endswith(".npz"):
        sd = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    target = model.state_dict()
    report = load_classification_backbone(target, sd, arch)
    if report["negative_variance_keys"]:
        raise ValueError(f"corrupt BN running_var in {path}: "
                         f"{report['negative_variance_keys'][:8]}")
    model.load_state_dict(target)
    log(f"Loaded {len(report['loaded'])} tensors "
        f"({len(report['unexpected_keys'])} unexpected)")


def run_classification_training(
    cfg: ClassificationConfig,
    run_dir: str,
    train_batches: BatchIter,
    test_batches: BatchIter,
    push_batches: Optional[BatchIter] = None,
    num_epochs: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
    target_accuracy: float = 0.0,
    last_layer_iterations: int = 20,  # reference main.py:180 runs 20
    push_every: int = 10,             # reference: every 10th epoch
    pretrained_path: Optional[str] = None,
    device: DeviceLike = None,
    seed: int = 0,
    mesh=None,
) -> ClassifierState:
    """The classifier's training run on ``device`` (default the card;
    without one it raises before it writes anything).  The model starts
    from the port's initializers drawn from ``seed``.  ``steps_per_epoch``
    (the StepLR's epoch in updates) defaults to the count of
    ``train_batches()``.  ``mesh``: data-parallel train steps (see the
    module's docstring)."""
    dev = resolve_device(mesh.device if mesh is not None else device)
    if mesh is None:
        logger = RunLogger(run_dir, "classification")
        store = CheckpointStore(run_dir)
    else:
        from adlm_tpu_torch.parallel.sharding import (
            RankStore,
            make_sharded_cls_step,
            rank_logger,
            shard_state,
        )

        logger = rank_logger(mesh, lambda: RunLogger(run_dir, "classification"))
        store = RankStore(CheckpointStore(run_dir), mesh)
    push_batches = push_batches or train_batches
    if mesh is None or mesh.is_main:
        save_cls_config(run_dir, cfg)
    if steps_per_epoch is None:
        steps_per_epoch = max(sum(1 for _ in train_batches()), 1)

    model = build_classifier(cfg, dev, seed)
    if pretrained_path:
        load_pretrained_stem(model, pretrained_path, cfg.model.base_architecture, logger.log)
    state = init_classifier_state(model, cfg, "warm", steps_per_epoch, device=dev)
    if mesh is None:
        steps = {phase: make_cls_train_step(model, cfg, phase, device=dev)
                 for phase in ("warm", "joint", "last")}
        n_ranks = 1
    else:
        state = shard_state(state, mesh)
        steps = {phase: make_sharded_cls_step(model, cfg, phase, mesh)
                 for phase in ("warm", "joint", "last")}
        n_ranks = mesh.data
    eval_fn = make_cls_eval_step(model, cfg, device=dev)

    def test_accuracy(st) -> float:
        acc = evaluate(eval_fn, st, test_batches())
        return acc if mesh is None else float(mesh.broadcast_object(acc))

    best = 0.0
    epochs = num_epochs if num_epochs is not None else cfg.num_train_epochs
    for epoch in range(epochs):
        if epoch < cfg.num_warm_epochs:
            stage = "warm"
        else:
            stage = "joint"
            if epoch == cfg.num_warm_epochs:
                # a fresh joint optimizer (and StepLR count) at the switch
                state = init_classifier_state(model, cfg, "joint", steps_per_epoch,
                                              device=dev)
        state, train_acc = run_epoch(steps[stage], state, train_batches(), n_ranks)
        acc = test_accuracy(state)
        logger.metrics(epoch, stage, "test", {"accuracy": acc, "train_accuracy": train_acc})
        best = save_if_better(store, "nopush", state, acc, best, target_accuracy, logger.log)

        if epoch >= cfg.push_start and epoch % push_every == 0:
            logger.log(f"epoch {epoch}: prototype push")
            protos, _ = push_classification_prototypes(state, push_batches(), device=dev)
            if mesh is not None:
                mesh.broadcast_([protos])
            set_prototypes(model, protos)
            acc = test_accuracy(state)
            best = save_if_better(store, "push", state, acc, best, target_accuracy,
                                  logger.log)
            # last-layer convex optimization after each push; the
            # reference evaluates and conditionally saves after EVERY
            # iteration (main.py:180-189)
            state_l = init_classifier_state(model, cfg, "last", steps_per_epoch, device=dev)
            for it in range(last_layer_iterations):
                state_l, _ = run_epoch(steps["last"], state_l, train_batches(), n_ranks)
                acc = test_accuracy(state_l)
                logger.metrics(epoch, f"push_last_{it}", "test", {"accuracy": acc})
                best = save_if_better(store, "push", state_l, acc, best, target_accuracy,
                                      logger.log)
    store.save("nopush", "last", cls_payload(state))
    logger.close()
    return state


def save_cls_config(run_dir: str, cfg: ClassificationConfig) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "cls_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_cls_config(run_dir: str) -> ClassificationConfig:
    with open(os.path.join(run_dir, "cls_config.json")) as f:
        d = json.load(f)
    model_d = d.pop("model")
    for k in ("deeplab_n_blocks", "atrous_rates", "msc_scales"):
        if k in model_d and isinstance(model_d[k], list):
            model_d[k] = tuple(model_d[k])
    return ClassificationConfig(model=PPNetConfig(**model_d), **d)

"""ProtoPNet image classification (counterpart of
``adlm_tpu.train.classification``; reference main.py, train_and_test.py:
37-99, push.py, prune.py, find_nearest.py, defaults from settings.py:
5-48).

Train and eval steps with the class-specific cluster / separation /
masked-L1 losses over global-min-pooled distances, the warm / joint /
last phases with their Adam groups and the joint phase's StepLR, an
RF-aware push, the k-nearest scan and pruning.  As in the JAX package:

* the steps take NHWC float32 batches (``ImageFolderDataset.batches``)
  and feed the NCHW model channels-last views;
* the model runs in train mode in all three phases, so the stem's BN
  statistics move in warm and last too; a frozen group is frozen with
  ``requires_grad_(False)`` (``optax.set_to_zero`` in the JAX package),
  set again at every step of its phase;
* ``compute_dtype="bfloat16"`` casts the f32 parameters to bf16 inside
  the differentiated call: the gradients come back f32, the BN
  statistics stay f32;
* the prototype head's forward (``ops/prototype.py``) is the CUDA
  kernel on the card, its backward plain PyTorch; push and the scan
  compute distances with the plain ``l2_distances``, as the JAX package
  does outside Pallas.

f32 runs in IEEE f32 (``core.device.ieee_f32``), the backward included.
Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.core.device import DeviceLike, ieee_f32, resolve_device, to_device
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class, prune_params
from adlm_tpu_torch.ops.losses import masked_l1
from adlm_tpu_torch.ops.prototype import l2_distances
from adlm_tpu_torch.train.optimizer import Schedule, make_adam, set_lrs

Metrics = Dict[str, torch.Tensor]
PHASES = ("warm", "joint", "last")


@dataclasses.dataclass(frozen=True)
class ClassificationConfig:
    """Defaults from reference settings.py:5-48 (CUB-200)."""

    model: PPNetConfig = dataclasses.field(default_factory=lambda: PPNetConfig(
        base_architecture="vgg19", img_size=224, num_prototypes=2000,
        prototype_channels=128, num_classes=200,
        add_on_layers_type="regular", patch_classification=False))
    joint_lr_features: float = 1e-4
    joint_lr_add_on: float = 3e-3
    joint_lr_protos: float = 3e-3
    joint_lr_step_size: int = 5       # epochs; StepLR gamma 0.1 (main.py)
    warm_lr_add_on: float = 3e-3
    warm_lr_protos: float = 3e-3
    last_layer_lr: float = 1e-4
    coef_crs_ent: float = 1.0
    coef_clst: float = 0.8
    coef_sep: float = -0.08
    coef_l1: float = 1e-4
    num_warm_epochs: int = 5
    num_train_epochs: int = 1000
    push_start: int = 10
    # bf16 weights and activations (the reference trains f32; loss math
    # and stored state stay f32)
    compute_dtype: str = "float32"


@dataclasses.dataclass
class ClassifierState:
    """What a phase carries between steps: ``model`` holds the
    parameters and BN statistics, ``optimizer`` the Adam moments of the
    phase's trained groups (None: no training), ``lr_scale`` its
    schedule; ``step`` counts the phase's optimizer updates from 0."""

    model: PPNet
    optimizer: Optional[torch.optim.Adam]
    lr_scale: Schedule
    proto_class: torch.Tensor
    phase: Optional[str]
    step: int = 0


def classification_loss(logits: torch.Tensor, min_distances: torch.Tensor,
                        labels: torch.Tensor, proto_class: torch.Tensor,
                        last_layer_weight: torch.Tensor,
                        cfg: ClassificationConfig, class_specific: bool = True,
                        n_total: Optional[int] = None, l1_weight: Optional[float] = None
                        ) -> Tuple[torch.Tensor, Metrics]:
    """CE + cluster + separation + masked L1 over min-pooled distances
    (reference train_and_test.py:37-99).  ``last_layer_weight`` is
    (P, K), the JAX package's layout.  f32, or f64 for f64 logits.

    ``n_total``: the batch means divide this rank's sums by the global
    batch size instead (a data-parallel rank's share); ``l1_weight``
    replaces ``cfg.coef_l1`` in the loss (0 on all data ranks but the
    first, which adds the parameter term once)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    labels = labels.long()

    def mean(v):
        return v.mean() if n_total is None else v.sum() / n_total

    ce = (F.cross_entropy(logits, labels) if n_total is None
          else F.cross_entropy(logits, labels, reduction="sum") / n_total)
    max_dist = float(cfg.model.prototype_channels)  # P_ch * 1 * 1

    correct = (proto_class[None, :] == labels[:, None]).to(torch.float32)
    inv_correct = ((max_dist - min_distances) * correct).amax(dim=1)
    cluster = mean(max_dist - inv_correct)

    wrong = 1.0 - correct
    inv_wrong = ((max_dist - min_distances) * wrong).amax(dim=1)
    separation = mean(max_dist - inv_wrong)
    avg_separation = mean((min_distances * wrong).sum(1)
                          / wrong.sum(1).clamp_min(1.0))

    l1 = masked_l1(last_layer_weight, proto_class)
    coef_l1 = cfg.coef_l1 if l1_weight is None else l1_weight
    if class_specific:
        loss = (cfg.coef_crs_ent * ce + cfg.coef_clst * cluster
                + cfg.coef_sep * separation + coef_l1 * l1)
    else:
        cluster = mean(min_distances.amin(dim=1))
        loss = cfg.coef_crs_ent * ce + cfg.coef_clst * cluster + coef_l1 * l1
    n_correct = (logits.argmax(-1) == labels).sum().to(torch.float32)
    return loss, {"cross_entropy": ce, "cluster": cluster,
                  "separation": separation, "avg_separation": avg_separation,
                  "l1": l1, "n_correct": n_correct}


def unpack_batch(batch) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(images, labels)`` or ``(images, labels, n_valid)`` (the
    ``with_count`` batches) → a triple."""
    if len(batch) == 3:
        return batch
    images, labels = batch
    return images, labels, images.shape[0]


def _cls_label(name: str) -> str:
    keys = name.split(".")
    if "prototype_vectors" in keys:
        return "protos"
    if "last_layer" in keys:
        return "last"
    if "add_on_layers" in keys:
        return "add_on"
    return "features"


def label_cls_params(model: nn.Module) -> Dict[str, str]:
    """Parameter name → group: ``protos``, ``last``, ``add_on`` or
    ``features``."""
    return {name: _cls_label(name) for name, _ in model.named_parameters()}


def cls_phase_groups(cfg: ClassificationConfig, phase: str
                     ) -> Dict[str, Tuple[float, float]]:
    """Trained group → (lr, weight decay) of a phase (reference
    main.py:110-129): warm trains the add-ons and prototypes (the last
    layer keeps its class-connection init), joint the features, add-ons
    and prototypes, last the last layer alone."""
    if phase == "warm":
        return {"add_on": (cfg.warm_lr_add_on, 1e-3), "protos": (cfg.warm_lr_protos, 0.0)}
    if phase == "joint":
        return {"features": (cfg.joint_lr_features, 1e-3),
                "add_on": (cfg.joint_lr_add_on, 1e-3),
                "protos": (cfg.joint_lr_protos, 0.0)}
    if phase == "last":
        return {"last": (cfg.last_layer_lr, 0.0)}
    raise ValueError(f"unknown phase {phase!r}")


def cls_lr_scale(cfg: ClassificationConfig, phase: str,
                 steps_per_epoch: int = 1) -> Schedule:
    """The factor on every group's lr at update ``u`` (from 0): the
    joint phase's per-epoch StepLR(step_size, 0.1) as a staircase over
    ``step_size · steps_per_epoch`` updates; 1 in warm and last."""
    if phase != "joint":
        return lambda count: 1.0
    every = cfg.joint_lr_step_size * steps_per_epoch
    return lambda count: 0.1 ** (count // every)


def freeze_for_phase(model: nn.Module, cfg: ClassificationConfig, phase: str) -> None:
    """``requires_grad`` on the phase's trained groups only."""
    trained = cls_phase_groups(cfg, phase)
    for name, p in model.named_parameters():
        p.requires_grad_(_cls_label(name) in trained)


def build_classifier(cfg: ClassificationConfig, device: DeviceLike = None,
                     seed: int = 0, state_dict: Optional[Dict[str, torch.Tensor]] = None
                     ) -> PPNet:
    """A classification PPNet on ``device`` (default the card;
    channels-last): the port's initializers drawn from ``seed``, or
    ``state_dict`` loaded strictly (then no initializer runs, and any
    prototype count loads, a pruned one too)."""
    dev = resolve_device(device)
    if state_dict is None:
        model = PPNet(cfg.model, generator=torch.Generator().manual_seed(seed))
        model.to(device=dev)
    else:
        with torch.device("meta"):
            model = PPNet(cfg.model)
        model = model.to_empty(device=dev)
        model.load_state_dict(state_dict, strict=True)
    return model.to(memory_format=torch.channels_last)


def _prepare(model: nn.Module, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last)
    return dev


def init_classifier_state(model: PPNet, cfg: ClassificationConfig,
                          phase: Optional[str], steps_per_epoch: int = 1,
                          proto_class: Optional[torch.Tensor] = None,
                          device: DeviceLike = None) -> ClassifierState:
    """A fresh ``phase`` on ``model``'s current weights: a new Adam over
    its trained groups (moments 0, step 0) and its schedule.
    ``phase=None`` gives a state that trains nothing (eval, push, scan).
    ``proto_class`` defaults to contiguous equal blocks."""
    dev = _prepare(model, device)
    if proto_class is None:
        proto_class = default_proto_class(cfg.model.num_prototypes, cfg.model.num_classes)
    opt, scale = None, (lambda count: 1.0)
    if phase is not None:
        labels = label_cls_params(model)
        groups = []
        for label, (lr, wd) in cls_phase_groups(cfg, phase).items():
            params = [p for n, p in model.named_parameters() if labels[n] == label]
            if params:
                groups.append({"params": params, "lr": lr, "weight_decay": wd,
                               "label": label, "base_lr": lr})
        opt, scale = make_adam(groups), cls_lr_scale(cfg, phase, steps_per_epoch)
    return ClassifierState(model=model, optimizer=opt, lr_scale=scale,
                           proto_class=torch.as_tensor(proto_class).long().to(dev),
                           phase=phase)


def _nchw(images, dev: torch.device) -> torch.Tensor:
    """NHWC batch → NCHW view on ``dev`` (channels-last strides), f32."""
    return to_device(images, dev, torch.float32).permute(0, 3, 1, 2)


def make_cls_train_step(model: PPNet, cfg: ClassificationConfig, phase: str,
                        device: DeviceLike = None, mesh=None) -> Callable:
    """``step(state, images, labels) -> (state, metrics)``: one update of
    ``phase`` on a (B, S, S, 3) batch, on ``device`` (default the card).
    Metrics are 0-d tensors on the device (``loss``, the loss terms and
    ``n_correct``); the step's gradients stay in ``.grad``.  ``state``
    is updated in place and returned.

    With a ``mesh`` (``parallel/sharding.py::make_sharded_cls_step``) the
    batch is this rank's slice: the stem's BatchNorms take the global
    batch's statistics, the means divide by the global batch size, the
    masked L1 enters on the first data rank only, and one flattened SUM
    reduces the gradients and the metrics before the update."""
    dev = _prepare(model, mesh.device if mesh is not None else device)
    bf16 = cfg.compute_dtype == "bfloat16"
    if mesh is not None:
        from adlm_tpu_torch.parallel.sharding import set_batch_norm_reduce

        set_batch_norm_reduce(model, mesh)
    l1_weight = (None if mesh is None or mesh.data_index == 0 else 0.0)

    def step(state: ClassifierState, images, labels) -> Tuple[ClassifierState, Metrics]:
        if state.model is not model or state.phase != phase:
            raise ValueError("the state belongs to another model or phase")
        freeze_for_phase(model, cfg, phase)
        model.train()
        with ieee_f32():
            x = _nchw(images, dev)
            y = to_device(labels, dev).long()
            if bf16:
                # bf16 copies of the f32 parameters inside the
                # differentiated call: the gradients come back f32
                fwd = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
                logits, min_d = functional_call(model, fwd, (x.to(torch.bfloat16),))
            else:
                logits, min_d = model(x)
            n_total = None if mesh is None else y.shape[0] * mesh.data
            loss, metrics = classification_loss(
                logits, min_d.to(torch.float32), y, state.proto_class,
                model.last_layer.weight.t(), cfg, n_total=n_total,
                l1_weight=l1_weight)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            metrics["loss"] = loss
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:
                keys = [k for k in metrics if k != "l1"]
                vals = [metrics[k].reshape(1).float() for k in keys]
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                mesh.sum_flat_(grads + vals)
                metrics.update({k: v[0] for k, v in zip(keys, vals)})
            set_lrs(state.optimizer, state.lr_scale, state.step)
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_cls_eval_step(model: PPNet, cfg: ClassificationConfig,
                       device: DeviceLike = None) -> Callable:
    """``step(state, images, labels) -> metrics`` in eval mode (running
    BN statistics), f32, with ``correct``: per-sample (B,) bool, so a
    caller can drop the wrap-padded tail of a ``with_count`` batch."""
    dev = _prepare(model, device)

    def step(state: ClassifierState, images, labels) -> Metrics:
        model.eval()
        with torch.inference_mode(), ieee_f32():
            y = to_device(labels, dev).long()
            logits, min_d = model(_nchw(images, dev))
            _, metrics = classification_loss(logits, min_d, y, state.proto_class,
                                             model.last_layer.weight.t(), cfg)
            metrics["correct"] = logits.argmax(-1) == y
        return metrics

    return step


def _features_and_distances(model: PPNet, images, dev: torch.device
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode conv features (B, h, w, C) and their plain f32
    distances (B, h, w, P) to the prototypes."""
    model.eval()
    f = model.conv_features(_nchw(images, dev)).permute(0, 2, 3, 1)
    return f, l2_distances(f, model.prototypes())


def make_cls_push_batch_fn(model: PPNet, device: DeviceLike = None) -> Callable:
    """``fn(state, images, labels, n_valid) -> (min_d, image, row, col,
    fmap)``: per prototype, the batch's nearest patch among the real
    (non-wrapped) images of its class (reference push.py root:172-248),
    the argmin over the batch's patches flattened image-major (the
    first index wins a tie).  A prototype with no eligible image gets
    ``inf``."""
    dev = _prepare(model, device)

    def fn(state: ClassifierState, images, labels, n_valid: int):
        with torch.inference_mode(), ieee_f32():
            f, d = _features_and_distances(model, images, dev)
            B, h, w, P = d.shape
            y = to_device(labels, dev).long()
            eligible = ((y[:, None] == state.proto_class[None, :])
                        & (torch.arange(B, device=dev) < n_valid)[:, None])
            masked = torch.where(eligible[:, None, None, :], d, torch.inf)
            flat = masked.permute(3, 0, 1, 2).reshape(P, B * h * w)
            arg = flat.argmin(dim=1)
            mind = flat.gather(1, arg[:, None])[:, 0]
            bi, pi, pj = arg // (h * w), (arg % (h * w)) // w, arg % w
            return mind, bi, pi, pj, f[bi, pi, pj, :]

    return fn


def push_classification_prototypes(
        state: ClassifierState, batches: Iterable, rf_info: Optional[list] = None,
        device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Dataset-wide projection of each prototype onto its nearest patch
    of its own class (reference push.py root:14-313).  Across batches
    only a strictly smaller distance replaces the winner.  Returns (the
    new (P, C) f32 prototypes on the model's device, {"min_distances"
    (P,), "rf_boxes" (P, 5): image index and [h0, h1, w0, w1], the RF
    box when ``rf_info`` is given, else the feature cell}); the model is
    left as it is."""
    from adlm_tpu_torch.utils.receptive_field import rf_box_at

    model = state.model
    fn = make_cls_push_batch_fn(model, device)
    protos = model.prototypes().detach()
    P = protos.shape[0]
    gmin = np.full(P, np.inf)
    gfmap = protos.float().cpu().numpy().copy()
    boxes = np.full((P, 5), -1, dtype=np.int64)
    offset = 0
    for batch in batches:
        images, labels, n_valid = unpack_batch(batch)
        # one transfer per batch
        mind, bi, pi, pj, fmap = (t.cpu().numpy() for t in
                                  fn(state, images, labels, n_valid))
        for j in np.where(mind < gmin)[0]:
            gmin[j] = mind[j]
            gfmap[j] = fmap[j]
            img_idx = offset + int(bi[j])
            if rf_info is not None:
                box = rf_box_at(images.shape[1:3], (int(pi[j]), int(pj[j])), rf_info)
                boxes[j] = [img_idx, *box]
            else:
                boxes[j] = [img_idx, int(pi[j]), int(pi[j]) + 1, int(pj[j]), int(pj[j]) + 1]
        offset += images.shape[0]
    new = torch.from_numpy(gfmap.astype(np.float32)).to(protos.device)
    return new, {"min_distances": gmin, "rf_boxes": boxes}


def set_prototypes(model: PPNet, prototypes: torch.Tensor) -> None:
    """Replace the model's (P, C) prototype vectors in place."""
    with torch.no_grad():
        model.prototype_vectors.copy_(prototypes.reshape(model.prototype_vectors.shape))


def find_k_nearest_patches_classification(state: ClassifierState, batches: Iterable,
                                          k: int = 6, device: DeviceLike = None
                                          ) -> np.ndarray:
    """(P, k) class labels of each prototype's k nearest images over
    the push set, an image's distance being its nearest patch's
    (reference find_nearest.py:66-236 via run_pruning.py:113-158).
    Wrap-padded duplicates are dropped; a stable sort keeps the earlier
    image on a tie."""
    model = state.model
    dev = _prepare(model, device)
    P = model.prototypes().shape[0]
    top_d = np.full((P, k), np.inf)
    top_l = np.full((P, k), -1, dtype=np.int64)
    for batch in batches:
        images, labels, n_valid = unpack_batch(batch)
        with torch.inference_mode(), ieee_f32():
            _, d = _features_and_distances(model, images, dev)
            md = d.amin(dim=(1, 2)).cpu().numpy()[:n_valid]           # (B, P)
        labels = np.asarray(labels)[:n_valid]
        cat_d = np.concatenate([top_d, md.T], axis=1)                 # (P, k+B)
        cat_l = np.concatenate([top_l, np.broadcast_to(
            np.asarray(labels, np.int64), (P, len(labels)))], axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        top_d = np.take_along_axis(cat_d, order, axis=1)
        top_l = np.take_along_axis(cat_l, order, axis=1)
    return top_l


def prune_classification_prototypes(
        state: ClassifierState, batches: Iterable, k: int = 6, prune_threshold: int = 3,
        log=print, device: DeviceLike = None
        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, np.ndarray]:
    """Prune the prototypes with fewer than ``prune_threshold`` of their
    ``k`` nearest images in their own class (reference prune.py:11-60).
    Returns (the pruned state_dict, its (P',) proto_class, prune_info
    (n, 2): [prototype, class] of each pruned one)."""
    nearest = find_k_nearest_patches_classification(state, batches, k=k, device=device)
    pc = state.proto_class.cpu().numpy()
    P = pc.shape[0]
    to_prune = [j for j in range(P) if int(np.sum(nearest[j] == pc[j])) < prune_threshold]
    keep = sorted(set(range(P)) - set(to_prune))
    log(f"cls-prune: k={k} threshold={prune_threshold} — pruning "
        f"{len(to_prune)}/{P} prototypes")
    if not keep:
        raise ValueError("pruning would remove every prototype")
    prune_info = np.asarray([[j, pc[j]] for j in to_prune], dtype=np.int64).reshape(-1, 2)
    new_sd, new_pc = prune_params(state.model.state_dict(), state.proto_class, keep)
    return new_sd, new_pc, prune_info


def with_prototypes(cfg: ClassificationConfig, n: int) -> ClassificationConfig:
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_prototypes=int(n)))


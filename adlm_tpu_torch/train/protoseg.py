"""ProtoSeg training step (counterpart of ``adlm_tpu.train.protoseg``).

The reference's manual-optimization loop (segmentation/module.py:
119-261): one call takes an ``iter_size`` accumulation window of
microbatches, accumulates the mean gradient and makes one optimizer
update.  As in the JAX package:

* labels are resized to the output grid on the device with the
  PIL-exact nearest rule (``ops/resize.py::resize_label_nearest``);
* the KLD term is fed the head's distances (reference module.py:137-142);
* ``fused_accumulation`` runs the window as one batch with
  group-normalized losses, gradient-identical to the loop;
* ``compute_dtype="bfloat16"`` casts the f32 parameters to bf16 inside
  the differentiated call, so gradients come back in f32;
* ``remat`` recomputes the forward during the backward;
* ``mesh=`` makes the data-parallel step of ``parallel/sharding.py``:
  each rank takes its slice of the window, the CE and KLD means divide
  by the counts summed over the ranks, the masked L1 (a term of the
  parameters alone) enters on the first data rank only, and one
  flattened SUM per window reduces the gradient and the metrics before
  the norm, the clip and the update.  So every rank makes the update of
  the single-device step on the global window, up to the order of the
  sums.

Everything runs in IEEE f32 (``core.device.ieee_f32``), the backward
included: cuDNN would otherwise compute f32 conv gradients in TF32.
Parameters and Adam moments are updated in place (the JAX package's
``donate=True``).  The prototype head's forward is the CUDA kernel on
the card; its backward is plain PyTorch on both devices
(``ops/prototype.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from adlm_tpu_torch.core.config import ExperimentConfig
from adlm_tpu_torch.core.device import DeviceLike, ieee_f32, resolve_device, to_device
from adlm_tpu_torch.models.ppnet import default_proto_class
from adlm_tpu_torch.ops.losses import (
    ce_count,
    cross_entropy_ignore,
    kld_pair_count,
    kld_prototype_loss,
    masked_l1,
)
from adlm_tpu_torch.ops.normalize import normalize
from adlm_tpu_torch.ops.resize import resize_label_nearest
from adlm_tpu_torch.train.optimizer import (
    Schedule,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    set_lrs,
)

Metrics = Dict[str, torch.Tensor]
_COUNTS = ("n_correct", "n_patches")
# metrics of the parameters alone, the same on every rank: not summed
_REPLICATED = ("l1",)


@dataclasses.dataclass
class ProtoSegState:
    """What a training phase carries between steps.  ``model`` holds the
    parameters, ``optimizer`` the Adam moments of the trained groups,
    ``lr_scale`` the phase's schedule, built for ``max_steps``; ``step``
    counts optimizer updates from 0."""

    model: nn.Module
    optimizer: torch.optim.Adam
    lr_scale: Schedule
    proto_class: torch.Tensor
    phase: int
    max_steps: Optional[int]
    step: int = 0


def _prepare(model: nn.Module, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last)
    return dev


def init_protoseg_state(model: nn.Module, cfg: ExperimentConfig, phase: int,
                        max_steps: Optional[int] = None,
                        proto_class: Optional[torch.Tensor] = None,
                        device: DeviceLike = None) -> ProtoSegState:
    """A fresh phase on ``model``'s current weights (default the card;
    the model moves there, channels-last).  A later phase continues from
    an earlier one by passing the same model (the reference reloads
    ``warmup_last.pth`` between phases, train.py:150-154)."""
    dev = _prepare(model, device)
    model.requires_grad_(True)
    opt, scale = make_optimizer(cfg.train, phase, max_steps, model)
    if proto_class is None:
        proto_class = default_proto_class(cfg.model.num_prototypes,
                                          cfg.model.num_classes)
    return ProtoSegState(model=model, optimizer=opt, lr_scale=scale,
                         proto_class=proto_class.to(dev), phase=phase,
                         max_steps=max_steps)


def _single_output_loss(logits: torch.Tensor, distances: torch.Tensor,
                        labels: torch.Tensor, proto_class: torch.Tensor,
                        cfg: ExperimentConfig, groups: Optional[int] = None,
                        image_valid: Optional[torch.Tensor] = None,
                        mesh=None) -> Tuple[torch.Tensor, Metrics]:
    """Loss terms of one MSC output (reference module.py:142-228).

    ``groups=G``: the batch is G microbatches and each term is the mean
    over groups of the per-group mean.  ``image_valid`` (B,) bool: False
    images add no CE pixel, no accuracy count and no KLD pair.  With a
    ``mesh`` the batch is this rank's share, and the CE and KLD
    denominators are the counts summed over the data ranks (one
    collective of the labels' counts, before either loss)."""
    t = cfg.train
    B, h, w = logits.shape[0], logits.shape[1], logits.shape[2]
    # uint8 labels: widen before the void shift below can wrap
    target = resize_label_nearest(labels.long(), (h, w))           # (B, h, w)
    target_flat = target.reshape(B * h * w)
    logits_flat = logits.reshape(B * h * w, -1)

    if t.ignore_void_class:
        valid = target_flat != 0
        ce_labels = torch.clamp(target_flat - 1, min=0)
        kld_labels = (target.reshape(B, h * w) if t.kld_raw_label_indexing
                      else target.reshape(B, h * w) - 1)
    else:
        valid = torch.ones_like(target_flat, dtype=torch.bool)
        ce_labels = target_flat
        kld_labels = target.reshape(B, h * w)

    if image_valid is not None:
        valid = valid & image_valid.repeat_interleave(h * w)
        kld_labels = torch.where(image_valid[:, None], kld_labels, -1)

    ce_n = kld_n = None
    if mesh is not None:
        counts = [ce_count(valid, groups).reshape(-1)]
        if t.loss_weight_kld > 0.0:
            counts.append(kld_pair_count(kld_labels, proto_class, groups).reshape(-1))
        counts = mesh.all_reduce_(torch.cat(counts).long())
        shape = () if groups is None else (groups,)
        g = 1 if groups is None else groups
        ce_n = counts[:g].reshape(shape)
        if t.loss_weight_kld > 0.0:
            kld_n = counts[g:].reshape(shape)
    ce, n_correct = cross_entropy_ignore(logits_flat, ce_labels, valid,
                                         groups=groups, count=ce_n)
    if t.loss_weight_kld > 0.0:
        kld = kld_prototype_loss(distances.reshape(B, h * w, -1), kld_labels,
                                 proto_class, groups=groups, count=kld_n)
    else:
        kld = torch.zeros((), device=logits.device)
    metrics = {"cross_entropy": ce, "kld_loss": kld,
               "n_correct": n_correct.to(torch.float32),
               "n_patches": valid.sum().to(torch.float32)}
    return ce, metrics


def loss_fn(model: nn.Module, proto_class: torch.Tensor,
            cfg: ExperimentConfig,
            batch: Tuple[torch.Tensor, torch.Tensor], train: bool,
            groups: Optional[int] = None,
            image_valid: Optional[torch.Tensor] = None,
            mesh=None) -> Tuple[torch.Tensor, Metrics]:
    """The training loss over all MSC outputs, averaged (reference
    module.py:141-228), and its metrics.

    ``batch`` is (images (B, H, W, 3) float or uint8, labels (B, H, W))
    on the model's device; uint8 images are normalized there with the
    config's mean and std.  Backpropagating the loss leaves the
    gradients in the parameters' ``.grad``.

    With a ``mesh`` the batch is this rank's share: the loss and the
    metrics other than ``l1`` are this rank's parts of the global ones,
    which their SUM over the data ranks gives; the L1 term enters the
    loss of the first data rank only."""
    images, labels = batch
    t = cfg.train
    if images.dtype == torch.uint8:
        images = normalize(images, (cfg.data.mean, cfg.data.std))
    x = images.permute(0, 3, 1, 2)   # NCHW view, channels-last strides
    if t.compute_dtype == "bfloat16":
        # bf16 forward and backward on bf16 copies of the f32 parameters:
        # the gradients flow back through the casts into f32 ``.grad``
        fwd_params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32
                      else p for n, p in model.named_parameters()}
        x = x.to(torch.bfloat16)

        def forward(inp):
            return functional_call(model, fwd_params, (inp,))
    else:
        x = x.to(torch.float32)
        forward = model
    model.train(train)
    if t.remat and train:
        outputs = checkpoint(forward, x, use_reentrant=False)
    else:
        outputs = forward(x)
    if not isinstance(outputs, list):
        outputs = [outputs]

    l1 = masked_l1(model.last_layer.weight.t(), proto_class)
    l1_weight = (t.loss_weight_l1 if mesh is None or mesh.data_index == 0
                 else 0.0)
    n_out = len(outputs)
    total = torch.zeros((), device=images.device)
    agg: Metrics = {}
    for logits, distances in outputs:
        ce, m = _single_output_loss(logits, distances, labels, proto_class,
                                    cfg, groups=groups, image_valid=image_valid,
                                    mesh=mesh)
        out_loss = (t.loss_weight_crs_ent * ce
                    + t.loss_weight_kld * m["kld_loss"]
                    + l1_weight * l1)
        total = total + out_loss / n_out
        for k, v in m.items():
            v = v if k in _COUNTS else v / n_out
            agg[k] = agg[k] + v if k in agg else v
    agg["loss"] = total
    agg["l1"] = l1
    return total, agg


def _reduce_window(mesh, grads, metrics: Metrics) -> None:
    """One flattened SUM over the data ranks of the gradients and of the
    summed metrics (``l1`` is the same everywhere), in place."""
    keys = [k for k in metrics if k not in _REPLICATED]
    vals = [metrics[k].reshape(1).to(torch.float32) for k in keys]
    bufs = list(grads) + vals
    if len({b.dtype for b in bufs}) != 1:
        mesh.sum_flat_(list(grads))
        mesh.sum_flat_(vals)
    else:
        mesh.sum_flat_(bufs)
    for k, v in zip(keys, vals):
        metrics[k] = v[0]


def make_train_step(model: nn.Module, cfg: ExperimentConfig, phase: int,
                    max_steps: Optional[int] = None,
                    device: DeviceLike = None, mesh=None):
    """``step(state, images, labels) -> (state, metrics)`` over one
    accumulation window, on ``device`` (default the card).

    ``images`` are (iter_size, bs, H, W, 3) float or uint8 and ``labels``
    (iter_size, bs, H, W), numpy or tensors, the JAX package's layout.
    Metrics are 0-d tensors on the device: means over the window, with
    ``n_correct``/``n_patches`` as sums and ``grad_norm`` the global norm
    of the mean gradient before any clip.  ``state`` is updated in place
    and returned.  ``max_steps`` is the phase's step budget: the state's
    schedule was built from the one ``init_protoseg_state`` got, and a
    state built for another budget raises ``ValueError`` (the JAX step
    builds its schedule from its own argument, so the two must agree).

    With a ``mesh`` (``core/mesh.py``) the step runs on ``mesh.device``
    and takes this rank's (iter_size, bs/data, H, W, 3) slice of the
    window; the metrics and the update are the global window's, the same
    on every rank (``parallel/sharding.py``)."""
    dev = _prepare(model, mesh.device if mesh is not None else device)
    t = cfg.train
    params = list(model.parameters())

    def step(state: ProtoSegState, images, labels) -> Tuple[ProtoSegState, Metrics]:
        if state.model is not model or state.phase != phase:
            raise ValueError("the state belongs to another model or phase")
        if state.max_steps != max_steps:
            raise ValueError(f"the state's schedule was built for max_steps="
                             f"{state.max_steps}, this step for {max_steps}")
        with ieee_f32():
            images = to_device(images, dev)
            labels = to_device(labels, dev)
            n_micro = images.shape[0]
            model.zero_grad(set_to_none=True)
            if t.fused_accumulation:
                # one (iter_size·bs) batch; the grouped losses make the
                # scalar (1/G)·Σ_g loss_g, so the gradient is the mean
                batch = (images.reshape(-1, *images.shape[2:]),
                         labels.reshape(-1, *labels.shape[2:]))
                total, m = loss_fn(model, state.proto_class, cfg, batch, True,
                                   groups=n_micro, mesh=mesh)
                total.backward()
                metrics = {k: v.detach() for k, v in m.items()}
            else:
                sums: Metrics = {}
                for i in range(n_micro):
                    total, m = loss_fn(model, state.proto_class, cfg,
                                       (images[i], labels[i]), True, mesh=mesh)
                    total.backward()   # .grad accumulates the sum
                    for k, v in m.items():
                        sums[k] = sums[k] + v.detach() if k in sums else v.detach()
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(n_micro)
                metrics = {k: v if k in _COUNTS else v / n_micro
                           for k, v in sums.items()}
            grads = [p.grad for p in params if p.grad is not None]
            if mesh is not None:
                _reduce_window(mesh, grads, metrics)
            metrics["grad_norm"] = global_norm(grads)
            if t.grad_clip_norm is not None:
                clip_by_global_norm(grads, t.grad_clip_norm,
                                     metrics["grad_norm"])
            set_lrs(state.optimizer, state.lr_scale, state.step)
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: nn.Module, cfg: ExperimentConfig,
                   device: DeviceLike = None, mesh=None):
    """``step(state, images, labels, n_valid=None) -> metrics`` over one
    (B, H, W, 3) batch, on ``device`` (default the card).

    ``n_valid`` masks out the trailing ``B - n_valid`` images: a
    fixed-shape val batch pads its last partial batch, and the padding
    must add nothing to the metrics (reference validates exact batches,
    segmentation/module.py:280-297).

    With a ``mesh`` the images are this rank's slice of a global batch,
    ``n_valid`` counts the global batch's real images, and the metrics
    are the global batch's on every rank."""
    dev = _prepare(model, mesh.device if mesh is not None else device)

    def step(state: ProtoSegState, images, labels,
             n_valid: Optional[int] = None) -> Metrics:
        with torch.inference_mode(), ieee_f32():
            images = to_device(images, dev)
            labels = to_device(labels, dev)
            B = images.shape[0]
            n_real = B if n_valid is None else n_valid
            if mesh is not None and n_valid is not None:
                n_real = mesh.share(n_valid, B)
            image_valid = torch.arange(B, device=dev) < n_real
            _, metrics = loss_fn(state.model, state.proto_class, cfg,
                                 (images, labels), False,
                                 image_valid=image_valid, mesh=mesh)
            if mesh is not None:
                _reduce_window(mesh, [], metrics)
        return metrics

    return step

"""Phase-wise optimizers with per-group LRs (counterpart of
``adlm_tpu.train.optimizer``; reference segmentation/module.py:333-403).

* **warmup (phase 0)** — add-on layers and ASPP (weights and biases) at
  the warm LR with weight decay; prototype vectors at the warm proto LR
  without decay; everything else frozen.
* **joint (phase 1)** — backbone convs at 1× LR, ASPP weights and biases
  at 10× (the reference's "20x" group also gets ``10 * lr``,
  module.py:372), add-ons and prototypes at their own LRs; last layer
  frozen; polynomial decay over ``max_steps // iter_size`` updates,
  optionally after a linear ramp (``joint_lr_warmup_updates``).
* **last (phase 2)** — only the last layer trains.

One ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8) holds a param group
per trained label.  Its ``weight_decay`` adds ``wd·param`` to the
gradient before the moments (coupled L2), as the JAX package's
``add_decayed_weights`` → ``scale_by_adam`` chain does.  A frozen group
is left out of the optimizer, but its parameters keep
``requires_grad``: the JAX package computes their gradients too, and
``global_norm`` and ``clip_by_global_norm`` run over all of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from adlm_tpu_torch.core.config import TrainConfig

# param-group labels (adlm_tpu/train/optimizer.py:34-40)
BACKBONE = "backbone"     # reference "1x": conv weights in res layers
ASPP_W = "aspp_w"         # reference "10x"
ASPP_B = "aspp_b"         # reference "20x" (also lr*10, module.py:372)
ADD_ON = "add_on"
PROTOS = "protos"
LAST = "last"
FROZEN = "frozen"

Schedule = Callable[[int], float]


def label_params(model: nn.Module) -> Dict[str, str]:
    """Parameter name → optimizer group, by the parts of its name.
    ``aspp`` is tested before ``features``, which holds it."""

    def label(name: str) -> str:
        keys = name.split(".")
        if "prototype_vectors" in keys:
            return PROTOS
        if "last_layer" in keys:
            return LAST
        if "add_on_layers" in keys:
            return ADD_ON
        if "aspp" in keys:
            return ASPP_B if keys[-1] == "bias" else ASPP_W
        if "features" in keys:
            return BACKBONE
        return FROZEN

    return {name: label(name) for name, _ in model.named_parameters()}


def poly_schedule(base_lr: float, max_updates: int, power: float) -> Schedule:
    """lr(u) = base · (1 − min(u, max)/max)^power (deeplab PolynomialLR,
    reference segmentation/module.py:395-401)."""

    def sched(count: int) -> float:
        frac = 1.0 - min(count, max_updates) / max_updates
        return base_lr * frac ** power

    return sched


def lr_scale(cfg: TrainConfig, phase: int,
             max_steps: Optional[int] = None) -> Schedule:
    """The factor on every group's base LR at optimizer update ``u``
    (counted from 0): 1 in phases 0 and 2; in phase 1 the poly decay,
    times ``min((u + 1)/ramp, 1)`` with a ramp
    (adlm_tpu/train/optimizer.py:102-120)."""
    if phase in (0, 2):
        return lambda count: 1.0
    if phase != 1:
        raise ValueError(f"unknown phase {phase}")
    if max_steps is None:
        raise ValueError("the joint phase needs max_steps")
    poly = poly_schedule(1.0, max(max_steps // cfg.iter_size, 1),
                         cfg.poly_lr_power)
    ramp = cfg.joint_lr_warmup_updates
    if not ramp:
        return poly
    return lambda count: min((count + 1.0) / ramp, 1.0) * poly(count)


def phase_groups(cfg: TrainConfig, phase: int
                 ) -> Dict[str, Tuple[float, float]]:
    """Trained label → (base lr, weight decay) of one phase; labels not
    listed are frozen (``optax.set_to_zero`` in the JAX package)."""
    if phase == 0:
        lr, wd = cfg.warm_optimizer_lr_add_on_layers, cfg.warm_optimizer_weight_decay
        return {ADD_ON: (lr, wd), ASPP_W: (lr, wd), ASPP_B: (lr, wd),
                PROTOS: (cfg.warm_optimizer_lr_prototype_vectors, 0.0)}
    if phase == 1:
        lr_f, wd = cfg.joint_optimizer_lr_features, cfg.joint_optimizer_weight_decay
        return {BACKBONE: (lr_f, wd), ASPP_W: (10 * lr_f, wd),
                ASPP_B: (10 * lr_f, wd),
                ADD_ON: (cfg.joint_optimizer_lr_add_on_layers, wd),
                PROTOS: (cfg.joint_optimizer_lr_prototype_vectors, 0.0)}
    if phase == 2:
        return {LAST: (cfg.last_layer_optimizer_lr, 0.0)}
    raise ValueError(f"unknown phase {phase}")


def make_optimizer(cfg: TrainConfig, phase: int, max_steps: Optional[int],
                   model: nn.Module) -> Tuple[torch.optim.Adam, Schedule]:
    """(optimizer, lr scale) for a training phase (0=warmup, 1=joint,
    2=last).  Each param group carries its ``label`` and ``base_lr``;
    before update ``u`` the caller sets ``lr = base_lr · scale(u)``
    (``set_lrs``)."""
    scale = lr_scale(cfg, phase, max_steps)
    labels = label_params(model)
    groups = []
    for label, (lr, wd) in phase_groups(cfg, phase).items():
        params = [p for n, p in model.named_parameters() if labels[n] == label]
        if params:
            groups.append({"params": params, "lr": lr, "weight_decay": wd,
                           "label": label, "base_lr": lr})
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    return opt, scale


def set_lrs(opt: torch.optim.Optimizer, scale: Schedule, count: int) -> None:
    """Every group's lr for optimizer update ``count``."""
    s = scale(count)
    for g in opt.param_groups:
        g["lr"] = g["base_lr"] * s


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every gradient (``optax.global_norm``)."""
    return torch.sqrt(torch.stack([g.to(torch.float32).square().sum()
                                   for g in grads]).sum())


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """In place, optax's ``clip_by_global_norm``: unless the global norm
    is below ``max_norm``, every gradient becomes ``g / norm · max_norm``
    (a NaN norm spreads, as in optax).  ``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` and is not this.  No host sync."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


AdamByName = Dict[str, Dict[str, torch.Tensor]]


def adam_state_by_name(opt: torch.optim.Adam, model: nn.Module) -> AdamByName:
    """The optimizer's per-parameter state keyed by parameter name
    (``{name: {"step", "exp_avg", "exp_avg_sq"}}``), not by the
    optimizer's integer ids: a checkpoint of it describes itself, and a
    model rebuilt with another prototype count takes it back by name."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: {k: v.detach() for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"] if p in opt.state}


def load_adam_state(opt: torch.optim.Adam, model: nn.Module,
                    by_name: AdamByName) -> None:
    """Put ``by_name`` (``adam_state_by_name``) into ``opt``: every
    parameter it trains must have an entry of the parameter's shape.
    The moments take the parameter's device, dtype and memory format,
    as the optimizer's own ``zeros_like`` would give them."""
    names = {id(p): n for n, p in model.named_parameters()}
    for g in opt.param_groups:
        for p in g["params"]:
            name = names[id(p)]
            if name not in by_name:
                raise KeyError(f"no Adam state for {name}")
            src = by_name[name]
            state = {"step": src["step"].detach().to("cpu", torch.float32).clone()}
            for k in ("exp_avg", "exp_avg_sq"):
                if tuple(src[k].shape) != tuple(p.shape):
                    raise ValueError(f"{name}.{k}: shape {tuple(src[k].shape)}, "
                                     f"parameter {tuple(p.shape)}")
                state[k] = torch.empty_like(p, memory_format=torch.preserve_format
                                            ).copy_(src[k])
            opt.state[p] = state

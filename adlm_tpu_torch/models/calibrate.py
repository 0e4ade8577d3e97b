"""Data-calibrated initialization for from-scratch training (counterpart
of ``adlm_tpu.models.calibrate``).

Without a pretrained backbone the frozen BNs hold (mean 0, var 1), the
activation variance compounds through the 101-layer residual stack, the
sigmoid add-on saturates and CE stays at uniform.  Three steps fix the
init, each measured on real training windows:

* ``calibrate_frozen_bn`` composes into each frozen BN's affine the
  correction that standardizes its output, one BN at a time
  (Gauss–Seidel) in the JAX package's order, sweeping until every BN is
  standardized;
* ``standardize_presigmoid`` folds ``(x − μ)/σ`` of the pre-sigmoid
  tensor into the convs that produce it;
* ``init_prototypes_from_data`` sets each prototype to the feature of a
  grid cell of its own class.

Each runs once, on the model's weights in place, on ``device`` (the card
unless the caller passes ``"cpu"``; the model moves there, as the other
entry points move it).  The calibration forwards run ``conv_features``
only, the head never: forward hooks on the ``FrozenBatchNorm`` modules
reduce each BN output's per-channel sum and sum of squares in f32 on the
device into one packed vector, fetched once per update, and the affine
is composed in float64 on the host.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch import nn

from adlm_tpu_torch.core.device import (
    DeviceLike,
    ieee_f32,
    model_dtype,
    resolve_device,
    to_device,
)
from adlm_tpu_torch.models.layers import FrozenBatchNorm
from adlm_tpu_torch.ops.resize import resize_label_nearest

# finite guards: a pre-calibration forward can overflow float32 at
# depth; clamped moments still shrink the affine in the right
# direction and later updates converge on exact values
_VAR_MAX = 1e30
_MEAN_MAX = 1e30
# the stop rule: every BN's output, measured before its own update
STOP_MEAN, STOP_VAR = 0.05, 0.1
# FrozenBatchNorm buffer ↔ the JAX package's constant name
_BUFFERS = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
            "var": "running_var"}

# execution rank of the bottleneck submodules (reduce → conv3x3 →
# increase; the shortcut is parallel)
_NAME_RANK = {"conv1": 0, "reduce": 0, "shortcut": 0, "conv3x3": 1,
              "increase": 2}


def _topo_key(path):
    """The JAX package's update order: natural sort (block2 < block10)
    of each path part, led by the submodule's execution rank."""
    key = []
    for part in path:
        toks = tuple(int(tok) if tok.isdigit() else tok
                     for tok in re.split(r"(\d+)", part) if tok)
        key.append((_NAME_RANK.get(part, -1),) + toks)
    return key


def bn_update_order(model: nn.Module) -> List[str]:
    """Names of the model's FrozenBatchNorms in the order
    ``calibrate_frozen_bn`` updates them: the JAX package's ``_topo_key``
    on each BN's flax path, which is the module name split at its dots
    (``utils/jax_weights.py`` maps the constants of flax path ``a/b/bn``
    to the buffers ``a.b.bn.*``).  Gauss–Seidel updates in another order
    give other constants."""
    names = [n for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm)]
    return sorted(names, key=lambda n: _topo_key(tuple(n.split("."))))


def _moments_from_sums(s: np.ndarray, ss: np.ndarray, n: int):
    mean = np.clip(np.nan_to_num(s / n), -_MEAN_MAX, _MEAN_MAX)
    var = np.nan_to_num(ss / n - mean ** 2, nan=_VAR_MAX, posinf=_VAR_MAX)
    return mean, np.clip(var, 0.0, _VAR_MAX)


@contextlib.contextmanager
def _eval_forward(model: nn.Module) -> Iterator[None]:
    """Single-scale eval forwards without autograd, in IEEE f32."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), ieee_f32():
            yield
    finally:
        model.train(was_training)


def _prepare(model: nn.Module, images, device: DeviceLike) -> torch.Tensor:
    """Move the model to the device; the (B, H, W, 3) images as an NCHW
    view with channels-last strides, in the model's dtype."""
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last)
    return to_device(images, dev, model_dtype(model)).permute(0, 3, 1, 2)


class _BNSums:
    """Forward hooks that add each listed BN output's per-channel sum and
    sum of squares, in f32 on the device, into one packed vector:
    [s_0, ss_0, s_1, ss_1, ...].  ``measure`` runs one forward and
    fetches the vector to the host once."""

    def __init__(self, modules: List[FrozenBatchNorm]):
        self.sizes = [m.weight.numel() for m in modules]
        self.offsets = [0] + np.cumsum([2 * c for c in self.sizes]).tolist()
        self.rows = [0] * len(modules)
        self.packed = None
        self.handles = [m.register_forward_hook(self._hook(i))
                        for i, m in enumerate(modules)]

    def _hook(self, i: int):
        o, c = self.offsets[i], self.sizes[i]

        def hook(module, inputs, out):
            y = out.float()
            self.packed[o:o + c] += y.sum((0, 2, 3))
            self.packed[o + c:o + 2 * c] += (y * y).sum((0, 2, 3))
            self.rows[i] += y.numel() // c
        return hook

    def measure(self, forward, device) -> np.ndarray:
        self.packed = torch.zeros(self.offsets[-1], device=device)
        self.rows = [0] * len(self.rows)
        forward()
        out = self.packed.cpu().numpy().astype(np.float64)
        self.packed = None
        return out

    def moments(self, packed: np.ndarray, i: int):
        """(mean, var) of BN ``i``'s output from a measured vector."""
        o, c = self.offsets[i], self.sizes[i]
        return _moments_from_sums(packed[o:o + c], packed[o + c:o + 2 * c], self.rows[i])

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def bn_output_moments(model: nn.Module, images, device: DeviceLike = None
                      ) -> Dict[str, tuple]:
    """{BN name: (mean, var)} of every FrozenBatchNorm's output over
    ``images`` (B, H, W, 3), float64 on the host, from one forward."""
    x = _prepare(model, images, device)
    names = bn_update_order(model)
    mods = dict(model.named_modules())
    sums = _BNSums([mods[n] for n in names])
    try:
        with _eval_forward(model):
            packed = sums.measure(lambda: model.conv_features(x), x.device)
        return {n: sums.moments(packed, i) for i, n in enumerate(names)}
    finally:
        sums.close()


def calibrate_frozen_bn(model: nn.Module, images, max_sweeps: int = 8,
                        eps: float = 1e-5, log=None,
                        device: DeviceLike = None) -> Dict[str, float]:
    """Make every FrozenBatchNorm standardize its input as measured on
    ``images`` (B, H, W, 3, normalized like training inputs), in place.

    BNs are calibrated **one at a time** (Gauss–Seidel), in
    ``bn_update_order``: one forward per update, composing the
    standardizing correction into that BN's frozen affine ((mean, var)
    reset to (0, 1); (gamma, beta) absorb ``scale/√(var_y+eps)`` and
    ``(bias−mean_y)/√(var_y+eps)``, kept in float64 on the host across
    updates), sweeping until a sweep finds every BN output within the
    stop rule (|mean| < ``STOP_MEAN``, |var − 1| < ``STOP_VAR``) before
    its update, or ``max_sweeps`` sweeps have run.

    Returns {"sweeps", "forwards", "max_abs_mean", "max_abs_var_minus_1"}
    of the last sweep (pre-update values)."""
    x = _prepare(model, images, device)
    names = bn_update_order(model)
    mods = dict(model.named_modules())
    bns = [mods[n] for n in names]
    host = [{k: getattr(m, b).detach().cpu().numpy().astype(np.float64)
             for k, b in _BUFFERS.items()} for m in bns]
    sums = _BNSums(bns)
    forwards = 0
    try:
        with _eval_forward(model):
            for sweep in range(max_sweeps):
                worst_m = worst_v = 0.0
                for i, (bn, node) in enumerate(zip(bns, host)):
                    packed = sums.measure(lambda: model.conv_features(x), x.device)
                    forwards += 1
                    # the affine currently applied: y = x*scale + bias
                    scale = node["gamma"] / np.sqrt(node["var"] + eps)
                    bias = node["beta"] - node["mean"] * scale
                    mean_y, var_y = sums.moments(packed, i)
                    sd = np.sqrt(var_y + eps)
                    node["mean"] = np.zeros_like(mean_y)
                    node["var"] = np.ones_like(var_y)
                    node["gamma"] = (scale / sd) * np.sqrt(1.0 + eps)
                    node["beta"] = (bias - mean_y) / sd
                    for k, b in _BUFFERS.items():
                        getattr(bn, b).copy_(torch.from_numpy(node[k].astype(np.float32)))
                    worst_m = max(worst_m, float(np.max(np.abs(mean_y))))
                    worst_v = max(worst_v, float(np.max(np.abs(var_y - 1.0))))
                    if log is not None and (i + 1) % 25 == 0:
                        log(f"bn-calibrate sweep {sweep + 1}: {i + 1}/{len(bns)}")
                if log is not None:
                    log(f"bn-calibrate sweep {sweep + 1}: max |mean| "
                        f"{worst_m:.3f}, max |var-1| {worst_v:.3f} pre-update")
                if worst_m < STOP_MEAN and worst_v < STOP_VAR:
                    break
    finally:
        sums.close()
    return {"sweeps": sweep + 1, "forwards": forwards,
            "max_abs_mean": worst_m, "max_abs_var_minus_1": worst_v}


def standardize_presigmoid(model: nn.Module, images, eps: float = 1e-3,
                           log=print, device: DeviceLike = None
                           ) -> Dict[str, float]:
    """Standardize the PRE-SIGMOID tensor, in place (LSUV-style init,
    Mishkin & Matas 2016).

    The last op before the add-on sigmoid has no BN: for the deeplab
    configs it is the ASPP branch sum (``features``' output), for the
    other add-on kinds the add-on stack's last 1x1 conv.  At random init
    its per-channel std saturates the sigmoid to exact 0/1, so no
    gradient reaches a feature parameter.  This measures per-channel
    (μ, σ) on ``images`` and folds ``(x − μ)/σ`` into the producing
    convs: every kernel and bias divided by σ, and the first producer's
    bias shifted by −μ/σ (the producers add, so the fold is exact).

    Returns the pre-sigmoid tensor's max |mean| and max std before, and
    max |mean| and max |std − 1| after."""
    x = _prepare(model, images, device)
    if model.cfg.add_on_layers_type == "deeplab_simple":
        aspp = model.features.base.aspp
        producers = [getattr(aspp, f"c{i}") for i in range(aspp.n)]

        def pre_fn():
            return model.features(x)
    else:
        last = [m for m in model.add_on_layers if isinstance(m, nn.Conv2d)][-1]
        producers = [last]

        def pre_fn():
            seen = []
            handle = last.register_forward_hook(lambda m, i, o: seen.append(o))
            try:
                model.conv_features(x)
            finally:
                handle.remove()
            return seen[0]

    def measure():
        with _eval_forward(model):
            pre = pre_fn()
        flat = pre.permute(0, 2, 3, 1).cpu().numpy().astype(np.float64)
        return flat.reshape(-1, flat.shape[-1])

    flat = measure()
    mean, sd = flat.mean(0), np.maximum(flat.std(0), eps)
    log(f"presigmoid-calibrate: pre |mean| max {np.abs(mean).max():.2f}, "
        f"std max {sd.max():.2f} over {flat.shape[-1]} channels")
    with torch.no_grad():
        for i, conv in enumerate(producers):
            w = conv.weight.detach().cpu().numpy()
            b = (conv.bias.detach().cpu().numpy() / sd).astype(np.float32)
            if i == 0:
                b = (b - mean / sd).astype(np.float32)
            conv.weight.copy_(torch.from_numpy(
                (w / sd[:, None, None, None]).astype(np.float32)))
            conv.bias.copy_(torch.from_numpy(b))
    post = measure()
    info = {"pre_abs_mean": float(np.abs(mean).max()), "pre_std": float(sd.max()),
            "post_abs_mean": float(np.abs(post.mean(0)).max()),
            "post_abs_std_minus_1": float(np.abs(post.std(0) - 1).max())}
    log(f"presigmoid-calibrate: post |mean| max {info['post_abs_mean']:.4f}, "
        f"|std-1| max {info['post_abs_std_minus_1']:.4f}")
    return info


def init_prototypes_from_data(model: nn.Module, proto_class, images, labels,
                              seed: int = 0, log=print,
                              device: DeviceLike = None) -> torch.Tensor:
    """Set each prototype, in place, to a REAL feature vector of a grid
    cell of its own class (ProtoPNet-style patch init): from a random
    init prototypes sit far from every feature and the log activation's
    gradient vanishes as 1/d².

    ``images`` (B, H, W, 3) normalized training windows; ``labels``
    (B, H, W) train ids (0 = void, class c at c+1), resized to the
    feature grid with the PIL-exact nearest rule.  The cells are drawn
    with ``np.random.RandomState(seed).choice`` exactly as the JAX
    package draws them, so both pick the same cells.  Prototypes of
    classes absent from the batch keep their vectors (logged).

    Returns the (P, C) prototype vectors on the model's device."""
    x = _prepare(model, images, device)
    with _eval_forward(model):
        f = model.conv_features(x)
        grid = resize_label_nearest(
            to_device(np.asarray(labels).astype(np.int32), x.device), f.shape[-2:])
    f = f.permute(0, 2, 3, 1).float().cpu().numpy()
    B, gh, gw, C = f.shape
    flat_f = f.reshape(B * gh * gw, C)
    flat_lab = grid.cpu().numpy().reshape(-1)

    rng = np.random.RandomState(seed)
    pc = (proto_class.cpu().numpy() if isinstance(proto_class, torch.Tensor)
          else np.asarray(proto_class))
    new_pv = model.prototypes().detach().float().cpu().numpy().copy()
    missing = []
    for cls in np.unique(pc):
        cells = np.nonzero(flat_lab == cls + 1)[0]  # train id = class+1
        idxs = np.nonzero(pc == cls)[0]
        if cells.size == 0:
            missing.append(int(cls))
            continue
        take = rng.choice(cells, size=len(idxs),
                          replace=cells.size < len(idxs))
        new_pv[idxs] = flat_f[take]
    if missing:
        log(f"proto-init: classes {missing} absent from the init batch "
            f"— their prototypes keep the random init")
    log(f"proto-init: {len(pc) - sum(np.isin(pc, missing))} prototypes "
        f"set from data cells")
    out = torch.from_numpy(new_pv).to(x.device)
    with torch.no_grad():
        model.prototype_vectors.copy_(out[:, :, None, None])
    return out

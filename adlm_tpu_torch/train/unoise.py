"""U-Noise training: utility U-Net + noise-mask model (counterpart of
``adlm_tpu.train.unoise``).

Reference semantics (src/train_util.py:11-59, src/train_noise.py:12-137):

* **Utility model** — U-Net trained with BCE-with-logits on Pancreas
  slices, Adam(3e-3), val metric = dice of ``logits > 0``.
* **Noise model** — a second U-Net predicts a mask ``B = σ(noise_unet(x))``;
  the reparameterized noise ``ε·(B·(max−min)+min)``, ``ε ~ N(0,1)``, is
  added to the *input* of the frozen utility model; loss
  ``BCE(util(x+noise), y) − λ·mean(log B)``, log B taken as logsigmoid of
  the logits (``noise_forward``).  The utility model runs in
  eval mode (frozen batch statistics) and trains nothing.

The steps take NHWC batches as the data pipeline yields them (images
(B, H, W, 3), or (B, H, W, 1) raw slices with ``raw=True``; masks
(B, H, W, 1)) and feed the NCHW models channels-last views.  Under
``compute_dtype="bfloat16"`` the parameters are cast inside the
differentiated function (``models/unet.py::forward_in``): the gradients
come back f32, the BN running statistics stay f32 and the utility's
eval-mode BN reads them in f32, as in the JAX package; the eval steps
run in f32.  f32 runs in IEEE f32 (TF32 off).

ε comes from ``torch.randn`` on the device with the caller's generator;
a caller may pass ε itself (NHWC, (B, H, W, 1)), as the parity tests do
to give both packages the same draw.

``mesh=`` makes the data-parallel train steps of ``parallel/sharding.py``:
each rank takes its slice of the batch, the trained U-Net's BatchNorms
reduce their statistics over the data ranks, every mean divides by the
global batch's count, ε is drawn at the GLOBAL batch's shape and each
rank takes its rows (so every rank draws the numbers a single device
draws), and one flattened SUM reduces the gradients and the metrics
before the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from adlm_tpu_torch.core.config import UNoiseConfig
from adlm_tpu_torch.core.device import DeviceLike, compute_dtype, ieee_f32, resolve_device
from adlm_tpu_torch.data.unoise_data import IMAGENET_MEAN, IMAGENET_STD
from adlm_tpu_torch.models.unet import UNet, forward_in
from adlm_tpu_torch.ops.losses import bce_with_logits, dice_coeff
from adlm_tpu_torch.train.optimizer import make_adam

Metrics = Dict[str, torch.Tensor]


@dataclass
class UtilityState:
    model: UNet
    optimizer: torch.optim.Adam
    step: int = 0


@dataclass
class NoiseState:
    model: UNet                # the noise U-Net
    utility: UNet              # frozen, eval mode, no gradients
    optimizer: torch.optim.Adam
    step: int = 0


def build_unet(depth: int, cf: int, device: torch.device, seed: int = 0,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> UNet:
    """A U-Net on ``device`` (channels-last on the card), from flax's
    initializers drawn on the host with ``seed``, or holding
    ``state_dict`` (params and running statistics, ``strict=True``; then
    no initializer runs)."""
    if state_dict is None:
        model = UNet(out_channels=1, depth=depth, cf=cf,
                     generator=torch.Generator().manual_seed(seed)).to(device)
    else:
        with torch.device("meta"):
            model = UNet(out_channels=1, depth=depth, cf=cf)
        model = model.to_empty(device=device)
        model.load_state_dict(state_dict)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def init_utility_state(cfg: UNoiseConfig, seed: int = 0,
                       device: DeviceLike = None) -> UtilityState:
    dev = resolve_device(device)
    model = build_unet(cfg.util_depth, cfg.util_channel_factor, dev, seed)
    return UtilityState(model, make_adam(model.parameters(), cfg.learning_rate))


def init_noise_state(cfg: UNoiseConfig, utility: Mapping[str, torch.Tensor],
                     seed: int = 0, pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                     device: DeviceLike = None) -> NoiseState:
    """``utility``: the utility U-Net's state_dict.  A ``pretrained``
    noise init (a utility model's state_dict, reference
    train_noise.py:115-119) carries BOTH the parameters and the running
    statistics."""
    dev = resolve_device(device)
    model = build_unet(cfg.depth, cfg.channel_factor, dev, seed, pretrained)
    util = build_unet(cfg.util_depth, cfg.util_channel_factor, dev, state_dict=utility)
    util.eval().requires_grad_(False)
    return NoiseState(model, util, make_adam(model.parameters(), cfg.learning_rate))


def _prep_images(images: torch.Tensor, raw: bool) -> torch.Tensor:
    """NHWC batch → NCHW view (channels-last strides).  ``raw``: (B, H, W, 1)
    unnormalized slices from ``UNoiseDataset(raw=True)`` are tiled to 3
    channels and ImageNet-normalized here, on the device."""
    if raw:
        mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
        std = torch.as_tensor(IMAGENET_STD, device=images.device)
        images = (images.float().expand(*images.shape[:3], 3) - mean) / std
    return images.permute(0, 3, 1, 2)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _sharded(mesh, model: UNet) -> None:
    """Global batch statistics for ``model``'s BatchNorms over ``mesh``."""
    if mesh is not None:
        from adlm_tpu_torch.parallel.sharding import set_batch_norm_reduce

        set_batch_norm_reduce(model, mesh)


def _reduce_step(mesh, model: UNet, metrics: Metrics) -> Metrics:
    """One flattened SUM over the data ranks of the gradients and the
    metrics (each rank's part of the global value)."""
    if mesh is None:
        return metrics
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    keys = list(metrics)
    vals = [metrics[k].reshape(1).float() for k in keys]
    mesh.sum_flat_(grads + vals)
    return {k: v[0] for k, v in zip(keys, vals)}


def make_utility_train_step(cfg: UNoiseConfig, raw: bool = False, mesh=None):
    """step(state, images, masks) → the loss (a device scalar).  The
    step's gradients stay in the parameters' ``.grad``.  With a ``mesh``
    the batch is this rank's slice and the loss the global batch's."""
    dtype = compute_dtype(cfg.compute_dtype)

    def step(state: UtilityState, images: torch.Tensor,
             masks: torch.Tensor) -> torch.Tensor:
        model = state.model.train()
        _sharded(mesh, model)
        with ieee_f32():
            logits = forward_in(model, _prep_images(images, raw), dtype)
            count = None if mesh is None else masks.numel() * mesh.data
            loss = bce_with_logits(logits, _nchw(masks), count)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = _reduce_step(mesh, model, {"loss": loss.detach()})["loss"]
            state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


def make_utility_eval_step(cfg: UNoiseConfig, raw: bool = False):
    """step(state, images, masks) → {val_loss, val_dice}, f32."""

    @torch.no_grad()
    def step(state: UtilityState, images: torch.Tensor, masks: torch.Tensor) -> Metrics:
        model = state.model.eval()
        with ieee_f32():
            logits = model(_prep_images(images, raw).float())
            masks = _nchw(masks)
            return {"val_loss": bce_with_logits(logits, masks),
                    "val_dice": dice_coeff(logits > 0.0, masks)}

    return step


def draw_eps(shape, generator: Optional[torch.Generator], device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """ε ~ N(0, 1) of ``shape`` (NCHW) on ``device``, in ``dtype``, as JAX
    draws it in B's dtype."""
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def noise_forward(cfg: UNoiseConfig, model: UNet, images: torch.Tensor, train: bool,
                  eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  dtype: torch.dtype = torch.float32, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(noise, B, log B): noise and B (B, 1, H, W) in ``dtype``, log B in
    f32 (reference src/train_noise.py:54-64).  ``images``: NCHW.
    ``eps``: NHWC (B, H, W, 1), or None to draw it in ``dtype`` from
    ``generator``.

    log B is ``logsigmoid`` of the logits, not ``log`` of B: the same
    value where B is representable, finite where B underflows to 0 (a
    noise model started from a confident utility model reaches logits
    below −88 in eval mode), where ``log(B)``, the JAX package's, is
    −inf and its gradient NaN (ROADMAP.md, Queue 3).

    With a ``mesh`` the images are this rank's slice of the global batch:
    ε is drawn (or given) at the global shape and sliced to its rows."""
    model.train(train)
    logits = forward_in(model, images, dtype)
    B = torch.sigmoid(logits)
    if eps is None:
        shape = B.shape if mesh is None else (B.shape[0] * mesh.data,) + B.shape[1:]
        eps = draw_eps(shape, generator, B.device, B.dtype)
    else:
        eps = _nchw(eps).to(device=B.device, dtype=B.dtype)
    if mesh is not None:
        eps = eps[mesh.batch_slice(eps.shape[0])]
    noise = eps * (B * (cfg.max_scale - cfg.min_scale) + cfg.min_scale)
    return noise, B, F.logsigmoid(logits.float())


def _noise_loss(cfg: UNoiseConfig, pred: torch.Tensor, masks: torch.Tensor,
                log_b: torch.Tensor, n_ranks: Optional[int] = None) -> torch.Tensor:
    """BCE − λ·mean(log B); ``n_ranks``: the means of a rank's share of a
    global batch split over that many data ranks."""
    if n_ranks is None:
        return bce_with_logits(pred, _nchw(masks)) - cfg.noise_coeff * log_b.mean()
    return (bce_with_logits(pred, _nchw(masks), masks.numel() * n_ranks)
            - cfg.noise_coeff * (log_b.sum() / (log_b.numel() * n_ranks)))


def make_noise_train_step(cfg: UNoiseConfig, raw: bool = False, mesh=None):
    """step(state, images, masks, eps=None, generator=None) →
    {train_loss, mean_B} (device scalars).  The step's gradients stay in
    the noise model's ``.grad``; the utility model is unchanged.  With a
    ``mesh`` the batch is this rank's slice, ``eps`` (if given) the
    global batch's, and the metrics the global batch's."""
    dtype = compute_dtype(cfg.compute_dtype)
    n_ranks = None if mesh is None else mesh.data

    def step(state: NoiseState, images: torch.Tensor, masks: torch.Tensor,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Metrics:
        util = state.utility.eval()
        _sharded(mesh, state.model)
        with ieee_f32():
            x = _prep_images(images, raw).to(dtype)
            noise, B, log_b = noise_forward(cfg, state.model, x, True, eps, generator,
                                            dtype, mesh=mesh)
            pred = forward_in(util, x + noise, dtype)
            loss = _noise_loss(cfg, pred, masks, log_b, n_ranks)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            b = B.detach().float()
            mean_b = b.mean() if mesh is None else b.sum() / (b.numel() * mesh.data)
            metrics = _reduce_step(mesh, state.model,
                                   {"train_loss": loss.detach(), "mean_B": mean_b})
            state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_noise_eval_step(cfg: UNoiseConfig, raw: bool = False):
    """step(state, images, masks, eps=None, generator=None) →
    {val_loss, val_dice}, f32."""

    @torch.no_grad()
    def step(state: NoiseState, images: torch.Tensor, masks: torch.Tensor,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Metrics:
        with ieee_f32():
            x = _prep_images(images, raw).float()
            noise, _, log_b = noise_forward(cfg, state.model, x, False, eps, generator)
            pred = state.utility.eval()(x + noise)
            return {"val_loss": _noise_loss(cfg, pred, masks, log_b),
                    "val_dice": dice_coeff(pred > 0.0, _nchw(masks))}

    return step

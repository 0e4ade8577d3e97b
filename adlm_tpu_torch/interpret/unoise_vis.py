"""U-Noise interpretation methods and their speed comparison (counterpart
of ``adlm_tpu.interpret.unoise_vis``; reference
src/make_visualizations.py).

* ``grad_cam`` — gradient of one output pixel with respect to the U-Net's
  bottleneck activation, channel-pooled and reweighted (reference
  :16-60).  The forward is split at the bottleneck (``UNet.encode`` /
  ``decode``) and autograd runs from the pixel to it.
* ``occlusion_sensitivity`` — the dice change when a zeroed patch slides
  over the input (reference :63-126), every anchor a batch entry,
  ``chunk`` anchors per forward.
* ``unoise_importance`` — the U-Noise mask B itself (one forward).
* ``interpretation_timing`` — seconds per method (reference :176-277),
  each call closed by a device synchronize.

Models run in eval mode, in IEEE f32 (or in the dtype of their
parameters); images are NHWC (B, H, W, 3) as the datasets yield them,
results numpy.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from adlm_tpu_torch.core.device import ieee_f32, model_dtype
from adlm_tpu_torch.models.unet import UNet


def _nchw(images: torch.Tensor, model: UNet) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).to(model_dtype(model))


def grad_cam(model: UNet, image: torch.Tensor, x: int = 0, y: int = 0) -> np.ndarray:
    """(h, w) Grad-CAM heatmap at the bottleneck for output pixel (y, x)
    of the first image: activations × channel-pooled gradients, averaged
    over channels, relu, max-normalized (reference
    make_visualizations.py:43-60)."""
    model.eval()
    with ieee_f32(), torch.no_grad():
        act, skips = model.encode(_nchw(image, model))
    act = act.detach().requires_grad_(True)
    with ieee_f32():
        out = model.decode(act, skips)
        grads, = torch.autograd.grad(out[0, 0, y, x], act)
    pooled = grads.float().mean(dim=(0, 2, 3))                   # (C,)
    heat = (act[0].detach().float() * pooled[:, None, None]).mean(dim=0)
    heat = torch.clamp(heat, min=0.0)
    heat = heat / torch.clamp(heat.max(), min=1e-12)
    return heat.cpu().numpy()


def dice_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B,) dice of each sample's flattened maps, eps 1e-10."""
    b = pred.shape[0]
    m1 = pred.reshape(b, -1).float()
    m2 = target.reshape(b, -1).float()
    return 2.0 * (m1 * m2).sum(-1) / (m1.sum(-1) + m2.sum(-1) + 1e-10)


@torch.no_grad()
def occlusion_sensitivity(model: UNet, images: torch.Tensor, masks: torch.Tensor,
                          patch: int = 10, stride: int = 1,
                          chunk: int = 64) -> np.ndarray:
    """(B, new_H, new_W) dice deltas, one per occluder anchor (reference
    make_visualizations.py:63-126).  The anchors lie on the standard grid
    ``(i·stride, j·stride)``; the reference's loop shifts them by one
    stride in w (its first anchor is (0, stride)), a deviation the JAX
    package documents too.  ``chunk`` anchors (× B images) go through one
    forward."""
    model.eval()
    B, H, W, _ = images.shape
    new_h = (H - patch) // stride + 1
    new_w = (W - patch) // stride + 1
    x = _nchw(images, model)
    target = masks.permute(0, 3, 1, 2)
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    anchors = torch.stack(torch.meshgrid(
        torch.arange(new_h, device=x.device) * stride,
        torch.arange(new_w, device=x.device) * stride, indexing="ij"), -1).reshape(-1, 2)
    with ieee_f32():
        baseline = dice_per_sample(model(x) > 0, target)
        scores = []
        for s in range(0, anchors.shape[0], chunk):
            a = anchors[s:s + chunk]
            rmask = (rows[None] >= a[:, :1]) & (rows[None] < a[:, :1] + patch)
            cmask = (cols[None] >= a[:, 1:]) & (cols[None] < a[:, 1:] + patch)
            hole = (rmask[:, :, None] & cmask[:, None, :])[:, None, None]  # (n,1,1,H,W)
            occluded = torch.where(hole, 0.0, x[None]).to(x.dtype)     # (n,B,C,H,W)
            n = occluded.shape[0]
            pred = model(occluded.reshape(n * B, *x.shape[1:])) > 0
            scores.append(dice_per_sample(pred, target.repeat(n, 1, 1, 1)).reshape(n, B))
    diff = torch.cat(scores) - baseline[None]
    return diff.T.reshape(B, new_h, new_w).cpu().numpy()


@torch.no_grad()
def unoise_importance(noise_model: UNet, images: torch.Tensor) -> np.ndarray:
    """(B, H, W, 1) per-pixel tolerance mask B (higher = more noise
    tolerated = less important), one forward (reference :129-171)."""
    noise_model.eval()
    with ieee_f32():
        logits = noise_model(_nchw(images, noise_model))
    return torch.sigmoid(logits.float()).permute(0, 2, 3, 1).cpu().numpy()


def interpretation_timing(methods: Dict[str, Callable[[], Any]],
                          repeats: int = 3) -> Dict[str, float]:
    """Seconds per call of each method (reference :176-277): one warm-up
    call, then the mean of ``repeats``, every call ending in a device
    synchronize (the methods return host arrays, which sync already)."""
    def run_synced(fn):
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out

    out = {}
    for name, fn in methods.items():
        run_synced(fn)
        t0 = time.perf_counter()
        for _ in range(repeats):
            run_synced(fn)
        out[name] = (time.perf_counter() - t0) / repeats
    return out

"""Segmentation evaluation: mIoU / pixel accuracy + prototype statistics
(counterpart of ``adlm_tpu.interpret.evaluate``).

Reference: ``segmentation/eval_valid.py`` — full-image forward, bilinear
upsample of the logits to label size, argmax, pixel accuracy and
per-class intersection/union with void ignored (:158-219), and the
interpretability statistics: nearest-prototype counts (:191-198) and
top-K same-class purity on random pixels (:200-214).

Everything of one batch runs on the device; only small count vectors
(and, with stats, the stat maps) come out.  Two stats resolutions:

* grid (default): nearest prototype and purity at the model's output
  grid;
* upsampled (``stats_upsampled=True``): the reference's statistic, on
  the distance maps bilinearly upsampled to label size.  The argmin
  over prototypes goes through the fused kernel on the card
  (``ops/upsample_argmin.py``), so the (B, H, W, P) tensor never
  exists.

Precision: f32 eval runs convolutions and matmuls in IEEE f32 (no TF32,
``core.device.ieee_f32``).  A bf16 eval casts the model's parameters
(``core.device.cast_params``) and the normalized input to bf16; the
prototype head and the statistics still compute in f32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
from adlm_tpu_torch.ops.normalize import normalize as normalize_images
from adlm_tpu_torch.ops.resize import resize_bilinear
from adlm_tpu_torch.ops.upsample_argmin import upsampled_nearest

_F32 = torch.float32
MeanStd = Optional[Tuple[Sequence[float], Sequence[float]]]


def _scalar(v: float, device) -> torch.Tensor:
    """A float32 scalar tensor: products with it round like the JAX
    package's f32 products with a weakly typed Python float."""
    return torch.tensor(v, dtype=_F32, device=device)


def agreement_counts(nearest: torch.Tensor, stat_pred: torch.Tensor,
                     proto_class: torch.Tensor) -> torch.Tensor:
    """``cnt[b, p]`` = pixels of image b whose nearest prototype is p and
    whose predicted class is p's class (reference eval_valid.py:191-198).

    Args:
      nearest: (B, h, w) nearest-prototype indices.
      stat_pred: (B, h, w) predicted classes (−1 = excluded).
      proto_class: (P,) prototype class ids.

    Returns:
      (B, P) int32 counts.
    """
    B, P = nearest.shape[0], proto_class.shape[0]
    nearest = nearest.long()
    agree = stat_pred.long() == proto_class.long()[nearest]
    code = nearest + P * torch.arange(B, device=nearest.device)[:, None, None]
    code = torch.where(agree, code, B * P)
    counts = torch.bincount(code.flatten(), minlength=B * P + 1)
    return counts[:B * P].view(B, P).to(torch.int32)


def _bilinear_gather(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                     out_h: int, out_w: int, first_row: int = 0,
                     in_h: Optional[int] = None) -> torch.Tensor:
    """Values of the bilinear upsample of ``x`` (B, h, w, P) to
    (out_h, out_w) at output pixels (rows, cols), (n,) shared or (B, n)
    per image, without the upsample: (B, n, P) float32.  Half-pixel
    source coordinates, edges replicate.  ``x`` may hold rows
    [first_row, first_row + h) of a map of ``in_h`` rows, which must
    hold the taps of ``rows``."""
    B, w = x.shape[0], x.shape[2]
    h = x.shape[1] if in_h is None else in_h
    dev = x.device
    rows = torch.atleast_2d(rows).expand(B, rows.shape[-1])
    cols = torch.atleast_2d(cols).expand(B, cols.shape[-1])
    sy = torch.clamp((rows.to(_F32) + 0.5) * _scalar(h / out_h, dev) - 0.5,
                     0.0, h - 1.0)
    sx = torch.clamp((cols.to(_F32) + 0.5) * _scalar(w / out_w, dev) - 0.5,
                     0.0, w - 1.0)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (sy - y0.to(_F32))[..., None]
    wx = (sx - x0.to(_F32))[..., None]
    bidx = torch.arange(B, device=dev)[:, None]
    y0, y1 = y0 - first_row, y1 - first_row
    v00, v01 = x[bidx, y0, x0], x[bidx, y0, x1]
    v10, v11 = x[bidx, y1, x0], x[bidx, y1, x1]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx)


def _topk_purity(sample_d: torch.Tensor, sample_pred: torch.Tensor,
                 proto_class: torch.Tensor) -> torch.Tensor:
    """Per-image top-K same-class purity (reference eval_valid.py:200-214):
    for each sampled pixel, sort prototypes by distance (stable, as
    ``jnp.argsort``); purity at K = share of the K nearest whose class is
    the pixel's predicted class; summed over pixels × 100 / n.

    Returns:
      (B, P) float32, one entry per K − 1.
    """
    n, P = sample_d.shape[1], sample_d.shape[2]
    order = torch.argsort(sample_d, dim=-1, stable=True)
    is_cls = (proto_class[order] == sample_pred[..., None]).to(_F32)
    purity = is_cls.cumsum(-1) / torch.arange(1, P + 1, dtype=_F32,
                                              device=sample_d.device)
    return purity.sum(dim=1) * 100.0 / n


def confusion_counts(pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> Dict[str, torch.Tensor]:
    """Per-class ``intersection``/``union`` and the ``correct``/``total``
    pixel counts of predictions (B, H, W) against raw annotations
    (B, H, W): 0 = void, class c at value c + 1 (reference
    eval_valid.py:178-189)."""
    valid = labels > 0
    gt = torch.clamp(labels.long() - 1, 0, num_classes - 1)
    # confusion counts over valid pixels: rows gt, columns pred
    code = torch.where(valid, gt * num_classes + pred,
                       num_classes * num_classes)
    conf = torch.bincount(code.flatten(), minlength=num_classes ** 2 + 1)
    conf = conf[:num_classes ** 2].view(num_classes, num_classes)
    inter = conf.diagonal()
    return {"intersection": inter,
            "union": conf.sum(0) + conf.sum(1) - inter,
            "correct": inter.sum(), "total": valid.sum()}


def _prepare(model: nn.Module, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last).eval()
    return dev


def _images_nchw(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) → the model's dtype, as an NCHW view whose strides
    are channels-last (no copy)."""
    return images.to(model_dtype(model)).permute(0, 3, 1, 2)


def make_inference_fn(model: nn.Module, num_classes: int,
                      with_stats: bool = False,
                      stats_upsampled: bool = False,
                      proto_chunk: int = 16,
                      normalize: MeanStd = None,
                      stats_exact: bool = False,
                      device: DeviceLike = None) -> Callable:
    """The eval step for ``model`` (a PPNet), on ``device`` (default the
    card; the model is moved there, channels-last, in eval mode).

    ``fn(proto_class, images, labels)`` → dict with per-class
    ``intersection``/``union``, ``correct``/``total`` pixel counts and
    the full-res ``pred``.  ``images`` are (B, H, W, 3); ``labels`` are
    raw annotations (B, H, W): 0 = void, class c at value c + 1
    (reference eval_valid.py:178-189).  Inputs may be numpy arrays or
    tensors on any device.

    With stats the call gains ``(u, v)``: (B, n) or shared (n,) floats in
    [0, 1) locating the random sample pixels (scaled to the stats
    grid), and the output gains ``stat_pred``, ``nearest_proto``,
    ``agree_counts`` (B, P) and ``topk_purity`` (B, P).

    ``normalize=(mean, std)`` takes raw uint8 images and normalizes them
    on the device.  ``stats_exact`` asks for the exact f32 blend of
    bf16 distance maps in the upsampled argmin; the kernel always
    blends exactly, so it matters only on the CPU.
    """
    dev = _prepare(model, device)

    def fn(proto_class, images, labels, *uv) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), ieee_f32():
            images = normalize_images(to_device(images, dev), normalize)
            labels = to_device(labels, dev)
            proto_class = to_device(proto_class, dev)
            grid_logits, dist = model(_images_nchw(model, images),
                                      return_distances=with_stats)
            H, W = labels.shape[1], labels.shape[2]
            logits = resize_bilinear(grid_logits, (H, W))
            pred = torch.argmax(logits, dim=-1)                  # (B,H,W)
            out = dict(confusion_counts(pred, labels, num_classes), pred=pred)
            if with_stats:
                out.update(_stats(grid_logits, dist, pred, proto_class,
                                  uv, (H, W)))
            return out

    def _stats(grid_logits, dist, pred, proto_class, uv, size):
        B = dist.shape[0]
        u = to_device(uv[0], dev, _F32)
        v = to_device(uv[1], dev, _F32)
        u = torch.atleast_2d(u).expand(B, u.shape[-1])
        v = torch.atleast_2d(v).expand(B, v.shape[-1])
        bidx = torch.arange(B, device=dev)[:, None]
        if stats_upsampled:
            # the reference's statistic: distances upsampled to label
            # size (eval_valid.py:172-214)
            sh, sw = size
            stat_pred = pred
            chunk = max(1, min(proto_chunk, (64 * 1024 * 1024) // (B * sh * sw)))
            nearest = upsampled_nearest(dist, size, chunk, exact=stats_exact)
            rows = torch.clamp((u * sh).to(torch.int32), max=sh - 1).long()
            cols = torch.clamp((v * sw).to(torch.int32), max=sw - 1).long()
            sample_d = _bilinear_gather(dist, rows, cols, sh, sw)
        else:
            sh, sw = dist.shape[1], dist.shape[2]
            stat_pred = torch.argmax(grid_logits, dim=-1)
            nearest = torch.argmin(dist, dim=-1).to(torch.int32)
            rows = torch.clamp((u * sh).to(torch.int32), max=sh - 1).long()
            cols = torch.clamp((v * sw).to(torch.int32), max=sw - 1).long()
            sample_d = dist[bidx, rows, cols]                    # (B,n,P)
        sample_pred = stat_pred[bidx, rows, cols]                # (B,n)
        return {"stat_pred": stat_pred, "nearest_proto": nearest,
                "agree_counts": agreement_counts(nearest, stat_pred,
                                                 proto_class),
                "topk_purity": _topk_purity(sample_d, sample_pred,
                                            proto_class)}

    return fn


def make_overlay_fn(model: nn.Module, proto_chunk: int = 16,
                    device: DeviceLike = None) -> Callable:
    """Forward for the qualitative overlays (reference
    eval_valid.py:270-343): ``fn(images)`` with normalized (B, H, W, 3)
    images → (prediction map, nearest-prototype map), both (B, H, W),
    from logits and distances upsampled to the input size."""
    dev = _prepare(model, device)

    def fn(images) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode(), ieee_f32():
            images = to_device(images, dev)
            logits, dist = model(_images_nchw(model, images),
                                 return_distances=True)
            H, W = images.shape[1], images.shape[2]
            pred = torch.argmax(resize_bilinear(logits, (H, W)), dim=-1)
            return pred, upsampled_nearest(dist, (H, W), proto_chunk)

    return fn


def mean_iou_from_confusion(intersection: np.ndarray, union: np.ndarray
                            ) -> Tuple[float, Dict[int, float]]:
    """mIoU over classes with nonzero union (reference
    eval_valid.py:218-219), as percentages."""
    ious = {int(c): float(intersection[c]) * 100.0 / float(union[c])
            for c in range(len(union)) if union[c] > 0}
    miou = float(np.mean(list(ious.values()))) if ious else 0.0
    return miou, ious


class SegEvaluator:
    """Accumulates eval metrics over batches (the eval_valid outputs).

    With ``with_stats`` the same forward also returns the statistic
    outputs (feed ``agree_counts``/``topk_purity`` to
    ``ProtoStatsAccumulator.update_counts``).  The random sample pixels
    are drawn on the host per image from a seeded ``RandomState``, in
    the JAX package's order, so both packages sample the same pixels.

    With a ``mesh`` (``core/mesh.py``) the batch is split over the data
    ranks: ``update`` takes this rank's slice of a global batch (as
    ``SegmentationDataset.eval_batches(shard=...)`` yields it), draws the
    sample pixels at the global batch's shape and takes its rows, sums
    the counters over the ranks (int64, exact) and returns the global
    batch's ``agree_counts``/``topk_purity`` rows on every rank (each
    rank fills its own rows of a zero buffer); ``pred`` stays the
    rank's own.  ``n_valid`` (the global batch's real images) lets a
    rank whose slice is all padding skip its forward, and zeroes the
    statistic rows of padding.

    With ``mesh.model`` > 1 (and ``spatial``, the default, as in the JAX
    package) each rank of a model group also splits image H: the step is
    ``parallel/spatial.py``'s, on the same host counters and sample
    pixels as one process.  ``pred`` and the statistic maps are then the
    rank's own rows.
    """

    def __init__(self, model: nn.Module, num_classes: int,
                 with_stats: bool = False, stats_upsampled: bool = False,
                 n_random_pixels: int = 100, seed: int = 0,
                 normalize: MeanStd = None, stats_exact: bool = False,
                 device: DeviceLike = None, mesh=None, spatial: bool = True):
        self.num_classes = num_classes
        self.mesh = mesh
        self.spatial = spatial and mesh is not None and mesh.model > 1
        if self.spatial:
            from adlm_tpu_torch.parallel.spatial import make_spatial_inference_fn

            self.fn = make_spatial_inference_fn(model, num_classes, mesh, with_stats,
                                                stats_upsampled, normalize, stats_exact)
        else:
            self.fn = make_inference_fn(model, num_classes, with_stats,
                                        stats_upsampled, normalize=normalize,
                                        stats_exact=stats_exact,
                                        device=mesh.device if mesh is not None else device)
        self.with_stats = with_stats
        self.n_random = n_random_pixels
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self) -> None:
        self.intersection = np.zeros(self.num_classes, np.int64)
        self.union = np.zeros(self.num_classes, np.int64)
        self.correct = 0
        self.total = 0

    def update(self, proto_class, images, labels,
               n_valid: Optional[int] = None) -> Dict[str, Any]:
        mesh = self.mesh
        b = images.shape[0]
        B = b if mesh is None else b * mesh.data
        args = ()
        if self.with_stats:
            args = (self.rng.random_sample((B, self.n_random)).astype(np.float32),
                    self.rng.random_sample((B, self.n_random)).astype(np.float32))
            if mesh is not None:
                args = tuple(a[mesh.batch_slice(B)] for a in args)
        if mesh is None:
            out = self.fn(proto_class, images, labels, *args)
        elif self.spatial:
            out = self.fn(proto_class, images, labels, *args,
                          n_valid=B if n_valid is None else n_valid)
        else:
            out = self._sharded_update(proto_class, images, labels, args,
                                       b if n_valid is None else mesh.share(n_valid, b))
        self.intersection += out["intersection"].cpu().numpy()
        self.union += out["union"].cpu().numpy()
        self.correct += int(out["correct"])
        self.total += int(out["total"])
        return out

    def _sharded_update(self, proto_class, images, labels, args, share: int):
        return sharded_update(self.fn, self.mesh, self.num_classes, self.with_stats,
                              proto_class, images, labels, args, share)

    def results(self) -> Dict[str, Any]:
        miou, ious = mean_iou_from_confusion(self.intersection, self.union)
        acc = self.correct * 100.0 / max(self.total, 1)
        return {"mean_iou": miou, "iou_per_class": ious,
                "pixel_accuracy": acc}


def sharded_update(fn: Callable, mesh, num_classes: int, with_stats: bool,
                   proto_class, images, labels, args, share: int) -> Dict[str, Any]:
    """One batch-sharded eval step: ``fn(proto_class, images, labels,
    *args)`` on this rank's slice (skipped when none of its ``share``
    images is real), its counters summed over the data group and its
    ``agree_counts``/``topk_purity`` rows gathered into the global
    batch's (zero for padding)."""
    K = num_classes
    dev = mesh.device
    if share > 0:
        out = fn(proto_class, images, labels, *args)
    else:
        # all padding: nothing to count, no forward
        out = {"intersection": torch.zeros(K, dtype=torch.long, device=dev),
               "union": torch.zeros(K, dtype=torch.long, device=dev),
               "correct": torch.zeros((), dtype=torch.long, device=dev),
               "total": torch.zeros((), dtype=torch.long, device=dev)}
    counts = torch.cat([out["intersection"].long(), out["union"].long(),
                        out["correct"].long().reshape(1),
                        out["total"].long().reshape(1)])
    mesh.all_reduce_(counts)
    out.update(intersection=counts[:K], union=counts[K:2 * K],
               correct=counts[2 * K], total=counts[2 * K + 1])
    if with_stats:
        P = int(torch.as_tensor(proto_class).shape[0])
        b = images.shape[0]
        for key, dt in (("agree_counts", torch.int32), ("topk_purity", _F32)):
            local = out.get(key)
            rows = torch.zeros((b, P), dtype=dt, device=dev)
            if local is not None:
                rows[:share] = local[:share]
            out[key] = mesh.gather_rows(rows)
    return out

"""U-Noise result figures: coverage-vs-dice curves (counterpart of
``adlm_tpu.interpret.figures``; reference src/make_figures.py:29-217).

* ``threshold_sweep`` and ``dice_at_median_importance`` — the
  reference's ``evaluate`` (make_figures.py:135-173): a fixed threshold
  grid ``B <= t`` with dice and coverage averaged per batch, and the
  published dice@50% = the dice with only the below-median-B half of all
  pixels visible (README.md:170-187).
* ``device_threshold_sweep`` — the same sweep with the batch's
  thresholds stacked into forwards of ``chunk`` masked batches, the
  visible fractions reduced on the device and one host copy per batch.
* ``coverage_dice_curve`` — a per-image exact-coverage variant (each
  image keeps its own lowest-B quantile).

``load_results_pickle`` / ``save_results_pickle`` read and write the
reference's ``data/results.pickle`` interchange format
(make_figures.py:186-209).  ``plot_curves`` draws with matplotlib where
it imports and does nothing where it does not.

``predict`` is any callable from an NHWC image batch to logits (the
utility model); images, masks and importance are NHWC arrays or tensors.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adlm_tpu_torch.core.device import DeviceLike, ieee_f32, model_dtype, resolve_device
from adlm_tpu_torch.models.unet import UNet
from adlm_tpu_torch.ops.losses import dice_coeff

Predict = Callable[[torch.Tensor], torch.Tensor]
Curve = List[Tuple[float, float]]


def make_predict(model: UNet) -> Predict:
    """NHWC images → NCHW logits of ``model`` in eval mode, no grad, IEEE
    f32 (or the dtype of its parameters)."""
    model.eval()
    dev = next(model.parameters()).device

    @torch.no_grad()
    def predict(images: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(images, device=dev).permute(0, 3, 1, 2)
        with ieee_f32():
            return model(x.to(model_dtype(model)))

    return predict


def _nchw_masks(masks, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(masks, device=like.device).permute(0, 3, 1, 2)


def coverage_dice_curve(predict: Predict, importance, images, masks,
                        coverages: Sequence[float] = tuple(np.linspace(0.05, 1.0, 20))
                        ) -> Curve:
    """Dice when only the ``coverage`` most-important pixels stay visible:
    LOW B = important, so each image keeps its lowest-B fraction."""
    imp = torch.as_tensor(np.asarray(importance))
    images = torch.as_tensor(np.asarray(images))
    curve = []
    for q in coverages:
        thresh = torch.quantile(imp.reshape(imp.shape[0], -1).float(), float(q), dim=1)
        visible = imp <= thresh[:, None, None, None]
        pred = predict(images * visible)
        curve.append((float(q), float(dice_coeff(pred > 0.0, _nchw_masks(masks, pred)))))
    return curve


def _iter_batches(batch_size: int, *arrays):
    n = arrays[0].shape[0]
    for s in range(0, n, batch_size):
        yield tuple(a[s:s + batch_size] for a in arrays)


def _grid(thresholds: Optional[Sequence[float]]) -> np.ndarray:
    return np.linspace(0.0, 1.0, 21) if thresholds is None else np.asarray(thresholds)


def threshold_sweep(predict: Predict, importance, images, masks,
                    thresholds: Optional[Sequence[float]] = None,
                    batch_size: int = 32) -> Tuple[List[float], List[float], List[float]]:
    """The reference's ``evaluate`` sweep (make_figures.py:135-158): for
    each threshold ``t`` of a 21-point grid, the input masked to
    ``images · (B <= t)`` through ``predict``, the batch dice and the
    visible-pixel fraction, both averaged PER BATCH over batches of
    ``batch_size`` (the reference's 32).  Returns (dice, coverage,
    thresholds)."""
    thresholds = _grid(thresholds)
    imp, images, masks = (np.asarray(a) for a in (importance, images, masks))
    dice = [[] for _ in thresholds]
    cov = [[] for _ in thresholds]
    for imgs_b, masks_b, b_b in _iter_batches(batch_size, images, masks, imp):
        for i, t in enumerate(thresholds):
            visible = b_b <= t
            pred = predict(torch.as_tensor(imgs_b * visible))
            dice[i].append(float(dice_coeff(pred > 0.0, _nchw_masks(masks_b, pred))))
            cov[i].append(float(np.mean(visible)))
    return ([float(np.mean(d)) for d in dice], [float(np.mean(c)) for c in cov],
            [float(t) for t in thresholds])


def device_threshold_sweep(predict: Predict, importance, images, masks,
                           thresholds: Optional[Sequence[float]] = None,
                           batch_size: int = 32, chunk: int = 7,
                           device: DeviceLike = None
                           ) -> Tuple[List[float], List[float], List[float]]:
    """``threshold_sweep`` with the masking, the forwards and the
    reductions on ``device``: each batch's thresholds go through the
    model ``chunk`` at a time as one stacked batch, and each batch's
    (dice, coverage) vectors come back in one copy.  The same per-batch
    averages.  ``device`` is the card unless the caller names the CPU."""
    thresholds = _grid(thresholds)
    dev = resolve_device(device)
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=dev)
    dice_b, cov_b = [], []
    for imgs_b, masks_b, b_b in _iter_batches(
            batch_size, np.asarray(images), np.asarray(masks), np.asarray(importance)):
        x = torch.as_tensor(imgs_b, device=dev)
        y = torch.as_tensor(masks_b, device=dev)
        b = torch.as_tensor(b_b, device=dev)
        n = x.shape[0]
        d, c = [], []
        for s in range(0, th.shape[0], chunk):
            visible = b[None] <= th[s:s + chunk, None, None, None, None]   # (t,n,H,W,1)
            t = visible.shape[0]
            pred = predict((x[None] * visible).reshape(t * n, *x.shape[1:])) > 0.0
            pred = pred.reshape(t, -1)
            target = y.permute(0, 3, 1, 2).reshape(1, -1).float()
            inter = (pred.float() * target).sum(1)
            d.append(2.0 * inter / (pred.float().sum(1) + target.sum() + 1e-10))
            c.append(visible.reshape(t, -1).float().mean(1))
        dice_b.append(torch.cat(d).cpu().numpy())
        cov_b.append(torch.cat(c).cpu().numpy())
    return (list(np.mean(dice_b, axis=0).astype(float)),
            list(np.mean(cov_b, axis=0).astype(float)),
            [float(t) for t in thresholds])


def dice_at_median_importance(predict: Predict, importance, images, masks,
                              batch_size: int = 32) -> float:
    """The published dice@50%-coverage number (``dice_at_half_coverage``,
    reference make_figures.py:160-173): the dice with only the
    below-median-B half of ALL pixels visible, averaged per batch.
    ``torch.median`` returns the LOWER middle element of an even count,
    so the median is ``sorted[(n-1)//2]``."""
    imp = np.asarray(importance)
    flat = np.sort(imp.ravel())
    median = flat[(flat.size - 1) // 2]
    ds = []
    for imgs_b, masks_b, b_b in _iter_batches(
            batch_size, np.asarray(images), np.asarray(masks), imp):
        pred = predict(torch.as_tensor(imgs_b * (b_b <= median)))
        ds.append(float(dice_coeff(pred > 0.0, _nchw_masks(masks_b, pred))))
    return float(np.mean(ds))


def load_results_pickle(path: str) -> Tuple[Dict[str, Curve], Dict[str, int], Dict[str, float]]:
    """The reference's ``data/results.pickle`` (make_figures.py:186-209):
    name → {thresholds, num_params, dice, coverage,
    dice_at_half_coverage}.  Returns (curves name → [(coverage, dice)],
    params name → int, dice@50% name → float).  Unpickling runs code: read
    only files you trust."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    curves, params, at_half = {}, {}, {}
    for name, d in data.items():
        curves[name] = [(float(c), float(x)) for c, x in zip(d["coverage"], d["dice"])]
        params[name] = int(d["num_params"])
        at_half[name] = float(d["dice_at_half_coverage"])
    return curves, params, at_half


def save_results_pickle(path: str, results: Dict[str, Dict]) -> None:
    """Write ``results`` (name → {thresholds, num_params, dice, coverage,
    dice_at_half_coverage}) in the reference's pickle format, for its own
    ``make_figures.py``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(results, f)


def plot_curves(curves: Dict[str, Curve], out_path: str,
                params_per_model: Optional[Dict[str, int]] = None,
                dice_at_half: Optional[Dict[str, float]] = None) -> bool:
    """Coverage-vs-dice figure, and with ``params_per_model`` a
    params-vs-dice@50% scatter beside it (``*_params.png``; dice@50% from
    ``dice_at_half``, else the curve point nearest 50%).  False, and no
    file, where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.figure(figsize=(8, 5))
    for name, curve in curves.items():
        label = name
        if params_per_model and name in params_per_model:
            label += f" ({params_per_model[name]:,} params)"
        plt.plot([c * 100 for c, _ in curve], [d for _, d in curve], marker="o", label=label)
    plt.xlabel("% of image visible")
    plt.ylabel("dice")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    if params_per_model:
        # params vs dice@50% (reference make_figures.py:205-217)
        plt.figure(figsize=(6, 4))
        for name, curve in curves.items():
            if name not in params_per_model:
                continue
            if dice_at_half and name in dice_at_half:
                at50 = dice_at_half[name]
            else:
                at50 = min(curve, key=lambda c: abs(c[0] - 0.5))[1]
            plt.scatter(params_per_model[name], at50, label=name)
        plt.xscale("log")
        plt.xlabel("params")
        plt.ylabel("dice @ 50% coverage")
        plt.legend()
        plt.tight_layout()
        plt.savefig(out_path.replace(".png", "_params.png"))
        plt.close()
    return True

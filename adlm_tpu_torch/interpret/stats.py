"""Eval-time interpretability statistics (counterpart of
``adlm_tpu.interpret.stats``; reference segmentation/eval_valid.py):

* same-class prototype pairwise distances (:83-118);
* nearest-prototype pixel counts per class (:191-198);
* top-K same-class purity on random pixels (:200-214).

Host-side numpy accumulators; tensors are fetched from their device.
``save_eval_plots`` and ``save_example_overlays`` write the eval
artifacts: the text and JSON files always, the figures only where
matplotlib imports (the JAX package's rule).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def prototype_pair_distances(prototypes, proto_class) -> Dict[str, Any]:
    """Pairwise L2 distances among same-class prototypes (torch.cdist
    semantics; the reference keeps the strict lower triangle, the same
    pair set as this upper triangle)."""
    p = _np(prototypes).astype(np.float32).reshape(len(_np(proto_class)), -1)
    pc = _np(proto_class)
    diff = p[:, None, :] - p[None, :, :]
    dist = np.sqrt(np.sum(diff * diff, axis=-1))
    same = pc[:, None] == pc[None, :]
    iu = np.triu_indices(p.shape[0], k=1)
    vals = dist[iu][same[iu]]
    return {"same_class_distances": vals,
            "mean": float(vals.mean()) if len(vals) else 0.0,
            "min": float(vals.min()) if len(vals) else 0.0}


class ProtoStatsAccumulator:
    """Accumulates nearest-prototype counts + top-K purity over batches."""

    def __init__(self, num_prototypes: int, num_classes: int,
                 proto_class, n_random_pixels: int = 100, seed: int = 0):
        self.P = num_prototypes
        self.C = num_classes
        self.pc = _np(proto_class)
        self.counts = np.zeros((num_classes, num_prototypes), np.int64)
        self.top_k = np.zeros(num_prototypes, np.float64)
        self.n_images = 0
        self.n_random = n_random_pixels
        self.rng = np.random.RandomState(seed)

    def update(self, pred, nearest_proto, distances=None, topk_purity=None,
               n_images: Optional[int] = None) -> None:
        """Accumulate one image or one batch from full stat maps.

        Args:
          pred: (h, w) or (B, h, w) predicted classes at the stats grid.
          nearest_proto: same shape, nearest-prototype indices.
          distances: (h, w, P) / (B, h, w, P) — host-side random-pixel
            sampling; or
          topk_purity: (B, P) purity vectors computed on the device.
          n_images: image-count increment override.
        """
        pred = _np(pred)
        nearest_proto = _np(nearest_proto)
        if distances is not None:
            distances = _np(distances)
        if pred.ndim == 2:
            pred = pred[None]
            nearest_proto = nearest_proto[None]
            if distances is not None and distances.ndim == 3:
                distances = distances[None]
        nearest_cls = self.pc[nearest_proto]
        agree = pred == nearest_cls
        if agree.any():
            flat = (pred[agree].astype(np.int64) * self.P
                    + nearest_proto[agree])
            self.counts += np.bincount(
                flat, minlength=self.C * self.P).reshape(self.C, self.P)
        if topk_purity is not None:
            self.top_k += _np(topk_purity).astype(np.float64).sum(axis=0)
        else:
            ks = np.arange(1, self.P + 1, dtype=np.float64)
            for b in range(pred.shape[0]):
                h, w = pred.shape[1], pred.shape[2]
                rows = self.rng.randint(h, size=self.n_random)
                cols = self.rng.randint(w, size=self.n_random)
                sample_d = distances[b, rows, cols, :]      # (n, P)
                sample_pred = pred[b, rows, cols]           # (n,)
                order = np.argsort(sample_d, axis=1)        # nearest 1st
                is_cls = self.pc[order] == sample_pred[:, None]
                cum = np.cumsum(is_cls, axis=1)             # (n, P)
                self.top_k += ((cum / ks).sum(axis=0)
                               * 100.0 / self.n_random)
        self.n_images += pred.shape[0] if n_images is None else n_images

    def update_counts(self, agree_counts, topk_purity,
                      n_images: Optional[int] = None) -> None:
        """Accumulate the device-computed statistics (``agree_counts``
        (P,) or (B, P) and ``topk_purity`` (B, P) of the eval step)."""
        ac = _np(agree_counts).astype(np.int64)
        if ac.ndim == 2:
            ac = ac.sum(axis=0)
        self.counts[self.pc, np.arange(self.P)] += ac
        tk = _np(topk_purity).astype(np.float64)
        self.top_k += tk.sum(axis=0)
        self.n_images += tk.shape[0] if n_images is None else n_images

    def results(self) -> Dict[str, Any]:
        top_k = self.top_k / max(self.n_images, 1)
        return {"nearest_proto_counts": self.counts,
                "mean_top_k_purity": top_k}


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def save_eval_plots(out_dir: str, iou_per_class: Dict[int, float],
                    mean_iou: float, pixel_accuracy: float,
                    stats: Optional[Dict[str, Any]] = None,
                    pair_stats: Optional[Dict[str, Any]] = None,
                    class_names: Optional[Dict[int, str]] = None) -> None:
    """Write the eval artifact set (reference eval_valid.py:227-343):
    ``mean_iou.txt`` and ``iou_scores.json``, then the figures where
    matplotlib imports."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "mean_iou.txt"), "w") as f:
        f.write(str(mean_iou))
    with open(os.path.join(out_dir, "iou_scores.json"), "w") as f:
        json.dump({str(k): v for k, v in iou_per_class.items()}, f)

    plt = _pyplot()
    if plt is None:
        return

    keys = sorted(iou_per_class)
    names = [(class_names or {}).get(k, str(k)) for k in keys]
    plt.figure(figsize=(15, 5))
    plt.bar(np.arange(len(keys)), [iou_per_class[k] for k in keys])
    plt.xticks(np.arange(len(keys)), names, rotation=45)
    plt.title(f"IOU over {len(keys)} classes (mIoU {mean_iou:.4f}, "
              f"pixel acc {pixel_accuracy:.4f})")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "iou_scores.png"))
    plt.close()

    if stats is not None:
        top_k = stats["mean_top_k_purity"]
        plt.figure(figsize=(10, 5))
        plt.plot(np.arange(1, len(top_k) + 1), top_k)
        plt.title("How many of the nearest K prototypes to a random pixel "
                  "are from its predicted class?")
        plt.xlabel("Nearest K prototypes")
        plt.ylabel("% of K from pixel class")
        plt.ylim([0, 100])
        plt.savefig(os.path.join(out_dir, "top_k_purity.png"))
        plt.close()

        counts = stats["nearest_proto_counts"]
        plt.figure(figsize=(15, 5))
        plt.imshow(np.log1p(counts), aspect="auto")
        plt.xlabel("prototype")
        plt.ylabel("class")
        plt.title("nearest-prototype pixel counts (log scale)")
        plt.colorbar()
        plt.savefig(os.path.join(out_dir, "nearest_proto_counts.png"))
        plt.close()

    if pair_stats is not None and len(pair_stats["same_class_distances"]):
        plt.figure(figsize=(8, 5))
        plt.hist(pair_stats["same_class_distances"], bins=50)
        plt.title(f"same-class prototype distances "
                  f"(mean {pair_stats['mean']:.3f})")
        plt.savefig(os.path.join(out_dir, "proto_distance_hist.png"))
        plt.close()


def save_example_overlays(out_dir: str, example_i: int,
                          image: np.ndarray, pred: np.ndarray,
                          nearest_proto: np.ndarray,
                          void_mask: np.ndarray,
                          protos_per_class: int = 10,
                          title: str = "") -> None:
    """Qualitative eval overlays (reference eval_valid.py:270-343), where
    matplotlib imports: ``example_<i>_prediction.png`` (the image under
    the predicted-class map at alpha 0.5, void greyed out) and
    ``example_<i>_prototypes.png`` (the nearest prototype within its
    class, i.e. its index mod ``protos_per_class``, from the upsampled
    distances).

    Args:
      image: (H, W, 3) uint8 raw image.
      pred: (H, W) predicted class ids.
      nearest_proto: (H, W) nearest prototype indices (absolute).
      void_mask: (H, W) float in [0, 1], 1 where the ground truth is void.
      protos_per_class: modulo of the prototype map (the reference
        hardcodes 10, eval_valid.py:311).
    """
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    dpi = 100
    h, w = pred.shape

    def _fig(overlay, vmax, name, subtitle):
        plt.figure(figsize=(w / dpi, h / dpi))
        if title or subtitle:
            plt.title(f"{title}\nExample {example_i}. {subtitle}")
        plt.imshow(image)
        plt.imshow(overlay, alpha=0.5, vmin=0, vmax=vmax)
        plt.imshow(np.zeros_like(pred), alpha=void_mask, vmin=0, vmax=1,
                   cmap="gray")
        plt.axis("off")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, f"example_{example_i}_{name}.png"))
        plt.close()

    _fig(pred, max(int(pred.max()), 1),
         "prediction", "Prediction (from interpolated logits)")
    _fig(nearest_proto % max(protos_per_class, 1), protos_per_class - 1,
         "prototypes", "Nearest prototypes (from interpolated distances)")

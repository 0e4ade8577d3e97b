"""Eval-time interpretability statistics (counterpart of
``adlm_tpu.interpret.stats``; reference segmentation/eval_valid.py):

* same-class prototype pairwise distances (:83-118);
* nearest-prototype pixel counts per class (:191-198);
* top-K same-class purity on random pixels (:200-214).

Host-side numpy accumulators; tensors are fetched from their device.
The plots come with the CLI slice.
"""

from __future__ import annotations

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

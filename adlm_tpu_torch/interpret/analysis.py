"""Global prototype analysis (counterpart of
``adlm_tpu.interpret.analysis``; ``local_analysis`` comes with the
classification slice).

``global_analysis``: the k nearest patches per prototype over a dataset,
with the full artifact set on request (reference
global_analysis.py:120-138, with the corrected ``dataset=`` calling
convention: the reference passes a stale ``dataloader=`` keyword and
crashes).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
from torch import nn

from adlm_tpu_torch.core.device import DeviceLike
from adlm_tpu_torch.interpret import visualize as vz


def _denorm(img: np.ndarray,
            mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
            cells: bool = False) -> np.ndarray:
    """Invert the dataset normalization to a [0,1] RGB image for
    rendering.

    ``cells=True`` marks raw-float datasets (no /255 at load, see
    ``DataConfig.cells``): the un-normalized values live on an arbitrary
    scale, so they are min-max normalized for display instead of clipped.
    """
    out = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    if cells:
        return vz.normalize01(out)
    return np.clip(out, 0, 1)


def make_denorm(data_cfg) -> Callable[[np.ndarray], np.ndarray]:
    """Denormalizer bound to a DataConfig's mean/std/cells: use it at
    every artifact-rendering site instead of assuming ImageNet stats."""
    return lambda img: _denorm(img, mean=data_cfg.mean, std=data_cfg.std,
                               cells=data_cfg.cells)


def global_analysis(model: nn.Module, proto_class,
                    dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
                    num_classes: int, k: int = 5,
                    save_dir: Optional[str] = None,
                    full_save: bool = False,
                    get_item: Optional[Callable] = None,
                    denorm: Optional[Callable] = None,
                    batch_size: int = 1,
                    device: DeviceLike = None) -> np.ndarray:
    """k nearest patch class ids per prototype, on ``device`` (default
    the card); optionally saves per-prototype class id arrays and, with
    ``full_save`` (which needs ``get_item: idx -> (image, label)``), the
    full nearest-patch artifact set (reference
    global_analysis.py:120-138 / find_nearest.py:236-337)."""
    from adlm_tpu_torch.interpret.nearest import (
        find_k_nearest_patches,
        save_nearest_artifacts,
    )

    ids, info = find_k_nearest_patches(model, proto_class, dataset,
                                       num_classes, k=k, return_info=True,
                                       batch_size=batch_size, device=device)
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        if full_save and get_item is not None:
            save_nearest_artifacts(model, proto_class, get_item, ids, info,
                                   save_dir, denorm=denorm, device=device)
        else:
            np.save(os.path.join(save_dir, "full_class_id.npy"), ids)
            for j in range(ids.shape[0]):
                d = os.path.join(save_dir, str(j))
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, "class_id.npy"), ids[j])
    return ids

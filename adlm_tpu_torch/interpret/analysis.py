"""Local and global prototype analysis (counterpart of
``adlm_tpu.interpret.analysis``).

* ``local_analysis``: for one image, the prediction map and the top-k
  most activated prototypes (by their maximum patch activation), each
  with its activation overlay and high-activation crop, and the
  own-class-is-strongest sanity check (reference
  local_analysis.py:119-124, :207-270); on request the per-class
  sections (:272-330).
* ``global_analysis``: the k nearest patches per prototype over a
  dataset, with the full artifact set on request (reference
  global_analysis.py:120-138, with the corrected ``dataset=`` calling
  convention: the reference passes a stale ``dataloader=`` keyword and
  crashes).

The forward runs on ``device`` (default the card, whose head is the
CUDA kernel); the ranking and the artifacts are host numpy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adlm_tpu_torch.core.device import DeviceLike, ieee_f32, to_device
from adlm_tpu_torch.interpret import visualize as vz
from adlm_tpu_torch.interpret.evaluate import _images_nchw, _prepare
from adlm_tpu_torch.ops.prototype import distance_to_similarity


def local_analysis(model: nn.Module, proto_class, image,
                   top_k: int = 10, save_dir: Optional[str] = None,
                   raw_image: Optional[np.ndarray] = None,
                   denorm: Optional[Callable] = None,
                   per_class_top: int = 0,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Analyze one normalized (1, H, W, 3) image on ``device`` (default
    the card).

    Returns the grid prediction map, the top-k prototype indices, classes
    and activations, and the own-class-strongest-connection sanity vector
    (P,).  ``per_class_top=k`` adds ``per_class``: for each of the k
    predicted classes with the most grid cells, that class's own
    prototypes ranked by activation (the segmentation stand-in for the
    reference's image-level top-k logits).  With ``save_dir`` the
    overlays and crops are written, and each per-class section's
    ``log.json`` (activation and last-layer connection per prototype).
    """
    dev = _prepare(model, device)
    with torch.inference_mode(), ieee_f32():
        logits, d = model(_images_nchw(model, to_device(image, dev)))
        act = distance_to_similarity(d[0], model.cfg.prototype_activation,
                                     model.cfg.epsilon)      # (h, w, P)
        act_max = act.amax(dim=(0, 1)).cpu().numpy()
        pred = torch.argmax(logits[0], dim=-1).cpu().numpy()
        act = act.cpu().numpy()
        w = model.last_layer_pk().float().cpu().numpy()      # (P, K)
    pc = to_device(proto_class, torch.device("cpu")).numpy()
    order = np.argsort(-act_max)[:top_k]
    # every prototype's strongest last-layer weight is its own class
    # (reference local_analysis.py:119-124)
    result = {"prediction": pred, "top_prototypes": order,
              "top_classes": pc[order], "top_activations": act_max[order],
              "own_class_is_strongest": np.argmax(w, axis=1) == pc}
    if per_class_top:
        counts = np.bincount(pred.reshape(-1), minlength=w.shape[1])
        top_cls = [int(c) for c in np.argsort(-counts)[:per_class_top] if counts[c] > 0]
        result["per_class"] = {c: np.nonzero(pc == c)[0][np.argsort(-act_max[pc == c])]
                               for c in top_cls}
    if save_dir is None:
        return result

    os.makedirs(save_dir, exist_ok=True)
    img = raw_image if raw_image is not None else (denorm or _denorm)(
        to_device(image, torch.device("cpu")).numpy()[0])
    H, W = img.shape[0], img.shape[1]
    ups: Dict[int, np.ndarray] = {}

    def save_pair(overlay_path: str, crop_path: str, j: int) -> None:
        if j not in ups:
            ups[j] = vz.upsample_cubic(act[:, :, j], (H, W))
        vz._save(overlay_path, vz._overlay(img, vz.normalize01(ups[j])))
        box = vz.high_activation_crop(ups[j])
        vz._save(crop_path, img[box[0]:box[1], box[2]:box[3]])

    for rank, j in enumerate(order):
        save_pair(os.path.join(save_dir, f"top-{rank + 1}_prototype_{j}_class"
                                         f"{int(result['top_classes'][rank])}.png"),
                  os.path.join(save_dir, f"top-{rank + 1}_prototype_{j}_crop.png"), int(j))
    for ci, (c, order_c) in enumerate(result.get("per_class", {}).items()):
        cdir = os.path.join(save_dir, f"top-{ci + 1}_class_prototypes")
        os.makedirs(cdir, exist_ok=True)
        entries = []
        for rank, j in enumerate(order_c):
            save_pair(os.path.join(cdir, f"top-{rank + 1}_activated_prototype_{int(j)}.png"),
                      os.path.join(cdir, f"top-{rank + 1}_prototype_{int(j)}_crop.png"), int(j))
            entries.append({"prototype": int(j), "class_identity": int(pc[j]),
                            "activation": float(act_max[j]),
                            "last_layer_connection": float(w[j, c])})
        with open(os.path.join(cdir, "log.json"), "w") as f:
            json.dump({"class": c, "pixel_count": int(counts[c]), "prototypes": entries},
                      f, indent=2)
    return result


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

"""k-nearest patch scan per prototype, the pruning front end
(counterpart of ``adlm_tpu.interpret.nearest``).

Reference: ``find_k_nearest_patches_to_prototypes`` (reference
find_nearest.py:66-342): per image and prototype, the minimum distance
over the void-penalized distance grid; the patch is labelled with the
prototype's own class if any full-resolution pixel of its box has it,
otherwise with the majority pixel class; a k-heap per prototype keeps
the smallest distances.

Per image, (min, argmin, patch label) is computed on the device (the
forward's head is the CUDA kernel on the card); the host merges the
per-image results into running top-k arrays with the JAX package's
numpy code, in dataset order, so the heap's tie handling is the same.
Entry points run on the card unless the caller passes ``device``, in
IEEE f32.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adlm_tpu_torch.core.device import (
    DeviceLike,
    ieee_f32,
    pipelined_batches,
    to_device,
)
from adlm_tpu_torch.interpret.evaluate import _images_nchw, _prepare
from adlm_tpu_torch.ops.normalize import normalize as normalize_images
from adlm_tpu_torch.ops.prototype import distance_to_similarity
from adlm_tpu_torch.ops.resize import resize_label_nearest

_VOID_PENALTY = 10e6  # reference find_nearest.py:132


def _nearest_one_image(d1: torch.Tensor, y: torch.Tensor,
                       proto_class: torch.Tensor, num_classes: int):
    """Per-image (min_dist, patch_label, patch_i, patch_j), each (P,).

    ``d1`` is the (h, w, P) distance map, ``y`` the (H, W) label already
    shifted by −1 (void = −1, as the reference, find_nearest.py:117).
    """
    h, w, P = d1.shape
    grid_y = resize_label_nearest(y, (h, w))                 # (h, w)
    # penalize void patches (the reference adds 10e6, find_nearest.py:132):
    # an f32 0 / 1e7 map added in f32, as in the JAX package
    masked = d1 + _VOID_PENALTY * (grid_y == -1)[:, :, None]
    flat = masked.reshape(h * w, P)
    arg = torch.argmin(flat, dim=0)                          # first min wins
    mind = flat.gather(0, arg[None])[0]
    pi, pj = arg // w, arg % w

    # label the winning patch from its full-resolution pixel box; the
    # integer rule equals the reference's int(i * (H/h))
    H, W = y.shape
    h0, h1 = (pi * H) // h, ((pi + 1) * H) // h
    w0, w1 = (pj * W) // w, ((pj + 1) * W) // w
    max_ph = -(-H // h) + 1
    max_pw = -(-W // w) + 1
    dev = d1.device
    rows = h0[:, None] + torch.arange(max_ph, device=dev)    # (P, max_ph)
    cols = w0[:, None] + torch.arange(max_pw, device=dev)    # (P, max_pw)
    valid = (((rows < h1[:, None]) & (rows < H))[:, :, None]
             & ((cols < w1[:, None]) & (cols < W))[:, None, :])
    patch = y[rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
    target = proto_class.to(patch.dtype)
    has_target = (valid & (patch == target[:, None, None])).flatten(1).any(1)
    # majority class among the box's pixels, void −1 included (the
    # reference counts raw values, find_nearest.py:204-206); first max wins
    bins = torch.clamp(patch + 1, 0, num_classes).flatten(1).long()
    counts = torch.zeros((P, num_classes + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, bins, valid.flatten(1).to(torch.int32))
    majority = torch.argmax(counts, dim=1) - 1
    labels = torch.where(has_target, target.long(), majority)
    return mind, labels, pi, pj


def _nearest_step(model: nn.Module, num_classes: int, dev: torch.device,
                  normalize=None) -> Callable:
    """(proto_class, images (B,H,W,3), labels (B,H,W) raw) → per-image
    (min_dist, patch_label, patch_i, patch_j), each (B, P)."""

    def fn(proto_class, images, labels):
        with torch.inference_mode(), ieee_f32():
            images = normalize_images(to_device(images, dev), normalize)
            ys = to_device(labels, dev).long() - 1           # void → −1
            proto_class = to_device(proto_class, dev)
            _, d = model.push_forward(_images_nchw(model, images))
            outs = [_nearest_one_image(d[b], ys[b], proto_class, num_classes)
                    for b in range(d.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))

    return fn


def make_nearest_batch_fn(model: nn.Module, num_classes: int,
                          device: DeviceLike = None) -> Callable:
    """``fn(proto_class, image (1,H,W,3), label (1,H,W))`` → (min_dist
    (P,), patch_label (P,), patch_i (P,), patch_j (P,)), on ``device``
    (default the card).  ``label`` is raw (void = 0, class c = c + 1)
    and shifted by −1 inside, as the reference does
    (find_nearest.py:117)."""
    step = _nearest_step(model, num_classes, _prepare(model, device))

    def fn(proto_class, image, label):
        return tuple(o[0] for o in step(proto_class, image, label))

    return fn


def make_nearest_batched_fn(model: nn.Module, num_classes: int,
                            normalize=None, device: DeviceLike = None) -> Callable:
    """Batched scan step, on ``device`` (default the card):
    ``fn(proto_class, images (B,H,W,3), labels (B,H,W))`` → per-image
    (min_dist (B,P), patch_label (B,P), patch_i (B,P), patch_j (B,P)).

    One batched forward (the scan's cost is the forward), then the
    per-image argmin and box labelling; the host merges per-image
    results in dataset order, so the heap's ties are the sequential
    scan's.  ``normalize=(mean, std)`` takes raw uint8 images and
    normalizes them on the device.
    """
    return _nearest_step(model, num_classes, _prepare(model, device), normalize)


def find_k_nearest_patches(
    model: nn.Module,
    proto_class,
    dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    k: int = 6,
    return_info: bool = False,
    batch_size: int = 1,
    raw_normalize=None,
    device: DeviceLike = None,
):
    """(P, k) class ids of each prototype's k nearest patches, on
    ``device`` (default the card).

    With ``return_info=True`` also returns a dict of (P, k) arrays
    {distances, image_idx, patch_i, patch_j} sorted nearest-first, for a
    second pass that writes the artifacts (``save_nearest_artifacts``)
    without holding an activation map per candidate.

    ``batch_size`` > 1 forwards several images per call (the last
    partial batch is padded with the batch's first image and the padded
    results are dropped); the host merge walks images in dataset order,
    so the selection, heap ties included, is the sequential scan's
    (distances can differ by the convolutions' batch tiling).
    ``raw_normalize=(mean, std)`` takes raw uint8 images (batched only).
    """
    if raw_normalize is not None and batch_size <= 1:
        raise ValueError("raw_normalize requires batch_size > 1")
    dev = _prepare(model, device)
    P = model.prototype_vectors.shape[0]
    proto_class = torch.as_tensor(proto_class).to(dev)
    top_d = np.full((P, k), np.inf)
    top_l = np.full((P, k), -1, dtype=np.int64)
    top_img = np.full((P, k), -1, dtype=np.int64)
    top_pi = np.full((P, k), -1, dtype=np.int64)
    top_pj = np.full((P, k), -1, dtype=np.int64)

    def merge(img_idx, mind, labels, pi, pj):
        # the running top-k, heap semantics: strictly smaller replaces
        # the current maximum
        worst = top_d.max(axis=1)
        improved = mind < worst
        for j in np.where(improved)[0]:
            slot = int(np.argmax(top_d[j]))
            top_d[j, slot] = mind[j]
            top_l[j, slot] = labels[j]
            top_img[j, slot] = img_idx
            top_pi[j, slot] = pi[j]
            top_pj[j, slot] = pj[j]

    if batch_size > 1:
        fn = _nearest_step(model, num_classes, dev, raw_normalize)

        def merge_batch(arrays, _, off, n_real):
            mind, labs, pi, pj = arrays
            for b in range(n_real):            # dataset order
                merge(off + b, mind[b], labs[b], pi[b], pj[b])

        # a partial batch is padded with its first image
        pipelined_batches(lambda im, lab: (list(fn(proto_class, im, lab)), None),
                          dataset, batch_size, lambda im, lab: (im, lab),
                          merge_batch)
    else:
        fn = _nearest_step(model, num_classes, dev)
        for img_idx, (image, label) in enumerate(dataset):
            mind, labels, pi, pj = (o[0].cpu().numpy()
                                    for o in fn(proto_class, image, label))
            merge(img_idx, mind, labels, pi, pj)

    order = np.argsort(top_d, axis=1)
    ids = np.take_along_axis(top_l, order, axis=1)
    if not return_info:
        return ids
    info = {
        "distances": np.take_along_axis(top_d, order, axis=1),
        "image_idx": np.take_along_axis(top_img, order, axis=1),
        "patch_i": np.take_along_axis(top_pi, order, axis=1),
        "patch_j": np.take_along_axis(top_pj, order, axis=1),
    }
    return ids, info


def save_nearest_artifacts(
    model: nn.Module,
    proto_class,
    get_item: Callable,  # index -> (image (1,H,W,3), label (1,H,W))
    ids: np.ndarray,
    info: dict,
    out_dir: str,
    raw_image_fn: Optional[Callable] = None,  # index -> (H,W,3) [0,1] image
    denorm: Optional[Callable] = None,  # normalized (H,W,3) -> [0,1] image
    device: DeviceLike = None,
) -> None:
    """Second pass: re-forward only the winner images and write the
    artifact set per (prototype, rank): the original, the patch box,
    the heatmap overlay, the high-activation crop and class_id.npy
    (reference find_nearest.py:236-337)."""
    from adlm_tpu_torch.interpret import visualize as vz

    dev = _prepare(model, device)
    P, k = ids.shape
    # group winners by image so each image is forwarded once, and keep
    # only the (h, w) activation slices that won: a full (h, w, P) map
    # per winner image would take gigabytes at Cityscapes scale
    protos_by_image: dict = {}
    for j in range(P):
        for rank in range(k):
            idx = int(info["image_idx"][j, rank])
            if idx >= 0:
                protos_by_image.setdefault(idx, set()).add(j)
    act_cache = {}   # (image_idx, proto_j) -> (h, w) activation
    img_cache = {}
    for idx, js in sorted(protos_by_image.items()):
        image, label = get_item(idx)
        js_arr = sorted(js)
        with torch.inference_mode(), ieee_f32():
            x = _images_nchw(model, to_device(image, dev))
            _, d = model.push_forward(x)
            acts = distance_to_similarity(
                d[0][:, :, js_arr], model.cfg.prototype_activation,
                model.cfg.epsilon).float().cpu().numpy()
        for pos, j in enumerate(js_arr):
            act_cache[(idx, j)] = acts[:, :, pos]
        if raw_image_fn is not None:
            img_cache[idx] = raw_image_fn(idx)
        else:
            from adlm_tpu_torch.interpret.analysis import _denorm
            img_cache[idx] = (denorm or _denorm)(np.asarray(image[0]))

    for j in range(P):
        d = os.path.join(out_dir, str(j))
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "class_id.npy"), ids[j])
        for rank in range(k):
            idx = int(info["image_idx"][j, rank])
            if idx < 0:
                continue
            img = img_cache[idx]
            act = act_cache[(idx, j)]
            H, W = img.shape[0], img.shape[1]
            h, w = act.shape
            pi, pj = int(info["patch_i"][j, rank]), int(info["patch_j"][j, rank])
            box = ((pi * H) // h, ((pi + 1) * H) // h,
                   (pj * W) // w, ((pj + 1) * W) // w)
            label_id = int(ids[j, rank])
            act_up = vz.upsample_cubic(act, (H, W))
            norm = vz.normalize01(act_up)
            prefix = os.path.join(d, f"nearest-{rank + 1}")
            np.save(prefix + "_act.npy", act)
            vz._save(prefix + f"_original_{label_id}.png", img)
            vz._save(prefix + f"_original_with_patch_{label_id}.png",
                     vz._draw_box(img, box, color=(0.0, 1.0, 1.0)))
            overlay = vz._overlay(img, norm)
            vz._save(prefix + f"_original_with_heatmap_{label_id}.png", overlay)
            vz._save(prefix + f"_original_with_heatmap_and_patch_{label_id}.png",
                     vz._draw_box(overlay, box, color=(0.0, 1.0, 1.0)))
            crop = vz.high_activation_crop(act_up)
            np.save(prefix + f"_high_act_patch_indices_{label_id}.npy",
                    np.asarray(crop))
            vz._save(prefix + f"_high_act_patch_{label_id}.png",
                     img[crop[0]:crop[1], crop[2]:crop[3]])
    np.save(os.path.join(out_dir, "full_class_id.npy"), ids)

"""Prototype push: masked argmin over the dataset on the device
(counterpart of ``adlm_tpu.interpret.push``).

Per batch, on the device: the forward (``PPNet.push_forward``, whose
head is the CUDA kernel on the card, with ``d`` written out),
patch-class eligibility (a scatter-free bit-OR pooling over the
full-resolution labels), the per-prototype masked (min, argmin) over
patches and the gather of the winning feature patches.  Only (P,)-sized
results come back to the host, which keeps the running global minimum
exactly as the reference does (strict ``<``: earlier images win ties,
as in its sequential scan, reference segmentation/push.py:101-280).

The host-side merge and bookkeeping are the JAX package's numpy code,
so ties resolve the same way by construction:

* a patch is eligible for prototype j iff it holds ≥1 full-resolution
  pixel of j's class (reference push.py:216-230), pixel → patch by the
  integer rule ``(p·h)//H``;
* winning patches overwrite the prototype vectors; a prototype never
  seen keeps its old vector; duplicates are pruned keeping the first
  occurrence (reference push.py:143-155, ``np.unique`` semantics).

Entry points run on the card unless the caller passes ``device``;
everything runs in IEEE f32 (``core.device.ieee_f32``): push winners
depend on accurate distances.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

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
from adlm_tpu_torch.models.ppnet import prune_params
from adlm_tpu_torch.ops.normalize import normalize as normalize_images

_INF = 1e30  # masked distance of an ineligible patch (f32)
# distances ≥ this mean "no eligible patch": they must never win nor
# count as seen (1e30 is finite, so a plain < inf test would mark a
# never-eligible prototype as updated with a garbage patch)
_INF_HOST = _INF * 0.5

StateDict = Dict[str, torch.Tensor]


def patch_class_bits(label: torch.Tensor, grid_hw: Tuple[int, int],
                     num_classes: int) -> torch.Tensor:
    """(..., h, w) int32 bitmask: bit c set ⇔ class c has ≥1 pixel in
    patch (i, j).  ``label`` is the (..., H, W) raw full-resolution
    annotation, 0 = void, class c at value c + 1 (reference
    push.py:216-223).

    Scatter-free: each pixel's class becomes one int32 bit, OR-pooled
    over the pixel blocks of each patch row and then each patch column
    by a chain of gathers (the blocks are known from the shapes alone).
    Needs ``num_classes ≤ 31``.
    """
    if num_classes > 31:
        raise ValueError("bit-packed eligibility supports ≤31 classes; "
                         f"got {num_classes}")
    H, W = label.shape[-2], label.shape[-1]
    h, w = grid_hw
    dev = label.device
    label = label.to(torch.int32)
    cls = torch.clamp(label - 1, 0, num_classes - 1)
    one = torch.ones((), dtype=torch.int32, device=dev)
    bits = torch.where(label > 0, torch.bitwise_left_shift(one, cls), 0)
    y = torch.zeros(bits.shape[:-2] + (h, W), dtype=torch.int32, device=dev)
    for idx in _block_gathers(H, h, dev):
        y = y | bits.index_select(-2, idx)
    e = torch.zeros(bits.shape[:-2] + (h, w), dtype=torch.int32, device=dev)
    for idx in _block_gathers(W, w, dev):
        e = e | y.index_select(-1, idx)
    return e


def _block_gathers(n_px: int, n_grid: int, dev: torch.device) -> torch.Tensor:
    """(m, n_grid) pixel indices whose k-th row takes the k-th pixel of
    every grid cell's block (its last pixel where the block is shorter
    than m).  The block of cell c holds the pixels p with
    (p·n_grid)//n_px == c, i.e. ceil(c·n_px/n_grid) ≤ p <
    ceil((c+1)·n_px/n_grid).  Built on ``dev`` from the shapes alone: a
    host copy per gather would wait for the work queued before it."""
    edges = [-(-c * n_px // n_grid) for c in range(n_grid + 1)]
    m = max(b - a for a, b in zip(edges, edges[1:]))
    c = torch.arange(n_grid, device=dev)
    starts = (c * n_px + n_grid - 1) // n_grid
    ends = torch.clamp(((c + 1) * n_px + n_grid - 1) // n_grid, max=n_px)
    k = torch.arange(m, device=dev)[:, None]
    return torch.minimum(starts + k, ends - 1)


def patch_class_eligibility(label: torch.Tensor, grid_hw: Tuple[int, int],
                            num_classes: int) -> torch.Tensor:
    """(..., h, w, C) bool: class c has ≥1 pixel in patch (i, j)
    (the unpacked view of ``patch_class_bits``)."""
    bits = patch_class_bits(label, grid_hw, num_classes)
    c = torch.arange(num_classes, dtype=torch.int32, device=bits.device)
    return torch.bitwise_and(torch.bitwise_right_shift(bits[..., None], c), 1) > 0


def _masked_distances(d: torch.Tensor, labels: torch.Tensor,
                      proto_class: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, h, w, P) distances with the patches that hold no pixel of the
    prototype's class at ``_INF`` (a broadcast bit test, no table)."""
    bits = patch_class_bits(labels, (d.shape[1], d.shape[2]), num_classes)
    elig = torch.bitwise_and(torch.bitwise_right_shift(
        bits[..., None], proto_class.to(torch.int32)), 1) > 0
    return torch.where(elig, d, torch.full((), _INF, dtype=d.dtype, device=d.device))


def _push_step(model: nn.Module, num_classes: int, dev: torch.device,
               normalize: Optional[Tuple] = None) -> Callable:
    """The batched step: (proto_class, images (B,H,W,3), labels (B,H,W))
    → ((min_dist, img_in_batch, patch_i, patch_j, fmap) per prototype,
    the (h, w) grid, the (B, h, w, P) distances)."""

    def fn(proto_class, images, labels):
        with torch.inference_mode(), ieee_f32():
            images = normalize_images(to_device(images, dev), normalize)
            labels = to_device(labels, dev)
            proto_class = to_device(proto_class, dev)
            f, d = model.push_forward(_images_nchw(model, images))
            B, h, w, P = d.shape
            flat = _masked_distances(d, labels, proto_class,
                                     num_classes).reshape(B * h * w, P)
            arg = torch.argmin(flat, dim=0)          # B-major, first min wins
            mind = flat.gather(0, arg[None])[0]
            bi = arg // (h * w)
            pi = (arg % (h * w)) // w
            pj = arg % w
            fmap = f[bi, pi, pj, :]
            return (mind, bi, pi, pj, fmap), (h, w), d

    return fn


def make_push_batch_fn(model: nn.Module, num_classes: int,
                       device: DeviceLike = None) -> Callable:
    """One-image push step, on ``device`` (default the card):
    ``fn(proto_class, image (1,H,W,3), label (1,H,W))`` → (min_dist (P,),
    patch_i (P,), patch_j (P,), fmap_patch (P,C), distances (1,h,w,P))."""
    step = _push_step(model, num_classes, _prepare(model, device))

    def fn(proto_class, image, label):
        (mind, _, pi, pj, fmap), _, d = step(proto_class, image, label)
        return mind, pi, pj, fmap, d

    return fn


def _reduce_winners(mesh, outs, hw: Tuple[int, int], b: int):
    """The batch winners of a batch split over ``mesh``'s data ranks from
    each rank's own: the lexicographic (distance, global flat index)
    minimum over the ranks, the global index being B-major over the
    global batch, so a tie goes to the earliest image as in one
    device's argmin; the winner's features are summed in with zeros on
    the other ranks.  Every rank ends with the same winners."""
    mind, bi, pi, pj, fmap = outs
    h, w = hw
    gidx = ((mesh.data_index * b + bi) * (h * w) + pi * w + pj).long()
    mind, win = mesh.lexmin(mind, gidx)
    fmap = torch.where((gidx == win)[:, None], fmap, torch.zeros_like(fmap))
    mesh.all_reduce_(fmap)
    return mind, win // (h * w), (win % (h * w)) // w, win % w, fmap


def make_push_batched_fn(model: nn.Module, num_classes: int,
                         normalize: Optional[Tuple] = None,
                         device: DeviceLike = None, mesh=None) -> Callable:
    """Batched push step, on ``device`` (default the card):
    ``fn(proto_class, images (B,H,W,3), labels (B,H,W))`` → per-prototype
    batch winner (min_dist (P,), img_in_batch (P,), patch_i, patch_j,
    fmap (P,C)).

    The argmin runs B-major over the (B·h·w) patches, so a tie goes to
    the EARLIEST image, as in the reference's sequential scan.
    ``normalize=(mean, std)`` takes raw uint8 images and normalizes them
    on the device (the reference's push normalizes every image as eval
    does, segmentation/push.py:187).

    With a ``mesh`` the images are this rank's slice of a global batch
    split over the data ranks, and every rank returns the global batch's
    winners (``img_in_batch`` its global index).
    """
    step = _push_step(model, num_classes,
                      _prepare(model, mesh.device if mesh is not None else device),
                      normalize)

    def fn(proto_class, images, labels):
        outs, hw, _ = step(proto_class, images, labels)
        if mesh is None:
            return outs
        return _reduce_winners(mesh, outs, hw, images.shape[0])

    return fn


def _rf_box(pi: int, pj: int, patch_h: float, patch_w: float):
    """The winning patch's pixel box [h0, h1, w0, w1] (reference
    push.py:63-71: ``int`` of the float patch size, end + 1)."""
    return (int(pi * patch_h), int(pi * patch_h + patch_h) + 1,
            int(pj * patch_w), int(pj * patch_w + patch_w) + 1)


def push_prototypes(
    model: nn.Module,
    proto_class,
    dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    *,
    run_dir: Optional[str] = None,
    save_visualizations: bool = False,
    class_names: Optional[Dict[int, str]] = None,
    dedup: bool = True,
    batch_size: int = 1,
    log: Callable[[str], None] = print,
    denorm: Optional[Callable] = None,
    get_item: Optional[Callable] = None,
    raw_uint8: bool = False,
    raw_normalize: Optional[Tuple] = None,
    device: DeviceLike = None,
    mesh=None,
) -> Tuple[StateDict, torch.Tensor, Dict[str, Any]]:
    """Project each prototype of ``model`` (a PPNet) onto its nearest
    training patch, on ``device`` (default the card; the model moves
    there, channels-last, in eval mode).

    Args:
      dataset: iterable of (normalized image (1,H,W,3) float32, raw label
        (1,H,W) int) pairs, in a fixed order.
      denorm: inverts the dataset normalization for the visualizations
        ((H,W,3) normalized → [0,1] RGB); ImageNet statistics by default,
        ``analysis.make_denorm(cfg.data)`` for other presets.
      get_item: index → (image (1,H,W,3), label (1,H,W)) random access
        into ``dataset``'s order; needed for visualizations with
        ``batch_size`` > 1 (a second pass re-forwards only the ≤P winner
        images to render the artifacts and grow the 95th-percentile
        bound boxes).
      raw_uint8: ``dataset`` yields RAW uint8 images, normalized on the
        device with ``raw_normalize=(mean, std)`` (required).  Batched
        path only, without visualizations.
      mesh: the batched push split over ``mesh``'s data ranks
        (``core/mesh.py``): ``dataset`` then yields this rank's slices
        (images, labels, n_real) of the padded global batches of
        ``batch_size`` (``SegmentationDataset.eval_batches(shard=...)``),
        the winners are reduced across the ranks (earliest global index
        on a tie) and every rank returns the same prototypes.  The
        first rank alone renders the visualizations and writes the
        files.

    Returns:
      (state_dict, proto_class, info).  The state dict holds P′ ≤ P
      prototypes (P′ < P when dedup removed some) and loads with
      ``strict=True`` into a PPNet built with ``num_prototypes=P′``; its
      entries other than the prototype vectors, ``ones`` and the last
      layer are the model's own tensors.  ``info`` carries the
      reference's bookkeeping: ``proto_rf_boxes`` / ``proto_bound_boxes``
      rows [img_idx, h0, h1, w0, w1, class] (reference push.py:63-71),
      ``unique_index`` and ``min_distances``.
    """
    dev = _prepare(model, device)
    sd = model.state_dict()
    P, C = sd["prototype_vectors"].shape[:2]
    proto_class = torch.as_tensor(proto_class).to(dev)
    pc_host = proto_class.cpu().numpy()

    global_min = np.full(P, np.inf)
    global_fmap = np.zeros((P, C), np.float32)
    rf_boxes = np.full((P, 6), -1, dtype=np.int64)
    bound_boxes = np.full((P, 6), -1, dtype=np.int64)

    from adlm_tpu_torch.interpret import visualize as vz
    if denorm is None:
        from adlm_tpu_torch.interpret.analysis import _denorm as denorm

    if raw_uint8 and (batch_size <= 1 or save_visualizations):
        raise ValueError("raw_uint8 push requires batch_size > 1 and "
                         "save_visualizations=False")
    if raw_uint8 and raw_normalize is None:
        raise ValueError("raw_uint8 push requires raw_normalize="
                         "(mean, std) — the reference's push normalizes "
                         "its inputs (segmentation/push.py:187)")

    def artifacts(j, image, label, dist_j, box):
        return vz.save_prototype_artifacts(
            run_dir=run_dir, proto_idx=j, image=denorm(np.asarray(image[0])),
            label=np.asarray(label[0]), dist_map=dist_j, rf_box=box,
            target_class=int(pc_host[j]), class_names=class_names,
            activation=model.cfg.prototype_activation,
            epsilon=model.cfg.epsilon)

    if mesh is not None:
        if batch_size <= 1 or batch_size % mesh.data:
            raise ValueError(f"a sharded push needs a batch divisible by the "
                             f"{mesh.data} data ranks; got {batch_size}")
        if not mesh.is_main:
            save_visualizations, run_dir = False, None
            log = lambda msg: None  # noqa: E731

    if batch_size > 1:
        if save_visualizations and (get_item is None or run_dir is None):
            raise ValueError("batched push visualizations need "
                             "get_item= random access and run_dir=")
        step = _push_step(model, num_classes, dev,
                          raw_normalize if raw_uint8 else None)

        def batch(images, labels):
            outs, (h, w), _ = step(proto_class, images, labels)
            return ([o.float() if o.is_floating_point() else o for o in outs],
                    (labels.shape[1] / h, labels.shape[2] / w))

        def merge(arrays, patch_hw, off, n_real):
            mind, bi, pi, pj, fmap = arrays
            patch_h, patch_w = patch_hw
            improved = (mind < global_min) & (mind < _INF_HOST) & (bi < n_real)
            for j in np.where(improved)[0]:
                global_min[j] = mind[j]
                global_fmap[j] = fmap[j]
                rf_boxes[j] = [off + int(bi[j]),
                               *_rf_box(pi[j], pj[j], patch_h, patch_w), pc_host[j]]
                bound_boxes[j] = rf_boxes[j]

        if mesh is None:
            # a partial batch is padded with all-void (ineligible) images,
            # so every call has the (batch_size, H, W) shape
            pipelined_batches(batch, dataset, batch_size,
                              lambda im, lab: (np.zeros_like(im), np.zeros_like(lab)),
                              merge)
        else:
            off = 0
            for images, labels, n_real in dataset:
                outs, hw, _ = step(proto_class, images, labels)
                outs = _reduce_winners(mesh, outs, hw, images.shape[0])
                arrays = [o.float().cpu().numpy() if o.is_floating_point()
                          else o.cpu().numpy() for o in outs]
                merge(arrays, (labels.shape[1] / hw[0], labels.shape[2] / hw[1]),
                      off, n_real)
                off += n_real

        if save_visualizations:
            # second pass: re-forward only the winner images (≤P) to
            # render the artifacts and grow the bound boxes
            single = _push_step(model, num_classes, dev)
            winners: Dict[int, list] = {}
            for j in range(P):
                if global_min[j] < _INF_HOST:
                    winners.setdefault(int(rf_boxes[j, 0]), []).append(j)
            for img_idx in sorted(winners):
                image, label = get_item(img_idx)
                dist_host = single(proto_class, image, label)[2][0].float().cpu().numpy()
                for j in winners[img_idx]:
                    box = tuple(int(x) for x in rf_boxes[j, 1:5])
                    bound_boxes[j, 1:5] = artifacts(j, image, label,
                                                    dist_host[:, :, j], box)

        return _finalize_push(sd, proto_class, global_min, global_fmap,
                              rf_boxes, bound_boxes, dedup, run_dir, log)

    step = _push_step(model, num_classes, dev)
    for img_idx, (image, label) in enumerate(dataset):
        (mind, _, pi, pj, fmap), (h, w), dist = step(proto_class, image, label)
        mind = mind.cpu().numpy()
        improved = (mind < global_min) & (mind < _INF_HOST)
        if not improved.any():
            continue
        pi, pj = pi.cpu().numpy(), pj.cpu().numpy()
        fmap = fmap.float().cpu().numpy()
        patch_h, patch_w = label.shape[1] / h, label.shape[2] / w
        dist_host = dist[0].float().cpu().numpy() if save_visualizations else None
        for j in np.where(improved)[0]:
            global_min[j] = mind[j]
            global_fmap[j] = fmap[j]
            box = _rf_box(pi[j], pj[j], patch_h, patch_w)
            rf_boxes[j] = [img_idx, *box, pc_host[j]]
            bound_boxes[j] = [img_idx, *box, pc_host[j]]
            if save_visualizations and run_dir is not None:
                bound_boxes[j, 1:5] = artifacts(j, image, label,
                                                dist_host[:, :, j], box)

    return _finalize_push(sd, proto_class, global_min, global_fmap,
                          rf_boxes, bound_boxes, dedup, run_dir, log)


def _finalize_push(sd: StateDict, proto_class: torch.Tensor,
                   global_min: np.ndarray, global_fmap: np.ndarray,
                   rf_boxes: np.ndarray, bound_boxes: np.ndarray, dedup: bool,
                   run_dir: Optional[str], log: Callable[[str], None]
                   ) -> Tuple[StateDict, torch.Tensor, Dict[str, Any]]:
    """The push tail: merge winners, dedup, save the bookkeeping."""
    P = global_min.shape[0]
    seen = global_min < _INF_HOST
    log(f"push: {int(seen.sum())}/{P} prototypes updated")

    # prototypes never seen keep their old vector (the reference
    # overwrites them with its zero-initialized buffer; keeping the
    # trained vector is safer, and both are then candidates for dedup)
    vec = sd["prototype_vectors"]
    old = vec.detach().float().cpu().numpy().reshape(P, -1)
    merged = np.where(seen[:, None], global_fmap, old).astype(np.float32)
    new_sd = dict(sd)
    new_sd["prototype_vectors"] = torch.from_numpy(merged).reshape(vec.shape).to(
        device=vec.device, dtype=vec.dtype)
    new_pc = proto_class

    unique_index = np.arange(P)
    if dedup:
        _, unique_index = np.unique(merged, axis=0, return_index=True)
        keep = sorted(unique_index.tolist())
        n_dup = P - len(keep)
        log(f"push: removing {n_dup} duplicate prototypes")
        if n_dup:
            new_sd, new_pc = prune_params(new_sd, proto_class, keep)

    info = {
        "proto_rf_boxes": rf_boxes,
        "proto_bound_boxes": bound_boxes,
        "unique_index": sorted(int(i) for i in unique_index),
        "min_distances": global_min,
    }

    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        np.save(os.path.join(run_dir, "bb-receptive_field.npy"), rf_boxes)
        np.save(os.path.join(run_dir, "bb.npy"), bound_boxes)
        with open(os.path.join(run_dir, "unique_prototypes.json"), "w") as f:
            json.dump(info["unique_index"], f)

    return new_sd, new_pc, info
